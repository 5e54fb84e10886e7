"""Mixture-of-experts on one card (counterpart of ``repro/models/moe.py``).

A router picks each token's top-k experts by softmax weight (renormalised
over the k); entries are ranked within their expert in token order and
dropped past a static capacity C, first come, first served. Dispatch is
sort-based: a stable sort of the entries' expert ids and a left
``searchsorted`` give each entry its rank, and ``slot = expert * C +
rank`` its row of an (E, C, d) send buffer, whose extra last row takes
every dropped entry and is discarded after the scatter. Every expert then
runs its FFN over its whole capacity buffer (empty slots included, as the
reference computes them), and each token sums its kept entries' outputs
weighted by the router. Every shape follows the call's token count T =
B * S alone, and nothing reads a value on the host (no boolean mask, no
``nonzero``), so a stage over it can be captured as a CUDA graph.

Capacity depends on the tokens of the call: bucket pads, padded group rows
and inactive decode rows are routed too, as in the reference, so the drops
(and the outputs at a capacity factor that drops) depend on the batch's
composition. The switch load-balance loss comes back beside the output;
the blocks carry it through the stack where the caller asks for it
(training's ``loss_fn``), and serving drops it.

This is the reference's path without a mesh (``moe_ref``, ``es == 1``).
Its expert-parallel branch (``shard_map`` with an all-to-all over the
``experts`` mesh axis) waits for the port's ``torch.distributed`` layer.
The profiler spans ``moe`` (the block) and ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine`` name its device
time.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation_fn, dtype_of, mk_param
from repro_torch.models.mlp import MLP, apply_mlp

CAP_MIN = 4   # decode batches route few tokens/expert; keep headroom

MOE_SPAN = "moe"
ROUTE_SPAN, DISPATCH_SPAN, EXPERTS_SPAN, COMBINE_SPAN = (
    "moe.route", "moe.dispatch", "moe.experts", "moe.combine")


class MoE(nn.Module):
    """``router`` (d, E) in f32; ``wg``, ``wu`` (Ep, d, f) and ``wd`` (Ep,
    f, d) in the param dtype, Ep the padded expert count (padded experts
    get no router column and no token); ``shared``, an MLP of f *
    ``num_shared_experts``, when the config has shared experts. The
    reference's leaf names, so ``convert.py`` maps them by name."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        m = cfg.moe
        d, f = cfg.d_model, m.d_expert
        E, Ep = m.num_experts, m.padded_experts
        self.router = mk_param((d, E), torch.float32, device, gen)
        self.wg = mk_param((Ep, d, f), dt, device, gen)
        self.wu = mk_param((Ep, d, f), dt, device, gen)
        self.wd = mk_param((Ep, f, d), dt, device, gen)
        if m.num_shared_experts:
            self.shared = MLP(cfg, gen, device,
                              d_ff=f * m.num_shared_experts)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(c, min(CAP_MIN, tokens * m.top_k))


def _route(x_tok: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_tok (T,d) -> (top-k expert ids (T,k), their weights (T,k) f32,
    renormalised, the switch load-balance loss E * sum_e f_e * p_e)."""
    m = cfg.moe
    probs = torch.softmax(x_tok.float() @ router_w, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    T = x_tok.shape[0]
    counts = torch.zeros(m.num_experts, dtype=torch.float32,
                         device=x_tok.device).index_add_(
        0, idx.reshape(-1), torch.ones(T * m.top_k, device=x_tok.device))
    f_e = counts / (T * m.top_k)
    aux = m.num_experts * (f_e * probs.mean(dim=0)).sum()
    return idx, w, aux


def _dispatch_indices(e_flat: torch.Tensor, E_local: int, C: int, ES: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry -> its row of the (ES, E_local, C) send buffer, and whether it
    is kept: its rank among its expert's entries in entry order (a stable
    sort, then the first index of its expert id in the sorted ids) below
    C. A dropped entry's row is ES * E_local * C, one past the buffer."""
    n = e_flat.shape[0]
    e_sorted, order = torch.sort(e_flat, stable=True)
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos_sorted = torch.arange(n, device=e_flat.device) - first
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < C
    dest = e_flat // E_local
    slot = dest * (E_local * C) + (e_flat % E_local) * C + pos
    slot = torch.where(keep, slot, torch.full_like(slot, ES * E_local * C))
    return slot, keep


def _expert_ffn(xin: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xin (E, N, d) -> ``act(xin @ wg) * (xin @ wu) @ wd`` per expert,
    (E, N, d), as batched products."""
    act = activation_fn(cfg.activation)
    h = act(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    return torch.bmm(h, wd)


def _moe_local(x_tok: torch.Tensor, p: MoE, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_tok (T,d) -> (out (T,d) in x's dtype, aux): the reference's
    per-shard body at es = 1."""
    T, d = x_tok.shape
    m = cfg.moe
    E_local = m.padded_experts
    C = _capacity(T, cfg)
    with torch.profiler.record_function(ROUTE_SPAN):
        idx, w, aux = _route(x_tok, p.router, cfg)
    with torch.profiler.record_function(DISPATCH_SPAN):
        e_flat = idx.reshape(-1)                             # (T*k,)
        t_flat = torch.arange(T * m.top_k, device=x_tok.device) // m.top_k
        slot, keep = _dispatch_indices(e_flat, E_local, C, 1)
        N = E_local * C
        # row N is the dump row of the dropped entries, discarded
        buf = torch.zeros(N + 1, d, dtype=x_tok.dtype, device=x_tok.device)
        buf.index_copy_(0, slot, x_tok.index_select(0, t_flat))
        xin = buf[:N].view(E_local, C, d)
    with torch.profiler.record_function(EXPERTS_SPAN):
        y = _expert_ffn(xin, p.wg, p.wu, p.wd, cfg).reshape(N, d)
    with torch.profiler.record_function(COMBINE_SPAN):
        vals = y.index_select(0, slot.clamp(max=N - 1))
        # the keep mask folded into the weights: a product by 0 or 1 is
        # exact, so this equals masking the values first, in one pass less
        wk = w.to(vals.dtype).reshape(-1) * (keep & (slot < N)).to(
            vals.dtype)
        out = (vals * wk[:, None]).view(T, m.top_k, d).sum(dim=1)
    return out.to(x_tok.dtype), aux


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), the switch aux loss): every token of the
    call routed together (capacity from T = B * S), plus the shared
    experts' MLP where the config has them."""
    with torch.profiler.record_function(MOE_SPAN):
        B, S, d = x.shape
        out, aux = _moe_local(x.reshape(B * S, d), p, cfg)
        out = out.reshape(B, S, d)
        if cfg.moe.num_shared_experts:
            out = out + apply_mlp(p.shared, x, cfg)
    return out, aux

"""Griffin / RecurrentGemma RG-LRU recurrent block (``repro/models/rglru.py``).
[arXiv:2402.19427]

Residual-block mixer: two input branches (a tanh-GELU gate; a causal conv1d
then the RG-LRU), merged multiplicatively and projected out. The sequence
form runs the gated recurrence h_t = a_t h_{t-1} + b_t as a doubling
(Hillis-Steele) scan over the sequence axis in f32, the function the
reference's ``jax.lax.associative_scan`` computes, up to the order of
rounding; decode is one step of the recurrence.

A layer's per-slot state is a dict of preallocated tensors updated in
place: ``h`` (B, w) f32, the hidden state after the row's last token, and
``conv`` (B, d_conv-1, w), the last d_conv-1 pre-conv inputs (the causal
conv's left context). Every write keeps a fixed shape and reads no value
on the host, so the serving stages stay capturable as CUDA graphs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (causal_conv_with_carry, dtype_of,
                                       mk_param, tail_at_lengths,
                                       write_rows)

N_BLOCKS = 8        # block-diagonal gate projections
LRU_C = 8.0         # RG-LRU temperature constant

# the profiler spans around a recurrent layer's mixer and around its scan
# (``chip_smoke.py`` reads their device time)
RGLRU_SPAN = "rglru"
RGLRU_SCAN_SPAN = "rglru_scan"

State = Dict[str, torch.Tensor]


def _width(cfg: ModelConfig) -> int:
    return cfg.recurrent.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """The reference's leaves: ``proj_x``/``proj_gate`` (d,w), ``conv_w``
    (d_conv,w), ``conv_b`` (w,), the block-diagonal gates ``wa``/``wx``
    (nb,bw,bw), their biases ``ba``/``bx`` and the decay ``a_param`` (w,),
    kept f32 in a bf16 model as the reference keeps them, and ``proj_out``
    (w,d)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        f32 = torch.float32
        d, w = cfg.d_model, _width(cfg)
        nb = N_BLOCKS if w % N_BLOCKS == 0 else 1
        bw = w // nb
        self.proj_x = mk_param((d, w), dt, device, gen)
        self.proj_gate = mk_param((d, w), dt, device, gen)
        self.conv_w = mk_param((cfg.recurrent.d_conv, w), dt, device, gen,
                               scale=0.5)
        self.conv_b = mk_param((w,), dt, device, init="zeros")
        self.wa = mk_param((nb, bw, bw), dt, device, gen)
        self.wx = mk_param((nb, bw, bw), dt, device, gen)
        self.ba = mk_param((w,), f32, device, init="zeros")
        self.bx = mk_param((w,), f32, device, init="zeros")
        self.a_param = mk_param((w,), f32, device, init="ones")
        self.proj_out = mk_param((w, d), dt, device, gen)


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> State:
    w = _width(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.recurrent.d_conv - 1, w),
                                dtype=dtype_of(cfg.activation_dtype),
                                device=device)}


def _block_diag(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u (..., nb*bw) @ block-diag w (nb,bw,bw) -> (..., nb*bw)."""
    nb, bw, _ = w.shape
    ub = u.reshape(u.shape[:-1] + (nb, bw))
    return torch.einsum("...ki,kij->...kj", ub, w).reshape(u.shape)


def _gates(p: RGLRU, u: torch.Tensor):
    """The recurrence's decay ``a`` and gated input ``b``, f32."""
    r = torch.sigmoid(_block_diag(u, p.wa).float() + p.ba)
    i = torch.sigmoid(_block_diag(u, p.wx).float() + p.bx)
    log_a = -LRU_C * r * F.softplus(p.a_param)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, mult * i * u.float()


def _gate_branch(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh form
    return F.gelu(x @ p.proj_gate, approximate="tanh")


def _mask_invalid(a, b, valid: torch.Tensor):
    """Tokens ``valid`` (B,S) leaves out carry a = 1, b = 0: the recurrence
    passes through them unchanged."""
    v = valid[..., None]
    return torch.where(v, a, 1.0), torch.where(v, b, 0.0)


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, f32: returns
    (prod_{s<=t} a_s, h). log2(S) rounds of the reference's combine
    ``(a, b) <- (a_t a_{t-k}, a_t b_{t-k} + b_t)`` at distances k = 1, 2,
    4, ...; the first k entries of a round combine with the identity and
    stay as they are. Each round makes new tensors (no in-place write),
    so autograd differentiates it."""
    with torch.profiler.record_function(RGLRU_SCAN_SPAN):
        k, S = 1, a.shape[1]
        while k < S:
            b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
            k *= 2
        return a, b


def _out(p: RGLRU, gate: torch.Tensor, h: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    return (gate.float() * h).to(dtype) @ p.proj_out


def _take_rows(src: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """src (B,S,...) at each row's position max(lengths - 1, 0)."""
    b = torch.arange(src.shape[0], device=src.device)
    return src[b, (lengths.long() - 1).clamp(min=0)]


def rglru_forward(p: RGLRU, x: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  cache: Optional[State] = None,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d). ``valid`` (B,S) marks the real tokens of a
    right-padded row (the others carry a = 1, b = 0, so the state after
    the row is the state after its real tokens). With ``cache``, batch row
    j's exit state (``h`` after its last real token, the pre-conv inputs
    ending there) is written into cache row ``rows[j]``; a negative
    ``rows[j]`` marks a padded group row, which repeats row 0's write
    (the reference's ``return_state``, written in place)."""
    with torch.profiler.record_function(RGLRU_SPAN):
        B, S = x.shape[:2]
        gate = _gate_branch(p, x)
        u_pre = x @ p.proj_x
        K = p.conv_w.shape[0]
        carry = u_pre.new_zeros((B, K - 1, u_pre.shape[-1]))
        u, _ = causal_conv_with_carry(u_pre, p.conv_w, p.conv_b, carry)
        a, b = _gates(p, u)
        if valid is not None:
            a, b = _mask_invalid(a, b, valid)
        _, h = linear_scan(a, b)
        out = _out(p, gate, h, x.dtype)
        if cache is not None:
            lengths = (torch.full((B,), S, dtype=torch.int32, device=x.device)
                       if valid is None else valid.sum(-1))
            pad = rows < 0
            src = torch.where(pad, 0, torch.arange(B, device=x.device))
            dst = torch.where(pad, rows[0], rows)
            write_rows(cache, {"h": _take_rows(h, lengths),
                               "conv": tail_at_lengths(u_pre, lengths,
                                                       K - 1)}, src, dst)
        return out


def rglru_chunk_step(p: RGLRU, x: torch.Tensor, cache: State,
                     slots: torch.Tensor, start: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One prompt chunk per group row against the live state: x (P,C,d)
    for cache rows ``slots`` (P,) at offsets ``start`` (P,), of which the
    first ``lengths[j]`` tokens are real. The entering ``h`` and conv tail
    are read at ``slots`` (zeros on a request's first chunk: the row may
    hold a previous occupant's state), the recurrence is seeded with them
    (the scan is linear in the entering state: h_t = (prod a) h0 +
    h_t^zero), and the exit state is written back. Tokens past
    ``lengths[j]`` carry a = 1, b = 0; a padded group row (lengths 0)
    repeats the first real row's write, so it writes nothing of its own
    (the reference scatters it out of bounds). Returns y (P,C,d)."""
    with torch.profiler.record_function(RGLRU_SPAN):
        P, C = x.shape[:2]
        rows = slots.long()
        first = (start == 0)
        h0 = torch.where(first[:, None], 0.0, cache["h"][rows])
        carry = torch.where(first[:, None, None], 0.0,
                            cache["conv"][rows]).to(cache["conv"].dtype)
        gate = _gate_branch(p, x)
        u_pre = x @ p.proj_x
        u, _ = causal_conv_with_carry(u_pre, p.conv_w, p.conv_b, carry)
        a, b = _gates(p, u)
        valid = torch.arange(C, device=x.device)[None, :] < lengths[:, None]
        a, b = _mask_invalid(a, b, valid)
        a_cum, h_zero = linear_scan(a, b)
        h = a_cum * h0[:, None, :] + h_zero
        out = _out(p, gate, h, x.dtype)
        real = lengths > 0
        j = torch.arange(P, device=x.device)
        src = torch.where(real, j, real.int().argmax())
        K = p.conv_w.shape[0]
        write_rows(cache, {"h": _take_rows(h, lengths),
                           "conv": tail_at_lengths(u_pre, lengths, K - 1,
                                                   prepend=carry)},
                   src, rows[src])
        return out


def rglru_decode_step(p: RGLRU, x: torch.Tensor, cache: State,
                      active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,1,d): one step of every row. A row ``active`` (B,) bool leaves
    out (a free or a mid-prefill slot riding the fixed-shape step) keeps
    its ``h`` and conv tail as they were. Returns y (B,1,d)."""
    with torch.profiler.record_function(RGLRU_SPAN):
        gate = _gate_branch(p, x)
        u_new = x @ p.proj_x
        window = torch.cat([cache["conv"], u_new.to(cache["conv"].dtype)],
                           dim=1)                               # (B,K,w)
        u = (torch.einsum("bkw,kw->bw", window, p.conv_w)
             + p.conv_b)[:, None]
        a, b = _gates(p, u)
        h = a[:, 0] * cache["h"] + b[:, 0]
        out = _out(p, gate, h[:, None], x.dtype)
        new_h, new_conv = h, window[:, 1:]
        if active is not None:
            new_h = torch.where(active[:, None], new_h, cache["h"])
            new_conv = torch.where(active[:, None, None], new_conv,
                                   cache["conv"])
        cache["h"].copy_(new_h)
        cache["conv"].copy_(new_conv)
        return out

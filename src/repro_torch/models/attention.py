"""Global (causal, all-positions) GQA attention with a KV cache — the part
of ``repro/models/attention.py`` that deepseek-7b serving runs. Prefill goes
through the flash kernel, decode through the flash-decode kernel.

The KV cache is a dict of preallocated ``k``/``v`` tensors (B, max_len, K, hd)
that prefill and decode update in place. (The JAX package instead returns a
new cache and donates the old one to the jitted step.)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.models.common import apply_rope, dtype_of, mk_param

Cache = Dict[str, torch.Tensor]


class Attention(nn.Module):
    """``wq`` (d,H,hd), ``wk``/``wv`` (d,K,hd), ``wo`` (H,hd,d): the JAX
    layout, so converted weights load as they are."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = mk_param((d, H, hd), dt, device, gen)
        self.wk = mk_param((d, K, hd), dt, device, gen)
        self.wv = mk_param((d, K, hd), dt, device, gen)
        self.wo = mk_param((H, hd, d), dt, device, gen)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device) -> Cache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg.activation_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) @ w (d,N,hd) -> (B,S,N,hd)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    q = apply_rope(_head_proj(x, p.wq), positions, cfg.rope_theta)
    k = apply_rope(_head_proj(x, p.wk), positions, cfg.rope_theta)
    v = _head_proj(x, p.wv)
    return q, k, v


def _out_proj(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,hd) -> (B,S,d)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p.wo.reshape(-1, p.wo.shape[-1])


def full_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None):
    """Causal attention over a whole (right-padded) sequence: x (B,S,d),
    ``kv_valid`` (B,S) marks real tokens. Returns (y (B,S,d), (k, v))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    lens = None if kv_valid is None else kv_valid.sum(-1).to(torch.int32)
    o = flash_attn(q, k, v, lens, causal=True)
    return _out_proj(p, o), (k, v)


def fill_cache_from_prefill(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                            rows: torch.Tensor) -> None:
    """Write prefill K/V (B,S,K,hd) in place: batch row j lands in cache row
    ``rows[j]`` at positions [0, S), for the first ``len(rows)`` rows.
    Positions past S keep what the row held before; decode writes a
    position before it attends it, so they are never read."""
    n, S = rows.shape[0], k.shape[1]
    cache["k"][rows, :S] = k[:n].to(cache["k"].dtype)
    cache["v"][rows, :S] = v[:n].to(cache["v"].dtype)


def decode_attention(p: Attention, x: torch.Tensor, cache: Cache,
                     pos: torch.Tensor, cfg: ModelConfig,
                     rows: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Cache]:
    """x (B,1,d); ``pos`` (B,) int32 tokens already in each row's cache.
    The new K/V is written in place at ``pos`` for the rows in ``rows``
    (all rows when None); an inactive row writes nothing, which is what
    the JAX package's write-back of the old value amounts to. Every row
    then attends keys [0, pos]. Returns (y (B,1,d), cache)."""
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    if rows is None:
        rows = torch.arange(x.shape[0], device=x.device)
    at = pos.long()[rows]
    cache["k"][rows, at] = k_new[rows, 0].to(cache["k"].dtype)
    cache["v"][rows, at] = v_new[rows, 0].to(cache["v"].dtype)
    o = decode_attn(q[:, 0], cache["k"], cache["v"], pos)    # (B,H,hd) f32
    return _out_proj(p, o.to(x.dtype)[:, None]), cache

"""Global (causal, all-positions) GQA attention with a KV cache — the part
of ``repro/models/attention.py`` that deepseek-7b serving runs. Prefill goes
through the flash kernel, decode through the flash-decode kernel (or its
int8-cache twin). A projection whose weight the build step quantized
(``QuantDense``) goes through the w8a8 kernel.

The KV cache is a dict of preallocated ``k``/``v`` tensors (B, max_len, K, hd)
that prefill and decode update in place. (The JAX package instead returns a
new cache and donates the old one to the jitted step.) With
``cfg.quant.kv_cache_dtype == "int8"`` the cache holds int8 ``k``/``v`` and
fp16 ``k_scale``/``v_scale`` (B, max_len, K): one symmetric scale per
(token, kv head).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import dense_w8a8, is_quantized_dense
from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_int8
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
    if cfg.quant.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                       device=device)}
    dt = dtype_of(cfg.activation_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _kv_quant(x: torch.Tensor):
    """x (..., hd) -> (int8 vals, fp16 scale (...,)) symmetric per vector
    (the values are rounded against the f32 scale, which is then stored
    in fp16, as the JAX package does)."""
    xf = x.to(torch.float32)
    absmax = torch.clamp(xf.abs().amax(dim=-1), min=1e-6)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _head_proj(x: torch.Tensor, w, cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,d) @ w (d,N,hd) -> (B,S,N,hd); the quantized form holds the
    head axes flattened ((d, N*hd) int8) and they are restored from
    ``cfg.head_dim``."""
    B, S, d = x.shape
    if is_quantized_dense(w):
        return dense_w8a8(x, w).view(B, S, -1, cfg.head_dim)
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    q = apply_rope(_head_proj(x, p.wq, cfg), positions, cfg.rope_theta)
    k = apply_rope(_head_proj(x, p.wk, cfg), positions, cfg.rope_theta)
    v = _head_proj(x, p.wv, cfg)
    return q, k, v


def _out_proj(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,hd) -> (B,S,d); ``wo`` contracts its leading head axes."""
    B, S = o.shape[:2]
    if is_quantized_dense(p.wo):
        return dense_w8a8(o.reshape(B, S, -1), p.wo)
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


def _cache_entries(cache: Cache, k: torch.Tensor, v: torch.Tensor):
    """(cache key, value) pairs that store K/V in this cache's format."""
    if "k_scale" not in cache:
        return (("k", k), ("v", v))
    kq, ks = _kv_quant(k)
    vq, vs = _kv_quant(v)
    return (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))


def fill_cache_from_prefill(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                            rows: torch.Tensor) -> None:
    """Write prefill K/V (B,S,K,hd) in place: batch row j lands in cache row
    ``rows[j]`` at positions [0, S), for the first ``len(rows)`` rows.
    Positions past S keep what the row held before; decode writes a
    position before it attends it, so they are never read. An int8 cache
    stores the quantized K/V; prefill itself attended the exact ones."""
    n, S = rows.shape[0], k.shape[1]
    for name, val in _cache_entries(cache, k[:n], v[:n]):
        cache[name][rows, :S] = val.to(cache[name].dtype)



def decode_attention(p: Attention, x: torch.Tensor, cache: Cache,
                     pos: torch.Tensor, cfg: ModelConfig,
                     rows: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Cache]:
    """x (B,1,d); ``pos`` (B,) int32 tokens already in each row's cache.
    The new K/V is written in place at ``pos`` for the rows in ``rows``
    (all rows when None); an inactive row writes nothing, which is what
    the JAX package's write-back of the old value amounts to. Every row
    then attends keys [0, pos]; an int8 cache is quantized on the write
    and read through the int8 decode kernel. Returns (y (B,1,d), cache)."""
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    if rows is None:
        rows = torch.arange(x.shape[0], device=x.device)
    at = pos.long()[rows]
    for name, val in _cache_entries(cache, k_new[rows, 0], v_new[rows, 0]):
        cache[name][rows, at] = val.to(cache[name].dtype)
    if "k_scale" in cache:
        o = decode_attn_int8(q[:, 0], cache["k"], cache["k_scale"],
                             cache["v"], cache["v_scale"], pos)
    else:
        o = decode_attn(q[:, 0], cache["k"], cache["v"], pos)
    return _out_proj(p, o.to(x.dtype)[:, None]), cache

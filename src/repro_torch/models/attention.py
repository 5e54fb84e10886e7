"""Global (causal, all-positions) GQA attention with a KV cache — the part
of ``repro/models/attention.py`` that deepseek-7b serving runs. Prefill and
prefill chunks go through the flash kernel, decode through the
flash-decode kernel (or its int8-cache twin). A projection whose weight the
build step quantized (``QuantDense``) goes through the w8a8 kernel.

The KV cache is a dict of preallocated ``k``/``v`` tensors (B, max_len, K, hd)
that prefill and decode update in place. (The JAX package instead returns a
new cache and donates the old one to the jitted step.) With
``cfg.quant.kv_cache_dtype == "int8"`` the cache holds int8 ``k``/``v`` and
fp16 ``k_scale``/``v_scale`` (B, max_len, K): one symmetric scale per
(token, kv head).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
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


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32)
            * scale.to(torch.float32)[..., None]).to(dtype)


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
    ``rows[j]`` at positions [0, S). A negative ``rows[j]`` marks a padded
    group row: it repeats row 0's write (the same cache row, the same
    values), so the write keeps one fixed shape, stays deterministic under
    repeated indices, and stores only the real rows. Positions past S keep
    what the row held before; decode writes a position before it attends
    it, so they are never read. An int8 cache stores the quantized K/V;
    prefill itself attended the exact ones."""
    S = k.shape[1]
    pad = rows < 0
    src = torch.where(pad, 0, torch.arange(rows.shape[0], device=rows.device))
    dst = torch.where(pad, rows[0], rows)
    for name, val in _cache_entries(cache, k, v):
        cache[name][dst, :S] = val.to(cache[name].dtype)[src]


def decode_attention(p: Attention, x: torch.Tensor, cache: Cache,
                     pos: torch.Tensor, cfg: ModelConfig,
                     rows: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Cache]:
    """x (B,1,d); ``pos`` (B,) int32 tokens already in each row's cache.
    Every row computes its K/V and writes it in place at ``pos`` (clamped
    to the cache, as the reference's ``dynamic_update_slice``); a row that
    ``active`` (B,) bool marks inactive (or that the index tensor ``rows``
    of active rows leaves out) writes back the value already there, the
    reference's ``guard``, so its cache stays bit for bit as it was and the
    step's shapes do not depend on which rows decode. Every row then
    attends keys [0, pos]; an int8 cache is quantized on the write and read
    through the int8 decode kernel. Returns (y (B,1,d), cache)."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None])
    if rows is not None:
        active = torch.zeros(B, dtype=torch.bool, device=x.device)
        active[rows.to(x.device)] = True
    b = torch.arange(B, device=x.device)
    at = pos.long().clamp(0, cache["k"].shape[1] - 1)
    for name, val in _cache_entries(cache, k_new[:, 0], v_new[:, 0]):
        val = val.to(cache[name].dtype)
        if active is not None:
            keep = active.view((B,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, cache[name][b, at])
        cache[name][b, at] = val
    if "k_scale" in cache:
        o = decode_attn_int8(q[:, 0], cache["k"], cache["k_scale"],
                             cache["v"], cache["v_scale"], pos)
    else:
        o = decode_attn(q[:, 0], cache["k"], cache["v"], pos)
    return _out_proj(p, o.to(x.dtype)[:, None]), cache


# an int8 cache's chunk path dequantizes each group row's keys up to the
# largest ``start + lengths`` rounded up to this many keys: the flash
# kernel's K/V tile on the tensor cores (128 keys; the CUDA-core kernel's
# 32-key tile divides it)
DEQUANT_TILE = 128


@dataclass
class ChunkCoords:
    """Where one prefill chunk call of P rows of C tokens reads and writes,
    on the device, in shapes fixed by (P, C); shared by every layer."""
    positions: torch.Tensor          # (P,C) int64: start[j] + i
    lens: torch.Tensor               # (P,) int32: start + lengths
    q_off: torch.Tensor              # (P,) int32: start
    kv_rows: torch.Tensor            # (P,) int32 cache rows (slots)
    write_rows: torch.Tensor         # (P*C,) int64 cache row of each write
    write_pos: torch.Tensor          # (P*C,) int64 its position in the row
    src: torch.Tensor                # (P*C,) int64 its token of the P*C
    dequant_len: Optional[int]       # keys an int8 cache dequantizes a row


def chunk_writes(slots, start, write_pos, lengths, C: int, max_len: int,
                 n_slots: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Host arrays (P,) of a chunk group -> (the call's coordinates as host
    arrays of fixed shapes, which ``chunk_coords`` reads; the keys an int8
    cache dequantizes a row). Row j's chunk covers positions start[j] ..
    start[j]+C-1, of which the first ``lengths[j]`` are real (0: a padded
    row). Only the real tokens are written, at ``write_pos[j] + i``, and
    only below ``max_len``: the JAX package scatters all C with
    out-of-bounds writes dropped, and the positions past a row's real
    tokens that it writes are rewritten before anything reads them (the
    next chunk or decode writes a position before attending it). The write
    has P*C entries: each entry that is not a real token repeats the call's
    first real write (the same index, its ``src`` that token), so the
    cache ends bit for bit as a write of the real tokens alone leaves it.
    Raises for a slot outside the cache's ``n_slots`` rows, or a call with
    no token to write."""
    slots, start, write_pos, lengths = (np.asarray(a, np.int64) for a in
                                        (slots, start, write_pos, lengths))
    if not all(0 <= s < n_slots for s in slots.tolist()):
        raise ValueError(f"chunk slots {slots.tolist()} outside the cache's "
                         f"{n_slots} rows")
    i = np.arange(C)[None, :]
    real = ((i < lengths[:, None])
            & (write_pos[:, None] + i < max_len)).reshape(-1)
    if not real.any():
        raise ValueError("a chunk call must write at least one token below "
                         f"max_len {max_len}")
    rows = np.repeat(slots, C)
    pos = (write_pos[:, None] + i).reshape(-1)
    src = np.arange(slots.size * C)
    first = int(np.flatnonzero(real)[0])
    ends = start + lengths
    dequant = -(-int(ends.max(initial=1)) // DEQUANT_TILE) * DEQUANT_TILE
    return {"slots": slots.astype(np.int32),
            "start": start.astype(np.int32),
            "lens": ends.astype(np.int32),
            "write_rows": np.where(real, rows, rows[first]),
            "write_pos": np.where(real, pos, pos[first]),
            "src": np.where(real, src, first)}, \
        min(max(dequant, 1), max_len)


def chunk_coords(t: Dict[str, torch.Tensor], C: int,
                 dequant_len: Optional[int] = None) -> ChunkCoords:
    """The device form of ``chunk_writes``' arrays (``t``: the same names as
    tensors on the device, e.g. a stage's static buffers)."""
    start = t["start"]
    return ChunkCoords(
        positions=start.long()[:, None]
        + torch.arange(C, device=start.device)[None, :],
        lens=t["lens"], q_off=start, kv_rows=t["slots"],
        write_rows=t["write_rows"], write_pos=t["write_pos"], src=t["src"],
        dequant_len=dequant_len)


def chunk_prefill_attention(p: Attention, x: torch.Tensor, cache: Cache,
                            cc: ChunkCoords, cfg: ModelConfig
                            ) -> torch.Tensor:
    """One prompt chunk per group row against the live cache (the global
    half of the JAX package's ``chunk_prefill_attention``): x (P,C,d) at
    positions ``cc.positions``. The chunk's real K/V is written into the
    cache rows in place, then every query attends its own cache row
    through the flash kernel: key t is visible to chunk query i of row j
    iff t <= start[j] + i (and t < start[j] + lengths[j]). An fp cache is
    read in place (``kv_rows``); an int8 cache is quantized on the write
    and its group rows dequantized up to ``cc.dequant_len`` keys. Every
    shape is fixed by (P, C) and ``cc.dequant_len``. Returns y (P,C,d)."""
    P, C = x.shape[:2]
    q, k_new, v_new = _project_qkv(p, x, cfg, cc.positions)
    k_tok = k_new.reshape(P * C, *k_new.shape[2:])[cc.src]
    v_tok = v_new.reshape(P * C, *v_new.shape[2:])[cc.src]
    for name, val in _cache_entries(cache, k_tok, v_tok):
        cache[name][cc.write_rows, cc.write_pos] = val.to(cache[name].dtype)
    if "k_scale" in cache:
        n, rows = cc.dequant_len, cc.kv_rows.long()
        ck = _kv_dequant(cache["k"][rows, :n], cache["k_scale"][rows, :n],
                         x.dtype)
        cv = _kv_dequant(cache["v"][rows, :n], cache["v_scale"][rows, :n],
                         x.dtype)
        o = flash_attn(q, ck, cv, cc.lens, q_off=cc.q_off)
    else:
        o = flash_attn(q, cache["k"], cache["v"], cc.lens, q_off=cc.q_off,
                       kv_rows=cc.kv_rows)
    return _out_proj(p, o)

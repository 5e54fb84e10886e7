"""GQA attention with a KV cache, of the two kinds gemma2-27b and
deepseek-7b serving run in ``repro/models/attention.py``: ``global``
(causal over every position) and ``local`` (a sliding window of
``cfg.window_size`` keys, its cache a ring of ``min(window_size, max_len)``
slots per row), both with the optional logit softcap, optional q/k/v
and output biases (XLM-R's, qwen2-vl's), and RoPE or M-RoPE (qwen2-vl's
three position streams) on q and k; and whisper's cross-attention, a decoder
query (its bias, no RoPE) over the encoder's frames. Prefill and prefill
chunks go through the flash kernel, and so do an encoder's non-causal
attention and a cross-attention's prefill; decode goes through the
flash-decode kernel (or its int8-cache twin), cross-attention's decode
too. A projection whose weight the build step quantized (``QuantDense``)
goes through the w8a8 kernel. Training takes the reference's dense path
in plain torch instead (``dense_attention``, ``dense_cross_attention``),
which autograd differentiates; the kernels have no backward.

The KV cache is a dict of preallocated ``k``/``v`` tensors (B, slots, K, hd)
that prefill and decode update in place. (The JAX package instead returns a
new cache and donates the old one to the jitted step.) With
``cfg.quant.kv_cache_dtype == "int8"`` the cache holds int8 ``k``/``v`` and
fp16 ``k_scale``/``v_scale`` (B, slots, K): one symmetric scale per
(token, kv head).

Ring slot r of a local layer holds the newest position p with p % slots ==
r (``_ring_newest_positions``). Since RoPE is applied before the write, the
order of the keys in a ring does not matter to a decode softmax, so decode
reads a ring through the same kernels as a global row. A prefill chunk
cannot read a ring in place (flash wants keys in position order), so it
gathers each row's ring into position order first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.core.quantization import dense_w8a8, is_quantized_dense
from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_int8
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.models.common import (apply_mrope, apply_rope, dtype_of,
                                       mk_param, softcap)

Cache = Dict[str, torch.Tensor]

# the dense path's mask value, finite so a fully masked softmax row (and
# its gradient) stays NaN-free, and its query-block size for long
# sequences: the reference's ``NEG_INF`` and ``PREFILL_Q_CHUNK``
NEG_INF = -2.3819763e38
PREFILL_Q_CHUNK = 4096


class Attention(nn.Module):
    """``wq`` (d,Hp,hd), ``wk``/``wv`` (d,K,hd), ``wo`` (Hp,hd,d): the JAX
    layout, so converted weights load as they are. ``Hp`` is
    ``cfg.padded_heads``: heads H..Hp-1 are padding, their ``wo`` rows
    zero at init (as the JAX package's), so the kernels attend them and
    the output projection discards them exactly. Every reshape after the
    projections takes its head count from the weights, never from
    ``cfg.num_heads``. With ``cfg.qkv_bias`` it holds ``bq`` (Hp,hd),
    ``bk`` and ``bv`` (K,hd), with ``cfg.o_bias`` ``bo`` (d,): zeros at
    init, as the JAX package's."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        Hp = cfg.padded_heads
        self.wq = mk_param((d, Hp, hd), dt, device, gen)
        self.wk = mk_param((d, K, hd), dt, device, gen)
        self.wv = mk_param((d, K, hd), dt, device, gen)
        self.wo = mk_param((Hp, hd, d), dt, device, gen)
        self.wo.data[H:] = 0          # the padded heads' output rows
        if cfg.qkv_bias:
            self.bq = mk_param((Hp, hd), dt, device, init="zeros")
            self.bk = mk_param((K, hd), dt, device, init="zeros")
            self.bv = mk_param((K, hd), dt, device, init="zeros")
        if cfg.o_bias:
            self.bo = mk_param((d,), dt, device, init="zeros")


def cache_slots(cfg: ModelConfig, max_len: int, kind: str) -> int:
    """Positions a layer's cache row holds: a local ring keeps
    ``min(window_size, max_len)``, a global row ``max_len``."""
    if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
        raise ValueError(f"attention kind must be {ATTN_GLOBAL!r} or "
                         f"{ATTN_LOCAL!r}, got {kind!r}")
    return min(cfg.window_size, max_len) if kind == ATTN_LOCAL else max_len


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                  kind: str) -> Cache:
    shape = (batch, cache_slots(cfg, max_len, kind), cfg.num_kv_heads,
             cfg.head_dim)
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


def _ring_newest_positions(last: torch.Tensor, win: int) -> torch.Tensor:
    """Per ring slot r, the newest absolute position p <= ``last`` (B,)
    with p % win == r; negative means that slot was never written.
    -> (B, win), in ``last``'s dtype."""
    r = torch.arange(win, dtype=last.dtype, device=last.device)[None, :]
    last = last[:, None]
    return last - torch.remainder(last - r, win)


def _head_proj(x: torch.Tensor, w, cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,d) @ w (d,N,hd) -> (B,S,N,hd), N the weight's heads (padded
    ones included); the quantized form holds the head axes flattened
    ((d, N*hd) int8) and they are restored from ``cfg.head_dim``."""
    B, S, d = x.shape
    if is_quantized_dense(w):
        return dense_w8a8(x, w).view(B, S, -1, cfg.head_dim)
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _rope(x: torch.Tensor, positions: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """RoPE as ``cfg.rope_mode`` says: plain at ``positions`` (B,S), or
    M-RoPE at (t, h, w) position ids (3,B,S)."""
    if cfg.rope_mode == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _one_stream(positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Positions (B,S) of a chunk or a decode step in the form ``_rope``
    takes: for M-RoPE the one stream broadcast to all three (3,B,S), as
    the reference's chunk and decode paths do."""
    if cfg.rope_mode == "mrope":
        return positions[None].expand((3,) + positions.shape)
    return positions


def _project_q(p: Attention, x: torch.Tensor, cfg: ModelConfig,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    """The query projection and its bias, then RoPE at ``positions``; a
    cross-attention query passes None and takes no RoPE (the reference's
    ``rope=False``)."""
    q = _head_proj(x, p.wq, cfg)
    if hasattr(p, "bq"):
        q = q + p.bq
    if positions is None:
        return q
    return _rope(q, positions, cfg)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """The projections, their biases (after the product, before RoPE, as
    the reference adds them), then RoPE (``cfg.rope_mode``'s) on q and
    k."""
    q = _project_q(p, x, cfg, positions)
    k = _head_proj(x, p.wk, cfg)
    v = _head_proj(x, p.wv, cfg)
    if hasattr(p, "bk"):
        k, v = k + p.bk, v + p.bv
    k = _rope(k, positions, cfg)
    return q, k, v


def _out_proj(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,hd) -> (B,S,d); ``wo`` contracts its leading head axes,
    then ``bo`` is added where the layer has one."""
    B, S = o.shape[:2]
    if is_quantized_dense(p.wo):
        y = dense_w8a8(o.reshape(B, S, -1), p.wo)
    else:
        y = o.reshape(B, S, -1) @ p.wo.reshape(-1, p.wo.shape[-1])
    return y + p.bo if hasattr(p, "bo") else y


def _softcap(cfg: ModelConfig) -> float:
    return cfg.attn_logit_softcap or 0.0


def full_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None, *,
                   kind: str, causal: bool = True):
    """Attention over a whole (right-padded) sequence, causal or (an
    encoder's) not: x (B,S,d) at ``positions`` (B,S), or (3,B,S) for
    M-RoPE; ``kv_valid`` (B,S) marks real tokens, and no
    query attends a padded key; a local layer sees the last
    ``window_size`` keys. Returns (y (B,S,d), (k, v))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    lens = None if kv_valid is None else kv_valid.sum(-1).to(torch.int32)
    o = flash_attn(q, k, v, lens, causal=causal,
                   window=cfg.window_size if kind == ATTN_LOCAL else 0,
                   softcap=_softcap(cfg))
    return _out_proj(p, o), (k, v)


def cross_kv(p: Attention, enc_hidden: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross-attention keys and values from the encoder's
    output (B,T,d): (k, v), each (B,T,K,hd), biases added, no RoPE (the
    reference's ``build_cross_kv``)."""
    k = _head_proj(enc_hidden, p.wk, cfg)
    v = _head_proj(enc_hidden, p.wv, cfg)
    if hasattr(p, "bk"):
        k, v = k + p.bk, v + p.bv
    return k, v


def cross_attention(p: Attention, x: torch.Tensor, cross_k: torch.Tensor,
                    cross_v: torch.Tensor, cfg: ModelConfig, *, mode: str,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every query of x (B,S,d) attends the encoder's frames ``cross_k`` /
    ``cross_v`` (B,T,K,hd), non-causally; the query takes its bias and no
    RoPE. Mode 'full' and 'prefill': the flash kernel, S queries over T
    keys, frames past ``kv_valid`` (B,T) masked. Mode 'decode' (S 1): the
    decode kernel over all T frames (``pos`` T-1), as the reference's
    decode attends them: its ``decode_step`` passes no ``enc_valid``.
    Nothing is written. Returns y (B,S,d)."""
    q = _project_q(p, x, cfg, None)
    if mode == "decode":
        o = decode_attn(q[:, 0], cross_k, cross_v, cross_k.shape[1] - 1,
                        softcap=_softcap(cfg))
        return _out_proj(p, o.to(x.dtype)[:, None])
    lens = None if kv_valid is None else kv_valid.sum(-1).to(torch.int32)
    o = flash_attn(q, cross_k, cross_v, lens, causal=False,
                   softcap=_softcap(cfg))
    return _out_proj(p, o)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """q (B,S,H,hd), k (B,T,K,hd) -> scores (B,K,G,S,T) in q's dtype,
    scaled by hd^-0.5, then softcapped."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, H // K, hd), k)
    return softcap(s * hd ** -0.5, cfg.attn_logit_softcap)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,K,G,S,T) f32, v (B,T,K,hd) -> (B,S,H,hd)."""
    B, K, G, S, T = probs.shape
    o = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return o.reshape(B, S, K * G, -1)


def _masked_probs(scores: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax in f32 over the keys, the keys ``mask`` leaves out at
    ``NEG_INF``."""
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    return torch.softmax(scores.float(), dim=-1)


def dense_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None, *, kind: str,
                    causal: bool = True) -> torch.Tensor:
    """``full_attention``'s function in plain torch, which autograd
    differentiates: the reference's dense path (its ``attention_impl``
    "chunked_jnp", the one its trainer takes; the flash kernel has no
    backward). The mask is built from the query stream's positions (the
    t stream for M-RoPE): causal, a local layer's window, and the keys
    ``kv_valid`` (B,S) marks. Past 2 x ``PREFILL_Q_CHUNK`` queries (a
    multiple of it), the queries run in blocks of that many, so one
    block's scores are live at a time. Returns y (B,S,d)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    S = x.shape[1]
    qpos = positions if positions.dim() == 2 else positions[0]

    def core(q_blk, qpos_blk):
        mask = torch.ones((q_blk.shape[0], q_blk.shape[1], S),
                          dtype=torch.bool, device=x.device)
        if causal:
            mask &= qpos_blk[:, :, None] >= qpos[:, None, :]
        if kind == ATTN_LOCAL:
            mask &= qpos_blk[:, :, None] - qpos[:, None, :] < cfg.window_size
        if kv_valid is not None:
            mask &= kv_valid.bool()[:, None, :]
        return _gqa_out(_masked_probs(_gqa_scores(q_blk, k, cfg),
                                      mask[:, None, None]), v)

    if S > 2 * PREFILL_Q_CHUNK and S % PREFILL_Q_CHUNK == 0:
        o = torch.cat([core(q[:, i:i + PREFILL_Q_CHUNK],
                            qpos[:, i:i + PREFILL_Q_CHUNK])
                       for i in range(0, S, PREFILL_Q_CHUNK)], dim=1)
    else:
        o = core(q, qpos)
    return _out_proj(p, o)


def dense_cross_attention(p: Attention, x: torch.Tensor,
                          cross_k: torch.Tensor, cross_v: torch.Tensor,
                          cfg: ModelConfig,
                          kv_valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``cross_attention``'s mode 'full' in plain torch, which autograd
    differentiates (the reference's dense cross-attention): every query of
    x (B,S,d), its bias and no RoPE, over the frames ``cross_k`` /
    ``cross_v`` (B,T,K,hd), those past ``kv_valid`` (B,T) masked. Returns
    y (B,S,d)."""
    q = _project_q(p, x, cfg, None)
    mask = None if kv_valid is None \
        else kv_valid.bool()[:, None, None, None, :]
    return _out_proj(p, _gqa_out(_masked_probs(_gqa_scores(q, cross_k, cfg),
                                               mask), cross_v))


def _cache_entries(cache: Cache, k: torch.Tensor, v: torch.Tensor):
    """(cache key, value) pairs that store K/V in this cache's format."""
    if "k_scale" not in cache:
        return (("k", k), ("v", v))
    kq, ks = _kv_quant(k)
    vq, vs = _kv_quant(v)
    return (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))


def _ring_fill(val: torch.Tensor, lengths: torch.Tensor,
               win: int) -> torch.Tensor:
    """val (B,S,...) -> the ring rows (B,win,...) a prefill of
    ``lengths`` (B,) real tokens leaves: slot r holds the newest real
    position p with p % win == r, and 0 where no position was written."""
    B, S = val.shape[:2]
    p_r = _ring_newest_positions(lengths.long() - 1, win)      # (B,win)
    b = torch.arange(B, device=val.device)[:, None]
    g = val[b, p_r.clamp(0, S - 1)]
    written = (p_r >= 0).view(p_r.shape + (1,) * (val.dim() - 2))
    return torch.where(written, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))


def fill_cache_from_prefill(cache: Cache, k: torch.Tensor, v: torch.Tensor,
                            rows: torch.Tensor, kind: str,
                            lengths: Optional[torch.Tensor] = None) -> None:
    """Write prefill K/V (B,S,K,hd) in place: batch row j lands in cache row
    ``rows[j]``. A negative ``rows[j]`` marks a padded group row: it
    repeats row 0's write (the same cache row, the same values), so the
    write keeps one fixed shape, stays deterministic under repeated
    indices, and stores only the real rows. An int8 cache stores the
    quantized K/V; prefill itself attended the exact ones.

    A global row takes positions [0, S); positions past S keep what the row
    held before (decode writes a position before it attends it, so they are
    never read). A local row is written whole: its ring as a prefill of
    ``lengths`` (B,) real tokens (default S) leaves it (``_ring_fill``),
    which is the JAX package's fresh ring."""
    S = k.shape[1]
    pad = rows < 0
    src = torch.where(pad, 0, torch.arange(rows.shape[0], device=rows.device))
    dst = torch.where(pad, rows[0], rows)
    if kind == ATTN_LOCAL and lengths is None:
        lengths = torch.full((k.shape[0],), S, dtype=torch.int32,
                             device=k.device)
    for name, val in _cache_entries(cache, k, v):
        if kind == ATTN_LOCAL:
            ring = _ring_fill(val, lengths, cache[name].shape[1])
            cache[name][dst] = ring.to(cache[name].dtype)[src]
        else:
            cache[name][dst, :S] = val.to(cache[name].dtype)[src]


def decode_attention(p: Attention, x: torch.Tensor, cache: Cache,
                     pos: torch.Tensor, cfg: ModelConfig,
                     rows: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None, *,
                     kind: str) -> Tuple[torch.Tensor, Cache]:
    """x (B,1,d); ``pos`` (B,) int32 tokens already in each row's cache.
    Every row computes its K/V and writes it in place: a global row at
    ``pos`` (clamped to the cache, as the reference's
    ``dynamic_update_slice``), a local ring at ``pos % slots``. A row that
    ``active`` (B,) bool marks inactive (or that the index tensor ``rows``
    of active rows leaves out) writes back the value already there, the
    reference's ``guard``, so its cache stays bit for bit as it was and the
    step's shapes do not depend on which rows decode. A global row then
    attends keys [0, pos]; a ring its slots [0, min(pos, slots-1)], which
    is every slot once it is full, the reference's ring rule. An int8
    cache is quantized on the write and read through the int8 decode
    kernel. Returns (y (B,1,d), cache)."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg,
                                   _one_stream(pos[:, None], cfg))
    if rows is not None:
        active = torch.zeros(B, dtype=torch.bool, device=x.device)
        active[rows.to(x.device)] = True
    b = torch.arange(B, device=x.device)
    slots = cache["k"].shape[1]
    if kind == ATTN_LOCAL:
        at = torch.remainder(pos.long(), slots)
        pos = pos.clamp(max=slots - 1)
    else:
        at = pos.long().clamp(0, slots - 1)
    for name, val in _cache_entries(cache, k_new[:, 0], v_new[:, 0]):
        val = val.to(cache[name].dtype)
        if active is not None:
            keep = active.view((B,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, cache[name][b, at])
        cache[name][b, at] = val
    if "k_scale" in cache:
        o = decode_attn_int8(q[:, 0], cache["k"], cache["k_scale"],
                             cache["v"], cache["v_scale"], pos,
                             softcap=_softcap(cfg))
    else:
        o = decode_attn(q[:, 0], cache["k"], cache["v"], pos,
                        softcap=_softcap(cfg))
    return _out_proj(p, o.to(x.dtype)[:, None]), cache


# an int8 cache's chunk path dequantizes each group row's keys up to the
# largest ``start + lengths`` rounded up to this many keys: the flash
# kernel's K/V tile on the tensor cores (128 keys; the CUDA-core kernel's
# 32-key tile divides it)
DEQUANT_TILE = 128


@dataclass
class ChunkCoords:
    """Where one prefill chunk call of P rows of C tokens reads and writes,
    on the device, in shapes fixed by (P, C) and the ring's W slots;
    shared by every layer. The ``ring_*`` fields are those of the local
    layers (None without one)."""
    positions: torch.Tensor          # (P,C) int64: start[j] + i
    lens: torch.Tensor               # (P,) int32: start + lengths
    q_off: torch.Tensor              # (P,) int32: start
    kv_rows: torch.Tensor            # (P,) int32 cache rows (slots)
    write_rows: torch.Tensor         # (P*C,) int64 cache row of each write
    write_pos: torch.Tensor          # (P*C,) int64 its position in the row
    src: torch.Tensor                # (P*C,) int64 its token of the P*C
    dequant_len: Optional[int]       # keys an int8 cache dequantizes a row
    ring_rows: Optional[torch.Tensor] = None   # (P*C,) int64, as write_rows
    ring_pos: Optional[torch.Tensor] = None    # (P*C,) int64 its ring slot
    ring_src: Optional[torch.Tensor] = None    # (P*C,) int64, as src
    ring_idx: Optional[torch.Tensor] = None    # (P,W) int64 slot of key u
    ring_n: Optional[torch.Tensor] = None      # (P,) int32 ring keys seen
    ring_lens: Optional[torch.Tensor] = None   # (P,) int32 ring_n + lengths


def _fixed_write(rows, pos, real) -> Dict[str, np.ndarray]:
    """The P*C-entry form of a write of the ``real`` entries alone: every
    other entry repeats the first real one (its index and its source)."""
    src = np.arange(rows.size)
    first = int(np.flatnonzero(real)[0])
    return {"rows": np.where(real, rows, rows[first]),
            "pos": np.where(real, pos, pos[first]),
            "src": np.where(real, src, first)}


def ring_writes(slots, start, write_pos, lengths, C: int,
                win: int) -> Dict[str, np.ndarray]:
    """The local layers' part of a chunk call's coordinates, host arrays
    (P,) -> fixed shapes by (P, C, win), for rings of ``win`` slots.

    Reads: row j's chunk attends the ring as it was before the chunk, in
    position order: key u < n = min(start, win) is position start - n + u,
    at ring slot ``ring_idx[j, u]``, and the chunk's own keys follow at u =
    n .. n+C-1 (``ring_n`` = n, ``ring_lens`` = n + lengths).

    Writes: token i goes to slot (write_pos + i) % win, only if it is real
    (i < lengths) and no later real token of its row takes the same slot
    (i >= lengths - win): a chunk longer than the ring keeps each slot's
    last write, as the JAX package's ``ring_write`` does. Every other entry
    repeats the call's first kept write, so the in-place index write stays
    deterministic."""
    slots, start, write_pos, lengths = (np.asarray(a, np.int64) for a in
                                        (slots, start, write_pos, lengths))
    i = np.arange(C)[None, :]
    keep = ((i < lengths[:, None])
            & (i >= lengths[:, None] - win)).reshape(-1)
    w = _fixed_write(np.repeat(slots, C),
                     np.mod(write_pos[:, None] + i, win).reshape(-1), keep)
    n = np.minimum(start, win)
    u = np.arange(win)[None, :]
    idx = np.where(u < n[:, None], np.mod(start[:, None] - n[:, None] + u,
                                          win), u)
    return {"ring_rows": w["rows"], "ring_pos": w["pos"],
            "ring_src": w["src"], "ring_idx": idx,
            "ring_n": n.astype(np.int32),
            "ring_lens": (n + lengths).astype(np.int32)}


def chunk_writes(slots, start, write_pos, lengths, C: int,
                 max_len: Optional[int], n_slots: int,
                 ring: Optional[int] = None
                 ) -> Tuple[Dict[str, np.ndarray], int]:
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
    ``max_len``: the positions of the model's global rows (None: it has
    none, and nothing bounds a write); ``ring``: the slots of its local
    rings, whose coordinates (``ring_writes``) join the arrays (None: it
    has none). Raises for a slot outside the cache's ``n_slots`` rows, or
    a call with no token to write."""
    slots, start, write_pos, lengths = (np.asarray(a, np.int64) for a in
                                        (slots, start, write_pos, lengths))
    if not all(0 <= s < n_slots for s in slots.tolist()):
        raise ValueError(f"chunk slots {slots.tolist()} outside the cache's "
                         f"{n_slots} rows")
    i = np.arange(C)[None, :]
    real = i < lengths[:, None]
    if max_len is not None:
        real &= write_pos[:, None] + i < max_len
    real = real.reshape(-1)
    if not real.any():
        raise ValueError("a chunk call must write at least one token below "
                         f"max_len {max_len}")
    w = _fixed_write(np.repeat(slots, C),
                     (write_pos[:, None] + i).reshape(-1), real)
    ends = start + lengths
    dequant = -(-int(ends.max(initial=1)) // DEQUANT_TILE) * DEQUANT_TILE
    out = {"slots": slots.astype(np.int32),
           "start": start.astype(np.int32),
           "lens": ends.astype(np.int32),
           "write_rows": w["rows"], "write_pos": w["pos"], "src": w["src"]}
    if ring is not None:
        out.update(ring_writes(slots, start, write_pos, lengths, C, ring))
    return out, min(max(dequant, 1), max_len or dequant)


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
        dequant_len=dequant_len,
        **{k: t.get(k) for k in ("ring_rows", "ring_pos", "ring_src",
                                 "ring_idx", "ring_n", "ring_lens")})


def _write_tokens(cache: Cache, k_tok: torch.Tensor, v_tok: torch.Tensor,
                  rows: torch.Tensor, pos: torch.Tensor) -> None:
    """The chunk's fixed P*C-entry write, in place, in the cache's
    format."""
    for name, val in _cache_entries(cache, k_tok, v_tok):
        cache[name][rows, pos] = val.to(cache[name].dtype)


# the profiler span around a local chunk's ring gather: its device time is
# what a ring read in place would save (``chip_smoke.py`` reads it)
RING_GATHER_SPAN = "ring_gather"


def _ring_in_order(k_new: torch.Tensor, v_new: torch.Tensor, cache: Cache,
                   cc: ChunkCoords, dtype: torch.dtype):
    """Each group row's ring as it was before the chunk, in position order,
    then the chunk's own keys at u = n .. n+C-1: (K, V), each (P, win+C,
    K, hd). An int8 ring reads as the JAX package's: dequantized, the
    chunk's keys through int8 too."""
    P, C = k_new.shape[:2]
    rows = cc.kv_rows.long()[:, None]
    dst = (cc.ring_n.long()[:, None]
           + torch.arange(C, device=k_new.device)[None, :])      # (P,C)
    pr = torch.arange(P, device=k_new.device)[:, None]
    if "k_scale" in cache:
        kq, ks = _kv_quant(k_new)
        vq, vs = _kv_quant(v_new)
        ring_k = _kv_dequant(cache["k"][rows, cc.ring_idx],
                             cache["k_scale"][rows, cc.ring_idx], dtype)
        ring_v = _kv_dequant(cache["v"][rows, cc.ring_idx],
                             cache["v_scale"][rows, cc.ring_idx], dtype)
        ck_new, cv_new = _kv_dequant(kq, ks, dtype), _kv_dequant(vq, vs,
                                                                 dtype)
    else:
        ring_k = cache["k"][rows, cc.ring_idx]
        ring_v = cache["v"][rows, cc.ring_idx]
        ck_new, cv_new = k_new, v_new
    ck = torch.cat([ring_k, ck_new], dim=1)                     # (P,win+C)
    cv = torch.cat([ring_v, cv_new], dim=1)
    ck[pr, dst] = ck_new
    cv[pr, dst] = cv_new
    return ck, cv


def _chunk_prefill_local(p: Attention, q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, cache: Cache, cc: ChunkCoords,
                         cfg: ModelConfig, dtype: torch.dtype
                         ) -> torch.Tensor:
    """The local half of ``chunk_prefill_attention`` (see there), on the
    chunk's projected q/k/v (P,C,...)."""
    P, C = q.shape[:2]
    win = cache["k"].shape[1]
    with torch.profiler.record_function(RING_GATHER_SPAN):
        ck, cv = _ring_in_order(k_new, v_new, cache, cc, dtype)
    flat = (P * C,) + k_new.shape[2:]
    _write_tokens(cache, k_new.reshape(flat)[cc.ring_src],
                  v_new.reshape(flat)[cc.ring_src], cc.ring_rows,
                  cc.ring_pos)
    o = flash_attn(q, ck, cv, cc.ring_lens, causal=True, window=win,
                   softcap=_softcap(cfg), q_off=cc.ring_n)
    return _out_proj(p, o)


def chunk_prefill_attention(p: Attention, x: torch.Tensor, cache: Cache,
                            cc: ChunkCoords, cfg: ModelConfig,
                            kind: str) -> torch.Tensor:
    """One prompt chunk per group row against the live cache: x (P,C,d) at
    positions ``cc.positions``. Returns y (P,C,d).

    Global: the chunk's real K/V is written into the cache rows in place,
    then every query attends its own cache row through the flash kernel:
    key t is visible to chunk query i of row j iff t <= start[j] + i (and
    t < start[j] + lengths[j]). An fp cache is read in place
    (``kv_rows``); an int8 cache is quantized on the write and its group
    rows dequantized up to ``cc.dequant_len`` keys.

    Local: a ring is not in position order and the chunk's write may evict
    keys its own early queries still need, so each row's ring is first
    gathered, before the write, into a (P, W+C) buffer in position order
    with the chunk's keys after it (``ring_writes``); flash attends that
    buffer causally with the window at query offset ``ring_n``, which is
    the key set the JAX package exposes (the pre-chunk ring masked to the
    window, then the chunk's keys under causal + window). Then the chunk
    is written at ring offsets, each slot keeping its last real write.

    Every shape is fixed by (P, C), the ring's W and ``cc.dequant_len``."""
    P, C = x.shape[:2]
    q, k_new, v_new = _project_qkv(p, x, cfg,
                                   _one_stream(cc.positions, cfg))
    if kind == ATTN_LOCAL:
        return _chunk_prefill_local(p, q, k_new, v_new, cache, cc, cfg,
                                    x.dtype)
    flat = (P * C,) + k_new.shape[2:]
    _write_tokens(cache, k_new.reshape(flat)[cc.src],
                  v_new.reshape(flat)[cc.src], cc.write_rows, cc.write_pos)
    if "k_scale" in cache:
        n, rows = cc.dequant_len, cc.kv_rows.long()
        ck = _kv_dequant(cache["k"][rows, :n], cache["k_scale"][rows, :n],
                         x.dtype)
        cv = _kv_dequant(cache["v"][rows, :n], cache["v_scale"][rows, :n],
                         x.dtype)
        o = flash_attn(q, ck, cv, cc.lens, q_off=cc.q_off,
                       softcap=_softcap(cfg))
    else:
        o = flash_attn(q, cache["k"], cache["v"], cc.lens, q_off=cc.q_off,
                       kv_rows=cc.kv_rows, softcap=_softcap(cfg))
    return _out_proj(p, o)

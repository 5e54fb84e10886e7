"""Plain PyTorch versions of the SLS (sparse-lengths-sum, embedding-bag)
kernels of ``csrc/sls.cu``: the same functions as the JAX package's
``kernels/sls/ref.py``. The wrappers run them for CPU tensors;
``chip_smoke.py`` holds each kernel against them on the card.

A bag reads only its first ``min(lengths[b], L)`` indices, as the kernels
do: an index past a bag's length is replaced by row 0 before the gather and
its value by 0 after it, so it may hold anything. A bag of length 0 pools
to exactly 0. A lookup whose index lies outside [0, R) makes its bag NaN
(the JAX oracle's ``jnp.take`` fills rows past the table with NaN; neither
side here wraps a negative index).

With ``groups=g`` a bag is summed in the kernels' order: g partial sums,
partial j over the lookups l = j, j + g, j + 2g, ... below the bag's
length, then added in the order of j, (((p_0 + p_1) + p_2) + ...).
``groups=1`` (the default) is the plain sum over l; ``ops.lane_plan``
gives the kernels' g for a table.
"""
from __future__ import annotations

import torch


def _bag_mask(indices: torch.Tensor, lengths: torch.Tensor, R: int):
    """(mask (NB,L) of the lookups each bag reads, the read lookups whose
    index lies outside [0, R), indices with every unread or outside entry
    replaced by row 0, as int64)."""
    L = indices.shape[1]
    mask = torch.arange(L, device=indices.device)[None, :] \
        < lengths.to(torch.int64)[:, None]
    idx = indices.to(torch.int64)
    outside = mask & ((idx < 0) | (idx >= R))
    return mask, outside, torch.where(mask & ~outside, idx, 0)


def _pool(vals: torch.Tensor, mask: torch.Tensor, outside: torch.Tensor,
          groups: int = 1) -> torch.Tensor:
    """vals (NB,L,D) f32 -> masked bag sums (NB,D) in ``groups`` partial
    sums (lookups l = j mod groups) added in order, NaN where a lookup fell
    outside the table."""
    vals = torch.where(outside[..., None], float("nan"), vals)
    vals = torch.where(mask[..., None], vals, 0.0)
    if groups == 1:
        return vals.sum(dim=1)
    NB, L, D = vals.shape
    pad = vals.new_zeros(NB, -L % groups, D)
    part = torch.cat([vals, pad], dim=1).reshape(NB, -1, groups, D).sum(dim=1)
    out = part[:, 0]
    for j in range(1, groups):
        out = out + part[:, j]
    return out


def _scale_bias(scale, bias, idx):
    return (scale.to(torch.float32)[idx][..., None],
            bias.to(torch.float32)[idx][..., None])


def sls_ref(table: torch.Tensor, indices: torch.Tensor,
            lengths: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """table (R,D) float; indices (NB,L) int32; lengths (NB,) int32 ->
    pooled (NB,D) f32 bag sums."""
    mask, outside, idx = _bag_mask(indices, lengths, table.shape[0])
    return _pool(table[idx].to(torch.float32), mask, outside, groups)


def sls_int8_ref(q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 indices: torch.Tensor, lengths: torch.Tensor,
                 groups: int = 1) -> torch.Tensor:
    """Row-wise int8 table: q (R,D) uint8, scale/bias (R,) fp16; each
    lookup adds q * scale + bias in f32."""
    mask, outside, idx = _bag_mask(indices, lengths, q.shape[0])
    s, b = _scale_bias(scale, bias, idx)
    return _pool(q[idx].to(torch.float32) * s + b, mask, outside, groups)


def sls_int4_ref(q4: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 indices: torch.Tensor, lengths: torch.Tensor,
                 groups: int = 1) -> torch.Tensor:
    """Packed int4 table: q4 (R,D//2) uint8, low nibble = even column."""
    mask, outside, idx = _bag_mask(indices, lengths, q4.shape[0])
    packed = q4[idx]                                          # (NB,L,D/2)
    vals = torch.stack([packed & 0xF, packed >> 4], dim=-1) \
        .reshape(packed.shape[:-1] + (-1,)).to(torch.float32)
    s, b = _scale_bias(scale, bias, idx)
    return _pool(vals * s + b, mask, outside, groups)

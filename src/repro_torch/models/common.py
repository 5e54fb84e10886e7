"""Shared model utilities: parameter init, RMSNorm and LayerNorm,
activations, the logit softcap, the recurrent blocks' causal conv with a
carried tail, RoPE and M-RoPE, and vocab padding (counterpart of
``repro/models/common.py``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

VOCAB_PAD_MULT = 256   # vocab rows pad to a multiple of this


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def dtype_of(name: str) -> torch.dtype:
    """Config dtype name ('float32', 'bfloat16') -> torch dtype."""
    return getattr(torch, name)


def mk_param(shape: Sequence[int], dtype: torch.dtype, device,
             gen: torch.Generator = None, init: str = "normal",
             scale: float = 1.0) -> nn.Parameter:
    """Inference parameter with the JAX package's init distribution:
    normal with std ``scale/sqrt(shape[0])`` (drawn in f32, then cast),
    zeros (norm scales, biases) or ones."""
    if init == "zeros":
        data = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        data = torch.ones(shape, dtype=dtype, device=device)
    elif init == "normal":
        std = scale / math.sqrt(max(shape[0], 1))
        # scaled in place: one f32 transient a leaf (kimi-k2's 512 experts
        # make 30 GB leaves), the values those of ``randn(...) * std``
        data = torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(std).to(dtype)
    else:
        raise ValueError(init)
    return nn.Parameter(data, requires_grad=False)


class RMSNorm(nn.Module):
    """Holds the norm's ``scale`` (zeros at init: the norm multiplies by
    ``1 + scale``)."""

    def __init__(self, d: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = mk_param((d,), dtype, device, init="zeros")

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rms_norm(x, self.scale, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, back in x.dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


class LayerNorm(nn.Module):
    """Holds the norm's ``scale`` and ``bias`` (the JAX leaf names; zeros at
    init: the norm multiplies by ``1 + scale``)."""

    def __init__(self, d: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = mk_param((d,), dtype, device, init="zeros")
        self.bias = mk_param((d,), dtype, device, init="zeros")

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * (1 + scale) + bias`` in f32, back
    in x.dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float()) + bias.float()).to(dt)


def make_norm(cfg, dtype: torch.dtype, device) -> nn.Module:
    """The norm ``cfg.norm_type`` names, of width ``cfg.d_model``."""
    norms = {"rmsnorm": RMSNorm, "layernorm": LayerNorm}
    if cfg.norm_type not in norms:
        raise ValueError(f"norm_type must be one of {sorted(norms)}, got "
                         f"{cfg.norm_type!r}")
    return norms[cfg.norm_type](cfg.d_model, dtype, device)


def activation_fn(name: str):
    # the JAX package's "gelu" is jax.nn.gelu, whose default is the tanh form
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``cap * tanh(x / cap)`` in f32, back in x.dtype; identity for None."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def causal_conv_with_carry(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           carry: torch.Tensor):
    """Depthwise causal conv of ``x`` (B,C,ch) with kernel ``w`` (K,ch)
    whose left context is ``carry`` (B,K-1,ch): the last K-1 pre-conv
    inputs before ``x`` (zeros at sequence start). Returns (out (B,C,ch),
    the concatenated (B,K-1+C,ch) input). The taps are summed in order
    i = 0..K-1 and ``b`` added last, each step rounded in x.dtype, as the
    reference sums them."""
    K, C = w.shape[0], x.shape[1]
    full = torch.cat([carry.to(x.dtype), x], dim=1)
    out = full[:, 0:C] * w[0]
    for i in range(1, K):
        out = out + full[:, i:i + C] * w[i]
    return out + b, full


def tail_at_lengths(seq: torch.Tensor, lengths: torch.Tensor, k: int,
                    prepend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The last ``k`` entries of ``seq`` (B,S,...) ending at each row's
    position ``lengths`` (B,): the causal-conv carry of a row whose real
    tokens stop mid-sequence. Entries before position 0 come from
    ``prepend`` (B,k,...), the carry entering ``seq``, or are zero (None:
    sequence start)."""
    if prepend is None:
        prepend = seq.new_zeros((seq.shape[0], k) + seq.shape[2:])
    full = torch.cat([prepend.to(seq.dtype), seq], dim=1)
    idx = lengths.long()[:, None] + torch.arange(k, device=seq.device)
    idx = idx.view(idx.shape + (1,) * (seq.dim() - 2)).expand(
        idx.shape + seq.shape[2:])
    return torch.gather(full, 1, idx)


def write_rows(cache, new, src: torch.Tensor, dst: torch.Tensor) -> None:
    """A recurrent layer's exit state into its cache, in place:
    ``cache[name][dst[j]] = new[name][src[j]]``, one fixed-shape index
    write per leaf (repeated entries write equal values)."""
    for name, val in new.items():
        cache[name][dst] = val[src].to(cache[name].dtype)


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim//2), f32."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions[..., None].float() * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B,S,H,D); positions (B,S) -> rotated x (split-half convention)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)   # (B,S,D/2)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): x (B,S,H,D); positions3 (3,B,S) the (t, h, w)
    position ids. The D/2 frequencies are split into ``sections`` groups
    in order, group i rotated by stream i's positions; the split-half
    convention and the f32 math of ``apply_rope``. With t = h = w it is
    ``apply_rope`` bit for bit. [arXiv:2409.12191]"""
    head_dim = x.shape[-1]
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    cos_l, sin_l = [], []
    start = 0
    for sec, pos in zip(sections, positions3):
        cos, sin = _rope_angles(pos, head_dim, theta)          # (B,S,D/2)
        cos_l.append(cos[..., start:start + sec])
        sin_l.append(sin[..., start:start + sec])
        start += sec
    cos = torch.cat(cos_l, dim=-1)[:, :, None, :]
    sin = torch.cat(sin_l, dim=-1)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

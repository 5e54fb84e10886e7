"""Shared model utilities: parameter init, RMSNorm, activations, RoPE and
vocab padding (counterpart of ``repro/models/common.py``)."""
from __future__ import annotations

import math
from typing import Sequence

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
             gen: torch.Generator = None, init: str = "normal") -> nn.Parameter:
    """Inference parameter with the JAX package's init distribution:
    normal with std ``1/sqrt(shape[0])`` (drawn in f32, then cast), or
    zeros (norm scales)."""
    if init == "zeros":
        data = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "normal":
        std = 1.0 / math.sqrt(max(shape[0], 1))
        data = (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * std).to(dtype)
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


def activation_fn(name: str):
    # the JAX package's "gelu" is jax.nn.gelu, whose default is the tanh form
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


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

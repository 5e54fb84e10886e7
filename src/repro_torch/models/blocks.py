"""Residual block of the global kind: pre-norm attention then a pre-norm
MLP (counterpart of the ``global`` path of ``repro/models/blocks.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import RMSNorm, dtype_of
from repro_torch.models.mlp import MLP, apply_mlp


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.pre_norm = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg, gen, device)
        self.pre_mlp_norm = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg, gen, device)


def apply_block(p: Block, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: attn.Cache, positions: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                kv_valid: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mode 'full': causal attention over x, no cache; mode 'prefill': the
    same, K/V written into cache rows ``rows``; mode 'decode': one token
    per row at ``pos``, K/V written for the active ``rows``. The cache is
    updated in place."""
    h = p.pre_norm(x, cfg.norm_eps)
    if mode == "decode":
        y, _ = attn.decode_attention(p.attn, h, cache, pos, cfg, rows)
    elif mode in ("full", "prefill"):
        y, (k, v) = attn.full_attention(p.attn, h, cfg, positions, kv_valid)
        if mode == "prefill":
            attn.fill_cache_from_prefill(cache, k, v, rows)
    else:
        raise ValueError(f"mode must be 'full', 'prefill' or 'decode', got "
                         f"{mode!r}")
    x = x + y
    return x + apply_mlp(p.mlp, p.pre_mlp_norm(x, cfg.norm_eps), cfg)

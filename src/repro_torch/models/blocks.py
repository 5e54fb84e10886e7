"""Residual attention block of the global or local kind: pre-norm attention
then a pre-norm MLP, each output normed again before its residual add when
``cfg.post_attn_norm`` is set (gemma2's sandwich norms) — the attention
path of ``repro/models/blocks.py``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import RMSNorm, dtype_of
from repro_torch.models.mlp import MLP, apply_mlp


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 kind: str):
        super().__init__()
        self.kind = kind
        dt = dtype_of(cfg.param_dtype)
        self.pre_norm = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.Attention(cfg, gen, device)
        if cfg.post_attn_norm:
            self.post_norm = RMSNorm(cfg.d_model, dt, device)
        self.pre_mlp_norm = RMSNorm(cfg.d_model, dt, device)
        self.mlp = MLP(cfg, gen, device)
        if cfg.post_attn_norm:
            self.post_mlp_norm = RMSNorm(cfg.d_model, dt, device)


def apply_block(p: Block, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: attn.Cache, positions: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                kv_valid: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None,
                chunk: Optional[attn.ChunkCoords] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mode 'full': causal attention over x, no cache; mode 'prefill': the
    same, K/V written into cache rows ``rows``; mode 'chunk': one prompt
    chunk per row against the live cache at the coordinates ``chunk``;
    mode 'decode': one token per row at ``pos``, the rows ``active`` leaves
    out keeping their cache. The cache is updated in place."""
    kind = p.kind
    h = p.pre_norm(x, cfg.norm_eps)
    if mode == "decode":
        y, _ = attn.decode_attention(p.attn, h, cache, pos, cfg,
                                     active=active, kind=kind)
    elif mode == "chunk":
        y = attn.chunk_prefill_attention(p.attn, h, cache, chunk, cfg, kind)
    elif mode in ("full", "prefill"):
        y, (k, v) = attn.full_attention(p.attn, h, cfg, positions, kv_valid,
                                        kind=kind)
        if mode == "prefill":
            attn.fill_cache_from_prefill(
                cache, k, v, rows, kind,
                None if kv_valid is None else kv_valid.sum(-1))
    else:
        raise ValueError(f"mode must be 'full', 'prefill', 'chunk' or "
                         f"'decode', got {mode!r}")
    if cfg.post_attn_norm:
        y = p.post_norm(y, cfg.norm_eps)
    x = x + y
    y = apply_mlp(p.mlp, p.pre_mlp_norm(x, cfg.norm_eps), cfg)
    if cfg.post_attn_norm:
        y = p.post_mlp_norm(y, cfg.norm_eps)
    return x + y

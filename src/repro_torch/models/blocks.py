"""Residual blocks of the global, local, recurrent, ssm and decoder kinds:
a pre-norm mixer (attention, or the RG-LRU for ``recurrent``) then a
pre-norm MLP, each output normed again before its residual add when
``cfg.post_attn_norm`` is set (gemma2's sandwich norms); a ``decoder``
block (whisper's) puts a pre-norm cross-attention to the encoder's output
between its causal self-attention and its MLP; an ``ssm`` block (Mamba2's)
is the pre-norm mixer and its residual add alone, with no MLP half. When
``cfg.moe`` is set, the MLP half of a block holds ``moe``, a mixture of
experts (``models/moe.py``), in place of ``mlp``; its load-balance loss is
carried through the stack where the caller asks for it (training), as the
reference's blocks carry it. Every norm is the one ``cfg.norm_type``
names (RMSNorm, or LayerNorm) — the attention, recurrent, ssm, decoder and
MoE paths of ``repro/models/blocks.py``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, \
    SSM, ModelConfig

# an enc-dec model's decoder layer: global self-attention, cross-attention
# to the encoder's output, MLP (the reference's kind of the same name)
DECODER = "decoder"
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import dtype_of, make_norm
from repro_torch.models.mlp import MLP, apply_mlp


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 kind: str):
        super().__init__()
        self.kind = kind
        dt = dtype_of(cfg.param_dtype)
        self.pre_norm = make_norm(cfg, dt, device)
        if kind == SSM:
            self.ssm = ssm_mod.SSM(cfg, gen, device)
            return                          # a Mamba2 block: mixer only
        if kind == RECURRENT:
            self.rec = rglru_mod.RGLRU(cfg, gen, device)
        elif kind in (ATTN_GLOBAL, ATTN_LOCAL, DECODER):
            self.attn = attn.Attention(cfg, gen, device)
        else:
            raise ValueError(f"block kind must be {ATTN_GLOBAL!r}, "
                             f"{ATTN_LOCAL!r}, {RECURRENT!r}, {SSM!r} or "
                             f"{DECODER!r}, got {kind!r}")
        if kind == DECODER:
            self.xattn_norm = make_norm(cfg, dt, device)
            self.xattn = attn.Attention(cfg, gen, device)
        if cfg.post_attn_norm:
            self.post_norm = make_norm(cfg, dt, device)
        self.pre_mlp_norm = make_norm(cfg, dt, device)
        if cfg.moe is not None:
            self.moe = moe_mod.MoE(cfg, gen, device)
        else:
            self.mlp = MLP(cfg, gen, device)
        if cfg.post_attn_norm:
            self.post_mlp_norm = make_norm(cfg, dt, device)


def _recurrent(p: Block, h: torch.Tensor, mode: str, cache, kv_valid, rows,
               chunk, active) -> torch.Tensor:
    if mode == "decode":
        return rglru_mod.rglru_decode_step(p.rec, h, cache, active=active)
    if mode == "chunk":
        return rglru_mod.rglru_chunk_step(p.rec, h, cache, chunk.kv_rows,
                                          chunk.q_off,
                                          chunk.lens - chunk.q_off)
    return rglru_mod.rglru_forward(
        p.rec, h, valid=kv_valid, cache=cache if mode == "prefill" else None,
        rows=rows)


def _ssm(p: Block, h: torch.Tensor, mode: str, cache, kv_valid, rows, chunk,
         active) -> torch.Tensor:
    if mode == "decode":
        return ssm_mod.ssm_decode_step(p.ssm, h, cache, active=active)
    if mode == "chunk":
        return ssm_mod.ssm_chunk_step(p.ssm, h, cache, chunk.kv_rows,
                                      chunk.q_off, chunk.lens - chunk.q_off)
    return ssm_mod.ssm_forward(p.ssm, h, valid=kv_valid,
                               cache=cache if mode == "prefill" else None,
                               rows=rows)


def apply_block(p: Block, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache, positions: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                kv_valid: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None,
                chunk: Optional[attn.ChunkCoords] = None,
                active: Optional[torch.Tensor] = None,
                causal: bool = True,
                cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cross_valid: Optional[torch.Tensor] = None,
                aux: Optional[torch.Tensor] = None):
    """mode 'full': attention (causal, or not for an encoder's
    ``causal=False``; or the recurrence) over x, no cache;
    mode 'train': the same through the attention that autograd
    differentiates (``attention.dense_attention``, the reference's dense
    path; the kernels have no backward);
    mode 'prefill': the same as 'full', the layer's state written into
    cache rows ``rows``; mode 'chunk': one prompt chunk per row against the
    live cache at the coordinates ``chunk``; mode 'decode': one token per
    row at ``pos``, the rows ``active`` leaves out keeping their cache. The
    cache is updated in place. A ``decoder`` layer's self-attention is a
    global layer's; its cross-attention reads the encoder's keys and
    values ``cross`` (k, v), masked to ``cross_valid`` in modes 'full',
    'train' and 'prefill' (``attention.cross_attention``, or
    ``dense_cross_attention`` in 'train'); it has no chunk mode.

    Returns x; given ``aux`` (an f32 scalar), returns (x, aux plus this
    block's MoE load-balance loss), the reference's carry."""
    if mode not in ("full", "train", "prefill", "chunk", "decode"):
        raise ValueError(f"mode must be 'full', 'train', 'prefill', 'chunk' "
                         f"or 'decode', got {mode!r}")
    kind = p.kind
    if kind == DECODER and mode == "chunk":
        raise ValueError("chunked prefill cannot cross block kind "
                         "'decoder': cross-attention decoder state has no "
                         "per-slot chunk contract")
    akind = ATTN_GLOBAL if kind == DECODER else kind
    h = p.pre_norm(x, cfg.norm_eps)
    if kind == SSM:                         # no post-norm, no MLP half
        x = x + _ssm(p, h, mode, cache, kv_valid, rows, chunk, active)
        return x if aux is None else (x, aux)
    if kind == RECURRENT:
        y = _recurrent(p, h, mode, cache, kv_valid, rows, chunk, active)
    elif mode == "train":
        y = attn.dense_attention(p.attn, h, cfg, positions, kv_valid,
                                 kind=akind, causal=causal)
    elif mode == "decode":
        y, _ = attn.decode_attention(p.attn, h, cache, pos, cfg,
                                     active=active, kind=akind)
    elif mode == "chunk":
        y = attn.chunk_prefill_attention(p.attn, h, cache, chunk, cfg, kind)
    else:
        y, (k, v) = attn.full_attention(p.attn, h, cfg, positions, kv_valid,
                                        kind=akind, causal=causal)
        if mode == "prefill":
            attn.fill_cache_from_prefill(
                cache, k, v, rows, akind,
                None if kv_valid is None else kv_valid.sum(-1))
    if cfg.post_attn_norm:
        y = p.post_norm(y, cfg.norm_eps)
    x = x + y
    if kind == DECODER:
        h = p.xattn_norm(x, cfg.norm_eps)
        x = x + (attn.dense_cross_attention(p.xattn, h, cross[0], cross[1],
                                            cfg, kv_valid=cross_valid)
                 if mode == "train" else
                 attn.cross_attention(p.xattn, h, cross[0], cross[1], cfg,
                                      mode=mode, kv_valid=cross_valid))
    h = p.pre_mlp_norm(x, cfg.norm_eps)
    if cfg.moe is not None:
        y, a = moe_mod.moe_apply(p.moe, h, cfg)
        aux = None if aux is None else aux + a
    else:
        y = apply_mlp(p.mlp, h, cfg)
    if cfg.post_attn_norm:
        y = p.post_mlp_norm(y, cfg.norm_eps)
    return x + y if aux is None else (x + y, aux)

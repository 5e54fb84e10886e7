"""Model assembly for the port: an all-global dense LM (embedding, a stack
of global blocks, final RMSNorm, greedy head) — the path deepseek-7b serving
runs in ``repro/models/model.py``. The JAX package scans stacked layer
parameters with ``jax.lax.scan``; here the layers are an ``nn.ModuleList``
walked by a Python loop, and the caches a list with one dict per layer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.common import RMSNorm, dtype_of, mk_param
from repro_torch.sharding import vocab as vocab_mod


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config that uses a feature the port does not have yet."""
    unsupported = {
        "block kinds other than global":
            set(cfg.block_pattern) != {ATTN_GLOBAL},
        "mixture of experts": cfg.moe is not None,
        "SSM blocks": cfg.ssm is not None,
        "recurrent blocks": cfg.recurrent is not None,
        "encoder-decoder": cfg.encdec is not None,
        "M-RoPE": cfg.rope_mode != "standard",
        "padded heads": cfg.padded_heads != cfg.num_heads,
        "q/k/v/o biases": cfg.qkv_bias or cfg.o_bias,
        "non-gated or biased MLP": not cfg.glu or cfg.mlp_bias,
        "layernorm": cfg.norm_type != "rmsnorm",
        "post-attention norms": cfg.post_attn_norm,
        "logit softcaps": cfg.attn_logit_softcap is not None
        or cfg.final_logit_softcap is not None,
        "embedding multiplier": cfg.embedding_multiplier is not None,
        "int8 KV cache on local rings": cfg.quant.kv_cache_dtype == "int8"
        and set(cfg.block_pattern) != {ATTN_GLOBAL},
        "embedding inputs": cfg.input_kind != "tokens",
    }
    missing = [name for name, used in unsupported.items() if used]
    if missing:
        raise NotImplementedError(f"{cfg.name}: the port does not support "
                                  f"{', '.join(missing)} yet")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        check_supported(cfg)
        dt = dtype_of(cfg.param_dtype)
        Vp = vocab_mod.padded_vocab(cfg)
        self.embed = mk_param((Vp, cfg.d_model), dt, device, gen)
        self.layers = nn.ModuleList(blk.Block(cfg, gen, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.lm_head = mk_param((Vp, cfg.d_model), dt, device, gen)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Model:
    """Random weights from a seeded ``torch.Generator`` on ``device``, with
    the JAX package's distributions (not its bits: ``jax.random`` and
    ``torch.Generator`` differ, so tests carry JAX weights across with
    ``repro_torch.convert``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, gen, device)


def model_device(params: Model) -> torch.device:
    return params.embed.device


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> List[attn_mod.Cache]:
    """One preallocated K/V cache dict per layer (int8 values and fp16
    scales when ``cfg.quant.kv_cache_dtype == "int8"``)."""
    return [attn_mod.init_kv_cache(cfg, batch, max_len, device)
            for _ in range(cfg.num_layers)]


def forward(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, mode: str, caches: Optional[List[attn_mod.Cache]],
            pos: Optional[torch.Tensor] = None,
            kv_valid: Optional[torch.Tensor] = None,
            cache_rows: Optional[torch.Tensor] = None,
            active=None) -> Tuple[torch.Tensor, List[attn_mod.Cache]]:
    """Returns (hidden (B,S,d), caches); the caches are updated in place.

    mode 'full': batch {'tokens' (B,S)}, causal over every position, no
    caches (pass None; the build step's calibration forward).
    mode 'prefill': batch {'tokens' (B,S)} right-padded, ``kv_valid`` (B,S)
    marks real tokens; batch row j's K/V goes to cache row
    ``cache_rows[j]`` (default row j), for the first ``len(cache_rows)``
    rows only — padded group rows write nothing.
    mode 'decode': batch {'tokens' (B,1)} at per-row positions ``pos``
    (B,); ``active`` (B,) bool (host array or tensor) marks the rows really
    decoding — the others write no K/V.
    """
    device = model_device(params)
    tokens = batch["tokens"].to(device)
    x = vocab_mod.embed_lookup(params.embed, tokens, cfg)
    B, S = tokens.shape
    positions = rows = None
    if mode in ("full", "prefill"):
        positions = torch.arange(S, device=device).expand(B, S)
    if mode == "full":
        caches = [None] * cfg.num_layers
    elif mode == "prefill":
        rows = (torch.arange(B, device=device) if cache_rows is None
                else cache_rows.to(device))
        if kv_valid is not None:
            kv_valid = kv_valid.to(device)
    elif mode == "decode":
        pos = torch.as_tensor(pos, dtype=torch.int32).to(device)
        if pos.dim() == 0:                     # one position for every row
            pos = pos.expand(B).contiguous()
        if active is not None:
            active = np.asarray(active.cpu() if isinstance(active, torch.Tensor)
                                else active, bool)
            rows = torch.from_numpy(np.flatnonzero(active)).to(device)
    for layer, cache in zip(params.layers, caches):
        x = blk.apply_block(layer, x, cfg, mode=mode, cache=cache,
                            positions=positions, pos=pos, kv_valid=kv_valid,
                            rows=rows)
    return params.final_norm(x, cfg.norm_eps), \
        (None if mode == "full" else caches)


def head_table(params: Model, cfg: ModelConfig) -> torch.Tensor:
    return params.embed if cfg.tie_embeddings else params.lm_head


def prefill(params: Model, cfg: ModelConfig, batch, max_len: int,
            kv_valid=None):
    """Run the prompt into fresh caches; returns (last hidden (B,d),
    caches)."""
    B = batch["tokens"].shape[0]
    caches = init_caches(cfg, B, max_len, model_device(params))
    x, caches = forward(params, cfg, batch, mode="prefill", caches=caches,
                        kv_valid=kv_valid)
    return x[:, -1], caches


def decode_step(params: Model, cfg: ModelConfig, tokens: torch.Tensor,
                caches, pos, active=None):
    """One decode step: tokens (B,1) at per-row positions ``pos`` (B,).
    Returns (last hidden (B,d), caches)."""
    x, caches = forward(params, cfg, {"tokens": tokens}, mode="decode",
                        caches=caches, pos=pos, active=active)
    return x[:, -1], caches


def greedy_next(params: Model, cfg: ModelConfig,
                hidden: torch.Tensor) -> torch.Tensor:
    """hidden (B,d) -> next token ids (B,) int32."""
    return vocab_mod.sharded_greedy(hidden, head_table(params, cfg), cfg)

"""Embedding lookup, LM head and the LM loss on one device (the
single-device branches of ``repro/sharding/vocab.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (VOCAB_PAD_MULT, dtype_of, round_up,
                                       softcap)


def padded_vocab(cfg: ModelConfig) -> int:
    return round_up(cfg.vocab_size, VOCAB_PAD_MULT)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """table (Vp,d); tokens (B,S) int -> (B,S,d) in the activation dtype,
    times ``cfg.embedding_multiplier`` (in f32, then back in the table's
    dtype) where the config has one."""
    out = table[tokens.long()]
    if cfg.embedding_multiplier:
        out = (out.float() * cfg.embedding_multiplier).to(out.dtype)
    return out.to(dtype_of(cfg.activation_dtype))


def lm_head_logits(x: torch.Tensor, table: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,d) -> logits (B,S,Vp), softcapped by
    ``cfg.final_logit_softcap``; padded-vocab columns are -inf."""
    logits = softcap(x @ table.t(), cfg.final_logit_softcap)
    pad = torch.arange(table.shape[0], device=x.device) >= cfg.vocab_size
    return logits.masked_fill(pad, float("-inf"))


def lm_head_loss(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross-entropy over the head: x (B,S,d), table (Vp,d),
    labels (B,S) int, ``mask`` (B,S) weighting each position (default 1).
    The logits, softcapped by ``cfg.final_logit_softcap``, are taken in
    f32; padded-vocab columns are -1e30 (finite, unlike the serving
    head's -inf, as the reference's loss has them). Returns (mean loss,
    mean z-term): z is logsumexp^2, the z-loss."""
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
    mask = mask.float()
    logits = softcap(x @ table.t(), cfg.final_logit_softcap).float()
    pad = torch.arange(table.shape[0], device=x.device) >= cfg.vocab_size
    logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    corr = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - corr) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return loss.sum() / denom, (lse * lse * mask).sum() / denom


def sharded_greedy(x: torch.Tensor, table: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Greedy next token, x (B,d) -> ids (B,) int32; ties go to the lowest
    index (``torch.argmax`` returns the first maximum, as ``jnp.argmax``).
    The softcap is monotone but can tie logits near saturation, so it
    comes before the argmax, as in the JAX package."""
    logits = lm_head_logits(x[:, None], table, cfg)[:, 0]
    return torch.argmax(logits, dim=-1).to(torch.int32)

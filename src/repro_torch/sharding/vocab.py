"""Embedding lookup and LM head on one device (the single-device branches
of ``repro/sharding/vocab.py``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import VOCAB_PAD_MULT, dtype_of, round_up


def padded_vocab(cfg: ModelConfig) -> int:
    return round_up(cfg.vocab_size, VOCAB_PAD_MULT)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """table (Vp,d); tokens (B,S) int -> (B,S,d) in the activation dtype."""
    return table[tokens.long()].to(dtype_of(cfg.activation_dtype))


def lm_head_logits(x: torch.Tensor, table: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,d) -> logits (B,S,Vp); padded-vocab columns are -inf."""
    logits = x @ table.t()
    pad = torch.arange(table.shape[0], device=x.device) >= cfg.vocab_size
    return logits.masked_fill(pad, float("-inf"))


def sharded_greedy(x: torch.Tensor, table: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """Greedy next token, x (B,d) -> ids (B,) int32; ties go to the lowest
    index (``torch.argmax`` returns the first maximum, as ``jnp.argmax``)."""
    logits = lm_head_logits(x[:, None], table, cfg)[:, 0]
    return torch.argmax(logits, dim=-1).to(torch.int32)

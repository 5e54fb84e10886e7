"""Config registry of the port: ``get_config("deepseek-7b")``.

Every architecture the port serves is registered (deepseek-7b, all
global; gemma2-27b, local and global layers in turn; gemma-2b, MQA at
head_dim 256 with padded heads; recurrentgemma-9b, RG-LRU recurrent
blocks between local layers; xlmr-paper, the paper's bidirectional
encoder with LayerNorm, q/k/v biases and a plain biased GELU MLP, served
in length buckets; whisper-medium, an encoder over stub frame embeddings
and a decoder whose layers add cross-attention to the encoder's output;
qwen2-vl-7b, M-RoPE over three position streams, q/k/v biases, padded
heads and token or stub patch-embedding inputs; mamba2-130m, Mamba2 SSD
mixer blocks alone, whose per-slot state is constant in the context
length; dbrx-132b, global attention blocks whose MLP half is a
mixture of 16 experts, top 4, with capacity drops; command-r-plus-104b,
global attention at G 12 with LayerNorm (a scale and a bias) and a tied
256000-row embedding; kimi-k2-1t-a32b, global attention at G 8 whose MLP
half is a mixture of 384 experts, top 8, padded to 512). Every config of
the JAX package's registry is here; DLRM's live in ``dlrm_paper``."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (command_r_plus_104b, dbrx_132b,
                                 deepseek_7b, gemma2_27b, gemma_2b,
                                 kimi_k2_1t_a32b, mamba2_130m, qwen2_vl_7b,
                                 recurrentgemma_9b, whisper_medium,
                                 xlmr_paper)
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT,
                                      SSM, ModelConfig, QuantConfig,
                                      reduce_for_smoke)

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (deepseek_7b.CONFIG, gemma2_27b.CONFIG,
                        gemma_2b.CONFIG, recurrentgemma_9b.CONFIG,
                        xlmr_paper.CONFIG, whisper_medium.CONFIG,
                        qwen2_vl_7b.CONFIG, mamba2_130m.CONFIG,
                        dbrx_132b.CONFIG, command_r_plus_104b.CONFIG,
                        kimi_k2_1t_a32b.CONFIG)}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") \
            from None


__all__ = ["ATTN_GLOBAL", "ATTN_LOCAL", "ModelConfig", "QuantConfig",
           "RECURRENT", "SSM", "get_config", "reduce_for_smoke"]

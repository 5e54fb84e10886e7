"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000. RG-LRU + local attention, pattern (recurrent, recurrent, local).
[arXiv:2402.19427; unverified]

A recurrent layer keeps a hidden state ``h`` (f32) and a causal-conv tail
per row; a local layer keeps a ring of ``window_size`` K/V slots.
"""
from repro_torch.configs.base import (ATTN_LOCAL, RECURRENT, ModelConfig,
                                      RecurrentConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,                  # (rec, rec, local) x 12 + (rec, rec) tail
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
    window_size=2048,
    activation="gelu_tanh",
    glu=True,
    norm_type="rmsnorm",
    tie_embeddings=True,
    embedding_multiplier=4096 ** 0.5,
    rope_theta=10_000.0,
    recurrent=RecurrentConfig(lru_width=4096, d_conv=4),
    supports_long_context=True,
)

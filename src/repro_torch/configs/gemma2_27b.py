"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.

Local+global alternating, attn/final logit softcap, sandwich norms.
[arXiv:2408.00118; hf]

Local layers keep a ring of ``window_size`` K/V slots per row; global
layers keep ``max_len``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    block_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    activation="gelu_tanh",
    glu=True,
    norm_type="rmsnorm",
    post_attn_norm=True,
    tie_embeddings=True,
    embedding_multiplier=4608 ** 0.5,
    rope_theta=10_000.0,
    supports_long_context=True,
)

"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.

GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]

Every layer is a global attention block: 96 query heads over 8 kv heads
(G 12) of head_dim 128, RoPE at theta 75000, a SwiGLU MLP of 33792, the
embedding tied to the head. The projections have no bias; the norms are
LayerNorm with a scale and a bias (``models/common.py::LayerNorm``).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256_000,
    block_pattern=(ATTN_GLOBAL,),
    activation="silu",
    glu=True,
    norm_type="layernorm",       # Cohere uses LayerNorm (no bias in proj)
    tie_embeddings=True,
    rope_theta=75_000.0,
    supports_long_context=False,
)

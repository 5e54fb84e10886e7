"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.

llama-arch [arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    block_pattern=(ATTN_GLOBAL,),
    activation="silu",
    glu=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
    rope_theta=10_000.0,
    supports_long_context=False,
)

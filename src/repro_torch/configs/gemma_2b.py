"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256, MQA. [arXiv:2403.08295; hf]

The 8 query heads are padded to 16: ``wq`` and ``wo`` hold 16 heads, the
padded heads' ``wo`` rows are zero, so attention computes them and the
output projection discards them exactly.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_padded_heads=16,   # 8 % 16 != 0: pad so TP-16 shards attention
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    block_pattern=(ATTN_GLOBAL,),
    activation="gelu_tanh",
    glu=True,
    norm_type="rmsnorm",
    tie_embeddings=True,
    embedding_multiplier=2048 ** 0.5,
    rope_theta=10_000.0,
    supports_long_context=False,   # pure full attention -> skip long_500k
)

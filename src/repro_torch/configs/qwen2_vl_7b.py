"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

The vision frontend is a stub, as in the JAX package's config: a batch may
carry precomputed patch embeddings (``embeds``) and their (t, h, w) M-RoPE
position ids (``positions``) in place of tokens. The 28 query heads are
padded to 32 (8 to each of the 4 kv heads): the padded heads' ``wo`` rows
are zero, so attention computes them and the output projection discards
them exactly.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_padded_heads=32,   # 28 % 16 != 0: pad so TP-16 shards attention
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    block_pattern=(ATTN_GLOBAL,),
    activation="silu",
    glu=True,
    norm_type="rmsnorm",
    qkv_bias=True,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),    # t/h/w split of head_dim//2 = 64
    input_kind="embeddings",        # patch-embedding stub; tokens too
    supports_long_context=False,
)

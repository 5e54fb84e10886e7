"""XLM-R (paper's NLP workload) — 24L encoder, 558M params.

Encoder-only (bidirectional, no KV cache); served with shape bucketing
(paper T5: compile per sequence-length bucket 32/64/128/...).
[arXiv:1911.02116 via the paper §II-C]

The paper served it in fp16; this config, like the JAX package's, leaves
``param_dtype`` at its bf16 default, and the port serves it so.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="xlmr-paper",
    family="encoder",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=250_002,
    block_pattern=(ATTN_GLOBAL,),
    activation="gelu",
    glu=False,
    norm_type="layernorm",
    qkv_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    rope_theta=10_000.0,     # positional handled via rope in our impl
    supports_long_context=False,
)

# Paper §VI-A bucketing ladder for variable-length text
SEQ_BUCKETS = (32, 64, 128, 256, 512)

"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128. SSD (state-space duality). [arXiv:2405.21060; unverified]

Every layer is a Mamba2 mixer block (pre-norm, mixer, residual; no MLP).
A layer's per-slot state is constant in the context length: the SSD state
``state`` (heads, head_dim, d_state) in f32 and a causal-conv tail.
"""
from repro_torch.configs.base import SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                        # attention-free, no MLP (mixer only)
    vocab_size=50_280,
    block_pattern=(SSM,),
    glu=False,
    norm_type="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    supports_long_context=True,    # constant-state decode
)

"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert
vocab=100352, MoE 16e top-4, fine-grained. [hf:databricks/dbrx-base; unverified]

Every layer is a global attention block whose MLP half is a
mixture-of-experts (``models/moe.py``): a router over 16 experts, each
token's top 4 by softmax weight, renormalised, every expert a SwiGLU FFN
of 10752 computed over a capacity buffer of its routed tokens, entries past
the capacity dropped first come, first served.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,                     # per-expert hidden size
    vocab_size=100_352,
    block_pattern=(ATTN_GLOBAL,),
    activation="silu",
    glu=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752,
                  capacity_factor=1.25),
    supports_long_context=False,
)

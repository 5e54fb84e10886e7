"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert
vocab=163840, MoE 384e top-8. Trillion-param MoE. [arXiv:2501.kimi2; unverified]

Total params ~1.03T (61 x 384 x 3 x 7168 x 2048 expert weights dominate);
active ~32B/token with top-8 routing.

Every layer is a global attention block (64 query heads over 8 kv heads,
G 8, head_dim 128) whose MLP half is a mixture of experts
(``models/moe.py``): a router over the 384 experts, each token's top 8,
renormalised; the expert weights hold 512 (128 padded experts, which get
no router column and no token, but run over their capacity buffers as
the real ones do).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                      # per-expert hidden size
    vocab_size=163_840,
    block_pattern=(ATTN_GLOBAL,),
    activation="silu",
    glu=True,
    norm_type="rmsnorm",
    tie_embeddings=False,
    rope_theta=50_000.0,
    # 384 experts don't divide a 256-shard mesh; pad to 512 so expert
    # parallelism can span BOTH mesh axes (dummy experts get no tokens)
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048,
                  capacity_factor=1.25, num_padded_experts=512),
    supports_long_context=False,
)

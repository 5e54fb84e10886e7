"""whisper-medium [audio] — 24L d_model=1024 16H d_ff=4096 vocab=51865.

Enc-dec; the conv frontend is a stub (the encoder takes precomputed frame
embeddings, ``input_kind="embeddings"``), as in the JAX package's config.
[arXiv:2212.04356]

The decoder takes tokens and attends, in each of its 24 layers, first its
own cache (causal self-attention) and then the encoder's output
(cross-attention over every frame); the encoder is 24 non-causal layers.
"""
from repro_torch.configs.base import ATTN_GLOBAL, EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,                  # decoder layers; encoder below
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    block_pattern=(ATTN_GLOBAL,),
    activation="gelu",
    glu=False,
    norm_type="layernorm",
    qkv_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    encdec=EncDecConfig(encoder_layers=24, decoder_layers=24,
                        max_target_len=448),
    input_kind="embeddings",        # audio frontend stub
    supports_long_context=False,
)

# Frames the encoder takes a request, a serving constant and not a model
# field (the config leaves the encoder length to the caller): Whisper's
# fixed 30-second window, 3000 mel frames, after its stride-2 conv.
ENC_FRAMES = 1500

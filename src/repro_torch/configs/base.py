"""Config system for the PyTorch port: the model and quantization config
dataclasses and ``reduce_for_smoke``.

A copy of ``repro/configs/base.py`` (pure data). The port keeps its own
copy so that it never imports the JAX package; the field set is kept
identical so a test can compare the two configs field by field. The
analytic parameter/FLOP counts and the workload shapes of the original
are not copied: nothing in the port reads them yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Block kinds understood by the block program (models/model.py)
# --------------------------------------------------------------------------
ATTN_GLOBAL = "global"      # full (causal) attention
ATTN_LOCAL = "local"        # sliding-window attention
SSM = "ssm"                 # Mamba2 SSD block
RECURRENT = "recurrent"     # Griffin RG-LRU block

# block kinds with a per-slot chunked-prefill contract (serving/state.py
# keys its slot-state kinds off it)
CHUNKABLE_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, SSM, RECURRENT)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    num_shared_experts: int = 0
    num_padded_experts: Optional[int] = None

    @property
    def padded_experts(self) -> int:
        return self.num_padded_experts or self.num_experts


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyperparameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class RecurrentConfig:
    """Griffin RG-LRU block hyperparameters."""
    lru_width: Optional[int] = None    # default: d_model
    d_conv: int = 4


@dataclass(frozen=True)
class QuantConfig:
    """Quantization knobs (paper §V workflow)."""
    embedding_bits: Optional[int] = None     # None = no embedding quant
    dense_int8: bool = False
    fallback_dtype: str = "bfloat16"
    skip_list: Tuple[str, ...] = ("final", "logits", "router")
    kv_cache_dtype: str = "bfloat16"         # 'int8' enables KV-cache quant


@dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int
    decoder_layers: int
    max_target_len: int = 512


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    num_padded_heads: Optional[int] = None
    block_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    window_size: int = 4096
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    rope_mode: str = "standard"        # standard | mrope
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qkv_bias: bool = False
    o_bias: bool = False

    # --- MLP ---
    activation: str = "silu"           # silu | gelu | gelu_tanh
    glu: bool = True
    mlp_bias: bool = False

    # --- norms / embeddings ---
    norm_type: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    post_attn_norm: bool = False
    tie_embeddings: bool = True
    embedding_multiplier: Optional[float] = None

    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    encdec: Optional[EncDecConfig] = None

    quant: QuantConfig = field(default_factory=QuantConfig)

    # --- numerics ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    # --- attention implementation (the JAX package's switch; the port
    # always runs its hand-written kernels) ---
    attention_impl: str = "chunked_jnp"

    # --- serving ---
    supports_long_context: bool = False
    input_kind: str = "tokens"         # tokens | embeddings

    def __post_init__(self):
        if self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {self.num_heads} is not a multiple "
                             f"of num_kv_heads {self.num_kv_heads}")

    @property
    def padded_heads(self) -> int:
        return self.num_padded_heads or self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer block kinds (length == num_layers)."""
        pat = self.block_pattern
        reps = self.num_layers // len(pat)
        tail = self.num_layers - reps * len(pat)
        return pat * reps + pat[:tail]

    def scan_plan(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(superblock_unit, repeats, tail_kinds): the JAX package's
        scan-over-layers plan, which ``convert.py`` needs to unstack its
        parameters."""
        pat = self.block_pattern
        reps = self.num_layers // len(pat)
        tail = self.block_pattern[: self.num_layers - reps * len(pat)]
        return pat, reps, tail


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config: few layers, small width, tiny vocab."""
    pat = cfg.block_pattern
    kw = dict(
        num_layers=max(len(pat), 2),
        d_model=64,
        num_heads=4,
        num_padded_heads=None,
        num_kv_heads=min(cfg.num_kv_heads, 4) or 1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        param_dtype="float32",
        activation_dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=32)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    if cfg.recurrent is not None:
        kw["recurrent"] = dataclasses.replace(cfg.recurrent, lru_width=64)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(
            cfg.encdec, encoder_layers=2, decoder_layers=2, max_target_len=32)
        kw["num_layers"] = 2
    if cfg.window_size > 16:
        kw["window_size"] = 8
    if cfg.rope_mode == "mrope":
        kw["mrope_sections"] = (4, 2, 2)   # sums to head_dim//2 = 8
    return dataclasses.replace(cfg, **kw)

"""Dense gated MLP (SwiGLU/GeGLU) (counterpart of ``repro/models/mlp.py``);
a projection whose weight the build step quantized goes through the w8a8
kernel."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import dense_w8a8, is_quantized_dense
from repro_torch.models.common import activation_fn, dtype_of, mk_param


class MLP(nn.Module):
    """``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d), the JAX layout."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = mk_param((d, f), dt, device, gen)
        self.w_up = mk_param((d, f), dt, device, gen)
        self.w_down = mk_param((f, d), dt, device, gen)


def _dense(x: torch.Tensor, w) -> torch.Tensor:
    """One projection: an fp matmul, or w8a8 for a ``QuantDense``."""
    if is_quantized_dense(w):
        return dense_w8a8(x, w)
    return x @ w


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = act(_dense(x, p.w_gate)) * _dense(x, p.w_up)
    return _dense(h, p.w_down)

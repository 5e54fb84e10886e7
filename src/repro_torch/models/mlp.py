"""Dense MLP, gated (SwiGLU/GeGLU) or plain with biases (XLM-R's)
(counterpart of ``repro/models/mlp.py``); a projection whose weight the
build step quantized goes through the w8a8 kernel."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import dense_w8a8, is_quantized_dense
from repro_torch.models.common import activation_fn, dtype_of, mk_param


class MLP(nn.Module):
    """``w_gate`` (only when ``cfg.glu``), ``w_up`` (d, f) and ``w_down``
    (f, d), the JAX layout, f = ``d_ff`` or ``cfg.d_ff``; with
    ``cfg.mlp_bias`` also ``b_up`` (f,) and ``b_down`` (d,), zeros at
    init."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 d_ff: int = None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, f = cfg.d_model, d_ff or cfg.d_ff
        if cfg.glu:
            self.w_gate = mk_param((d, f), dt, device, gen)
        self.w_up = mk_param((d, f), dt, device, gen)
        self.w_down = mk_param((f, d), dt, device, gen)
        if cfg.mlp_bias:
            self.b_up = mk_param((f,), dt, device, init="zeros")
            self.b_down = mk_param((d,), dt, device, init="zeros")


def _dense(x: torch.Tensor, w) -> torch.Tensor:
    """One projection: an fp matmul, or w8a8 for a ``QuantDense``."""
    if is_quantized_dense(w):
        return dense_w8a8(x, w)
    return x @ w


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up) @ w_down`` when gated, else ``act(x
    @ w_up + b_up) @ w_down + b_down``; each bias is added after its
    product (after ``dense_w8a8`` at a quantized site)."""
    act = activation_fn(cfg.activation)
    gate = _dense(x, p.w_gate) if cfg.glu else None
    up = _dense(x, p.w_up)
    if hasattr(p, "b_up"):
        up = up + p.b_up
    h = act(gate) * up if cfg.glu else act(up)
    y = _dense(h, p.w_down)
    return y + p.b_down if hasattr(p, "b_down") else y

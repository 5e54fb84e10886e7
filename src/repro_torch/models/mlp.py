"""Dense gated MLP (SwiGLU/GeGLU), fp path (counterpart of
``repro/models/mlp.py``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
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


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = act(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down

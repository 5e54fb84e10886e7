"""Training step of the port (counterpart of
``repro/training/train_step.py``): the loss and its gradients through
autograd, optionally over microbatches whose f32 gradients are summed and
averaged (the reference scans them), each layer optionally recomputed in
the backward pass (``remat``), then the optimizer's update of the model's
parameters in place."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                            init_opt_state)


def choose_microbatches(cfg: ModelConfig, global_batch: int, seq: int,
                        n_data_shards: int, act_budget_bytes: float = 4e9) -> int:
    """Pick grad-accum steps so per-microbatch boundary activations fit.

    Scan-over-layers keeps one (micro_b, S, d) activation per layer alive for
    the backward pass; budget that at ~4GB/device."""
    per_dev = max(global_batch // max(n_data_shards, 1), 1)
    bytes_per_sample = cfg.num_layers * seq * cfg.d_model * 2
    micro = max(int(act_budget_bytes // max(bytes_per_sample, 1)), 1)
    micro = min(micro, per_dev)
    # accumulation steps must divide the per-device batch
    accum = per_dev // micro
    while per_dev % accum:
        accum += 1
    return accum


def _microbatch(key: str, x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch i of n of a batch entry: rows along axis 0, or along
    axis 1 for M-RoPE positions (3,B,S)."""
    ax = 1 if (key == "positions" and x.dim() == 3
               and x.shape[0] == 3) else 0
    rows = x.shape[ax] // n
    return x.narrow(ax, i * rows, rows)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *,
                    accum_steps: int = 1, remat: bool = True) -> Callable:
    """Returns ``train_step(model, opt_state, batch) -> (opt_state,
    metrics)``. batch: {'tokens' (B,S), 'labels' (B,S)[, 'embeds',
    'enc_embeds', 'positions', 'loss_mask']}, numpy arrays or tensors;
    each entry goes to the model's device. The model's parameters (which
    must require grad) and ``opt_state`` are updated in place. metrics:
    'loss', 'grad_norm', and with one microbatch the loss's parts 'xent',
    'z' and 'aux' (the reference's), each a device scalar."""

    def grads_of(model, names, mb):
        loss, parts = model_mod.loss_fn(model, cfg, mb, remat=remat)
        params = [model.get_parameter(n) for n in names]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not read has gradient 0, as jax.grad's
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, {
            n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}

    def train_step(model, opt_state, batch):
        device = model_mod.model_device(model)
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                    else v).to(device)
                 for k, v in batch.items()}
        params = dict(model.named_parameters())
        names = list(params)
        if accum_steps == 1:
            loss, parts, grads = grads_of(model, names, batch)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=device) for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(accum_steps):
                mb = {k: _microbatch(k, v, i, accum_steps)
                      for k, v in batch.items()}
                l, _, g = grads_of(model, names, mb)
                for n in names:
                    grads[n] += g[n].float()
                loss = loss + l
                del g
            for g in grads.values():
                g /= accum_steps
            loss = loss / accum_steps
            parts = {}
        metrics = apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, **parts)
        return opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig, seed: int = 0,
                     device="cuda"):
    """(model with gradients on, its optimizer state)."""
    model = model_mod.init_params(cfg, seed, device).requires_grad_(True)
    return model, init_opt_state(dict(model.named_parameters()), opt_cfg)

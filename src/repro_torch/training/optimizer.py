"""Optimizers of the port (counterpart of ``repro/training/optimizer.py``):
Adam with f32 moments, and Adafactor with a factored second moment (for
models past ~40B parameters, whose f32 Adam state does not fit).

The state and the update are written over a mapping of named parameters
(``dict(model.named_parameters())``), updated in place; the formulas are
the reference's, in its order: the global-norm clip of the gradients,
then Adam's bias-corrected moments with weight decay added to the update,
or Adafactor's factored ``vr``/``vc`` (rows and columns of each matrix of
its last two axes) with the update's RMS clipped to 1. ``torch.optim``'s
Adam clips and decays otherwise, and its Adafactor is another algorithm.

The reference stacks the layers of a scan unit into one leaf, so its
Adafactor clips the update's RMS over every layer of a unit position at
once; here each layer's parameter is a leaf of its own and is clipped on
its own. The factored moments are the same per layer either way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import torch

Params = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class OptConfig:
    name: str = "adam"              # adam | adafactor
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # adafactor
    decay: float = 0.8
    min_dim_factored: int = 128


def select_for(param_count: int) -> OptConfig:
    """Paper-scale pragmatism: factored states above ~40B params."""
    if param_count > 40e9:
        return OptConfig(name="adafactor", lr=1e-3)
    return OptConfig(name="adam", lr=1e-3)


def _factored(p: torch.Tensor, cfg: OptConfig) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= cfg.min_dim_factored \
        and p.shape[-2] >= cfg.min_dim_factored


def init_opt_state(params: Params, cfg: OptConfig) -> Dict:
    """{"step": int32 scalar on the parameters' device, then Adam's "mu"
    and "nu" or Adafactor's "v" ({"vr", "vc"} or {"v"}), each a dict by
    parameter name, f32}."""
    device = next(iter(params.values())).device
    step = torch.zeros((), dtype=torch.int32, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if cfg.name == "adam":
        return {"step": step,
                "mu": {k: zeros(p.shape) for k, p in params.items()},
                "nu": {k: zeros(p.shape) for k, p in params.items()}}
    if cfg.name == "adafactor":
        return {"step": step, "v": {
            k: ({"vr": zeros(p.shape[:-1]),
                 "vc": zeros(p.shape[:-2] + p.shape[-1:])}
                if _factored(p, cfg) else {"v": zeros(p.shape)})
            for k, p in params.items()}}
    raise ValueError(cfg.name)


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def _clip_scale(gnorm: torch.Tensor, cfg: OptConfig):
    if not cfg.grad_clip:
        return 1.0
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)


@torch.no_grad()
def apply_updates(params: Params, grads: Params, state: Dict,
                  cfg: OptConfig) -> Dict:
    """One update of every parameter of ``params`` in place from ``grads``
    (the same names); ``state`` is updated in place too. Returns the
    metrics, {"grad_norm": the gradients' global norm before the clip}."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg)
    state["step"] += 1
    step = state["step"].float()

    if cfg.name == "adam":
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        for k, p in params.items():
            g = grads[k].float() * scale
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_(b1 * mu + (1 - b1) * g)
            nu.copy_(b2 * nu + (1 - b2) * g * g)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - cfg.lr * u)
        return {"grad_norm": gnorm}

    # adafactor (simplified: no momentum, relative step off, factored v)
    beta2 = 1.0 - step ** (-cfg.decay)
    for k, p in params.items():
        g = grads[k].float() * scale
        g2 = g * g + 1e-30
        v = state["v"][k]
        if "vr" in v:
            vr = beta2 * v["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=1e-30)
            vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            vhat = beta2 * v["v"] + (1 - beta2) * g2
            v["v"].copy_(vhat)
        u = g / torch.sqrt(vhat + cfg.eps)
        # update clipping (RMS <= 1)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        p.copy_(p.float() - cfg.lr * u)
    return {"grad_norm": gnorm}

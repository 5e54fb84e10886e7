"""QuantizedParams build step (paper §V) on torch (counterpart of
``repro/models/quantize.py``): per-channel int8 weights and scales for
every dense projection of the LM stack, chosen by the calibration and
fall-back workflow in ``core/quantization.py``.

Every MLP projection (``w_gate``/``w_up``/``w_down``) and attention
projection (``wq``/``wk``/``wv``/``wo``) is a quantization SITE, named as
the JAX package names it: ``scan{i}.{module}.{weight}`` for position ``i``
of the repeating layer unit, ``tail{i}.{module}.{weight}`` for the
unrolled tail (``cfg.scan_plan()``). The JAX package stacks a scan
position's ``repeats`` copies in one array; the port has one module per
layer, so a scan site here groups the layers ``r * len(unit) + i``: one
decision for all of them, its error the max over them, and a fall-back
moves all of them back to the fp weight together. deepseek-7b has 7
sites, not 210. Embeddings, norms and the LM head stay fp.

The workflow quantizes every site, measures end-to-end top-1 token
disagreement against the fp model on a calibration batch, and while the
disagreement exceeds ``budget`` falls the highest-error site back to fp.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import (QuantDense, QuantWorkflowResult,
                                           quantization_workflow,
                                           quantize_weight_int8,
                                           set_quantized)
from repro_torch.models import model as model_mod

# module -> weight names that are dense GEMM sites
QUANT_SITES = {"mlp": ("w_gate", "w_up", "w_down"),
               "attn": ("wq", "wk", "wv", "wo")}

# site name -> ('scan'|'tail', position, module, weight, layer indices)
Site = Tuple[str, int, str, str, List[int]]


@dataclass
class QuantizedParams:
    """Result of the build step: ``params`` is a model that shares every
    fp tensor with the original and holds a ``QuantDense`` at each
    int8-decided site of each of its layers."""
    params: model_mod.Model
    result: QuantWorkflowResult
    quantized_sites: int
    fallback_sites: int

    @property
    def schemes(self) -> Dict[str, str]:
        return {d.name: d.scheme for d in self.result.decisions}


def _collect_sites(params: model_mod.Model, cfg: ModelConfig
                   ) -> Dict[str, Site]:
    unit, repeats, tail = cfg.scan_plan()
    n_scan = repeats * len(unit)
    groups = [("scan", i, [r * len(unit) + i for r in range(repeats)])
              for i in range(len(unit))]
    groups += [("tail", i, [n_scan + i]) for i in range(len(tail))]
    sites = {}
    for group, gi, layers in groups:
        if not layers:
            continue
        block = params.layers[layers[0]]
        for mod, wnames in QUANT_SITES.items():
            modp = getattr(block, mod, None)
            if modp is None:
                continue
            for wname in wnames:
                if hasattr(modp, wname):
                    sites[f"{group}{gi}.{mod}.{wname}"] = \
                        (group, gi, mod, wname, layers)
    return sites


def _as_2d(w: torch.Tensor, wname: str) -> torch.Tensor:
    """Flatten a dense weight to (reduction, output). ``wo`` (H, hd, d)
    contracts its leading head axes; every other site ((d, H, hd) head
    projections, 2-D MLP weights) contracts its leading axis — head axes
    flatten into the output axis and ``models/attention.py`` restores
    them from ``cfg.head_dim`` at apply time."""
    if wname == "wo":
        return w.reshape(-1, w.shape[-1])
    return w.reshape(w.shape[0], -1)


def _quantize_leaf(w: torch.Tensor, wname: str) -> QuantDense:
    return QuantDense(*quantize_weight_int8(_as_2d(w, wname)))


def _site_error(ws: Sequence[torch.Tensor], wname: str) -> float:
    """Relative dequant error of the site (max over its layers)."""
    def one(w):
        w2 = _as_2d(w, wname).to(torch.float32)
        q, s = quantize_weight_int8(w2)
        deq = q.to(torch.float32) * s
        num = torch.linalg.norm(w2 - deq)
        den = torch.clamp(torch.linalg.norm(w2), min=1e-8)
        return num / den
    return float(torch.stack([one(w) for w in ws]).max())


def _shallow_clone(m: nn.Module) -> nn.Module:
    """A new module tree over the same tensors: replacing a submodule or
    parameter of the clone leaves the original as it was, and moving the
    clone's parameters (new Parameter objects) does not move the
    original's."""
    new = copy.copy(m)
    new._parameters = {k: None if p is None else
                       nn.Parameter(p.detach(), requires_grad=False)
                       for k, p in m._parameters.items()}
    new._buffers = dict(m._buffers)
    new._modules = {k: None if c is None else _shallow_clone(c)
                    for k, c in m._modules.items()}
    return new


def materialize(params: model_mod.Model, cfg: ModelConfig,
                schemes: Dict[str, str],
                quantized_leaves: Dict[str, List[QuantDense]]
                ) -> model_mod.Model:
    """The model with int8-decided sites swapped for their precomputed
    quantized leaves, one per layer of the site (fp-decided sites keep
    the original weight)."""
    sites = _collect_sites(params, cfg)
    new = _shallow_clone(params)
    for name, scheme in schemes.items():
        if scheme != "int8" or name not in sites:
            continue
        _, _, mod, wname, layers = sites[name]
        for leaf, layer in zip(quantized_leaves[name], layers):
            set_quantized(getattr(new.layers[layer], mod), wname, leaf)
    return new


def default_calib_tokens(cfg: ModelConfig, batch: int = 2,
                         seq: int = 16) -> torch.Tensor:
    """Deterministic calibration batch from numpy seed 0. (The JAX
    package draws its default batch with ``jax.random``, so the two
    defaults differ; pass ``calib_tokens`` to compare the two builds.)"""
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))


def _full_argmax(params: model_mod.Model, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    h, _ = model_mod.forward(params, cfg, {"tokens": tokens}, mode="full",
                             caches=None)
    table = model_mod.head_table(params, cfg)
    logits = h.to(torch.float32) @ table.to(torch.float32).t()
    return torch.argmax(logits[..., :cfg.vocab_size], dim=-1)


@torch.no_grad()
def build_quantized_params(cfg: ModelConfig, params: model_mod.Model, *,
                           budget: float = 0.05,
                           calib_tokens=None,
                           skip: Tuple[str, ...] = (),
                           max_iters: int = 4) -> QuantizedParams:
    """Run the §V workflow over every dense projection site and return the
    mixed-precision params, on the device of ``params``. ``budget`` bounds
    the top-1 token disagreement vs the fp reference on the calibration
    batch; ``skip`` force-keeps named sites (substring match) fp."""
    if calib_tokens is None:
        calib_tokens = default_calib_tokens(cfg)
    calib_tokens = torch.as_tensor(calib_tokens).to(
        model_mod.model_device(params))
    sites = _collect_sites(params, cfg)
    sites = {n: loc for n, loc in sites.items()
             if not any(s in n for s in skip)}

    def leaves_of(name) -> List[torch.Tensor]:
        _, _, mod, wname, layers = sites[name]
        return [getattr(getattr(params.layers[l], mod), wname)
                for l in layers]

    # quantize every site once up front; workflow iterations just re-mix
    quantized = {n: [_quantize_leaf(w, sites[n][3]) for w in leaves_of(n)]
                 for n in sites}
    ref_argmax = _full_argmax(params, cfg, calib_tokens)

    def eval_metric(schemes: Dict[str, str]) -> float:
        qp = materialize(params, cfg, schemes, quantized)
        qa = _full_argmax(qp, cfg, calib_tokens)
        return float(torch.mean((qa != ref_argmax).to(torch.float32)))

    def site_error(name, _w):
        return _site_error(leaves_of(name), sites[name][3])

    result = quantization_workflow(
        {n: leaves_of(n) for n in sites}, eval_metric, budget=budget,
        layer_error_fn=site_error, max_iters=max_iters)
    final = materialize(params, cfg,
                        {d.name: d.scheme for d in result.decisions},
                        quantized)
    n_int8 = sum(d.scheme == "int8" for d in result.decisions)
    return QuantizedParams(final, result, n_int8,
                           len(result.decisions) - n_int8)

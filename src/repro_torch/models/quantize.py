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
sites, not 210. Embeddings, norms, the LM head, the MoE experts and
router, and the RG-LRU and SSM mixers stay fp (the reference's skip-list:
``QUANT_SITES`` has no ``moe``), so dbrx-132b's sites are its attention
projections alone (4, whatever its depth) and a model of ssm layers alone
(mamba2-130m) has no site: its build decides nothing and serves the fp
weights.

The workflow quantizes every site, measures end-to-end top-1 token
disagreement against the fp model on a calibration batch, and while the
disagreement exceeds ``budget`` falls the highest-error site back to fp.
The build quantizes a site when the workflow first reaches it, so its
transients are one site's at a time, and takes the calibration argmax
over slices of the vocabulary, never an f32 copy of the whole table.
``release_fp=True`` also moves each int8 site's fp weights off the device
as each is quantized: a model whose fp and int8 weights do not fit the
device together (gemma2-27b: ~50.7 GiB bf16 and ~24.3 GiB of int8 sites
on an 80 GB card) builds within the fp model plus one leaf's
transients.
"""
from __future__ import annotations

import copy
import gc
from dataclasses import dataclass
from typing import Dict, List, Tuple

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
    fp tensor it holds with the original (the embedding, norms and
    fall-back sites, on the original's device) and holds a ``QuantDense``
    at each int8-decided site of each of its layers, on the same device.
    It holds no int8-decided site's fp weight: those stay with the
    original, on its device by default, or on the host after a build with
    ``release_fp=True``."""
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


def _quantize_leaf(w: torch.Tensor, wname: str
                   ) -> Tuple[QuantDense, torch.Tensor]:
    """The leaf's int8 form and its relative dequant error ||w - deq|| /
    ||w||, from one quantization in f32 (one leaf's f32 transients at a
    time)."""
    w2 = _as_2d(w, wname).to(torch.float32)
    q, s = quantize_weight_int8(w2)
    deq = q.to(torch.float32) * s
    num = torch.linalg.norm(w2 - deq)
    den = torch.clamp(torch.linalg.norm(w2), min=1e-8)
    return QuantDense(q, s), num / den


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` in storage of its own (a copy on the CPU too,
    so that a released leaf never shares the storage it left)."""
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu")
    out.copy_(t)
    return out


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
    """Deterministic calibration batch from numpy seed 0, on the host (the
    build step moves it to the model's device; its forward passes are
    ``batch x seq`` tokens, so the build's activations stay small at any
    width). The JAX package draws its default batch with ``jax.random``,
    so the two defaults differ; pass ``calib_tokens`` to compare the two
    builds."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))


# vocabulary rows the calibration argmax casts to f32 at a time:
# gemma2-27b's 16384 x 4608 slice is 302 MB where its whole tied table
# would be 4.7 GB
ARGMAX_SLICE_ROWS = 16384


def sliced_argmax(h: torch.Tensor, table: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """``torch.argmax`` over the first ``vocab`` columns of the f32 logits
    ``h @ table.T`` without an f32 copy of ``table``: ``ARGMAX_SLICE_ROWS``
    rows at a time, each slice's max and its index kept while no later
    slice's max is larger, so a tie keeps the first index, as
    ``torch.argmax`` does (and a NaN wins, as there)."""
    h = h.to(torch.float32)
    best = idx = None
    for lo in range(0, vocab, ARGMAX_SLICE_ROWS):
        logits = h @ table[lo:min(lo + ARGMAX_SLICE_ROWS, vocab)].to(
            torch.float32).t()
        i = torch.argmax(logits, dim=-1)
        m = torch.gather(logits, -1, i[..., None])[..., 0]
        i = i + lo
        if best is None:
            best, idx = m, i
            continue
        take = (m > best) | (torch.isnan(m) & ~torch.isnan(best))
        best = torch.where(take, m, best)
        idx = torch.where(take, i, idx)
    return idx


def _full_argmax(params: model_mod.Model, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    h, _ = model_mod.forward(params, cfg, {"tokens": tokens}, mode="full",
                             caches=None)
    return sliced_argmax(h, model_mod.head_table(params, cfg),
                         cfg.vocab_size)


@torch.no_grad()
def build_quantized_params(cfg: ModelConfig, params: model_mod.Model, *,
                           budget: float = 0.05,
                           calib_tokens=None,
                           skip: Tuple[str, ...] = (),
                           max_iters: int = 4,
                           release_fp: bool = False) -> QuantizedParams:
    """Run the §V workflow over every dense projection site and return the
    mixed-precision params, on the device of ``params``. ``budget`` bounds
    the top-1 token disagreement vs the fp reference on the calibration
    batch; ``skip`` force-keeps named sites (substring match) fp.

    The fp reference argmax is taken first; a site is quantized when the
    workflow first reaches it, and a site that falls back drops its int8
    leaves, so the device holds ``params``, the int8 sites made so far
    and one leaf's f32 transients.

    ``release_fp=False`` (the default) leaves ``params`` as it was, whole
    on its device: an fp engine or a mixed fleet can go on serving it
    beside the result. ``release_fp=True`` CHANGES ``params``: each fp
    weight of a site moves to the host as soon as it is quantized (in
    ``params``' own Parameter objects, which then hold host copies), and
    a site that falls back moves back to the device. On return ``params``
    holds every int8-decided site's fp weights on the host and the rest
    on its device, so the device holds the result alone;
    ``params.to(device)`` brings the fp model back. The device's peak is
    ``params`` plus one leaf's int8 form and f32 transients. An fp engine
    refuses a model left so (``InferenceEngine`` checks every leaf's
    device)."""
    dev = model_mod.model_device(params)
    if calib_tokens is None:
        calib_tokens = default_calib_tokens(cfg)
    calib_tokens = torch.as_tensor(calib_tokens).to(dev)
    sites = _collect_sites(params, cfg)
    sites = {n: loc for n, loc in sites.items()
             if not any(s in n for s in skip)}

    def leaves_of(name) -> List[nn.Parameter]:
        _, _, mod, wname, layers = sites[name]
        return [getattr(getattr(params.layers[l], mod), wname)
                for l in layers]

    # the fp reference, before any fp leaf leaves the device
    ref_argmax = _full_argmax(params, cfg, calib_tokens)
    quantized: Dict[str, List[QuantDense]] = {}
    errors: Dict[str, float] = {}

    def quantize_site(name) -> None:
        if name in quantized:
            return
        leaves, errs = [], []
        for p in leaves_of(name):
            leaf, err = _quantize_leaf(p, sites[name][3])
            leaves.append(leaf)
            errs.append(err)
            if release_fp:
                p.data = _to_host(p.data)
        quantized[name] = leaves
        errors[name] = float(torch.stack(errs).max())

    def settle(schemes: Dict[str, str]) -> None:
        """Each int8 site quantized; each fall-back site's int8 leaves
        dropped and its fp weights on the device."""
        for name, scheme in schemes.items():
            if scheme == "int8":
                quantize_site(name)
                continue
            quantized.pop(name, None)
            for p in leaves_of(name):
                if p.device != dev:
                    p.data = p.data.to(dev)

    def eval_metric(schemes: Dict[str, str]) -> float:
        settle(schemes)
        qp = materialize(params, cfg, schemes, quantized)
        qa = _full_argmax(qp, cfg, calib_tokens)
        return float(torch.mean((qa != ref_argmax).to(torch.float32)))

    def site_error(name, _w):
        quantize_site(name)
        return errors[name]

    result = quantization_workflow(
        {n: leaves_of(n) for n in sites}, eval_metric, budget=budget,
        layer_error_fn=site_error, max_iters=max_iters)
    schemes = {d.name: d.scheme for d in result.decisions}
    settle(schemes)
    final = materialize(params, cfg, schemes, quantized)
    if release_fp and dev.type == "cuda":
        # hand the released leaves' blocks back before the serve's caches
        # and graphs allocate
        gc.collect()
        torch.cuda.empty_cache()
    n_int8 = sum(d.scheme == "int8" for d in result.decisions)
    return QuantizedParams(final, result, n_int8,
                           len(result.decisions) - n_int8)

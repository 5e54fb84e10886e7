"""Carry JAX parameters and KV caches across to the port, and back.

The JAX package stacks the parameters of its repeating layer unit along a
leading ``repeats`` axis (``params["scan"]``, one stacked dict per unit
position) plus an unrolled ``params["tail"]``; the port has one module per
layer. Layer ``r * len(unit) + i`` is ``scan[i]`` at index ``r``, then the
tail. Block dicts use the same names as the port's modules, so a flattened
JAX path is the port's ``state_dict`` key. That holds for quantized
weights too: the JAX leaf ``{"q8": (K,N) int8, "scale": (N,) f32}`` is the
port's ``QuantDense`` module with buffers ``q8`` and ``scale`` (``q8``
keeps its logical (K,N) shape; the port stores it column-major). The
int8 KV cache's ``k_scale``/``v_scale`` carry across like ``k``/``v``.
DLRM parameters are a plain dict on both sides (``dlrm_params_from_jax``).

Takes and gives numpy arrays only (``jax.tree.map(np.asarray, tree)`` on
the caller's side): this module imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantDense, set_quantized
from repro_torch.models import model as model_mod


def _to_torch(a) -> torch.Tensor:
    """A writable copy (the port updates caches in place; arrays that JAX
    hands out are read-only)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":             # ml_dtypes bfloat16: exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _per_layer(tree: Dict[str, Any], cfg: ModelConfig) -> List[Any]:
    """{"scan": (stacked unit dicts...), "tail": (dicts...)} -> one tree
    per layer, in layer order."""
    unit, repeats, _ = cfg.scan_plan()

    def index(t, r):
        if isinstance(t, dict):
            return {k: index(v, r) for k, v in t.items()}
        return t[r]

    out = [index(tree["scan"][i], r)
           for r in range(repeats) for i in range(len(unit))]
    return out + list(tree["tail"])


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy (f32 for bf16, which numpy lacks)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack_layers(per_layer: List[Dict[str, Any]], cfg: ModelConfig
                  ) -> Dict[str, Any]:
    """One tree per layer -> {"scan": stacked unit dicts, "tail": ...}
    (the inverse of ``_per_layer``)."""
    unit, repeats, tail = cfg.scan_plan()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    n_scan = repeats * len(unit)
    scan = tuple(stack([per_layer[r * len(unit) + i] for r in range(repeats)])
                 for i in range(len(unit)))
    return {"scan": scan,
            "tail": tuple(per_layer[n_scan:n_scan + len(tail)])}


def _nest(flat: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries of ``flat`` under ``prefix`` as a nested dict."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v
    return out


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> model_mod.Model:
    """The JAX package's ``init_params`` tree, or the ``params`` of its
    ``build_quantized_params`` (as numpy) -> the port's model on
    ``device``, bit-identical weights."""
    flat: Dict[str, Any] = {}
    for key in ("embed", "lm_head"):
        if key in np_tree:
            flat[key] = np_tree[key]
    _flatten(np_tree["final_norm"], "final_norm.", flat)
    for l, layer in enumerate(_per_layer(np_tree, cfg)):
        _flatten(layer, f"layers.{l}.", flat)
    model = model_mod.Model(cfg, torch.Generator(device=device), device)
    for key, val in flat.items():
        if key.endswith(".q8"):                   # a quantized site
            path, wname = key[:-len(".q8")].rsplit(".", 1)
            set_quantized(model.get_submodule(path), wname,
                          QuantDense.empty(*val.shape, device))
    model.load_state_dict({k: _to_torch(v) for k, v in flat.items()})
    return model


def params_to_jax(model: model_mod.Model, cfg: ModelConfig
                  ) -> Dict[str, Any]:
    """The port's model (quantized sites included) -> the JAX package's
    parameter tree as numpy (f32 for bf16 weights)."""
    flat = {k: _host(v) for k, v in model.state_dict().items()}
    tree = _stack_layers([_nest(flat, f"layers.{l}.")
                          for l in range(cfg.num_layers)], cfg)
    tree["final_norm"] = _nest(flat, "final_norm.")
    for key in ("embed", "lm_head"):
        if key in flat:
            tree[key] = flat[key]
    return tree


def caches_from_jax(np_caches: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> List[Dict[str, torch.Tensor]]:
    """The JAX package's cache tree (as numpy) -> one K/V dict per layer."""
    return [{k: _to_torch(v).to(device) for k, v in layer.items()}
            for layer in _per_layer(np_caches, cfg)]


def caches_to_jax(caches: List[Dict[str, torch.Tensor]],
                  cfg: ModelConfig) -> Dict[str, Any]:
    """One K/V dict per layer -> the JAX package's cache tree (numpy, f32
    for bf16 caches)."""
    return _stack_layers([{name: _host(t) for name, t in c.items()}
                          for c in caches], cfg)


def dlrm_params_from_jax(np_tree: Dict[str, Any],
                         device="cuda") -> Dict[str, Any]:
    """The JAX package's ``init_dlrm`` tree (as numpy) -> the port's DLRM
    parameters on ``device``: ``slab`` (R,D) f32, or ``slab_q`` with
    ``q8`` (R,D) or ``q4`` (R,D/2) uint8 and fp16 ``scale``/``bias``
    (R,), plus the ``bottom`` and ``top`` MLP layers (``w``, ``b``).
    Bit-identical values."""
    if ("slab" in np_tree) == ("slab_q" in np_tree):
        raise ValueError("a DLRM tree holds exactly one of slab, slab_q")
    out: Dict[str, Any] = {}
    if "slab" in np_tree:
        out["slab"] = _to_torch(np_tree["slab"]).to(device)
    else:
        sq = np_tree["slab_q"]
        qkey = "q8" if "q8" in sq else "q4"
        out["slab_q"] = {k: _to_torch(sq[k]).to(device)
                         for k in (qkey, "scale", "bias")}
    for side in ("bottom", "top"):
        out[side] = [{k: _to_torch(layer[k]).to(device) for k in ("w", "b")}
                     for layer in np_tree[side]]
    return out

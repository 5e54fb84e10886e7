"""Carry JAX parameters and KV caches across to the port, and back.

The JAX package stacks the parameters of its repeating layer unit along a
leading ``repeats`` axis (``params["scan"]``, one stacked dict per unit
position) plus an unrolled ``params["tail"]``; the port has one module per
layer. Layer ``r * len(unit) + i`` is ``scan[i]`` at index ``r``, then the
tail. Block dicts use the same names as the port's modules, so a flattened
JAX path is the port's ``state_dict`` key: a MoE block's ``moe`` leaves
too (``router``, the experts' ``wg``/``wu``/``wd`` with the padded
experts' rows, ``shared``). That holds for quantized
weights too: the JAX leaf ``{"q8": (K,N) int8, "scale": (N,) f32}`` is the
port's ``QuantDense`` module with buffers ``q8`` and ``scale`` (``q8``
keeps its logical (K,N) shape; the port stores it column-major). The
int8 KV cache's ``k_scale``/``v_scale`` carry across like ``k``/``v``.
DLRM parameters are a plain dict on both sides (``dlrm_params_from_jax``).
An enc-dec model's encoder is the JAX ``enc_scan`` (one stacked unit of
``encoder_layers`` global blocks) and ``enc_final_norm``, the port's
``enc_layers`` and ``enc_final_norm``; its cross K/V cache, the JAX
``caches["cross"]`` (stacked as the layers' caches), is each decoder
layer's ``cross_k``/``cross_v``.

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


def _per_layer(tree: Dict[str, Any], cfg: ModelConfig,
               plan=None) -> List[Any]:
    """{"scan": (stacked unit dicts...), "tail": (dicts...)} -> one tree
    per layer, in layer order (``plan``: (unit, repeats, tail), default
    ``cfg.scan_plan()``)."""
    unit, repeats, _ = plan or cfg.scan_plan()

    def index(t, r):
        if isinstance(t, dict):
            return {k: index(v, r) for k, v in t.items()}
        return t[r]

    out = [index(tree["scan"][i], r)
           for r in range(repeats) for i in range(len(unit))]
    return out + list(tree["tail"])


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as numpy (f32 for bf16, which numpy lacks): a
    view of a CPU tensor would follow the port's in-place updates."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _enc_plan(cfg: ModelConfig):
    """The JAX ``enc_scan``'s plan: one global unit, scanned over the
    encoder's layers."""
    return ("global",), cfg.encdec.encoder_layers, ()


def _stack_layers(per_layer: List[Dict[str, Any]], cfg: ModelConfig,
                  plan=None) -> Dict[str, Any]:
    """One tree per layer -> {"scan": stacked unit dicts, "tail": ...}
    (the inverse of ``_per_layer``)."""
    unit, repeats, tail = plan or cfg.scan_plan()

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
    if cfg.encdec is not None:
        _flatten(np_tree["enc_final_norm"], "enc_final_norm.", flat)
        enc = {"scan": np_tree["enc_scan"], "tail": ()}
        for l, layer in enumerate(_per_layer(enc, cfg, _enc_plan(cfg))):
            _flatten(layer, f"enc_layers.{l}.", flat)
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
    return state_to_jax(model.state_dict(), cfg)


def state_to_jax(state: Dict[str, torch.Tensor], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """Tensors keyed by the port's ``state_dict`` names (a model's, or its
    gradients by parameter name) -> the JAX package's parameter tree as
    numpy (f32 for bf16)."""
    flat = {k: _host(v) for k, v in state.items()}
    tree = _stack_layers([_nest(flat, f"layers.{l}.")
                          for l in range(cfg.num_layers)], cfg)
    tree["final_norm"] = _nest(flat, "final_norm.")
    for key in ("embed", "lm_head"):
        if key in flat:
            tree[key] = flat[key]
    if cfg.encdec is not None:
        tree["enc_scan"] = _stack_layers(
            [_nest(flat, f"enc_layers.{l}.")
             for l in range(cfg.encdec.encoder_layers)], cfg,
            _enc_plan(cfg))["scan"]
        tree["enc_final_norm"] = _nest(flat, "enc_final_norm.")
    return tree


CROSS = {"cross_k": "k", "cross_v": "v"}     # port cache key -> JAX's


def caches_from_jax(np_caches: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> List[Dict[str, torch.Tensor]]:
    """The JAX package's cache tree (as numpy) -> one K/V dict per layer
    (with its cross K/V where the tree has ``cross``)."""
    out = [{k: _to_torch(v).to(device) for k, v in layer.items()}
           for layer in _per_layer(np_caches, cfg)]
    if "cross" in np_caches:
        for c, x in zip(out, _per_layer(np_caches["cross"], cfg)):
            c.update({ours: _to_torch(x[theirs]).to(device)
                      for ours, theirs in CROSS.items()})
    return out


def caches_to_jax(caches: List[Dict[str, torch.Tensor]],
                  cfg: ModelConfig) -> Dict[str, Any]:
    """One K/V dict per layer -> the JAX package's cache tree (numpy, f32
    for bf16 caches; ``cross`` where the layers hold cross K/V)."""
    tree = _stack_layers([{name: _host(t) for name, t in c.items()
                           if name not in CROSS} for c in caches], cfg)
    if caches and "cross_k" in caches[0]:
        tree["cross"] = _stack_layers(
            [{theirs: _host(c[ours]) for ours, theirs in CROSS.items()}
             for c in caches], cfg)
    return tree


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

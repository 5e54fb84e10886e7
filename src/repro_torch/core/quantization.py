"""Paper §V quantization on torch (counterpart of
``repro/core/quantization.py``): row-wise int8/int4 embedding tables,
per-channel int8 weights, dynamic per-row int8 activations, the quantized
dense apply, and the iterative accuracy-driven workflow (quantize every
site; fall the worst back while the end metric is over budget).

A quantized dense weight is a ``QuantDense`` module holding the JAX
leaf's two arrays as buffers: ``q8`` (in, out) int8 and ``scale`` (out,)
f32, so a port ``state_dict`` key ends in ``.q8``/``.scale`` where the
JAX pytree path does. ``q8`` is stored column-major (strides (1, in)),
the layout the w8a8 kernel reads; its logical shape stays (in, out).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.w8a8.ops import kernel_layout, w8a8_matmul


# --------------------------------------------------------------------------
# Row-wise embedding-table quantization (paper: int8 + int4 mixed [18]), in
# the JAX package's order: the f32 scale divides, then scale and bias are
# stored in fp16.
# --------------------------------------------------------------------------

def _row_range(table: torch.Tensor, levels: float):
    t = table.to(torch.float32)
    mn = t.amin(dim=1, keepdim=True)
    mx = t.amax(dim=1, keepdim=True)
    scale = torch.clamp(mx - mn, min=1e-8) / levels
    q = torch.clamp(torch.round((t - mn) / scale), 0, levels)
    return q.to(torch.uint8), scale[:, 0].to(torch.float16), \
        mn[:, 0].to(torch.float16)


def quantize_rows_int8(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Asymmetric row-wise int8: q = round((x - min) / scale), scale/bias
    fp16 per row (FBGEMM fused-rowwise layout)."""
    q, scale, bias = _row_range(table, 255.0)
    return {"q8": q, "scale": scale, "bias": bias}


def dequantize_rows_int8(qt: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (qt["q8"].to(torch.float32)
            * qt["scale"].to(torch.float32)[:, None]
            + qt["bias"].to(torch.float32)[:, None])


def quantize_rows_int4(table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Row-wise int4, two values packed per uint8 (even dim required): the
    low nibble holds the even column."""
    if table.shape[1] % 2:
        raise ValueError("int4 packing needs even embed dim")
    q, scale, bias = _row_range(table, 15.0)
    return {"q4": q[:, 0::2] | (q[:, 1::2] << 4), "scale": scale,
            "bias": bias}


def dequantize_rows_int4(qt: Dict[str, torch.Tensor]) -> torch.Tensor:
    q4 = qt["q4"]
    q = torch.stack([q4 & 0xF, q4 >> 4], dim=-1).reshape(q4.shape[0], -1)
    return (q.to(torch.float32) * qt["scale"].to(torch.float32)[:, None]
            + qt["bias"].to(torch.float32)[:, None])


def quantize_rows(table: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    if bits == 8:
        return quantize_rows_int8(table)
    if bits == 4:
        return quantize_rows_int4(table)
    raise ValueError(f"unsupported embedding bits {bits}")


def dequantize_rows(qt: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (dequantize_rows_int8 if "q8" in qt else dequantize_rows_int4)(qt)


# --------------------------------------------------------------------------
# Dense w8a8
# --------------------------------------------------------------------------

class QuantDense(nn.Module):
    """A dense projection replaced by its w8a8 form."""

    def __init__(self, q8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q8", kernel_layout(q8))
        self.register_buffer("scale", scale.to(torch.float32).contiguous())

    @classmethod
    def empty(cls, k: int, n: int, device) -> "QuantDense":
        """Zeros of the right shapes, to load a state_dict into."""
        return cls(torch.zeros((k, n), dtype=torch.int8, device=device),
                   torch.zeros((n,), dtype=torch.float32, device=device))


def set_quantized(module: nn.Module, wname: str, leaf: QuantDense) -> None:
    """Put ``leaf`` where ``module`` held the fp weight ``wname``."""
    if wname in module._parameters:
        delattr(module, wname)
    setattr(module, wname, leaf)


def quantize_weight_int8(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (in, out) -> (int8 w, per-out-channel scale fp32), symmetric."""
    w = w.to(torch.float32)
    absmax = torch.clamp(w.abs().amax(dim=0), min=1e-8)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_act_int8_rowwise(x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-ROW activation quant: one symmetric absmax scale per
    row of the last axis. Returns (int8 x, f32 scales of shape
    x.shape[:-1])."""
    xf = x.to(torch.float32)
    absmax = torch.clamp(xf.abs().amax(dim=-1), min=1e-8)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def is_quantized_dense(w) -> bool:
    return isinstance(w, QuantDense)


def dense_w8a8(x: torch.Tensor, qw: QuantDense) -> torch.Tensor:
    """x (..., K) times a quantized weight (K, N) -> (..., N) in x.dtype,
    with dynamic per-row activation scales. The GEMM is the w8a8 kernel on
    the card and its exact plain version on the CPU."""
    xq, xs = quantize_act_int8_rowwise(x)
    K, N = qw.q8.shape
    y = w8a8_matmul(xq.reshape(-1, K), qw.q8, xs.reshape(-1), qw.scale)
    return y.reshape(x.shape[:-1] + (N,)).to(x.dtype)


# --------------------------------------------------------------------------
# Quantization workflow (paper §V-B), copied from the JAX package: only the
# default per-layer error is written in torch.
# --------------------------------------------------------------------------

@dataclass
class LayerQuantDecision:
    name: str
    scheme: str                 # 'int8' | 'fp16' (fallback)
    error: float                # relative per-layer error observed


@dataclass
class QuantWorkflowResult:
    decisions: List[LayerQuantDecision]
    passed: bool
    metric_delta: float
    iterations: int


def quantization_workflow(
        layers: Dict[str, torch.Tensor],
        eval_metric: Callable[[Dict[str, str]], float],
        *,
        budget: float,
        layer_error_fn: Optional[Callable[[str, torch.Tensor], float]] = None,
        max_iters: int = 8) -> QuantWorkflowResult:
    """Iteratively int8-quantize ``layers``; while the end metric delta
    exceeds ``budget``, move the highest-error layer back to fp16 (the paper:
    "use the per-layer quantization error as feedback and increase precision
    for operators that incur high quantization errors").

    ``eval_metric(schemes)`` returns the end-to-end metric degradation for a
    {layer: scheme} assignment (e.g. NE delta for DLRM).
    """
    def default_err(name, w):
        qw, s = quantize_weight_int8(w)
        deq = qw.to(torch.float32) * s
        num = torch.linalg.norm(w.to(torch.float32) - deq)
        den = torch.clamp(torch.linalg.norm(w.to(torch.float32)), min=1e-8)
        return float(num / den)

    err_fn = layer_error_fn or default_err
    errors = {n: err_fn(n, w) for n, w in layers.items()}
    schemes = {n: "int8" for n in layers}
    delta = float(eval_metric(schemes))
    iters = 0
    order = sorted(errors, key=lambda n: -errors[n])
    while delta > budget and iters < max_iters:
        # fall back the worst remaining int8 layer
        int8_left = [n for n in order if schemes[n] == "int8"]
        if not int8_left:
            break
        schemes[int8_left[0]] = "fp16"
        delta = float(eval_metric(schemes))
        iters += 1
    decisions = [LayerQuantDecision(n, schemes[n], errors[n])
                 for n in sorted(layers)]
    return QuantWorkflowResult(decisions, delta <= budget, delta, iters)

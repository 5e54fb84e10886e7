"""Plain PyTorch version of the w8a8 GEMM: the same function as the CUDA
kernel in ``csrc/w8a8.cu``. The wrapper runs it for CPU tensors;
``chip_smoke.py`` holds the kernel against it on the card, bit for bit.

The int8 products are summed in float64, which is exact here (each
product is at most 127 * 127 and a sum stays far below 2^53 for any K the
model has), so the sum equals the kernel's int32 sum. float32 would not
do: 127 * 127 * 11008 is about 1.8e8, above 2^24. (PyTorch has no int32
matrix product on the card, and float64 works on both devices.)
"""
from __future__ import annotations

import torch


def w8a8_ref(xq: torch.Tensor, wq: torch.Tensor, x_scale,
             w_scale: torch.Tensor) -> torch.Tensor:
    """xq (M,K) int8, wq (K,N) int8 (any strides), x_scale scalar or
    (M,)/(M,1) f32 per-row activation scales, w_scale (N,) f32 -> (M,N)
    f32: exact integer sum, then ``float(acc) * xs * ws`` in that order."""
    acc = xq.double() @ wq.double()
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=xq.device)
    if xs.dim():
        xs = xs.reshape(-1, 1)
    return acc.float() * xs * w_scale.float()[None, :]

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
    return _dequant(xq.double() @ wq.double(), x_scale, w_scale)


def _dequant(acc: torch.Tensor, x_scale, w_scale: torch.Tensor):
    """``float(acc) * xs * ws``, in that order."""
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device)
    if xs.dim():
        xs = xs.reshape(-1, 1)
    return acc.float() * xs * w_scale.float()[None, :]


def k_slices(K: int, split: int):
    """The K slices of the decode-rows kernel's split (K a multiple of 16):
    slice r is [k16*r//split, k16*(r+1)//split) in 16-byte units, k16 =
    K/16, as ``csrc/w8a8.cu::w8a8_splitk_kernel`` cuts it."""
    k16 = K // 16
    return [(k16 * r // split * 16, k16 * (r + 1) // split * 16)
            for r in range(split)]


def w8a8_split_ref(xq: torch.Tensor, wq: torch.Tensor, x_scale,
                   w_scale: torch.Tensor, split: int) -> torch.Tensor:
    """``w8a8_ref`` computed as the decode-rows kernel does: one exact
    partial sum per K slice (``k_slices``), the partials added, then the
    same epilogue. Integer sums make the order irrelevant, so it equals
    ``w8a8_ref`` bit for bit."""
    acc = sum(xq[:, k0:k1].double() @ wq[k0:k1].double()
              for k0, k1 in k_slices(xq.shape[1], split))
    return _dequant(acc, x_scale, w_scale)

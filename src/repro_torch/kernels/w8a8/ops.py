"""Wrapper of the w8a8 GEMM kernel (``csrc/w8a8.cu``).

``w8a8_matmul`` checks its inputs, then launches the CUDA kernel for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors. There is
no fallback: a CUDA input the kernel cannot take raises.
``w8a8_matmul.launches`` counts kernel launches (plain-version calls do not
count).

The weight is the logical (K,N) int8 matrix. The kernel reads it
K-contiguous, so on the card it must be stored column-major: strides
(1, K), which is ``kernel_layout(wq)`` (a (K,N) view of an (N,K)
row-major tensor). The port's quantized weights are stored so.

Decode rows (M <= 16, K % 16 == 0) run the split-K kernel: ``splitk_plan``
picks how many K slices (``ref.k_slices``) it cuts K into, from N, K and
the card's SM count, and passes it to the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w8a8.ref import w8a8_ref

# w8a8_matmul_fwd(xq, wq_t, xs, ws, out, M, N, K, split, stream) in
# csrc/w8a8.cu
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# the split-K kernel's geometry (csrc/w8a8.cu): weight rows per block, the
# largest split (a cluster's portable size), and the least K slice worth a
# block, bytes
SPLITK_ROWS = 64
SPLITK_MAX = 8
SPLITK_MIN_SLICE = 1024


def splitk_plan(N: int, K: int, sms: int) -> int:
    """K slices of the decode-rows kernel: as many as keep the ceil(N/64)
    weight tiles times the split within one block per SM, at least 1, at
    most 8, and none shorter than 1 KB of K (so 1 for a K of 64 or 128).
    One block of 4 warps per SM streams the weight fastest on the H100
    (``scripts/torch_decode_plans.py`` sweeps the split)."""
    tiles = -(-N // SPLITK_ROWS)
    split = sms // tiles
    return max(1, min(split, SPLITK_MAX, K // SPLITK_MIN_SLICE))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("w8a8")
    lib.w8a8_matmul_fwd.argtypes = ARGTYPES
    lib.w8a8_matmul_fwd.restype = ctypes.c_int
    return lib


def kernel_layout(wq: torch.Tensor) -> torch.Tensor:
    """The same (K,N) values stored column-major (strides (1, K))."""
    return wq.t().contiguous().t()


def w8a8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale,
                w_scale: torch.Tensor) -> torch.Tensor:
    """xq (M,K) int8, wq (K,N) int8, x_scale scalar or (M,)/(M,1) f32,
    w_scale (N,) f32 -> (M,N) f32 = float(xq @ wq) * xs * ws."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"w8a8_matmul wants xq (M,K) and wq (K,N); got "
                         f"{tuple(xq.shape)}, {tuple(wq.shape)}")
    M, K = xq.shape
    N = wq.shape[1]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"w8a8_matmul takes int8 xq and wq; got {xq.dtype}, "
                         f"{wq.dtype}")
    if w_scale.shape != (N,):
        raise ValueError(f"w8a8_matmul: w_scale must be ({N},); got "
                         f"{tuple(w_scale.shape)}")
    if not (xq.device == wq.device == w_scale.device):
        raise ValueError("w8a8_matmul: xq, wq and w_scale must be on one "
                         "device")
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=xq.device)
    if xs.numel() not in (1, M) or (xs.dim() > 1 and xs.shape[0] != M):
        raise ValueError(f"w8a8_matmul: x_scale must be a scalar or ({M},); "
                         f"got {tuple(xs.shape)}")
    if xq.device.type == "cpu":
        return w8a8_ref(xq, wq, xs, w_scale)
    if xq.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: no kernel for device {xq.device}")
    if w_scale.dtype != torch.float32:
        raise ValueError(f"w8a8_matmul kernel takes float32 w_scale; got "
                         f"{w_scale.dtype}")
    if not xq.is_contiguous() or not wq.t().is_contiguous() \
            or not w_scale.is_contiguous():
        raise ValueError("w8a8_matmul kernel needs a contiguous xq and "
                         "w_scale and a column-major wq (kernel_layout)")
    xs = xs.reshape(-1).expand(M).contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = _lib()
    split = splitk_plan(N, K, _build.sm_count(xq.device.index))
    err = lib.w8a8_matmul_fwd(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), M, N, K, split,
        torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(lib, err, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0

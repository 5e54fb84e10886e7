"""Wrapper of the flash prefill kernel (``csrc/flash.cu``).

``flash_attn`` checks its inputs, then launches the CUDA kernel for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors. There is no
fallback: a CUDA input the kernel cannot take raises. ``flash_attn.launches``
counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# flash_attn_fwd(q, k, v, lens, o, B, S, T, H, K, hd, causal, window,
#                softcap, dtype, stream) in csrc/flash.cu
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash")
    lib.flash_attn_fwd.argtypes = ARGTYPES
    lib.flash_attn_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, lens):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attn wants q (B,S,H,hd) and k, v (B,T,K,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attn: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)} (H must be a multiple of K)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attn: q, k and v must be on one device")
    if lens is not None and (lens.shape != (B,) or lens.dtype != torch.int32
                             or lens.device != q.device):
        raise ValueError(f"flash_attn: lens must be ({B},) int32 on "
                         f"{q.device}; got {tuple(lens.shape)} {lens.dtype} "
                         f"on {lens.device}")


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lens: Optional[torch.Tensor] = None, *, causal: bool = True,
               window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,hd); k,v (B,T,K,hd); lens (B,) int32 valid key count
    (default T) -> (B,S,H,hd) in q.dtype."""
    _check(q, k, v, lens)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, lens, causal=causal,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn: no kernel for device {q.device}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attn kernel takes float32 or bfloat16 q, k, "
                         f"v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attn kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attn kernel needs contiguous q, k, v")
    if lens is None:
        lens = torch.full((B,), T, dtype=torch.int32, device=q.device)
    lens = lens.contiguous()
    o = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        o.data_ptr(), B, S, T, H, K, hd, int(causal), int(window),
        float(softcap), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attn")
    flash_attn.launches += 1
    return o


flash_attn.launches = 0

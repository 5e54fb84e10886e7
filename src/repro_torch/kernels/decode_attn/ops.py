"""Wrapper of the flash decode kernel (``csrc/decode.cu``).

``decode_attn`` checks its inputs, then launches the CUDA kernel for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors. There is no
fallback: a CUDA input the kernel cannot take raises. ``decode_attn.launches``
counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8          # query heads per kv head held in registers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# decode_attn_fwd(q, k, v, pos, o, B, S, H, K, hd, softcap, dtype, stream)
# in csrc/decode.cu
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode")
    lib.decode_attn_fwd.argtypes = ARGTYPES
    lib.decode_attn_fwd.restype = ctypes.c_int
    return lib


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: Union[int, torch.Tensor], *,
                softcap: float = 0.0) -> torch.Tensor:
    """q (B,H,hd); k,v (B,S,K,hd); pos (B,) int32 per-row position, or a
    scalar for every row (row b attends keys [0, pos[b]]) -> (B,H,hd) f32."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attn wants q (B,H,hd) and k, v (B,S,K,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"decode_attn: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)} (H must be a multiple of K)")
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attn: q, k and v must be on one device")
    if not isinstance(pos, torch.Tensor) or pos.dim() == 0:
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=q.device)
    if pos.shape != (B,) or pos.dtype != torch.int32 \
            or pos.device != q.device:
        raise ValueError(f"decode_attn: pos must be ({B},) int32 on "
                         f"{q.device}; got {tuple(pos.shape)} {pos.dtype} "
                         f"on {pos.device}")
    if q.device.type == "cpu":
        return decode_attn_ref(q, k, v, pos, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"decode_attn kernel takes float32 or bfloat16 q, "
                         f"k, v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if hd not in HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"decode_attn kernel takes head_dim in {HEAD_DIMS} "
                         f"and at most {MAX_GROUP} query heads per kv head; "
                         f"got head_dim {hd}, group {H // K}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attn kernel needs contiguous q, k, v")
    pos = pos.contiguous()
    o = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.decode_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), B, S, H, K, hd, float(softcap), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attn")
    decode_attn.launches += 1
    return o


decode_attn.launches = 0

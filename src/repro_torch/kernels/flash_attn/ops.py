"""Wrapper of the flash prefill kernel (``csrc/flash.cu``).

``flash_attn`` checks its inputs, then launches the CUDA kernel for CUDA
tensors, or runs the plain version (``ref.py``) for CPU tensors. There is no
fallback: a CUDA input the kernel cannot take raises. The kernel has no
backward and writes its output outside autograd, so a CUDA q, k or v that
requires grad, under grad mode, raises too (training takes
``models/attention.py::dense_attention``); the plain version on the CPU is
differentiable and runs as before. ``flash_attn.launches``
counts kernel launches (plain-version calls do not count),
``flash_attn.offset_launches`` those of them given a ``q_off`` (the model's
chunk path always passes one, so that a chunk stage's launch does not
depend on its offsets' values), ``flash_attn.window_launches`` those
given a sliding window (a local layer's) and
``flash_attn.noncausal_launches`` those with ``causal=False`` (an
encoder's).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# flash_attn_fwd(q, k, v, lens, q_off, kv_rows, o, B, Bk, S, T, H, K, hd,
#                causal, window, softcap, dtype, stream) in csrc/flash.cu
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash")
    lib.flash_attn_fwd.argtypes = ARGTYPES
    lib.flash_attn_fwd.restype = ctypes.c_int
    return lib


def _check(q, k, v, lens, q_off, kv_rows):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attn wants q (B,S,H,hd) and k, v "
                         f"(Bk,T,K,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if (kv_rows is None and k.shape[0] != B) or k.shape[3] != hd \
            or H % k.shape[2]:
        raise ValueError(f"flash_attn: k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)} (H must be a multiple of K, "
                         f"and without kv_rows k's batch must be q's)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attn: q, k and v must be on one device")
    for name, t in (("lens", lens), ("q_off", q_off), ("kv_rows", kv_rows)):
        if t is not None and (t.shape != (B,) or t.dtype != torch.int32
                              or t.device != q.device):
            raise ValueError(f"flash_attn: {name} must be ({B},) int32 on "
                             f"{q.device}; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lens: Optional[torch.Tensor] = None, *, causal: bool = True,
               window: int = 0, softcap: float = 0.0,
               q_off: Optional[torch.Tensor] = None,
               kv_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,S,H,hd); k,v (Bk,T,K,hd); lens (B,) int32 valid key count
    (default T) -> (B,S,H,hd) in q.dtype.

    ``q_off`` (B,) int32: query i of row b sits at absolute position
    ``q_off[b] + i`` (default 0); the causal mask and the window count from
    there, so a prefill chunk attends the keys its row's cache already
    holds. ``kv_rows`` (B,) int32: row b reads K/V row ``kv_rows[b]`` of
    ``k``/``v`` (default b), so a chunk group reads the engine's whole
    cache in place; a row outside [0, Bk) reads no key and gives 0."""
    _check(q, k, v, lens, q_off, kv_rows)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, lens, causal=causal,
                                   window=window, softcap=softcap,
                                   q_off=q_off, kv_rows=kv_rows)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_attn: the CUDA kernel has no backward, so q, k and v "
            "that require grad would get no gradient; train through "
            "models.attention.dense_attention (model.forward mode 'train', "
            "which model.loss_fn takes), or call this under torch.no_grad()")
    B, S, H, hd = q.shape
    Bk, T, K = k.shape[:3]
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
    o = torch.empty_like(q)
    lib = _lib()
    # absent q_off / kv_rows go to the kernel as null pointers: offset 0,
    # row b
    err = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.contiguous().data_ptr(),
        None if q_off is None else q_off.contiguous().data_ptr(),
        None if kv_rows is None else kv_rows.contiguous().data_ptr(),
        o.data_ptr(), B, Bk, S, T, H, K, hd, int(causal), int(window),
        float(softcap), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attn")
    flash_attn.launches += 1
    flash_attn.offset_launches += q_off is not None
    flash_attn.window_launches += window > 0
    flash_attn.noncausal_launches += not causal
    return o


flash_attn.launches = 0
flash_attn.offset_launches = 0
flash_attn.window_launches = 0
flash_attn.noncausal_launches = 0

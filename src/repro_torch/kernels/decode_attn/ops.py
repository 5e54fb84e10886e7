"""Wrappers of the flash decode kernels: ``decode_attn`` over an fp cache
(``csrc/decode.cu``) and ``decode_attn_int8`` over an int8 cache with fp16
scales (``csrc/decode_int8.cu``).

Each checks its inputs, then launches its CUDA kernel for CUDA tensors, or
runs its plain version (``ref.py``) for CPU tensors. There is no fallback:
a CUDA input the kernel cannot take raises. ``decode_attn.launches`` and
``decode_attn_int8.launches`` count kernel launches (plain-version calls do
not count).

Both kernels split S (``csrc/decode_split.cuh``): ``chunk_plan`` picks the
keys per block from the bytes of a K row and the block's shared memory
(``smem_bytes``: the K/V rows and the group's f32 accumulators;
``ref.row_chunks`` are the chunks a row reads), and rows of more than one
chunk merge their chunks through an f32 scratch allocated per call: in the
same launch, by the block that draws the last of one int32 ticket counter
per (row, kv head), or, where a row's records could pass 12 KB (gemma2-27b's
and gemma-2b's decode), in a second kernel of the same call (one launch
counted; ``scripts/torch_decode_merge.py`` times both merges). The two
kernels share the counters: they are
allocated zeroed once per device and every launch of either kernel leaves
them zero (a replayed CUDA graph's launches too), so launches that run in
turn on one stream (the engine's) share them; two launches that run at
once on different streams must not. The replicas of a fleet on one card
share them too: the router steps its replicas in turn, every stage on the
current stream (``serving/router.py``), so their launches never overlap.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import (decode_attn_int8_ref,
                                                 decode_attn_ref)

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16         # query heads per kv head (8 at a time in registers)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# decode_attn_fwd(q, k, v, pos, o, part, ticket, B, S, H, K, hd, chunk,
#                 softcap, dtype, stream) in csrc/decode.cu
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


# decode_attn_int8_fwd(q, kq, k_scale, vq, v_scale, pos, o, part, ticket, B,
#                      S, H, K, hd, chunk, softcap, dtype, stream) in
# csrc/decode_int8.cu
ARGTYPES_INT8 = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

CHUNK_MIN, CHUNK_MAX = 64, 256      # keys per block
# the names the int8 kernel's callers know them by
INT8_CHUNK_MIN, INT8_CHUNK_MAX = CHUNK_MIN, CHUNK_MAX
BLOCKS_PER_SM = 16
CHUNK_SMEM = 160 * 1024   # bytes of K and V rows a block may hold
CARD_SMEM = 227 * 1024    # a block's dynamic shared memory on the H100
SMEM_PAD = 16             # bytes after each K/V row in shared memory


def chunk_warps(chunk: int) -> int:
    """Warps a block of a ``chunk``-key chunk has (``csrc/decode_split.cuh``
    ``chunk_warps``): 4 at 64-key chunks, 8 from 128 keys on."""
    return 4 if chunk % 128 else 8


def smem_bytes(row_bytes: int, hd: int, group: int, chunk: int) -> int:
    """Dynamic shared memory of one block (``csrc/decode_split.cuh``
    ``smem_bytes``): the chunk's K and V rows padded by 16 bytes, then the
    group's q and each warp's (acc, m, l) in f32."""
    return 2 * chunk * (row_bytes + SMEM_PAD) + 4 * (
        group * hd + chunk_warps(chunk) * group * (hd + 2))


def chunk_plan(B: int, K: int, S: int, sms: int, hd: int, elem_bytes: int,
               group: int) -> int:
    """Keys per block of the split-S decode kernels, for K/V rows of ``hd``
    elements of ``elem_bytes`` bytes (1 int8, 2 bf16, 4 f32) and ``group``
    query heads per kv head: 64, doubled (up to 256) while the grid of K *
    B * ceil(S/chunk) blocks would hold more than 16 per SM for rows of up
    to 128 bytes, and proportionally fewer for wider rows (8 at 256 bytes,
    4 at 512, 2 at 1024), which bounds the scratch, the records one merge
    reads and the blocks the card cannot hold at once; and while the
    doubled chunk's K and V rows (2 * chunk * (row bytes + 16) in shared
    memory) stay within 160 KB and its whole block (``smem_bytes``, the
    group's accumulators included) within the card's 227 KB. (hd 256 at G
    16 keeps 64 keys: 150 KB in bf16, 215 KB in f32; 128 keys on 8 warps
    would take 283 KB in bf16.)"""
    row_bytes = hd * elem_bytes
    per_sm = BLOCKS_PER_SM * 128 // max(row_bytes, 128)
    chunk = CHUNK_MIN
    while chunk < CHUNK_MAX \
            and B * K * -(-S // chunk) > per_sm * sms \
            and 2 * 2 * chunk * (row_bytes + SMEM_PAD) <= CHUNK_SMEM \
            and smem_bytes(row_bytes, hd, group, 2 * chunk) <= CARD_SMEM:
        chunk *= 2
    return chunk


def int8_chunk_plan(B: int, K: int, S: int, sms: int, hd: int,
                    group: int) -> int:
    """``chunk_plan`` of the int8 kernel (1-byte elements)."""
    return chunk_plan(B, K, S, sms, hd, 1, group)


_TICKETS = {}
# counters a larger buffer replaced: a captured CUDA graph may still point
# at them, so they are never freed
_RETIRED = []


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters on ``device``, zero between
    launches (allocated zeroed once, grown when a call needs more; never
    while a CUDA graph is being captured, since the zeroing would only run
    at replay: a stage's eager warm-up sizes them first)."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"decode ticket counters: {n} needed during a "
                               f"CUDA graph capture; run the stage once "
                               f"before capturing it")
        if t is not None:
            _RETIRED.append(t)
        t = _TICKETS[device] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                           device=device)
    return t


def _scratch(B: int, H: int, K: int, S: int, hd: int, chunk: int, device):
    """The f32 scratch of a split-S launch: one (acc, m, l) record of
    G * (hd + 4) floats per (row, kv head, chunk); None when every row fits
    one chunk."""
    n_chunks = -(-S // chunk)
    if n_chunks == 1:
        return None
    return torch.empty(B * K * n_chunks * (H // K) * (hd + 4),
                       dtype=torch.float32, device=device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode")
    lib.decode_attn_fwd.argtypes = ARGTYPES
    lib.decode_attn_fwd.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_int8() -> ctypes.CDLL:
    lib = _build.load("decode_int8")
    lib.decode_attn_int8_fwd.argtypes = ARGTYPES_INT8
    lib.decode_attn_int8_fwd.restype = ctypes.c_int
    return lib


def _row_pos(pos, B: int, device, name: str) -> torch.Tensor:
    """``pos`` as a (B,) int32 tensor on ``device`` (a scalar broadcasts)."""
    if not isinstance(pos, torch.Tensor) or pos.dim() == 0:
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=device)
    if pos.shape != (B,) or pos.dtype != torch.int32 \
            or pos.device != device:
        raise ValueError(f"{name}: pos must be ({B},) int32 on {device}; "
                         f"got {tuple(pos.shape)} {pos.dtype} on "
                         f"{pos.device}")
    return pos.contiguous()


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
    pos = _row_pos(pos, B, q.device, "decode_attn")
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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attn kernel needs k and v at 16-byte aligned "
                         "addresses")
    o = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    chunk = chunk_plan(B, K, S, _build.sm_count(q.device.index), hd,
                       k.element_size(), H // K)
    part = _scratch(B, H, K, S, hd, chunk, q.device)
    lib = _lib()
    err = lib.decode_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), None if part is None else part.data_ptr(),
        _tickets(q.device, B * K).data_ptr(), B, S, H, K, hd, chunk,
        float(softcap), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attn")
    decode_attn.launches += 1
    return o


decode_attn.launches = 0


def decode_attn_int8(q: torch.Tensor, kq: torch.Tensor, k_scale: torch.Tensor,
                     vq: torch.Tensor, v_scale: torch.Tensor,
                     pos: Union[int, torch.Tensor], *,
                     softcap: float = 0.0) -> torch.Tensor:
    """q (B,H,hd); kq, vq (B,S,K,hd) int8; k_scale, v_scale (B,S,K) fp16;
    pos (B,) int32 or a scalar (row b attends keys [0, pos[b]]) -> (B,H,hd)
    f32."""
    if q.dim() != 3 or kq.dim() != 4 or kq.shape != vq.shape \
            or k_scale.shape != kq.shape[:3] \
            or v_scale.shape != kq.shape[:3]:
        raise ValueError(f"decode_attn_int8 wants q (B,H,hd), kq, vq "
                         f"(B,S,K,hd) and scales (B,S,K); got "
                         f"{tuple(q.shape)}, {tuple(kq.shape)}, "
                         f"{tuple(vq.shape)}, {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)}")
    B, H, hd = q.shape
    S, K = kq.shape[1], kq.shape[2]
    if kq.shape[0] != B or kq.shape[3] != hd or H % K:
        raise ValueError(f"decode_attn_int8: kq {tuple(kq.shape)} does not "
                         f"match q {tuple(q.shape)} (H must be a multiple of "
                         f"K)")
    if len({t.device for t in (q, kq, k_scale, vq, v_scale)}) != 1:
        raise ValueError("decode_attn_int8: q, the cache and its scales must "
                         "be on one device")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8 \
            or k_scale.dtype != torch.float16 \
            or v_scale.dtype != torch.float16:
        raise ValueError(f"decode_attn_int8 takes int8 kq, vq and float16 "
                         f"scales; got {kq.dtype}, {vq.dtype}, "
                         f"{k_scale.dtype}, {v_scale.dtype}")
    pos = _row_pos(pos, B, q.device, "decode_attn_int8")
    if q.device.type == "cpu":
        return decode_attn_int8_ref(q, kq, k_scale, vq, v_scale, pos,
                                    softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn_int8: no kernel for device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attn_int8 kernel takes a float32 or "
                         f"bfloat16 q; got {q.dtype}")
    if hd not in HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"decode_attn_int8 kernel takes head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per kv head; got head_dim {hd}, group {H // K}")
    if not all(t.is_contiguous() for t in (q, kq, k_scale, vq, v_scale)):
        raise ValueError("decode_attn_int8 kernel needs contiguous q, cache "
                         "and scales")
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("decode_attn_int8 kernel needs kq and vq at 16-byte "
                         "aligned addresses")
    o = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    chunk = int8_chunk_plan(B, K, S, _build.sm_count(q.device.index), hd,
                            H // K)
    part = _scratch(B, H, K, S, hd, chunk, q.device)
    lib = _lib_int8()
    err = lib.decode_attn_int8_fwd(
        q.data_ptr(), kq.data_ptr(), k_scale.data_ptr(), vq.data_ptr(),
        v_scale.data_ptr(), pos.data_ptr(), o.data_ptr(),
        None if part is None else part.data_ptr(),
        _tickets(q.device, B * K).data_ptr(), B, S, H, K, hd, chunk,
        float(softcap), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attn_int8")
    decode_attn_int8.launches += 1
    return o


decode_attn_int8.launches = 0

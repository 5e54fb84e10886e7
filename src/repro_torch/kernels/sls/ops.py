"""Wrappers of the SLS (embedding-bag) kernels of ``csrc/sls.cu``: ``sls``
over an fp32 table, ``sls_int8`` over a row-wise int8 table and
``sls_int4`` over a packed int4 table, each with fp16 per-row scale and
bias when quantized.

Each checks its inputs, then launches its CUDA kernel for CUDA tensors, or
runs its plain version (``ref.py``) for CPU tensors. There is no fallback:
a CUDA input the kernel cannot take raises. ``sls.launches``,
``sls_int8.launches`` and ``sls_int4.launches`` count kernel launches
(plain-version calls do not count).

A bag reads only its first ``lengths[b]`` indices; one of those outside
[0, R) reads nothing and makes the bag NaN, in the kernels and the plain
versions alike.

``lane_plan`` picks the kernel's lane loads (16 bytes where the row size and
the table's address allow) and with them the number of lane groups that
split a bag: the kernel adds each group's lookups in the order of l and the
groups' partial sums in group order, which the plain versions compute with
``groups=`` (``ref.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sls.ref import sls_int4_ref, sls_int8_ref, sls_ref

# sls_fp_fwd(table, indices, lengths, out, NB, L, D, R, vec, unroll, stream)
# in csrc/sls.cu
ARGTYPES_FP = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# sls_int8_fwd / sls_int4_fwd(q, scale, bias, indices, lengths, out, NB, L, D,
#                             R, vec, unroll, stream)
ARGTYPES_Q = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
INT_MAX = 2**31 - 1
COLUMNS_PER_BYTE = {"sls_fp_fwd": 0.25, "sls_int8_fwd": 1.0,
                    "sls_int4_fwd": 2.0}
UNROLLS = (2, 4, 8)     # row loads a lane may issue before it adds any
ROWS_IN_FLIGHT = 8      # a warp's row loads in flight, at least, by the plan
MAX_COLUMNS = 16        # output columns a lane may hold


def bag_groups(row_bytes: int, vec: int) -> int:
    """The rows one warp load reads at ``vec`` bytes a lane: 32 // (lanes a
    row takes), 1 for a row of more than 32 lanes (which takes passes of
    32)."""
    lanes = row_bytes // vec
    return 32 // lanes if lanes <= 32 else 1


def lane_plan(row_bytes: int, elem: int, address: int,
              columns_per_byte: float = 1.0) -> tuple:
    """(vec, groups, unroll) of the SLS kernel for rows of ``row_bytes``
    bytes of ``elem``-byte elements in a table at ``address``, holding
    ``columns_per_byte`` output columns a byte (1/4 fp32, 1 int8, 2
    int4): ``vec``, the bytes a lane loads of a row, is the widest of 16,
    8, 4, 2, 1 (at least ``elem``) that divides the row size and the
    address and leaves a lane at most 16 columns to sum (int4 stops at 8
    bytes); ``groups`` is ``bag_groups``; ``unroll``, the row loads each
    lane issues before it adds any, is the fewest of 2, 4, 8 that keep 8
    rows in flight a warp, or 8 (registers are what a row in flight costs,
    and fewer of them keep more bags resident). At D=96: fp32 16 bytes, 1
    group, unroll 8; int8 16 bytes, 5 groups, unroll 2; int4 8 bytes, 5
    groups, unroll 2."""
    vec = next(w for w in (16, 8, 4, 2, 1)
               if w >= elem and w * columns_per_byte <= MAX_COLUMNS
               and row_bytes % w == 0 and address % w == 0)
    groups = bag_groups(row_bytes, vec)
    unroll = next((u for u in UNROLLS if groups * u >= ROWS_IN_FLIGHT),
                  UNROLLS[-1])
    return vec, groups, unroll


def table_plan(entry: str, table) -> tuple:
    """``lane_plan`` of the kernel entry ``entry`` (``sls_fp_fwd``,
    ``sls_int8_fwd`` or ``sls_int4_fwd``) over ``table``, its fp32 or
    uint8 table."""
    elem = 4 if entry == "sls_fp_fwd" else 1    # bytes of a table element
    return lane_plan(table.shape[1] * elem, elem, table.data_ptr(),
                     COLUMNS_PER_BYTE[entry])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("sls")
    for fn, types in ((lib.sls_fp_fwd, ARGTYPES_FP),
                      (lib.sls_int8_fwd, ARGTYPES_Q),
                      (lib.sls_int4_fwd, ARGTYPES_Q)):
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _check_bags(name: str, indices: torch.Tensor, lengths: torch.Tensor,
                device) -> None:
    if indices.dim() != 2 or lengths.shape != (indices.shape[0],):
        raise ValueError(f"{name} wants indices (NB,L) and lengths (NB,); got "
                         f"{tuple(indices.shape)}, {tuple(lengths.shape)}")
    if indices.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 indices and lengths; got "
                         f"{indices.dtype}, {lengths.dtype}")
    if not (indices.device == lengths.device == device):
        raise ValueError(f"{name}: the table, indices and lengths must be on "
                         f"one device")


def _check_q(name: str, q, scale, bias) -> None:
    if q.dim() != 2 or q.dtype != torch.uint8 or 0 in q.shape:
        raise ValueError(f"{name} takes a uint8 table (R,C), R, C > 0; got "
                         f"{tuple(q.shape)} {q.dtype}")
    if scale.shape != (q.shape[0],) or bias.shape != (q.shape[0],) \
            or scale.dtype != torch.float16 or bias.dtype != torch.float16:
        raise ValueError(f"{name}: scale and bias must be ({q.shape[0]},) "
                         f"float16; got {tuple(scale.shape)} {scale.dtype}, "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if not (q.device == scale.device == bias.device):
        raise ValueError(f"{name}: the table, scale and bias must be on one "
                         f"device")


def _launch(wrapper, entry: str, tables, indices, lengths, D: int):
    """Launch ``entry`` on CUDA tensors and count it on ``wrapper``;
    returns the (NB,D) f32 output."""
    name = wrapper.__name__
    device = indices.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    if not all(t.is_contiguous() for t in (*tables, indices, lengths)):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    NB, L = indices.shape
    R = tables[0].shape[0]
    if max(R, NB, L) > INT_MAX:
        raise ValueError(f"{name} kernel takes at most {INT_MAX} table rows, "
                         f"bags and lookups a bag; got {R}, {NB}, {L}")
    out = torch.empty((NB, D), dtype=torch.float32, device=device)
    if NB == 0:
        return out
    vec, _, unroll = table_plan(entry, tables[0])
    lib = _lib()
    err = getattr(lib, entry)(
        *(t.data_ptr() for t in tables), indices.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), NB, L, D, R, vec, unroll,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, name)
    wrapper.launches += 1
    return out


def sls(table: torch.Tensor, indices: torch.Tensor,
        lengths: torch.Tensor) -> torch.Tensor:
    """table (R,D) f32; indices (NB,L) int32; lengths (NB,) int32 -> (NB,D)
    f32: out[b] = sum of table[indices[b, l]] over l < lengths[b]."""
    if table.dim() != 2 or table.dtype != torch.float32 or 0 in table.shape:
        raise ValueError(f"sls takes a float32 table (R,D), R, D > 0; got "
                         f"{tuple(table.shape)} {table.dtype}")
    _check_bags("sls", indices, lengths, table.device)
    if table.device.type == "cpu":
        return sls_ref(table, indices, lengths)
    return _launch(sls, "sls_fp_fwd", (table,), indices, lengths,
                   table.shape[1])


def sls_int8(q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             indices: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q (R,D) uint8 with per-row fp16 scale and bias -> (NB,D) f32 sums of
    q * scale + bias."""
    _check_q("sls_int8", q, scale, bias)
    _check_bags("sls_int8", indices, lengths, q.device)
    if q.device.type == "cpu":
        return sls_int8_ref(q, scale, bias, indices, lengths)
    return _launch(sls_int8, "sls_int8_fwd", (q, scale, bias), indices,
                   lengths, q.shape[1])


def sls_int4(q4: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             indices: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q4 (R,D/2) uint8 (low nibble = even column) with per-row fp16 scale
    and bias -> (NB,D) f32."""
    _check_q("sls_int4", q4, scale, bias)
    _check_bags("sls_int4", indices, lengths, q4.device)
    if q4.device.type == "cpu":
        return sls_int4_ref(q4, scale, bias, indices, lengths)
    return _launch(sls_int4, "sls_int4_fwd", (q4, scale, bias), indices,
                   lengths, 2 * q4.shape[1])


sls.launches = 0
sls_int8.launches = 0
sls_int4.launches = 0

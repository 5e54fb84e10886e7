#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``
from the repository root.

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. build   — compile every CUDA kernel of ``src/repro_torch/csrc`` (one
             ``nvcc`` per source, in parallel): flash prefill, flash
             decode, int8-KV decode, the w8a8 GEMM and the SLS kernels
             (fp32, int8, int4); then ``cuobjdump -sass`` of the flash and
             w8a8 libraries must show ``wgmma`` (GMMA) and TMA load
             (UTMALDG) instructions.
2. kernels — each kernel against its plain PyTorch version on the card, on
             the JAX package's kernel test cases plus the serving path's
             shapes, with the error, the kernel's time, the plain version's
             time, one PyTorch library call's time where one computes the
             same function (``scaled_dot_product_attention`` for the
             attention kernels, ``torch._int_mm`` and the two scale
             multiplies for w8a8; a yardstick only) and the least time the
             card could take (bytes at 3.35 TB/s or operations at the peak
             rate of the input type, whichever is larger); then a seeded
             sweep of random shapes, masks and types, checked only. The
             w8a8 GEMM must equal its plain version bit for bit. The
             decode-step kernels are held at their split edges: w8a8 at 1 to
             16 rows on deepseek-7b's shapes, the reduced configs' K of 64
             and 128 and K slices that end inside a step; both split-S
             decode kernels (bf16/f32 and int8-KV) with pos on and around
             64-key chunk boundaries, G 1-8, hd 16-128 and a softcap, and
             f32 at hd 128 in 128-key chunks (135 KB of shared memory; the
             sweeps draw the chunk edges half the time). The SLS
             kernels' main shape is the DLRM batch (6144 bags of at most
             128 lookups, D 96, lengths from ``dlrm_batches``) on a table
             far larger than L2; ``embedding_bag`` is the fp32 yardstick.
             Each SLS kernel is held against its plain version in its own
             summation order (the lane groups' partial sums added in group
             order), at its layout edges too: bags longer than one staged
             batch of 128 indices, L = 1, rows that are not a multiple of
             16 bytes or of more than 32 lanes, tables that start 8 or 1
             bytes past a 16-byte boundary.
             The tensor-core paths are held at their edges: bf16 flash
             with GQA at hd 128, S not a multiple of the 128-row tile, an
             empty row, a window and a softcap; w8a8 at M = 17, 65 and
             2047, a partial K and a partial N tile, and the decode
             (M <= 16) and fallback (K % 16 != 0) routes; the sweeps add
             tile-edge sizes. One ``torch.profiler`` window then reads the
             device time of flash, SDPA, bf16 decode, SDPA's decode, the
             w8a8 GEMM and ``torch._int_mm`` at M=4 and M=2048, the int8-KV
             decode, the three SLS kernels and fp32 ``embedding_bag`` at the
             main shapes.
3. serve  — full-width deepseek-7b in bf16 (random weights from a seed)
             through ``InferenceEngine(device="cuda")``: 8 requests, 32 new
             tokens each. The kernels' launch counters are zeroed just
             before and read just after, and both attention kernels must
             have run.
4. serve (quantized) — the same weights and requests through a second
             engine with ``precision="w8a8"`` and an int8 KV cache: the §V
             build step on the card, then serving. The w8a8 and int8-KV
             decode kernels must have run and the bf16 decode kernel not;
             the greedy agreement with phase 3 is printed, not held (the
             logits of random full-width weights are near-flat).
5. check   — the reduced deepseek-7b config (f32, head_dim 16) and a
             bf16 head_dim-128 one (``reduce_hd128``) served on the card and
             on the host (plain versions) from the same weights must agree
             on >= 95% of the greedy tokens, each in its fp type and in w8a8
             with an int8 KV cache, and a full-width prefill must give
             finite hidden states.
6. profile — one full-width prefill call and eight decode steps through
             the model layer, fp and then w8a8 with the int8 KV cache: wall
             time untraced, then the device time of one ``torch.profiler``
             trace (busy share, the share of the matrix products and of each
             port kernel, the top kernels).
7. serve-dlrm — with the deepseek-7b weights freed: DLRM ``PAPER_COMPLEX``
             at its published widths with every table halved (one shard,
             a 58.6 GB row-wise int8 slab made on the card from a seed)
             through ``DLRMEngine(device="cuda")``: a full-trace warm-up,
             then 64 requests of batch 64 with the launch counters zeroed
             just before and read just after; the int8 SLS kernel must
             have run once a request and the other two not; one request's
             pooled output is held against the plain version on the same
             slab, and its logits against the dense stage on that output.
8. profile-dlrm — one traced pipeline pass of a batch: device busy share,
             the SLS kernel's share, device activities.
9. check-dlrm — reduced ``PAPER_COMPLEX`` with an fp32, an int8 and an
             int4 slab, the same weights served on the card and on the
             host (plain versions): pooled outputs within the SLS
             tolerances, logits within 2e-3; each card run must launch its
             slab's SLS kernel once a request and the other two not.

Kernel times (``ms``) are CUDA-event times of single calls, each after an
L2 flush; the device window's times leave out the host's enqueue gap.

The line before the last is a JSON object with one entry per kernel (its
``launches`` are those of the phase whose path runs it: serve, serve-w8a8,
serve-dlrm, or check-dlrm for the fp32 and int4 SLS kernels); the last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device and
the repository's ``src/`` beside this file; imports nothing of JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import dlrm_paper  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core.metrics import token_agreement  # noqa: E402
from repro_torch.data.synthetic import dlrm_batches  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    chunk_plan, decode_attn, decode_attn_int8)
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    decode_attn_int8_ref, decode_attn_ref)
from repro_torch.kernels.flash_attn.ops import flash_attn  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.sls.ops import (  # noqa: E402
    sls, sls_int4, sls_int8, table_plan)
from repro_torch.kernels.sls.ref import (  # noqa: E402
    sls_int4_ref, sls_int8_ref, sls_ref)
from repro_torch.kernels.w8a8.ops import w8a8_matmul  # noqa: E402
from repro_torch.kernels.w8a8.ref import w8a8_ref  # noqa: E402
from repro_torch.models import dlrm as dlrm_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.quantize import (  # noqa: E402
    QuantizedParams, build_quantized_params)
from repro_torch.serving.dlrm_engine import DLRMEngine  # noqa: E402
from repro_torch.serving.engine import InferenceEngine, Request  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12,             # f32 outside the tensor cores
              torch.int8: 1979e12}              # dense tensor-core int8
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
KERNELS = {
    "flash_attn": dict(source="src/repro_torch/csrc/flash.cu",
                       replaces="src/repro/kernels/flash_attn/flash.py:33"),
    "decode_attn": dict(source="src/repro_torch/csrc/decode.cu",
                        replaces="src/repro/kernels/decode_attn/decode.py:24"),
    "decode_attn_int8": dict(
        source="src/repro_torch/csrc/decode_int8.cu",
        replaces="src/repro/kernels/decode_attn/decode.py:100"),
    "w8a8_matmul": dict(source="src/repro_torch/csrc/w8a8.cu",
                        replaces="src/repro/kernels/w8a8/matmul.py:27"),
    "sls_fp": dict(source="src/repro_torch/csrc/sls.cu",
                   replaces="src/repro/kernels/sls/sls.py:21"),
    "sls_int8": dict(source="src/repro_torch/csrc/sls.cu",
                     replaces="src/repro/kernels/sls/sls.py:34"),
    "sls_int4": dict(source="src/repro_torch/csrc/sls.cu",
                     replaces="src/repro/kernels/sls/sls.py:50"),
}
LAUNCHERS = {"flash_attn": flash_attn, "decode_attn": decode_attn,
             "decode_attn_int8": decode_attn_int8,
             "w8a8_matmul": w8a8_matmul, "sls_fp": sls, "sls_int8": sls_int8,
             "sls_int4": sls_int4}
# each SLS kernel's plain version and tolerance (repro/kernels/sls/ops.py)
SLS_PLAIN = {"sls_fp": sls_ref, "sls_int8": sls_int8_ref,
             "sls_int4": sls_int4_ref}
SLS_TOL = {"sls_fp": 1e-5, "sls_int8": 1e-4, "sls_int4": 1e-4}
DEV = "cuda"
SMS = 132                                       # H100 SXM; read in main()


L2_FLUSH_BYTES = 2 * 50 * 2**20                   # twice the H100's 50 MB L2


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``, each call timed on its own
    after the L2 cache is flushed: on the serving path every layer finds
    its K/V cache cold (the other layers' weights stream through L2 in
    between)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least ms, 'bytes' or 'operations')."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype,
            tol: float = None, nan_ok: bool = False) -> float:
    """Max abs error; raises past ``tol``, by default the JAX package's
    tolerance for the type (|got - want| <= tol + tol * |want|), and
    unless ``got`` is finite or, with ``nan_ok``, NaN exactly where
    ``want`` is and finite elsewhere."""
    tol = TOL[dtype] if tol is None else tol
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    nan = torch.isnan(want) if nan_ok else torch.zeros_like(want, dtype=bool)
    err = torch.where(nan, 0.0, got - want).abs()
    if (torch.isnan(got) != nan).any() or not torch.isfinite(got[~nan]).all() \
            or (err > tol + tol * want.abs()).any():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err.max().item():.3e}, "
                             f"tol {tol})")
    return err.max().item() if err.numel() else 0.0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_counts(lib) -> dict:
    """Lines of ``cuobjdump -sass`` of a built library that hold a
    ``wgmma`` (GMMA) or a TMA tile load (UTMALDG)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    lines = sass.splitlines()
    return {op: sum(op in line for line in lines) for op in ("GMMA", "UTMALDG")}


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernel libraries ({', '.join(sorted(libs))}) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("flash", "w8a8"):
        counts = sass_counts(libs[name])
        print(f"build: {name} SASS holds {counts['GMMA']} GMMA and "
              f"{counts['UTMALDG']} UTMALDG instructions", flush=True)
        if not all(counts.values()):
            raise AssertionError(f"{name}: no wgmma or no TMA load in its "
                                 f"library ({counts})")


# ---- kernels ------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def flash_case(name, gen, B, S, H, K, hd, dtype, lens=None, **kw):
    """One flash case on the card; returns the measurement dict."""
    q = _randn(gen, (B, S, H, hd), dtype)
    k = _randn(gen, (B, S, K, hd), dtype)
    v = _randn(gen, (B, S, K, hd), dtype)
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=DEV)
    got = flash_attn(q, k, v, lens_t, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, lens_t, **kw)
    err = compare(f"flash_attn[{name}]", got, want, dtype)
    # the work these inputs need: the (query, key) pairs the mask keeps
    causal, window = kw.get("causal", True), kw.get("window", 0)
    pos = torch.arange(S, device=DEV)
    mask = torch.ones(S, S, dtype=torch.bool, device=DEV)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    n_valid = torch.tensor(lens if lens is not None else [S] * B, device=DEV)
    mask = mask[None] & (pos[None, None, :] < n_valid[:, None, None])
    pairs = mask.sum().item()
    elem = q.element_size()
    flops = 4.0 * pairs * H * hd
    nbytes = elem * (2 * q.numel() + 2 * K * hd * n_valid.sum().item())
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    library_ms = library_err = None
    if not kw.get("softcap"):       # SDPA has no logit softcap
        # (B,heads,S,hd) layout, kv heads repeated per group, outside the
        # timed call
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        m4 = mask[:, None]
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)
        library_err = (lib_out.transpose(1, 2).float()
                       - want.float()).abs().max().item()
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4))
    def call():
        return flash_attn(q, k, v, lens_t, **kw)

    def library_call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)

    return dict(max_abs_err=err, library_err=library_err, ms=time_ms(call),
                plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, lens_t,
                                                             **kw)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                call=call,
                library_call=None if library_ms is None else library_call)


def decode_case(name, gen, B, H, K, hd, S, pos, dtype, softcap=0.0):
    q = _randn(gen, (B, H, hd), dtype)
    k = _randn(gen, (B, S, K, hd), dtype)
    v = _randn(gen, (B, S, K, hd), dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    got = decode_attn(q, k, v, pos_t, softcap=softcap)
    torch.cuda.synchronize()
    want = decode_attn_ref(q, k, v, pos_t, softcap=softcap)
    err = compare(f"decode_attn[{name}]", got, want, dtype)
    keys = sum(min(p, S - 1) + 1 for p in pos)
    elem = q.element_size()
    flops = 4.0 * H * hd * keys
    nbytes = elem * (q.numel() + 2 * K * hd * keys) + 4 * B * H * hd
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    library_ms = library_err = None
    if not softcap:
        qt = q[:, :, None].contiguous()                         # (B,H,1,hd)
        kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))                # (B,H,S,hd)
        m4 = (torch.arange(S, device=DEV)[None, :]
              <= pos_t[:, None])[:, None, None]                 # (B,1,1,S)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)
        library_err = (lib_out[:, :, 0].float() - want).abs().max().item()
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4))
    def call():
        return decode_attn(q, k, v, pos_t, softcap=softcap)

    def library_call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)

    return dict(max_abs_err=err, library_err=library_err, ms=time_ms(call),
                plain_ms=time_ms(lambda: decode_attn_ref(q, k, v, pos_t,
                                                         softcap=softcap)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                call=call,
                library_call=None if library_ms is None else library_call)


def _int8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device=DEV,
                         dtype=torch.int8)


def _w8a8_inputs(gen, M, K, N, row_scale):
    """xq (M,K), wq (K,N) stored column-major (the kernel's layout), per-row
    or scalar activation scales, per-column weight scales."""
    xq = _int8(gen, (M, K))
    wq = _int8(gen, (N, K)).t()
    xs = (torch.rand(M, generator=gen, device=DEV) * 0.049 + 0.001
          if row_scale else torch.tensor(0.02, device=DEV))
    ws = torch.rand(N, generator=gen, device=DEV) * 0.019 + 0.001
    return xq, wq, xs, ws


def check_w8a8(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error, which must be 0: the int32 sum is exact, so the
    kernel equals its plain version bit for bit."""
    if got.shape != want.shape:
        raise AssertionError(f"w8a8_matmul[{name}]: shape {tuple(got.shape)}"
                             f" != {tuple(want.shape)}")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"w8a8_matmul[{name}]: kernel differs from its "
                             f"plain version (max abs err {err:.3e}); it "
                             f"must equal it bit for bit")
    return err


def _int_mm_yardstick(xq, wq, xs, ws):
    """``torch._int_mm`` (int8 x int8 -> int32 in cuBLASLt) followed by the
    two scale multiplies. It takes more than 16 rows, so a decode-sized xq
    is padded with zero rows outside the timed call. Returns (the timed
    callable, its (M,N) result)."""
    M = xq.shape[0]
    rows = max(M, 32)
    xp = torch.zeros(rows, xq.shape[1], dtype=torch.int8, device=DEV)
    xp[:M] = xq
    xs_col = torch.zeros(rows, 1, device=DEV)
    xs_col[:M] = xs.reshape(-1, 1)

    def fn():
        return torch._int_mm(xp, wq).float() * xs_col * ws

    return fn, fn()[:M]


def w8a8_case(name, gen, M, K, N, row_scale=True):
    xq, wq, xs, ws = _w8a8_inputs(gen, M, K, N, row_scale)
    got = w8a8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    want = w8a8_ref(xq, wq, xs, ws)
    err = check_w8a8(name, got, want)
    flops = 2.0 * M * K * N
    nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
    bound_ms, bound_by = bound(flops, nbytes, torch.int8)
    library_ms = library_err = lib_fn = None
    try:
        lib_fn, lib_out = _int_mm_yardstick(xq, wq, xs, ws)
    except RuntimeError as e:           # a yardstick only: note and go on
        print(f"w8a8_matmul[{name}]: torch._int_mm yardstick not measured: "
              f"{str(e).splitlines()[0]}", flush=True)
    else:
        library_err = (lib_out - want).abs().max().item()
        library_ms = time_ms(lib_fn)
    def call():
        return w8a8_matmul(xq, wq, xs, ws)

    return dict(max_abs_err=err, library_err=library_err, ms=time_ms(call),
                plain_ms=time_ms(lambda: w8a8_ref(xq, wq, xs, ws)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                call=call, library_call=lib_fn)


def _int8_cache(gen, B, S, K, hd):
    """kq, k_scale, vq, v_scale: int8 values, fp16 scales in [0.001,
    0.021) (the JAX package's int8 decode cases)."""
    kq, vq = (_int8(gen, (B, S, K, hd)) for _ in range(2))
    ks, vs = ((torch.rand((B, S, K), generator=gen, device=DEV) * 0.02
               + 0.001).half() for _ in range(2))
    return kq, ks, vq, vs


def decode_int8_case(name, gen, B, H, K, hd, S, pos, dtype, softcap=0.0):
    q = _randn(gen, (B, H, hd), dtype)
    cache = _int8_cache(gen, B, S, K, hd)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    got = decode_attn_int8(q, *cache, pos_t, softcap=softcap)
    torch.cuda.synchronize()
    want = decode_attn_int8_ref(q, *cache, pos_t, softcap=softcap)
    err = compare(f"decode_attn_int8[{name}]", got, want, dtype)
    keys = sum(min(p, S - 1) + 1 for p in pos)
    flops = 4.0 * H * hd * keys
    # q once, int8 K and V plus their two fp16 scales up to pos, f32 out
    nbytes = q.numel() * q.element_size() + K * keys * (2 * hd + 4) \
        + 4 * B * H * hd
    bound_ms, bound_by = bound(flops, nbytes, dtype)

    def call():
        return decode_attn_int8(q, *cache, pos_t, softcap=softcap)

    return dict(max_abs_err=err, library_err=None, ms=time_ms(call),
                plain_ms=time_ms(lambda: decode_attn_int8_ref(
                    q, *cache, pos_t, softcap=softcap)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call=call)


def _show(kernel, name, r):
    lib = ("n/a" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} (its max_abs_err {r['library_err']:.3e})")
    print(f"{kernel}[{name}]: max_abs_err={r['max_abs_err']:.3e} "
          f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms={lib} bound_us={r['bound_ms'] * 1e3:.2f} "
          f"({r['bound_by']})", flush=True)


def _sls_table(gen, kind, R, D):
    """The table of SLS kernel ``kind``: (R,D) f32, or uint8 values ((R,D)
    int8, (R,D/2) packed int4) with fp16 scale in [0.01, 0.11) and bias
    N(0, 0.1^2) per row (the JAX package's SLS cases)."""
    if kind == "sls_fp":
        return (torch.randn((R, D), generator=gen, device=DEV),)
    cols = D if kind == "sls_int8" else D // 2
    q = torch.randint(0, 256, (R, cols), generator=gen, device=DEV,
                      dtype=torch.uint8)
    scale = (torch.rand(R, generator=gen, device=DEV) * 0.1 + 0.01).half()
    bias = (torch.randn(R, generator=gen, device=DEV) * 0.1).half()
    return q, scale, bias


def _bags(gen, R, NB, L):
    idx = torch.randint(0, R, (NB, L), generator=gen, device=DEV,
                        dtype=torch.int32)
    lens = torch.randint(0, L + 1, (NB,), generator=gen, device=DEV,
                         dtype=torch.int32)
    return idx, lens


def sls_groups(kind, tables) -> int:
    """The lane groups that split a bag in SLS kernel ``kind`` over
    ``tables`` (``table_plan``), which its plain version adds in the same
    order."""
    return table_plan(f"{kind}_fwd", tables[0])[1]


def sls_check(kind, name, tables, idx, lens) -> float:
    """One SLS kernel call against its plain version in the kernel's
    summation order; max abs error."""
    got = LAUNCHERS[kind](*tables, idx, lens)
    torch.cuda.synchronize()
    want = SLS_PLAIN[kind](*tables, idx, lens,
                           groups=sls_groups(kind, tables))
    return compare(f"{kind}[{name}]", got, want, torch.float32,
                   tol=SLS_TOL[kind], nan_ok=True)


def sls_measure(kind, tables, idx, lens, err) -> dict:
    """Times of the kernel, its plain version and (fp32) ``embedding_bag``
    on one input, with the bound these bags need: each lookup reads its
    row (and 4 bytes of fp16 scale and bias when quantized) and its index
    once; the lengths are read and the (NB,D) f32 output written once."""
    fn, plain = LAUNCHERS[kind], SLS_PLAIN[kind]
    NB, L = idx.shape
    lookups = lens.clamp(0, L).sum().item()
    t = tables[0]
    D = t.shape[1] * (2 if kind == "sls_int4" else 1)
    row_bytes = t.shape[1] * t.element_size() + (0 if kind == "sls_fp" else 4)
    nbytes = lookups * (row_bytes + 4) + 4 * NB + 4 * NB * D
    flops = lookups * D * (1 if kind == "sls_fp" else 2)
    bound_ms, bound_by = bound(flops, nbytes, torch.float32)
    library_ms = library_err = None
    if kind == "sls_fp":
        # embedding_bag over the same bags: the valid indices flattened,
        # one offset per bag (made outside the timed call)
        keep = torch.arange(L, device=DEV)[None, :] < lens[:, None]
        flat = idx[keep].long()
        offsets = (torch.cumsum(lens.clamp(0, L), 0) - lens.clamp(0, L)).long()
        lib_out = F.embedding_bag(flat, t, offsets, mode="sum")
        library_err = (lib_out - plain(*tables, idx, lens)).abs().max().item()
        library_ms = time_ms(lambda: F.embedding_bag(flat, t, offsets,
                                                     mode="sum"))

    def call():
        return fn(*tables, idx, lens)

    def library_call():
        return F.embedding_bag(flat, t, offsets, mode="sum")

    return dict(max_abs_err=err, library_err=library_err, ms=time_ms(call),
                plain_ms=time_ms(lambda: plain(*tables, idx, lens)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                call=call,
                library_call=None if library_ms is None else library_call)


def dlrm_main_bags(R: int):
    """The DLRM serving path's SLS input: the bags of one batch of 64
    (``dlrm_batches(PAPER_COMPLEX, 64, seed=0)``), 96 tables -> 6144 bags
    of at most 128 lookups, each table's power-law indices placed in its
    own R/96 rows of an R-row table."""
    cfg = dlrm_paper.PAPER_COMPLEX
    b = next(dlrm_batches(cfg, 64, seed=0))
    per = R // cfg.num_tables
    idx = b["indices"] % per \
        + (np.arange(cfg.num_tables) * per)[None, :, None]
    L = cfg.max_lookups_per_table
    return (torch.from_numpy(idx.reshape(-1, L).astype(np.int32)).to(DEV),
            torch.from_numpy(b["lengths"].reshape(-1)).to(DEV))


SLS_MAIN_ROWS = 1 << 23


def _shifted(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A copy of ``t`` that starts ``nbytes`` past the start of its
    (aligned) allocation."""
    e = nbytes // t.element_size()
    buf = torch.empty(t.numel() + e, dtype=t.dtype, device=DEV)
    out = buf[e:].view(t.shape)
    out.copy_(t)
    return out


def sls_edges(gen) -> None:
    """The SLS kernels' layout edges, each against its plain version in the
    kernel's order: bags longer than one staged batch of 128 indices (L
    300), L = 1, rows that are not a multiple of 16 bytes (8-, 4- and
    2-byte lane loads), rows of more than 32 lanes (two and three passes),
    tables that start 8 and 1 bytes past a 16-byte boundary; lengths past L
    and below 0, and one index outside the table (a NaN bag) in each."""
    # (kind, R, D, NB, L, bytes the table's start is shifted by)
    cases = [(k, 3000, 96, 64, 300, 0) for k in SLS_PLAIN] \
        + [(k, 500, 96, 200, 1, 0) for k in SLS_PLAIN] \
        + [(k, 1000, D, 64, 40, 0) for k, D in (
            ("sls_fp", 50), ("sls_int8", 100), ("sls_int8", 98),
            ("sls_int4", 36), ("sls_fp", 200), ("sls_int8", 600))] \
        + [(k, 1000, 96, 64, 40, shift) for k, shift in (
            ("sls_fp", 8), ("sls_int8", 8), ("sls_int8", 1), ("sls_int4", 8),
            ("sls_int4", 1))]
    worst = {k: 0.0 for k in SLS_PLAIN}
    plans = set()
    for kind, R, D, NB, L, shift in cases:
        tables = _sls_table(gen, kind, R, D)
        tables = (_shifted(tables[0], shift), *tables[1:])
        idx, _ = _bags(gen, R, NB, L)
        lens = torch.randint(-2, L + 4, (NB,), generator=gen, device=DEV,
                             dtype=torch.int32)
        idx[0, 0], lens[0] = R, max(int(lens[0]), 1)   # bag 0 is NaN
        plans.add((kind, D, shift) + table_plan(f"{kind}_fwd", tables[0]))
        worst[kind] = max(worst[kind], sls_check(
            kind, f"edge R{R} D{D} NB{NB} L{L} shift {shift}", tables, idx,
            lens))
    print(f"sls edges: {len(cases)} cases agree with the plain versions "
          f"(kind, D, shift, vec, groups, unroll: {sorted(plans)}); max abs "
          f"err {worst}", flush=True)


def sls_cases(gen, device_fns: dict) -> dict:
    """The JAX package's SLS cases (repro/kernels/sls/ops.py), empty bags,
    then the main shape on a 2^23-row table (3.2 GB in fp32, 805 MB in
    int8, 403 MB in int4: far past the 50 MB L2); returns the main
    shape's measurements and adds each kernel's main call (and
    ``embedding_bag``'s) to ``device_fns``."""
    cases = {"sls_fp": [(64, 16, 8, 4), (1000, 64, 32, 8), (4096, 128, 16, 64),
                        (128, 256, 4, 1)],
             "sls_int8": [(64, 16, 8, 4), (1000, 64, 32, 8), (512, 128, 16, 32)],
             "sls_int4": [(64, 16, 8, 4), (1000, 64, 32, 8)]}
    main = {}
    sls_edges(gen)
    main_idx, main_lens = dlrm_main_bags(SLS_MAIN_ROWS)
    for kind, shapes in cases.items():
        worst = 0.0
        for R, D, NB, L in shapes:
            tables = _sls_table(gen, kind, R, D)
            worst = max(worst, sls_check(kind, f"R{R}_D{D}_NB{NB}_L{L}",
                                         tables, *_bags(gen, R, NB, L)))
            idx, _ = _bags(gen, R, NB, L)
            worst = max(worst, sls_check(
                kind, f"R{R}_D{D}_NB{NB}_L{L} empty", tables, idx,
                torch.zeros(NB, dtype=torch.int32, device=DEV)))
        print(f"{kind}: the JAX package's {len(shapes)} cases and their "
              f"all-empty bags agree with the plain version; max abs err "
              f"{worst:.3e}", flush=True)
        tables = _sls_table(gen, kind, SLS_MAIN_ROWS, 96)
        err = sls_check(kind, "main", tables, main_idx, main_lens)
        r = main[kind] = sls_measure(kind, tables, main_idx, main_lens, err)
        _show(kind, f"main_NB6144_L128_D96_R{SLS_MAIN_ROWS} "
              f"({main_lens.sum().item()} lookups)", r)
        device_fns[f"{kind} main_NB6144_D96"] = r["call"]
        if r["library_call"] is not None:
            device_fns["embedding_bag main_NB6144_D96"] = r["library_call"]
    return main


def sweep_sls(seed: int, n: int) -> None:
    """``n`` random cases per SLS kernel: D not a multiple of 4 and odd D
    (fp32, int8), L = 1, empty and all-empty bags, lengths past L and
    below 0, indices outside the table (NaN bags), and a table view that
    starts off 16-byte alignment; each against its plain version. No
    timing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    worst = {k: 0.0 for k in SLS_PLAIN}
    for i in range(n):
        for kind in SLS_PLAIN:
            step = 2 if kind == "sls_int4" else 1
            D = step * int(rng.integers(1, 160 // step))
            R, NB = int(rng.integers(1, 3000)), int(rng.integers(1, 300))
            L = int(rng.choice([1, int(rng.integers(1, 200))]))
            tables = _sls_table(gen, kind, R + 1, D)
            if rng.integers(0, 3) == 0:          # drop row 0: a shifted start
                tables = tuple(t[1:] for t in tables)
            else:
                tables = tuple(t[:R] for t in tables)
            idx, _ = _bags(gen, R, NB, L)
            if rng.integers(0, 4) == 0:          # a few indices off the table
                flat = idx.view(-1)
                at = torch.from_numpy(rng.integers(0, flat.numel(), 3)).to(DEV)
                flat[at] = torch.tensor([R, -1, 2**31 - 1], dtype=torch.int32,
                                        device=DEV)
            lens = torch.from_numpy(rng.integers(-2, L + 3, NB)
                                    .astype(np.int32)).to(DEV)
            if rng.integers(0, 4) == 0:
                lens.zero_()
            err = sls_check(kind, f"sweep {i}: R{R} D{D} NB{NB} L{L}",
                            tables, idx, lens)
            worst[kind] = max(worst[kind], err)
    torch.cuda.synchronize()
    print(f"sweep: {n} random cases per SLS kernel agree with the plain "
          f"versions; max abs err {worst}", flush=True)


def split_group_cases() -> dict:
    """Decode cases of the split-S kernels at G 1 to 8 and hd 16 to 128 in
    both query types, each row's pos on a 64-key chunk's end or past a
    boundary, a softcap at G 3 and 6: name -> (B, H, K, hd, S, pos, dtype,
    softcap)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return {f"G{G}_hd{hd}_B2_K2_S300": (2, 2 * G, 2, hd, 300,
                                        [255, 64 * (G % 4) + G], dt,
                                        30.0 if G % 3 == 0 else 0.0)
            for G, hd, dt in ((1, 16, f32), (2, 32, bf16), (3, 64, f32),
                              (4, 128, bf16), (5, 16, bf16), (6, 32, f32),
                              (7, 64, bf16), (8, 128, f32))}


def phase_kernels() -> dict:
    """Every case of both kernels; returns the main-path measurements."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    # the JAX package's cases (repro/kernels/flash_attn/ops.py)
    flash_cases = {
        "mha_64": (2, 64, 4, 4, 32, f32, None, {}),
        "gqa_128": (2, 128, 8, 2, 64, f32, None, {}),
        "mqa_256": (1, 256, 8, 1, 64, f32, None, {}),
        "local_128": (2, 128, 4, 4, 32, f32, None, {"window": 32}),
        "softcap": (2, 64, 4, 2, 32, f32, None, {"softcap": 30.0}),
        "padded_lens": (2, 64, 4, 4, 32, f32, [38, 38], {}),
        "noncausal": (2, 64, 4, 4, 32, f32, None, {"causal": False}),
        "odd_seq_96": (1, 96, 4, 4, 32, f32, None, {}),
        "bf16": (2, 128, 8, 2, 64, bf16, None, {}),
        # the tensor-core kernel's edges: GQA at hd 128, S past the 128-row
        # tile, an empty row, a window, a softcap, hd 64, 32 heads to a kv head
        "bf16_gqa_B2_S256_H32_K8_hd128": (2, 256, 32, 8, 128, bf16, None, {}),
        "bf16_S300_hd128": (2, 300, 8, 8, 128, bf16, None, {}),
        "bf16_lens0_hd128": (2, 300, 8, 8, 128, bf16, [0, 211], {}),
        "bf16_window128_hd128": (2, 300, 8, 8, 128, bf16, None,
                                 {"window": 128}),
        "bf16_softcap30_hd128": (2, 300, 8, 4, 128, bf16, None,
                                 {"softcap": 30.0}),
        "bf16_hd64_S300_lens": (2, 300, 8, 2, 64, bf16, [300, 129], {}),
        "bf16_mqa_G32_hd128": (1, 256, 32, 1, 128, bf16, None, {}),
        # deepseek-7b prefill: 4 prompts of a 512 bucket, right-padded
        "main_B4_S512_H32_hd128": (4, 512, 32, 32, 128, bf16,
                                   [512, 300, 77, 1], {}),
    }
    device_fns = {}
    main = {}
    for name, (B, S, H, K, hd, dt, lens, kw) in flash_cases.items():
        r = flash_case(name, gen, B, S, H, K, hd, dt, lens, **kw)
        _show("flash_attn", name, r)
        if name.startswith("main"):
            main["flash_attn"] = r
            device_fns["flash_attn " + name] = r["call"]
            device_fns["SDPA " + name] = r["library_call"]
    # the JAX package's cases (repro/kernels/decode_attn/ops.py), scalar
    # pos broadcast to every row, then deepseek-7b decode at per-row pos
    decode_cases = {
        "B2_H8_K8_hd64_S256_p0.5": (2, 8, 8, 64, 256, [128] * 2, f32, 0.0),
        "B2_H8_K2_hd64_S256_p0.9": (2, 8, 2, 64, 256, [230] * 2, f32, 0.0),
        "B1_H8_K1_hd128_S512_p0.3": (1, 8, 1, 128, 512, [153], f32, 0.0),
        "B4_H4_K4_hd32_S64_p0.0": (4, 4, 4, 32, 64, [0] * 4, f32, 0.0),
        "softcap_B2_H8_K4_hd64_S256": (2, 8, 4, 64, 256, [179] * 2, f32,
                                       50.0),
        "main_B4_S1024_H32_hd128": (4, 32, 32, 128, 1024,
                                    [1023, 600, 31, 0], bf16, 0.0),
    }
    # the split-S kernel's edges (64-key chunks at these sizes): pos 0, one
    # short of a chunk's end, on it, one past it, and at and past S-1; G
    # from 1 to 8 and hd from 16 to 128 in both types; softcap; and f32 at
    # hd 128 at the main shape, whose 128-key chunks take 135 KB of shared
    # memory
    decode_cases.update({
        "edges_B4_H8_K8_hd128_S1024": (4, 8, 8, 128, 1024, [0, 62, 63, 64],
                                       bf16, 0.0),
        "edges_B4_H8_K8_hd64_S1024": (4, 8, 8, 64, 1024,
                                      [127, 128, 1023, 5000], f32, 0.0),
        "softcap_B2_H32_K8_hd128_S700": (2, 32, 8, 128, 700, [699, 191],
                                         bf16, 30.0),
        "f32_B4_S1024_H32_hd128": (4, 32, 32, 128, 1024, [1023, 600, 31, 0],
                                   f32, 0.0),
        # 128-key chunks on 8 warps a block, G 4, softcap
        "gqa_B4_H128_K32_hd128_S1024": (4, 128, 32, 128, 1024,
                                        [1023, 511, 128, 127], bf16, 30.0)})
    decode_cases.update(split_group_cases())
    for name, (B, H, K, hd, S, pos, dt, cap) in decode_cases.items():
        r = decode_case(name, gen, B, H, K, hd, S, pos, dt, cap)
        _show("decode_attn", name, r)
        if name.startswith("main"):
            main["decode_attn"] = r
            device_fns["decode_attn " + name] = r["call"]
            device_fns["SDPA " + name] = r["library_call"]
    # the JAX package's cases (repro/kernels/w8a8/ops.py), then deepseek-7b's
    # dense projections at decode (4 rows) and prefill (4 x 512 rows)
    w8a8_cases = {
        "128x128x128": (128, 128, 128, False),
        "256x512x128": (256, 512, 128, False),
        "128x256x384": (128, 256, 384, False),
        "512x128x256": (512, 128, 256, False),
        "96x192x320_padded": (96, 192, 320, False),
        "48x160x288_rowscale_padded": (48, 160, 288, True),
        "128x128x128_rowscale": (128, 128, 128, True),
    }
    for M in (4, 2048):
        for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
            w8a8_cases[f"main_M{M}_K{K}_N{N}"] = (M, K, N, True)
    # the tensor-core kernel's edges (ragged M, a partial K tile, a partial
    # N tile) and the other two routes (M <= 16; K % 16 != 0)
    for M in (17, 65, 2047):
        w8a8_cases[f"M{M}_K4096_N11008"] = (M, 4096, 11008, True)
    w8a8_cases.update({"M300_K4112_N4096": (300, 4112, 4096, True),
                       "M300_K4096_N4104": (300, 4096, 4104, True),
                       "decode_M4_K4112_N4104": (4, 4112, 4104, True),
                       "fallback_M300_K4100_N4104": (300, 4100, 4104, True)})
    # the split-K decode-rows kernel: M from 1 to 16 at deepseek-7b's
    # shapes, the reduced configs' K of 64 and 128 (one slice), K slices
    # that end inside a 256-byte step (11024 -> 5504 + 5520 bytes, 2752 ->
    # 1376 + 1376), and the byte-wise M <= 16 route (K % 16 != 0)
    for M in (1, 8, 16):
        for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
            w8a8_cases[f"decode_M{M}_K{K}_N{N}"] = (M, K, N, True)
    w8a8_cases.update({
        "decode_M4_K64_N192": (4, 64, 192, True),
        "decode_M4_K128_N64": (4, 128, 64, True),
        "decode_M3_K11024_N4096_midstep": (3, 11024, 4096, True),
        "decode_M16_K2752_N4104_scalar": (16, 2752, 4104, False),
        "bytewise_M4_K4100_N4104": (4, 4100, 4104, True)})
    for name, (M, K, N, row) in w8a8_cases.items():
        r = w8a8_case(name, gen, M, K, N, row)
        _show("w8a8_matmul", name, r)
        if name == "main_M4_K4096_N11008":
            main["w8a8_matmul"] = r
        if name.startswith("main_M"):
            device_fns["w8a8_matmul " + name] = r["call"]
            device_fns["torch._int_mm + scales " + name] = r["library_call"]
    # the JAX package's int8 cases (repro/kernels/decode_attn/ops.py),
    # scalar pos broadcast, then deepseek-7b decode over an int8 cache
    decode_int8_cases = {
        "B2_H8_K8_hd64_S256_p0.5": (2, 8, 8, 64, 256, [128] * 2, f32, 0.0),
        "B2_H8_K2_hd64_S256_p0.9": (2, 8, 2, 64, 256, [230] * 2, f32, 0.0),
        "B1_H8_K1_hd128_S512_p0.3": (1, 8, 1, 128, 512, [153], f32, 0.0),
        "main_B4_S1024_H32_hd128": (4, 32, 32, 128, 1024,
                                    [1023, 600, 31, 0], bf16, 0.0),
    }
    # the split-S kernel's edges (64-key chunks at these sizes): pos 0, one
    # short of a chunk's end, on it, one past it, and at and past S-1; G
    # from 1 to 8 and hd from 16 to 128 in both query types; softcap
    decode_int8_cases.update({
        "edges_B4_H8_K8_hd128_S1024": (4, 8, 8, 128, 1024, [0, 62, 63, 64],
                                       bf16, 0.0),
        "edges_B4_H8_K8_hd64_S1024": (4, 8, 8, 64, 1024,
                                      [127, 128, 1023, 5000], f32, 0.0),
        "softcap_B2_H32_K8_hd128_S700": (2, 32, 8, 128, 700, [699, 191],
                                         bf16, 30.0),
        # 256-key chunks on 8 warps a block (two tiles a warp), G 2
        "B8_H64_K32_hd128_S2048": (8, 64, 32, 128, 2048,
                                   [2047, 1500, 256, 255, 0, 1024, 700, 64],
                                   f32, 0.0)})
    decode_int8_cases.update(split_group_cases())
    for name, (B, H, K, hd, S, pos, dt, cap) in decode_int8_cases.items():
        r = decode_int8_case(name, gen, B, H, K, hd, S, pos, dt, cap)
        _show("decode_attn_int8", name, r)
        if name.startswith("main"):
            main["decode_attn_int8"] = r
            device_fns["decode_attn_int8 " + name] = r["call"]
    main.update(sls_cases(gen, device_fns))
    device_window(device_fns)
    for r in main.values():         # let the main shapes' tables go
        r.pop("call", None)
        r.pop("library_call", None)
    sweep(seed=1, n=32)
    sweep_int8(seed=2, n=32)
    sweep_sls(seed=3, n=32)
    return main


def device_window(fns: dict, iters: int = 10) -> None:
    """Device time of one call of each of ``fns`` (a name -> callable; None
    is skipped), from one ``torch.profiler`` window. Each call follows an
    L2 flush and sits between two marker kernels (``torch.cuda._sleep``'s
    ``spin_kernel``); its time is the sum of the device activities between
    its two markers. (Kernels launched through ctypes carry no PyTorch op
    to attribute them to, so the markers, not ``record_function``, say
    which call a kernel belongs to.)"""
    fns = {k: f for k, f in fns.items() if f is not None}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns.values():
            for _ in range(iters):
                flush.zero_()
                torch.cuda._sleep(100)
                fn()
                torch.cuda._sleep(100)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if len(marks) != 2 * iters * len(fns):
        print(f"device time per call: not measured ({len(marks)} marker "
              f"kernels in the trace, {2 * iters * len(fns)} launched)",
              flush=True)
        return
    times = [sum(e.time_range.elapsed_us() for e in events[a + 1:b]) / 1e3
             for a, b in zip(marks[::2], marks[1::2])]
    print("device time per call (one torch.profiler window, after an L2 "
          "flush each): " + "; ".join(
              f"{name} {sum(times[i * iters:(i + 1) * iters]) / iters:.4f} ms"
              for i, name in enumerate(fns)), flush=True)


def sweep(seed: int, n: int) -> None:
    """``n`` random cases per kernel, outside the JAX package's cases:
    T != S, empty rows (lens or pos 0), every head_dim and group size the
    kernels take, both input types (bf16 at hd 64 and 128 most often: the
    tensor-core path), S and T at its tile edges half the time, masks and
    softcap mixed; decode half the time over a cache of several chunks with
    each row's pos on or next to a chunk boundary (``chunk_plan``); each
    against its plain version. No timing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    worst = {"flash_attn": 0.0, "decode_attn": 0.0}
    for i in range(n):
        B, K, G = int(rng.integers(1, 4)), pick([1, 2, 4]), pick([1, 2, 4, 8])
        hd = pick([16, 32, 64, 128, 64, 128])
        dt = pick([torch.float32, torch.bfloat16, torch.bfloat16])
        cap = pick([0.0, 0.0, 30.0])
        # half the sizes at the tensor-core kernel's 128-row / 128-key edges
        S, T = (pick([int(rng.integers(1, 300)),
                      pick([127, 128, 129, 255, 256, 257])]) for _ in range(2))
        kw = dict(causal=bool(rng.integers(0, 2)), window=pick([0, 0, 16, 70]),
                  softcap=cap)
        q = _randn(gen, (B, S, K * G, hd), dt)
        k, v = (_randn(gen, (B, T, K, hd), dt) for _ in range(2))
        lens = torch.tensor(rng.integers(0, T + 1, B), dtype=torch.int32,
                            device=DEV)
        err = compare(f"flash_attn[sweep {i}: B{B} S{S} T{T} K{K} G{G} hd{hd} "
                      f"{dt} {kw} lens {lens.tolist()}]",
                      flash_attn(q, k, v, lens, **kw),
                      flash_attention_ref(q, k, v, lens, **kw), dt)
        worst["flash_attn"] = max(worst["flash_attn"], err)
        qd = _randn(gen, (B, K * G, hd), dt)
        if rng.integers(0, 2):          # the split edges, on a longer cache
            T = int(rng.integers(129, 1100))
            k, v = (_randn(gen, (B, T, K, hd), dt) for _ in range(2))
            chunk = chunk_plan(B, K, T, SMS, hd * k.element_size())
            edges = [c * chunk + d for c in range(T // chunk + 1)
                     for d in (-1, 0, 1)] + [T - 1, T + 3]
            pos = torch.tensor([max(0, pick(edges)) for _ in range(B)],
                               dtype=torch.int32, device=DEV)
        else:
            pos = torch.tensor(rng.integers(0, T, B), dtype=torch.int32,
                               device=DEV)
        err = compare(f"decode_attn[sweep {i}: B{B} S{T} K{K} G{G} hd{hd} "
                      f"{dt} softcap {cap} pos {pos.tolist()}]",
                      decode_attn(qd, k, v, pos, softcap=cap),
                      decode_attn_ref(qd, k, v, pos, softcap=cap), dt)
        worst["decode_attn"] = max(worst["decode_attn"], err)
    torch.cuda.synchronize()
    print(f"sweep: {n} random cases per kernel agree with the plain versions;"
          f" max abs err {worst}", flush=True)


def sweep_int8(seed: int, n: int) -> None:
    """``n`` random cases per int8 kernel: w8a8 at ragged M, K and N, at
    the tensor-core kernel's 128-row, 256-column and 128-byte K tile edges
    (K not a multiple of 16 takes the fallback's byte-wise loader), M <= 16
    (the split-K kernel) about half the time, scalar and per-row scales,
    checked bit for bit; int8-KV decode at every head_dim and group size,
    both query types, empty rows and softcap mixed, half the time with S
    over several chunks and each row's pos on or next to a chunk boundary
    (``chunk_plan``). No timing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    worst = {"w8a8_matmul": 0.0, "decode_attn_int8": 0.0}
    for i in range(n):
        M = pick([1, 3, 4, 16, 17, 64, 127, 128, 129, 257,
                  int(rng.integers(1, 600)), int(rng.integers(1, 17)),
                  int(rng.integers(1, 17)), int(rng.integers(1, 17)),
                  int(rng.integers(1, 17)), int(rng.integers(1, 17))])
        K = pick([int(rng.integers(1, 40)) * 16,
                  pick([112, 128, 144, 256, 272]), int(rng.integers(1, 700))])
        N = pick([int(rng.integers(1, 400)), pick([255, 256, 257, 511, 513])])
        row = bool(rng.integers(0, 2))
        xq, wq, xs, ws = _w8a8_inputs(gen, M, K, N, row)
        err = check_w8a8(f"sweep {i}: M{M} K{K} N{N} per-row {row}",
                         w8a8_matmul(xq, wq, xs, ws),
                         w8a8_ref(xq, wq, xs, ws))
        worst["w8a8_matmul"] = max(worst["w8a8_matmul"], err)
        B, K, G = int(rng.integers(1, 4)), pick([1, 2, 4]), pick([1, 2, 4, 8])
        hd, dt = pick([16, 32, 64, 128]), pick([torch.float32, torch.bfloat16])
        cap, T = pick([0.0, 0.0, 30.0]), int(rng.integers(1, 300))
        if rng.integers(0, 2):          # the split edges
            T = int(rng.integers(129, 1100))
            chunk = chunk_plan(B, K, T, SMS, hd)
            edges = [c * chunk + d for c in range(T // chunk + 1)
                     for d in (-1, 0, 1)] + [T - 1, T + 3]
            pos = torch.tensor([max(0, pick(edges)) for _ in range(B)],
                               dtype=torch.int32, device=DEV)
        else:
            pos = torch.tensor(rng.integers(0, T, B), dtype=torch.int32,
                               device=DEV)
        q = _randn(gen, (B, K * G, hd), dt)
        cache = _int8_cache(gen, B, T, K, hd)
        err = compare(f"decode_attn_int8[sweep {i}: B{B} S{T} K{K} G{G} "
                      f"hd{hd} {dt} softcap {cap} pos {pos.tolist()}]",
                      decode_attn_int8(q, *cache, pos, softcap=cap),
                      decode_attn_int8_ref(q, *cache, pos, softcap=cap), dt)
        worst["decode_attn_int8"] = max(worst["decode_attn_int8"], err)
    torch.cuda.synchronize()
    print(f"sweep: {n} random cases per int8 kernel agree with the plain "
          f"versions; max abs err {worst}", flush=True)


# ---- serve ----------------------------------------------------------------

def stage_ms(tel, stage: str) -> float:
    """Mean wall time of one call of an engine stage (each stage ends in a
    copy of its tokens to the host, so this is its time to completion)."""
    return 1e3 * tel.stage_dispatch_s[stage] / tel.stage_calls[stage]


def _requests(n, lo, hi, new_tokens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i, L in enumerate(rng.integers(lo, hi + 1, n))]


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


def _serve(eng, cfg, label: str):
    """Warm the engine on one request, then serve 8 requests x 32 tokens
    with every launch counter zeroed just before and read just after.
    Raises unless all 8 got 32 tokens in the vocab. Returns (launches,
    the requests' outputs)."""
    eng.run(_requests(1, 64, 64, 4, cfg.vocab_size, seed=1))    # warm-up
    eng.telemetry.reset_serving_stats()
    reqs = _requests(8, 64, 512, 32, cfg.vocab_size, seed=0)
    for fn in LAUNCHERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in LAUNCHERS.items()}
    tel = eng.telemetry
    ttft = tel.ttft_percentiles()
    n_tok = sum(len(r.output) for r in reqs)
    print(f"{label}: deepseek-7b full width bf16, {cfg.num_layers} layers, "
          f"prompts {sorted(len(r.tokens) for r in reqs)}; served "
          f"{tel.served}/{len(reqs)} in {wall:.3f} s, {n_tok / wall:.1f} "
          f"tok/s, TTFT p50 {ttft['p50']:.2f} ms p99 {ttft['p99']:.2f} ms, "
          f"mean decode step {stage_ms(tel, 'decode'):.3f} ms over "
          f"{tel.steps} steps, mean prefill call "
          f"{stage_ms(tel, 'prefill'):.3f} ms over "
          f"{tel.prefill_batches} calls; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tel.served != len(reqs):
        raise AssertionError(f"served {tel.served} of {len(reqs)}")
    bad = [r.rid for r in reqs if len(r.output) != 32
           or not all(0 <= t < cfg.vocab_size for t in r.output)]
    if bad:
        raise AssertionError(f"requests {bad} did not get 32 tokens in the "
                             f"vocab")
    print(f"{label}: kernel launches {launches}", flush=True)
    return launches, [r.output for r in reqs]


def _require_launched(label: str, launches: dict, names) -> None:
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched "
                             f"while serving")


def phase_serve(cfg, params):
    """Full-width deepseek-7b serving through the engine in bf16; returns
    the kernels' launch counts of the measured run and its outputs."""
    eng = InferenceEngine(cfg, params, batch_slots=4, max_len=1024,
                          prefill_buckets=(64, 128, 256, 512), device=DEV)
    launches, outputs = _serve(eng, cfg, "serve")
    _require_launched("serve", launches, ("flash_attn", "decode_attn"))
    return launches, outputs


def phase_serve_quant(cfg, params, ref_outputs):
    """The same weights and requests through ``precision="w8a8"`` with an
    int8 KV cache; returns the launch counts and the quantized model."""
    cfg_q = _int8_kv(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg_q, params, precision="w8a8", batch_slots=4,
                          max_len=1024, prefill_buckets=(64, 128, 256, 512),
                          device=DEV)
    torch.cuda.synchronize()
    q = eng.quant
    print(f"serve-w8a8: build step {time.perf_counter() - t0:.1f} s: "
          f"{q.quantized_sites} sites int8, {q.fallback_sites} fall back to "
          f"bf16 (calibration disagreement {q.result.metric_delta:.4f}, "
          f"budget 0.05, {q.result.iterations} fall-backs); {q.schemes}",
          flush=True)
    launches, outputs = _serve(eng, cfg_q, "serve-w8a8")
    _require_launched("serve-w8a8", launches,
                      ("flash_attn", "w8a8_matmul", "decode_attn_int8"))
    if launches["decode_attn"]:
        raise AssertionError(f"serve-w8a8: the bf16 decode kernel ran "
                             f"{launches['decode_attn']} times over an int8 "
                             f"cache")
    agree = token_agreement(zip(outputs, ref_outputs))
    print(f"serve-w8a8: greedy-token agreement with the bf16 engine "
          f"{agree:.4f} (printed, not held: random full-width weights give "
          f"near-flat logits)", flush=True)
    return launches, eng.run_params


def reduce_hd128(cfg):
    """deepseek-7b cut to 2 layers of d_model 256 (2 heads of head_dim 128,
    d_ff 512, vocab 256) in bf16: the full width's head_dim and type, so
    the card runs the serving path's kernels (bf16 flash on the tensor
    cores, the split-K w8a8 and split-S int8-KV decode at hd 128)."""
    return dataclasses.replace(
        reduce_for_smoke(cfg), d_model=256, num_heads=2, num_kv_heads=2,
        head_dim=128, d_ff=512, param_dtype="bfloat16",
        activation_dtype="bfloat16")


def _card_vs_host(label: str, small, host, quant=None) -> float:
    """Serve 6 requests x 8 tokens from the same weights on the card and on
    the host (plain versions); raises below 0.95 greedy-token agreement.
    ``quant``: the host's w8a8 build step result, copied to the card."""
    card = copy.deepcopy(host).to(DEV)
    runs = [(card, DEV), (host, "cpu")]
    if quant is not None:
        card_qp = QuantizedParams(copy.deepcopy(quant.params).to(DEV),
                                  quant.result, quant.quantized_sites,
                                  quant.fallback_sites)
        runs = [(card, DEV, card_qp), (host, "cpu", quant)]
    outs = []
    for run in runs:
        kw = {} if quant is None else dict(precision="w8a8",
                                           quantized_params=run[2])
        eng = InferenceEngine(small, run[0], batch_slots=3, max_len=64,
                              prefill_buckets=(8, 16, 32), device=run[1],
                              **kw)
        reqs = _requests(6, 3, 30, 8, small.vocab_size, seed=3)
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    agree = token_agreement(zip(*outs))
    print(f"check: {label}, card vs host greedy-token agreement {agree:.4f} "
          f"over 6 requests", flush=True)
    if agree < 0.95:
        raise AssertionError(f"{label}: card/host token agreement {agree} < "
                             f"0.95")
    return agree


def phase_check(cfg, params):
    """The reduced config (f32, head_dim 16) and the head_dim-128 bf16 one
    (``reduce_hd128``), each in its own precision and in w8a8 with an int8
    KV cache (one build step on the host, its quantized model copied to the
    card), served on the card and on the host; then a full-width prefill."""
    for small, name in ((reduce_for_smoke(get_config("deepseek-7b")),
                         "reduced deepseek-7b"),
                        (reduce_hd128(get_config("deepseek-7b")),
                         "reduced deepseek-7b bf16 head_dim 128")):
        host = model_mod.init_params(small, seed=0, device="cpu")
        _card_vs_host(name, small, host)
        small_q = _int8_kv(small)
        qp = build_quantized_params(small_q, host)
        _card_vs_host(f"{name} w8a8 + int8 KV ({qp.quantized_sites} sites "
                      f"int8)", small_q, host, qp)
    prompt = torch.from_numpy(_requests(1, 200, 200, 1, cfg.vocab_size,
                                        seed=4)[0].tokens)[None]
    with torch.inference_mode():
        h, _ = model_mod.prefill(params, cfg, {"tokens": prompt},
                                 max_len=256)
    if h.shape != (1, cfg.d_model) or not torch.isfinite(h).all():
        raise AssertionError(f"full-width prefill hidden {tuple(h.shape)} "
                             f"is not finite")
    print(f"check: full-width prefill hidden {tuple(h.shape)} finite, "
          f"rms {h.float().pow(2).mean().sqrt().item():.4f}", flush=True)


# ---- profile ----------------------------------------------------------------

MATMUL_KERNEL_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


LM_SHARES = {"matmul kernels": MATMUL_KERNEL_NAMES,
             "flash_fwd_kernel": ("flash_fwd_kernel",),
             "decode_kernel": ("decode_kernel",),
             "decode_int8_kernel": ("decode_int8_kernel",),
             # w8a8_kernel_tma (M > 16) and the byte-wise w8a8_kernel
             "w8a8_kernel": ("w8a8_kernel",),
             "w8a8_splitk_kernel (M <= 16)": ("w8a8_splitk_kernel",)}


def profile_window(label: str, fn, steps: int, shares=LM_SHARES) -> None:
    """Device busy share of ``fn`` (which ends in a host copy or a wait): its
    wall time untraced, then its kernels' device time from one traced run,
    with the share of each group of kernel names in ``shares``."""
    fn()                                                     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side activities only (kernels, copies, memsets): an aten op's
    # own device time counts the kernels it launched a second time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    if not events:
        print(f"profile: {label}: wall {wall_ms / steps:.3f} ms per step; "
              f"device time not measured (the trace holds no device "
              f"activity)", flush=True)
        return
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3

    def share(names):
        return sum(e.self_device_time_total for e in events
                   if any(n in e.key.lower() for n in names)) / 1e3 / dev_ms

    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    groups = ", ".join(f"{name} {100 * share(names):.1f}%"
                       for name, names in shares.items())
    print(f"profile: {label}: wall {wall_ms / steps:.3f} ms per step "
          f"(untraced), device kernels {dev_ms / steps:.3f} ms per step, "
          f"device busy {100 * dev_ms / wall_ms:.1f}% of the wall time; "
          f"{groups} of device time; "
          f"{sum(e.count for e in events) // steps} device activities "
          f"per step", flush=True)
    for e in top:
        print(f"profile: {label}:   {e.self_device_time_total / 1e3 / steps:8.3f}"
              f" ms/step x{e.count // steps:<4d} {e.key[:90]}", flush=True)


def phase_profile(cfg, params, tag: str = ""):
    """Where one full-width prefill call and one decode step spend their
    time: the model layer driven directly at the serve phase's shapes
    (``params`` may be a quantized model, ``cfg`` an int8-KV config)."""
    B, S, max_len = 4, 512, 1024
    lens = torch.tensor([512, 300, 77, 1], device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    valid = torch.arange(S, device=DEV)[None, :] < lens[:, None]
    caches = model_mod.init_caches(cfg, B, max_len, DEV)

    @torch.inference_mode()
    def prefill():
        x, _ = model_mod.forward(params, cfg, {"tokens": toks},
                                 mode="prefill", caches=caches,
                                 kv_valid=valid)
        last = x[torch.arange(B, device=DEV), lens - 1]
        return model_mod.greedy_next(params, cfg, last).cpu()

    steps = 8

    @torch.inference_mode()
    def decode():
        pos = lens.to(torch.int32)
        nxt = prefill_tokens[:, None].to(DEV)
        for i in range(steps):
            h, _ = model_mod.decode_step(params, cfg, nxt, caches, pos + i)
            nxt = model_mod.greedy_next(params, cfg, h).cpu()[:, None] \
                .to(DEV)

    prefill_tokens = prefill()
    profile_window(f"{tag}prefill {B}x{S} (lens {lens.tolist()})", prefill, 1)
    profile_window(f"{tag}decode step, {B} rows at pos {lens.tolist()}+",
                   decode, steps)


# ---- DLRM -------------------------------------------------------------------

DLRM_REQUESTS, DLRM_BATCH = 64, 64
DLRM_SHARES = {"matmul kernels": MATMUL_KERNEL_NAMES,
               "sls_kernel": ("sls_kernel",)}


def _zero_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def _require_sls(label: str, launches: dict, kind: str, n: int) -> None:
    """``kind`` ran once a request and the other SLS kernels not at all."""
    want = {k: (n if k == kind else 0) for k in SLS_PLAIN}
    got = {k: launches[k] for k in SLS_PLAIN}
    if got != want:
        raise AssertionError(f"{label}: SLS launches {got}, expected {want}")


def phase_serve_dlrm():
    """DLRM serving at PAPER_COMPLEX's published widths on one card (every
    table halved: the int8 slab of the full table set, 117 GB, does not fit
    80 GB). Returns (int8 SLS launches, the engine, one batch)."""
    cfg = dlrm_paper.PAPER_COMPLEX_ONE_CARD
    asn = dlrm_mod.make_assignment(cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm_mod.init_dlrm(cfg, asn,
                                torch.Generator(device=DEV).manual_seed(0),
                                DEV, quantize=True)
    torch.cuda.synchronize()
    slab = params["slab_q"]
    slab_gb = sum(t.numel() * t.element_size() for t in slab.values()) / 1e9
    print(f"init-dlrm: {cfg.name}, {cfg.num_tables} tables, "
          f"{asn.total_rows} slab rows x {cfg.embed_dim} in int8 "
          f"({slab_gb:.2f} GB with fp16 scale and bias) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    eng = DLRMEngine(cfg, asn, params, device=DEV)
    t0 = time.perf_counter()
    batches = [next(dlrm_batches(cfg, DLRM_BATCH, seed=s))
               for s in range(DLRM_REQUESTS)]
    print(f"serve-dlrm: {DLRM_REQUESTS} batches of {DLRM_BATCH} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # full-trace warm-up, excluded from latency and transfer stats, as the
    # JAX launcher does
    eng.serve(batches, pipelined=True, warm=True)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, stats = eng.serve(batches, pipelined=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in LAUNCHERS.items()}
    tel = eng.telemetry
    lat = tel.latency_percentiles()
    print(f"serve-dlrm: served {tel.served}/{DLRM_REQUESTS} requests of "
          f"{DLRM_BATCH} in {wall:.3f} s, "
          f"{DLRM_REQUESTS * DLRM_BATCH / wall:.0f} items/s, latency p50 "
          f"{lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms (all submitted at "
          f"once), transfer bytes saved "
          f"{100 * eng.transfer_stats.bytes_saved_frac:.1f}%, slab "
          f"{slab_gb:.2f} GB, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"serve-dlrm: kernel launches {launches}", flush=True)
    if tel.served != DLRM_REQUESTS:
        raise AssertionError(f"served {tel.served} of {DLRM_REQUESTS}")
    bad = [i for i, o in enumerate(outs)
           if o.shape != (DLRM_BATCH,) or not torch.isfinite(o).all()]
    if bad:
        raise AssertionError(f"serve-dlrm: requests {bad} gave no finite "
                             f"({DLRM_BATCH},) logits")
    _require_sls("serve-dlrm", launches, "sls_int8", DLRM_REQUESTS)
    # per-stage times: a measured re-run outside the counted window
    _, mstats = eng.serve(batches, pipelined=True, warm=True, measure=True)
    print("serve-dlrm: stage times (sequential, per request) " + ", ".join(
        f"{k} {1e3 * v / DLRM_REQUESTS:.3f} ms"
        for k, v in mstats.stage_time_s.items()), flush=True)
    # one request against the plain version on the same 58.6 GB slab
    x = eng.ingest(batches[0])
    idx, lens = x["sls"]
    with torch.inference_mode():
        pooled = dlrm_mod.sls_forward(params, cfg, asn, idx, lens)
        B, T, L = idx.shape
        gidx = idx + torch.tensor(asn.table_offset, dtype=torch.int32,
                                  device=DEV)[None, :, None]
        want = sls_int8_ref(slab["q8"], slab["scale"], slab["bias"],
                            gidx.reshape(B * T, L),
                            lens.reshape(-1)).reshape(B, T, -1)
        err = compare("serve-dlrm pooled", pooled, want, torch.float32,
                      tol=SLS_TOL["sls_int8"])
        logits = dlrm_mod.dense_forward(params, cfg, x["dense"], want)
        lerr = compare("serve-dlrm logits", outs[0], logits, torch.float32)
    keep = torch.arange(L, device=DEV)[None, None, :] < lens[..., None]
    top = gidx[keep].max().item()
    print(f"serve-dlrm: request 0 pooled {tuple(pooled.shape)} within "
          f"{err:.3e} of the plain version on the same slab, logits within "
          f"{lerr:.3e} of the dense stage on it; highest row read {top} "
          f"(byte offset {top * cfg.embed_dim}; 2^32 is {2**32})",
          flush=True)
    return launches["sls_int8"], eng, batches[0]


def phase_profile_dlrm(eng, batch) -> None:
    """One traced pipeline pass (ingest, sparse, dense, post) of a batch."""
    profile_window(f"dlrm pipeline pass, batch {DLRM_BATCH}",
                   lambda: eng.serve([batch], pipelined=True, warm=True), 1,
                   shares=DLRM_SHARES)


def phase_check_dlrm() -> dict:
    """Reduced PAPER_COMPLEX with an fp32, an int8 and an int4 slab: the
    same weights served on the card and on the host. Returns each SLS
    kernel's launches on its card run."""
    base = dlrm_paper.reduce_for_smoke(dlrm_paper.PAPER_COMPLEX)
    batches = [next(dlrm_batches(base, 16, seed=s)) for s in range(4)]
    launches = {}
    for bits, kind in ((None, "sls_fp"), (8, "sls_int8"), (4, "sls_int4")):
        cfg = dataclasses.replace(base, quant=dataclasses.replace(
            base.quant, embedding_bits=bits or 8))
        asn = dlrm_mod.make_assignment(cfg, 1)
        host = dlrm_mod.init_dlrm(cfg, asn, torch.Generator().manual_seed(0),
                                  "cpu", quantize=bits is not None)
        card = dlrm_mod.params_to(host, DEV)
        eng = DLRMEngine(cfg, asn, card, device=DEV)
        _zero_launches()
        outs, _ = eng.serve(batches)
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
        _require_sls(f"check-dlrm {kind}", counts, kind, len(batches))
        launches[kind] = counts[kind]
        ref, _ = DLRMEngine(cfg, asn, host, device="cpu").serve(batches)
        lerr = max(compare(f"check-dlrm {kind} logits", o.cpu(), r,
                           torch.float32) for o, r in zip(outs, ref))
        perr = 0.0
        for b in batches:
            pooled = [dlrm_mod.sls_forward(
                p, cfg, asn, torch.from_numpy(b["indices"]).to(d),
                torch.from_numpy(b["lengths"]).to(d)).cpu()
                for p, d in ((card, DEV), (host, "cpu"))]
            perr = max(perr, compare(f"check-dlrm {kind} pooled", *pooled,
                                     torch.float32, tol=SLS_TOL[kind]))
        print(f"check-dlrm: reduced PAPER_COMPLEX, "
              f"{'fp32' if bits is None else f'int{bits}'} slab: card vs "
              f"host pooled max abs err {perr:.3e} (tol {SLS_TOL[kind]}), "
              f"logits {lerr:.3e} (tol {TOL[torch.float32]}) over "
              f"{len(batches)} requests; {kind} launched {counts[kind]} "
              f"times", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    global SMS
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    phase_build()
    main_path = phase_kernels()
    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"init: deepseek-7b full width, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, bf16_outputs = phase_serve(cfg, params)
    launches_q, quant_params = phase_serve_quant(cfg, params, bf16_outputs)
    phase_check(cfg, params)
    phase_profile(cfg, params)
    phase_profile(_int8_kv(cfg), quant_params, tag="w8a8+int8kv ")
    # each kernel's launches are those of the serve phase that runs it
    launches.update({k: launches_q[k] for k in ("w8a8_matmul",
                                                "decode_attn_int8")})
    # the DLRM slab needs the card: drop every deepseek-7b tensor first
    del params, quant_params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"freed deepseek-7b: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)
    launches["sls_int8"], eng, batch = phase_serve_dlrm()
    phase_profile_dlrm(eng, batch)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches.update({k: n for k, n in phase_check_dlrm().items()
                     if k != "sls_int8"})
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = [dict(name=name, route="cuda", **KERNELS[name],
                 launches=launches[name],
                 **{k: main_path[name][k] for k in keys})
            for name in KERNELS]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

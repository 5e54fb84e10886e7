#!/usr/bin/env python3
"""Time the two merges of the split-S decode kernels against each other on
one NVIDIA GPU: ``python3 scripts/torch_decode_merge.py`` from the
repository root.

A row of more than one chunk merges its chunks' (acc, m, l) records either
in the split launch itself, by the block that arrives last, or in
``merge_kernel``, a second launch with a block per 128 output elements
(``csrc/decode_split.cuh``). The header picks by the bytes of one (row, kv
head)'s records (``DECODE_MERGE_IN_LAUNCH_BYTES``). This script builds
``csrc/decode.cu`` and ``csrc/decode_int8.cu`` twice, once with every merge
in the launch and once with every merge apart, and runs both builds through
the wrappers' own plans (``kernels/decode_attn/ops.py``) at the serving
shapes of deepseek-7b, gemma2-27b (ring and global layers) and gemma-2b, and
at shapes whose records lie between theirs. Each call is held against its
plain version, then timed in a ``torch.profiler`` window, each call after
an L2 flush and between two marker kernels: "busy" sums the device
activities between the markers, "span" runs from the first one's start to
the last one's end (the gap between the two launches included). Each build
runs in a process of its own (``--variant``; the two builds' kernels share
their names), in the order in-launch, apart, apart, in-launch. Needs one
CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    decode_attn_int8_ref, decode_attn_ref)

DEV = "cuda"
# the build flag's value for each merge: every multi-chunk row in the launch,
# or every one apart
VARIANTS = {"in_launch": str(2 ** 62), "apart": "0"}
# name -> (B, H, K, hd, S, pos, softcap); bf16 queries (and an fp cache)
CASES = {
    "deepseek7b_B4_S1024_H32_K32_hd128": (4, 32, 32, 128, 1024,
                                          [1023, 600, 31, 0], 0.0),
    "gemma2_ring_B4_S4096_H32_K16_hd128": (4, 32, 16, 128, 4096,
                                           [4095, 4095, 4095, 300], 50.0),
    "gemma2_global_B4_S5120_H32_K16_hd128": (4, 32, 16, 128, 5120,
                                             [4700, 4200, 4127, 350], 50.0),
    "G2_hd128_S16384_pos16383": (4, 32, 16, 128, 16384, [16383] * 4, 0.0),
    "G8_hd128_S4096_pos4095": (4, 32, 4, 128, 4096, [4095] * 4, 0.0),
    "gemma2b_pos127": (4, 16, 1, 256, 4608, [127] * 4, 0.0),
    "gemma2b_pos255": (4, 16, 1, 256, 4608, [255] * 4, 0.0),
    "gemma2b_pos511": (4, 16, 1, 256, 4608, [511] * 4, 0.0),
    "gemma2b_pos1023": (4, 16, 1, 256, 4608, [1023] * 4, 0.0),
    "gemma2b_pos2047": (4, 16, 1, 256, 4608, [2047] * 4, 0.0),
    "gemma2b_B4_S4608_H16_K1_hd256": (4, 16, 1, 256, 4608,
                                      [4095, 3000, 1200, 31], 0.0),
}


def lib_file(name: str, variant: str):
    return _build.BUILD_DIR / f"{name}-merge-{variant}.so"


def build(variant: str) -> dict:
    """Both decode sources built with the variant's merge rule, started
    (the caller waits): name -> (Popen, library path)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("decode", "decode_int8"):
        out = lib_file(name, variant)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               f"-DDECODE_MERGE_IN_LAUNCH_BYTES={VARIANTS[variant]}ull",
               "-o", str(out), str(_build.sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    return procs


def build_all() -> None:
    """Both builds of both sources, all four ``nvcc`` at once."""
    procs = {v: build(v) for v in VARIANTS}
    for v, ps in procs.items():
        for name, (proc, _) in ps.items():
            log, _ = proc.communicate(timeout=900)
            if proc.returncode:
                raise RuntimeError(f"nvcc {name} ({v}) failed:\n{log}")


def load(variant: str) -> dict:
    """source -> the variant's ctypes library."""
    libs = {}
    for name in ("decode", "decode_int8"):
        lib = ctypes.CDLL(str(lib_file(name, variant)))
        fn = (lib.decode_attn_fwd if name == "decode"
              else lib.decode_attn_int8_fwd)
        fn.argtypes = (dops.ARGTYPES if name == "decode"
                       else dops.ARGTYPES_INT8)
        fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def call_fp(lib, q, k, v, pos, softcap, sms):
    """``ops.decode_attn``'s launch, through ``lib``."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    o = torch.empty((B, H, hd), dtype=torch.float32, device=DEV)
    chunk = dops.chunk_plan(B, K, S, sms, hd, k.element_size(), H // K)
    part = dops._scratch(B, H, K, S, hd, chunk, q.device)
    err = lib.decode_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), None if part is None else part.data_ptr(),
        dops._tickets(q.device, B * K).data_ptr(), B, S, H, K, hd, chunk,
        float(softcap), dops._DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "decode")
    return o


def call_int8(lib, q, kq, ks, vq, vs, pos, softcap, sms):
    """``ops.decode_attn_int8``'s launch, through ``lib``."""
    B, H, hd = q.shape
    S, K = kq.shape[1], kq.shape[2]
    o = torch.empty((B, H, hd), dtype=torch.float32, device=DEV)
    chunk = dops.int8_chunk_plan(B, K, S, sms, hd, H // K)
    part = dops._scratch(B, H, K, S, hd, chunk, q.device)
    err = lib.decode_attn_int8_fwd(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), pos.data_ptr(), o.data_ptr(),
        None if part is None else part.data_ptr(),
        dops._tickets(q.device, B * K).data_ptr(), B, S, H, K, hd, chunk,
        float(softcap), dops._DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "decode_int8")
    return o


def window(fns: dict, iters: int = 10) -> dict:
    """name -> (busy ms, span ms), mean of ``iters`` calls, one profiler
    window (``chip_smoke.device_window``'s markers and flush)."""
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
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
        raise RuntimeError(f"{len(marks)} marker kernels in the trace, "
                           f"{2 * iters * len(fns)} launched")
    out = {}
    pairs = list(zip(marks[::2], marks[1::2]))
    for i, name in enumerate(fns):
        busy = span = 0.0
        for a, b in pairs[i * iters:(i + 1) * iters]:
            inner = events[a + 1:b]
            busy += sum(e.time_range.elapsed_us() for e in inner)
            span += (inner[-1].time_range.end - inner[0].time_range.start
                     if inner else 0)
        out[name] = (busy / iters / 1e3, span / iters / 1e3)
    return out


def run_variant(variant: str, out: str) -> None:
    """One build's every case, checked and timed; writes {"times": name ->
    (busy ms, span ms), "records": ...} as JSON to ``out``."""
    libs = load(variant)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=DEV).manual_seed(0)
    fns, records = {}, {}
    for case, (B, H, K, hd, S, pos, cap) in CASES.items():
        q = cs._randn(gen, (B, H, hd), torch.bfloat16)
        k, v = (cs._randn(gen, (B, S, K, hd), torch.bfloat16)
                for _ in range(2))
        cache = cs._int8_cache(gen, B, S, K, hd)
        p = torch.tensor(pos, dtype=torch.int32, device=DEV)
        G = H // K
        chunk = dops.chunk_plan(B, K, S, sms, hd, 2, G)
        chunk8 = dops.int8_chunk_plan(B, K, S, sms, hd, G)
        for kern, c in (("decode", chunk), ("decode_int8", chunk8)):
            nsplit = max(min(x, S - 1) // c + 1 for x in pos)
            records[f"{kern} {case}"] = (c, nsplit,
                                         nsplit * G * (hd + 4) * 4)
        f = (lambda a=(libs["decode"], q, k, v, p, cap): call_fp(*a, sms))
        f8 = (lambda a=(libs["decode_int8"], q, *cache, p, cap):
              call_int8(*a, sms))
        e = cs.compare(f"decode[{case}, {variant}]", f(),
                       decode_attn_ref(q, k, v, p, softcap=cap),
                       torch.bfloat16)
        e8 = cs.compare(f"decode_int8[{case}, {variant}]", f8(),
                        decode_attn_int8_ref(q, *cache, p, softcap=cap),
                        torch.bfloat16)
        print(f"{case} {variant}: max abs err decode {e:.3e}, int8 "
              f"{e8:.3e}", flush=True)
        fns[f"decode {case}"] = f
        fns[f"decode_int8 {case}"] = f8
    with open(out, "w") as fh:
        json.dump({"times": window(fns), "records": records}, fh)


def main() -> None:
    if len(sys.argv) == 5 and sys.argv[1] == "--variant":
        run_variant(sys.argv[2], sys.argv[4])
        return
    if not torch.cuda.is_available():
        sys.exit("torch_decode_merge: no CUDA device")
    print(cs.card_line(), flush=True)
    build_all()
    runs = []
    for i, var in enumerate(("in_launch", "apart", "apart", "in_launch")):
        out = str(_build.BUILD_DIR / f"merge-{i}-{var}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--variant", var, "--out", out], check=True,
                       timeout=900)
        with open(out) as fh:
            runs.append((var, json.load(fh)))
    rows = []
    for name, (chunk, nsplit, rec) in runs[0][1]["records"].items():
        row = {"case": name, "chunk": chunk, "longest_row_chunks": nsplit,
               "longest_row_record_bytes": rec,
               **{v: {"busy_ms": [], "span_ms": []} for v in VARIANTS}}
        for var, r in runs:
            busy, span = r["times"][name]
            row[var]["busy_ms"].append(busy)
            row[var]["span_ms"].append(span)
        rows.append(row)
        print(f"{name}: chunk {chunk}, longest row {nsplit} chunks = {rec} "
              f"B of records; span ms in-launch "
              f"{' '.join(f'{x:.4f}' for x in row['in_launch']['span_ms'])},"
              f" apart {' '.join(f'{x:.4f}' for x in row['apart']['span_ms'])}"
              f"; busy in-launch "
              f"{' '.join(f'{x:.4f}' for x in row['in_launch']['busy_ms'])},"
              f" apart {' '.join(f'{x:.4f}' for x in row['apart']['busy_ms'])}",
              flush=True)
    print(json.dumps({"merge_ab": rows}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Sweep the launch plans of the port's two decode-step kernels on one NVIDIA
GPU: ``python3 scripts/torch_decode_plans.py`` from the repository root.

- ``nvcc -Xptxas -v`` of ``csrc/w8a8.cu``, ``csrc/decode_int8.cu`` and
  ``csrc/decode.cu``: the registers, shared memory and spills of the
  split-K and split-S kernels.
- The w8a8 split-K kernel (M <= 16) at deepseek-7b's three decode shapes,
  every K split from 1 to 8 against the plain version bit for bit (M = 1,
  4, 8, 16), then the device time of each split at M = 4.
- The int8-KV decode kernel at the main decode shape (B=4, S=1024, H=K=32,
  hd=128, pos 1023, 600, 31, 0), every chunk it takes (64, 128, 192, 256
  keys) against the plain version, then the device time of each chunk.
- The bf16 decode kernel at the same shape, every chunk (64-256) against
  the plain version and timed beside ``scaled_dot_product_attention`` on
  the same inputs; the f32 cache at chunks 64 and 128 (the largest its
  shared memory takes at hd 128), checked and timed.

Device times come from one ``torch.profiler`` window per kernel, each call
after an L2 flush (``chip_smoke.device_window``). The plans the wrappers
pick (``kernels/w8a8/ops.py::splitk_plan``,
``kernels/decode_attn/ops.py::chunk_plan``) are marked. Needs one CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from scripts import torch_ptxas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    decode_attn_int8_ref, decode_attn_ref)
from repro_torch.kernels.w8a8 import ops as wops  # noqa: E402
from repro_torch.kernels.w8a8.ref import w8a8_ref  # noqa: E402

DEV = "cuda"
W8A8_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))   # (K, N)


def ptxas_report() -> None:
    """Registers, stack and spills of every kernel of the three sources
    (``scripts/torch_ptxas.py``)."""
    torch_ptxas.main(["w8a8", "decode_int8", "decode"])


def w8a8_split(xq, wq, xs, ws, split: int) -> torch.Tensor:
    M, K = xq.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=DEV)
    lib = wops._lib()
    err = lib.w8a8_matmul_fwd(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
                              ws.data_ptr(), out.data_ptr(), M, N, K, split,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"w8a8 split {split}")
    return out


def decode_chunk(q, kq, ks, vq, vs, pos, chunk: int) -> torch.Tensor:
    B, H, hd = q.shape
    S, K = kq.shape[1], kq.shape[2]
    o = torch.empty((B, H, hd), dtype=torch.float32, device=DEV)
    part = dops._scratch(B, H, K, S, hd, chunk, q.device)
    lib = dops._lib_int8()
    err = lib.decode_attn_int8_fwd(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), pos.data_ptr(), o.data_ptr(),
        None if part is None else part.data_ptr(),
        dops._tickets(q.device, B * K).data_ptr(), B, S, H, K, hd, chunk, 0.0,
        dops._DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"decode_int8 chunk {chunk}")
    return o


def decode_fp_chunk(q, k, v, pos, chunk: int) -> torch.Tensor:
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    o = torch.empty((B, H, hd), dtype=torch.float32, device=DEV)
    part = dops._scratch(B, H, K, S, hd, chunk, q.device)
    lib = dops._lib()
    err = lib.decode_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), o.data_ptr(),
        None if part is None else part.data_ptr(),
        dops._tickets(q.device, B * K).data_ptr(), B, S, H, K, hd, chunk, 0.0,
        dops._DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"decode {q.dtype} chunk {chunk}")
    return o


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_decode_plans: no CUDA device")
    print(cs.card_line(), flush=True)
    ptxas_report()
    _build.build_all(["w8a8", "decode_int8", "decode"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=DEV).manual_seed(0)
    splits = range(1, wops.SPLITK_MAX + 1)
    fns = {}
    for K, N in W8A8_SHAPES:
        pick = wops.splitk_plan(N, K, sms)
        for M in (1, 4, 8, 16):
            xq, wq, xs, ws = cs._w8a8_inputs(gen, M, K, N, True)
            want = w8a8_ref(xq, wq, xs, ws)
            for split in splits:
                cs.check_w8a8(f"M{M} K{K} N{N} split {split}",
                              w8a8_split(xq, wq, xs, ws, split), want)
            if M == 4:
                for split in splits:
                    mark = " (plan)" if split == pick else ""
                    fns[f"w8a8 M4 K{K} N{N} split {split}{mark}"] = (
                        lambda a=(xq, wq, xs, ws), s=split: w8a8_split(*a, s))
        print(f"w8a8 K{K} N{N}: splits 1-8 equal the plain version bit for "
              f"bit at M 1, 4, 8, 16", flush=True)
    B, H, K, hd, S = 4, 32, 32, 128, 1024
    q = cs._randn(gen, (B, H, hd), torch.bfloat16)
    cache = cs._int8_cache(gen, B, S, K, hd)
    pos = torch.tensor([1023, 600, 31, 0], dtype=torch.int32, device=DEV)
    want = decode_attn_int8_ref(q, *cache, pos)
    pick = dops.int8_chunk_plan(B, K, S, sms, hd, H // K)
    for chunk in (64, 128, 192, 256):
        err = cs.compare(f"decode_int8 chunk {chunk}",
                         decode_chunk(q, *cache, pos, chunk), want,
                         torch.bfloat16)
        mark = " (plan)" if chunk == pick else ""
        print(f"decode_int8 chunk {chunk}: max abs err {err:.3e}", flush=True)
        fns[f"decode_int8 chunk {chunk}{mark}"] = (
            lambda c=chunk: decode_chunk(q, *cache, pos, c))
    for dt, chunks in ((torch.bfloat16, (64, 128, 192, 256)),
                       (torch.float32, (64, 128))):
        qf = cs._randn(gen, (B, H, hd), dt)
        k, v = (cs._randn(gen, (B, S, K, hd), dt) for _ in range(2))
        want = decode_attn_ref(qf, k, v, pos)
        pick = dops.chunk_plan(B, K, S, sms, hd, k.element_size(), H // K)
        for chunk in chunks:
            err = cs.compare(f"decode {dt} chunk {chunk}",
                             decode_fp_chunk(qf, k, v, pos, chunk), want, dt)
            mark = " (plan)" if chunk == pick else ""
            print(f"decode {dt} chunk {chunk}: max abs err {err:.3e}",
                  flush=True)
            fns[f"decode {dt} chunk {chunk}{mark}"] = (
                lambda a=(qf, k, v), c=chunk: decode_fp_chunk(*a, pos, c))
        if dt == torch.bfloat16:    # the yardstick, on the same inputs
            qt = qf[:, :, None].contiguous()
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            m4 = (torch.arange(S, device=DEV)[None, :]
                  <= pos[:, None])[:, None, None]
            fns["SDPA bf16"] = (lambda a=(qt, kt, vt, m4):
                                F.scaled_dot_product_attention(
                                    *a[:3], attn_mask=a[3]))
    cs.device_window(fns)


if __name__ == "__main__":
    main()

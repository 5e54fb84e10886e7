#!/usr/bin/env python3
"""Flash prefill on one NVIDIA GPU, monolithic and at prefill-chunk offsets,
against another copy of the kernel source: ``python3
scripts/torch_flash_chunks.py [--against DIR]`` from the repository root.

- ``nvcc -Xptxas -v`` of ``csrc/flash.cu`` (and of ``DIR/flash.cu``):
  registers, shared memory and spills of both flash kernels.
- Both libraries checked against the plain version at deepseek-7b's
  prefill shape (B=4, S=T=512, H=K=32, hd=128, bf16, lens 512, 300, 77, 1)
  and, where the source takes query offsets, at its chunk shape (4 x 128
  at offsets 384, 128, 0, 256 over a 4 x 1024 cache).
- The device time of each, from one ``torch.profiler`` window, each call
  after an L2 flush (``chip_smoke.device_window``), in turns: this tree,
  the other, the other, this tree.

``DIR`` holds a ``flash.cu`` and the headers it includes, e.g. the
``src/repro_torch/csrc`` of a ``git archive`` of an earlier commit. Its C
entry point may be the one before query offsets (no ``q_off``,
``kv_rows``, ``Bk``). Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402

DEV = "cuda"


def build(src_dir: Path, out: Path) -> str:
    """Build ``src_dir/flash.cu`` into ``out`` with the port's flags and
    ``-Xptxas -v``; returns ptxas's lines for the kernels."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(src_dir), "-o", str(out), str(src_dir / "flash.cu")]
    log = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=True, timeout=600).stdout
    return "\n".join(ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "Compiling entry" in ln)


def bind(lib_path: Path, src: Path):
    """(call(q, k, v, lens, q_off, kv_rows) -> o, takes offsets) for the
    library's C entry, whichever of the two signatures its source has."""
    lib = ctypes.CDLL(str(lib_path))
    params = re.search(r"int flash_attn_fwd\(([^)]*)\)",
                       src.read_text()).group(1).split(",")
    offsets = len(params) == 19
    n_ptr = 7 if offsets else 5
    lib.flash_attn_fwd.argtypes = ([ctypes.c_void_p] * n_ptr
                                   + [ctypes.c_int] * (len(params) - n_ptr - 3)
                                   + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p])
    lib.flash_attn_fwd.restype = ctypes.c_int

    def call(q, k, v, lens, q_off=None, kv_rows=None):
        B, S, H, hd = q.shape
        Bk, T, K = k.shape[:3]
        o = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr()]
        if offsets:
            ptrs += [None if q_off is None else q_off.data_ptr(),
                     None if kv_rows is None else kv_rows.data_ptr()]
            dims = [B, Bk, S, T, H, K, hd]
        else:
            dims = [B, S, T, H, K, hd]
        err = lib.flash_attn_fwd(*ptrs, o.data_ptr(), *dims, 1, 0, 0.0, 1,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path.name}: CUDA error {err}")
        return o

    return call, offsets


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, default=None,
                    help="a directory with another flash.cu and its headers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_chunks: no CUDA device")
    print(cs.card_line(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"this tree": _build.CSRC_DIR}
    if args.against is not None:
        libs["against"] = args.against.resolve()
    calls = {}
    for name, src_dir in libs.items():
        out = _build.BUILD_DIR / f"flash-ab-{name.replace(' ', '-')}.so"
        print(f"ptxas, flash.cu of {name} ({src_dir}):\n"
              f"{build(src_dir, out)}", flush=True)
        calls[name] = bind(out, src_dir / "flash.cu")
    gen = torch.Generator(device=DEV).manual_seed(0)
    bf16 = torch.bfloat16
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    q, k, v = (cs._randn(gen, (4, 512, 32, 128), bf16) for _ in range(3))
    lens = i32([512, 300, 77, 1])
    qc = cs._randn(gen, (4, 128, 32, 128), bf16)
    kc, vc = (cs._randn(gen, (4, 1024, 32, 128), bf16) for _ in range(2))
    start, lengths = cs.CHUNK_MAIN["start"], cs.CHUNK_MAIN["lengths"]
    clens, coff = i32([s + n for s, n in zip(start, lengths)]), i32(start)
    crows = i32(cs.CHUNK_MAIN["slots"])
    want = flash_attention_ref(q, k, v, lens)
    cwant = flash_attention_ref(qc, kc, vc, clens, q_off=coff, kv_rows=crows)
    fns = {}
    for name, (call, offsets) in calls.items():
        err = cs.compare(f"flash ({name}) main", call(q, k, v, lens), want,
                         bf16)
        line = f"{name}: main max abs err {err:.3e}"
        fns[name] = {"main": lambda c=call: c(q, k, v, lens)}
        if offsets:
            err = cs.compare(f"flash ({name}) chunk",
                             call(qc, kc, vc, clens, coff, crows), cwant, bf16)
            line += f", chunk max abs err {err:.3e}"
            fns[name]["chunk"] = lambda c=call: c(qc, kc, vc, clens, coff,
                                                  crows)
        print(line, flush=True)
    order = list(fns) + list(reversed(list(fns)))
    window = {}
    for turn, name in enumerate(order):
        for shape, fn in fns[name].items():
            window[f"flash ({name}) {shape} [turn {turn}]"] = fn
    cs.device_window(window, iters=20)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Sweep the lane plans of the port's SLS kernel on one NVIDIA GPU:
``python3 scripts/torch_sls_plans.py`` from the repository root.

- ``nvcc -Xptxas -v`` of ``csrc/sls.cu``: registers, shared memory and
  spills of every instance of ``sls_kernel<KIND, VB, U>``.
- At the DLRM main shape (6144 bags of one ``PAPER_COMPLEX`` batch of 64,
  L=128, D=96, on a 2^23-row table, as ``chip_smoke.py`` builds it), each
  kernel (fp32, int8, int4) at 16-, 8- and 4-byte lane loads and every
  row unroll it takes (2, 4 or 8 loads a lane before it adds), each
  against its plain version in the kernel's summation order, with fp32
  ``embedding_bag`` on the same bags.
- What bounds it: the planned kernel on other bags of the same shape:
  "hot" (the main lengths, each index folded into the first 8 rows of its
  table, 768 rows in all, which stay in L2 after their first miss: what
  the kernel's own chain of dependent loads costs), "uniform" (the main
  lengths, indices drawn uniformly over the table: no reuse, every row a
  random device-memory access), "one" (every bag of length 1: the lengths
  -> index -> row chain once) and "empty" (every bag of length 0: the
  launch, the lengths and the output).

Device times come from one ``torch.profiler`` window, each call after an
L2 flush (``chip_smoke.device_window``).
The plan the wrapper picks (``kernels/sls/ops.py::lane_plan``) is marked.
Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sls import ops as sops  # noqa: E402

DEV = "cuda"
ENTRY = {"sls_fp": "sls_fp_fwd", "sls_int8": "sls_int8_fwd",
         "sls_int4": "sls_int4_fwd"}


def ptxas_report() -> None:
    out_dir = _build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out_dir / "sls-ptxas.so"), str(_build.sources()["sls"])]
    log = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=True, timeout=600).stdout
    keep = [ln.strip() for ln in log.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    print("ptxas sls:\n  " + "\n  ".join(keep), flush=True)
    names = [ln.split("sls_kernel")[1].split("EEv")[0] for ln in keep
             if "Compiling entry" in ln]
    regs = [ln.split("Used ")[1].split(" registers")[0] for ln in keep
            if "registers" in ln]
    print("ptxas sls registers by <KIND, VB, U>: " + ", ".join(
        f"{n}: {r}" for n, r in zip(names, regs)), flush=True)


def sls_unroll(kind: str, tables, idx, lens, unroll: int,
               vec: int = 16) -> torch.Tensor:
    """The kernel at ``vec``-byte lane loads and ``unroll`` row loads."""
    t = tables[0]
    D = t.shape[1] * (2 if kind == "sls_int4" else 1)
    NB, L = idx.shape
    out = torch.empty((NB, D), dtype=torch.float32, device=DEV)
    lib = sops._lib()
    err = getattr(lib, ENTRY[kind])(
        *(x.data_ptr() for x in tables), idx.data_ptr(), lens.data_ptr(),
        out.data_ptr(), NB, L, D, t.shape[0], vec, unroll,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{kind} unroll {unroll}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_sls_plans: no CUDA device")
    print(cs.card_line(), flush=True)
    ptxas_report()
    _build.build_all(["sls"])
    gen = torch.Generator(device=DEV).manual_seed(0)
    idx, lens = cs.dlrm_main_bags(cs.SLS_MAIN_ROWS)
    per = cs.SLS_MAIN_ROWS // 96                  # rows of one table
    uniform = torch.randint(0, cs.SLS_MAIN_ROWS, idx.shape, generator=gen,
                            device=DEV, dtype=torch.int32)
    probes = (("main", idx, lens), ("hot", idx // per * per + idx % 8, lens),
              ("uniform", uniform, lens),
              ("one", idx, torch.ones_like(lens)),
              ("empty", idx, torch.zeros_like(lens)))
    fns = {}
    for kind in ENTRY:
        tables = cs._sls_table(gen, kind, cs.SLS_MAIN_ROWS, 96)
        t = tables[0]
        pvec, groups, pick = sops.table_plan(ENTRY[kind], t)
        for name, bags, n in probes:
            want = cs.SLS_PLAIN[kind](*tables, bags, n, groups=groups)
            for vec in (16, 8, 4) if name == "main" else (pvec,):
                g = sops.bag_groups(t.shape[1] * t.element_size(), vec)
                want = cs.SLS_PLAIN[kind](*tables, bags, n, groups=g)
                for unroll in (sops.UNROLLS if name == "main" else (pick,)):
                    label = f"{kind} {name} vec {vec} unroll {unroll}"
                    err = cs.compare(label, sls_unroll(kind, tables, bags, n,
                                                       unroll, vec),
                                     want, torch.float32, tol=cs.SLS_TOL[kind])
                    mark = " (plan)" if (unroll, vec) == (pick, pvec) else ""
                    print(f"{kind} {name} vec {vec} groups {g} unroll "
                          f"{unroll}: max abs err {err:.3e}", flush=True)
                    fns[f"{kind} {name} vec {vec} unroll {unroll}{mark}"] = (
                        lambda k=kind, a=tables, x=bags, m=n, u=unroll, w=vec:
                        sls_unroll(k, a, x, m, u, w))
        if kind == "sls_fp":
            keep = torch.arange(idx.shape[1], device=DEV)[None, :] \
                < lens[:, None]
            flat = idx[keep].long()
            offsets = (torch.cumsum(lens, 0) - lens).long()
            fns["embedding_bag fp32 main"] = (
                lambda a=(flat, t, offsets): F.embedding_bag(*a, mode="sum"))
    cs.device_window(fns)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Registers, stack and spills of the port's CUDA kernels, as ptxas reports
them: ``python3 scripts/torch_ptxas.py [--match TEXT] [source ...]`` from
the repository root on a machine with ``nvcc`` (no GPU needed).

Each named source of ``src/repro_torch/csrc`` (default: every one) is
compiled with the build's flags plus ``-Xptxas -v``, all at once, into a
scratch library under ``src/repro_torch/build/``. One line per kernel
instantiation: its demangled name (``cu++filt``), registers per thread,
stack frame and spill stores / loads in bytes. ``--match`` (repeatable)
keeps the kernels whose demangled name holds one of the TEXTs (e.g.
``256`` for the head_dim-256 instantiations). Imports nothing of JAX;
needs no CUDA device.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\w+)'")
PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def demangle(names):
    """Demangled names by ``cu++filt`` (or ``c++filt``), else as given."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    tool = tool if os.path.exists(tool) else shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def parse(log: str):
    """[(mangled name, registers, stack, spill stores, spill loads)] in the
    order ptxas compiled them."""
    rows, cur = [], None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            cur = [m.group(1), None, 0, 0, 0]
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = PROPS.search(line)
        if m:
            cur[2:5] = [int(x) for x in m.groups()]
        m = REGS.search(line)
        if m:
            cur[1] = int(m.group(1))
    return [tuple(r) for r in rows]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="*", help="csrc sources, e.g. flash")
    ap.add_argument("--match", action="append", default=[],
                    help="keep kernels whose demangled name holds this "
                         "(repeatable: any of them)")
    args = ap.parse_args(argv)
    names = args.sources or list(_build.sources())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(_build.BUILD_DIR / f"{name}-ptxas.so"),
               str(_build.sources()[name])]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            print(f"nvcc {name} failed:\n{log}", flush=True)
            failed.append(name)
            continue
        rows = parse(log)
        pretty = demangle([r[0] for r in rows])
        kept = [(p, r) for p, r in zip(pretty, rows)
                if not args.match or any(m in p for m in args.match)]
        print(f"ptxas {name}: {len(kept)} of {len(rows)} kernels"
              + (f" matching {args.match!r}" if args.match else ""),
              flush=True)
        for p, (_, regs, stack, st, ld) in kept:
            print(f"  {regs} registers, stack {stack} B, spill stores {st} B,"
                  f" spill loads {ld} B: {p}", flush=True)
    if failed:
        raise SystemExit(f"nvcc failed for {failed}")


if __name__ == "__main__":
    main()

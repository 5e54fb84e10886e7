#!/usr/bin/env python3
"""Chosen phases of ``chip_smoke.py`` on one NVIDIA GPU, after its build:
``python3 scripts/torch_smoke_phases.py PHASE...`` from the repository
root, e.g. ``phase_cmdr phase_kimi`` or ``--cmdr-kimi-kernels`` (an entry
of ``chip_smoke.CHILD_PHASES``, run in a process of its own as the whole
script runs it).

Each phase runs as the whole script runs it, on the same card settings
(TF32 off); a phase that raises is printed with its traceback and the next
one runs. The seconds each took and what it returned are printed after
it. Exits 1 if any phase failed. A slice's phases can so be iterated on
without the rest of the script; the whole script is still the proof that
the port runs on the card. Needs one CUDA device; imports nothing of
JAX.
"""
from __future__ import annotations

import os
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main(names) -> int:
    if not torch.cuda.is_available():
        sys.exit("torch_smoke_phases: no CUDA device")
    cs.SMS = torch.cuda.get_device_properties(0).multi_processor_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    t_all = time.perf_counter()
    cs.phase_build()
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            if name in cs.CHILD_PHASES:
                cs.run_child(name)
                out = None
            else:
                out = getattr(cs, name)()
        except Exception:                   # noqa: BLE001 - report, go on
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
            out = "FAILED"
            cs._free_card()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s -> {out}",
              flush=True)
    print(f"phases: {time.perf_counter() - t_all:.1f} s, failed "
          f"{failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

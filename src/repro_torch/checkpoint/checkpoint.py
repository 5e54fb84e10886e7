"""Checkpoints of the port (counterpart of
``repro/checkpoint/checkpoint.py``), in the reference's layout on disk:

- one directory a step, ``step_{N:08d}``, holding each leaf as
  ``leaf_{i:06d}.npy`` in the sorted order of its key, and ``index.json``,
  ``{"step": N, "leaves": {key: {"file", "shape", "dtype"}}}``; the keys
  are the port's ``state_dict`` names
- an atomic commit: the files go to ``step_N.tmp``, which is then renamed,
  so a crash mid-write never leaves a step directory half written
- an async save on a background thread, one in flight at a time
- retention of the last ``keep`` steps

The leaves are written with numpy, which has no bfloat16: a bf16 leaf
raises (the trainer runs in f32).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _host_leaves(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A copy of every leaf on the host, taken before ``save`` returns (the
    caller goes on updating its tensors in place)."""
    out = {}
    for k, t in state.items():
        if t.dtype == torch.bfloat16:
            raise ValueError(f"checkpoint: leaf {k!r} is bfloat16, which "
                             f"numpy cannot write; save it in float32")
        out[k] = t.detach().to("cpu", copy=True).numpy()
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---- save ------------------------------------------------------------
    def save(self, step: int, state: Mapping[str, torch.Tensor], *,
             blocking: bool = True):
        """Write ``state`` (a ``state_dict``) as step ``step``."""
        self.wait()                       # one async save in flight at most
        flat = _host_leaves(state)

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            index = {}
            for i, k in enumerate(sorted(flat)):
                fname = f"leaf_{i:06d}.npy"           # deterministic names
                np.save(os.path.join(tmp, fname), flat[k])
                index[k] = {"file": fname, "shape": list(flat[k].shape),
                            "dtype": str(flat[k].dtype)}
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump({"step": step, "leaves": index}, f)
            if os.path.exists(final):
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                os.replace(tmp, final)                # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---- restore -----------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Step ``step``'s leaves for the keys of ``like`` (a
        ``state_dict``), each in its leaf's dtype and on its device."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)["leaves"]
        out = {}
        for k, t in like.items():
            arr = np.load(os.path.join(path, index[k]["file"]))
            out[k] = torch.from_numpy(arr).to(dtype=t.dtype, device=t.device)
        return out

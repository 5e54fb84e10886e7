"""Data pipeline of the port (counterpart of ``repro/data/pipeline.py``): a
host-side prefetching loader over the synthetic generators. A worker
thread stages the next batches on the device while the device computes:
each array is copied into pinned memory and sent with a non-blocking
copy, so the input path overlaps the step.

The reference's ``shard_batch`` places a batch on a mesh; the port's
waits for its ``torch.distributed`` layer.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

_POLL_S = 0.05     # how often a blocked worker looks for close()


def stage(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: through pinned memory and a
    non-blocking copy on a CUDA device (the caching host allocator keeps
    the pinned block until its copy is done), as they are on the CPU."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


class PrefetchLoader:
    """Wrap a numpy-batch iterator; a worker thread stages the next
    ``depth`` batches on ``device``. An exception in the worker comes out
    of ``__next__``; ``close`` stops the worker and waits for it."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], depth: int = 2,
                 device="cpu"):
        self._it = it
        self._device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set() \
                        or not self._put(stage(batch, self._device)):
                    return
        except Exception as e:                       # surface in __next__
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, timeout: float = 10.0):
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("PrefetchLoader: the worker did not stop")

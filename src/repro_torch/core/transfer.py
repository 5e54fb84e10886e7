"""Paper T6 on the port: partial tensor transfers and command batching on
the host-to-device input path (counterpart of ``repro/core/transfer.py``).

- *Partial tensor transfers*: sparse-index tensors have a static maximum
  size, but only each table's used prefix is shipped.
- *Command batching*: the per-table index prefixes are coalesced into one
  pinned staging buffer and shipped as one copy, then unpacked into the
  static layout on the device.

``TransferStats``, ``SparseBatch`` and ``pack_sparse_inputs`` are copies of
the originals; ``command_batched_transfer`` and ``naive_transfer`` ship
through torch and count exactly as the originals do.

A pinned buffer must not be refilled while an asynchronous copy out of it
is still reading it. ``PinnedStaging`` therefore keeps a ring of buffers,
one per copy in flight, each with an event recorded after its copy, and
waits on that event before it refills the buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class TransferStats:
    bytes_full: int = 0          # what a naive full-size transfer would ship
    bytes_partial: int = 0       # what we actually shipped
    num_transfers_naive: int = 0
    num_transfers_batched: int = 0

    @property
    def bytes_saved_frac(self) -> float:
        return 1.0 - self.bytes_partial / max(self.bytes_full, 1)


@dataclass
class SparseBatch:
    """Static-shape SLS inputs for one request batch.

    indices (B, T, Lmax) int32, lengths (B, T) int32 — per-sample bags per
    table, padded to the compile-time max ``Lmax``.
    """
    indices: np.ndarray
    lengths: np.ndarray

    @property
    def used_per_table(self) -> np.ndarray:
        return self.lengths.max(axis=0)      # (T,) max bag per table


def pack_sparse_inputs(bags: Sequence[Sequence[Sequence[int]]],
                       num_tables: int, max_lookups: int) -> SparseBatch:
    """bags[b][t] = list of indices for sample b, table t."""
    B = len(bags)
    idx = np.zeros((B, num_tables, max_lookups), np.int32)
    lens = np.zeros((B, num_tables), np.int32)
    for b, sample in enumerate(bags):
        for t, bag in enumerate(sample):
            L = min(len(bag), max_lookups)
            idx[b, t, :L] = np.asarray(bag[:L], np.int32)
            lens[b, t] = L
    return SparseBatch(idx, lens)


class PinnedStaging:
    """A ring of ``depth`` pinned host buffers for asynchronous
    host-to-device copies. ``to_device`` takes the next buffer, waits until
    the copies last made out of it have completed, fills it and issues one
    ``non_blocking`` copy per array."""

    ALIGN = 16                      # bytes; each array starts aligned

    def __init__(self, depth: int = 8):
        self._bufs: List[Optional[torch.Tensor]] = [None] * depth
        self._events: List[Optional[torch.cuda.Event]] = [None] * depth
        self._next = 0

    def to_device(self, arrays: Sequence[np.ndarray],
                  device) -> List[torch.Tensor]:
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        starts, n = [], 0
        for a in arrays:
            starts.append(n)
            n += -(-a.nbytes // self.ALIGN) * self.ALIGN
        if self._bufs[i] is None or self._bufs[i].numel() < n:
            self._bufs[i] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        buf, out = self._bufs[i], []
        for a, s in zip(arrays, starts):
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            part = buf[s:s + a.nbytes].view(dtype).view(a.shape)
            part.numpy()[...] = a
            out.append(part.to(device, non_blocking=True))
        if self._events[i] is None:
            self._events[i] = torch.cuda.Event()
        self._events[i].record(torch.cuda.current_stream(device))
        return out


def _ship(arrays: Sequence[np.ndarray], device,
          staging: Optional[PinnedStaging]) -> List[torch.Tensor]:
    """The arrays as tensors on ``device``: through ``staging`` to a card,
    as private copies on the host."""
    device = torch.device(device)
    if device.type == "cuda":
        if staging is None:
            raise ValueError("a transfer to the card goes through a "
                             "PinnedStaging ring")
        return staging.to_device(arrays, device)
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def command_batched_transfer(batch: SparseBatch,
                             stats: Optional[TransferStats] = None,
                             device="cpu",
                             staging: Optional[PinnedStaging] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coalesce all tables' used index prefixes into ONE staging buffer,
    ship it (and the lengths) with one copy each, then unpack it into the
    static layout on the device with one gather (entries past a table's
    used prefix are 0, as in the reference).

    Returns (indices (B,T,Lmax) int32, lengths (B,T) int32) on ``device``.
    """
    B, T, Lmax = batch.indices.shape
    used = batch.used_per_table                     # (T,)
    # partial transfer: ship only rows [0, used_t) of each table's slice
    staged = np.concatenate(
        [batch.indices[:, t, :used[t]].reshape(B, -1) for t in range(T)
         if used[t] > 0] or [np.zeros((B, 0), np.int32)], axis=1)
    if stats is not None:
        stats.bytes_full += batch.indices.nbytes + batch.lengths.nbytes
        stats.bytes_partial += staged.nbytes + batch.lengths.nbytes
        stats.num_transfers_naive += T + 1          # one per table + lengths
        stats.num_transfers_batched += 2            # staged + lengths
    staged_dev, lens_dev = _ship([staged, batch.lengths], device, staging)
    if staged.shape[1] == 0:
        return torch.zeros((B, T, Lmax), dtype=torch.int32,
                           device=lens_dev.device), lens_dev
    # device-side unpack: entry (t, l) of a row is staged column
    # first[t] + l while l < used[t] (used recomputed from the lengths on
    # the device, so nothing else crosses)
    used_dev = lens_dev.amax(dim=0).to(torch.int64)
    first = torch.cumsum(used_dev, 0) - used_dev
    lpos = torch.arange(Lmax, device=lens_dev.device)
    src = (first[:, None] + lpos[None, :]).clamp_(max=staged.shape[1] - 1)
    keep = lpos[None, :] < used_dev[:, None]                    # (T, Lmax)
    out = staged_dev[:, src.reshape(-1)].reshape(B, T, Lmax)
    return torch.where(keep[None], out, 0), lens_dev


def naive_transfer(batch: SparseBatch,
                   stats: Optional[TransferStats] = None,
                   device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: ship every table's full static-size tensor separately
    (from pageable memory)."""
    if stats is not None:
        stats.bytes_full += batch.indices.nbytes + batch.lengths.nbytes
        stats.bytes_partial += batch.indices.nbytes + batch.lengths.nbytes
        stats.num_transfers_naive += batch.indices.shape[1] + 1
        stats.num_transfers_batched += batch.indices.shape[1] + 1
    return (torch.from_numpy(np.array(batch.indices)).to(device),
            torch.from_numpy(np.array(batch.lengths)).to(device))

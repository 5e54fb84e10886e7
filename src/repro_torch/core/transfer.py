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

The sequence-snapshot legs (``snapshot_device_get`` /
``snapshot_device_put``, the LM engine's movable state) ship a whole slot
row — every layer's K/V (and int8 scales) — as ONE copy each way through
one pinned buffer (``SnapshotStaging``), counted in ``TransferStats`` as
the originals count them. A tree is the engine's cache layout: a list
with one dict of tensors per layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

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


Tree = List[Dict[str, torch.Tensor]]


class SnapshotStaging:
    """One pinned host buffer for the snapshot legs, grown on demand. An
    event recorded after a host-to-device copy out of it guards the next
    refill; a device-to-host copy into it is waited for before it is
    read."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None
        self._event: Optional[torch.cuda.Event] = None

    def buffer(self, nbytes: int) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf[:nbytes]

    def record(self, device) -> None:
        if self._event is None:
            self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(device))


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()


def _layout(shapes_dtypes) -> Tuple[List[int], int]:
    """16-byte aligned start of each (shape, dtype) in one byte buffer, and
    the buffer's size."""
    starts, n = [], 0
    for shape, dtype in shapes_dtypes:
        starts.append(n)
        n += -(-_nbytes(shape, dtype) // PinnedStaging.ALIGN) \
            * PinnedStaging.ALIGN
    return starts, n


def _view(buf: torch.Tensor, start: int, shape, dtype) -> torch.Tensor:
    """The bytes of ``buf`` from ``start`` as a (shape, dtype) tensor."""
    n = _nbytes(shape, dtype)
    return buf[start:start + n].view(dtype).view(shape)


def _count(stats: Optional[TransferStats], n_leaves: int, partial: int,
           full: int) -> None:
    if stats is not None:
        stats.bytes_partial += partial
        stats.bytes_full += full
        stats.num_transfers_naive += n_leaves
        stats.num_transfers_batched += 1


def snapshot_device_get(tree: Tree, stats: Optional[TransferStats] = None,
                        full_bytes: Optional[int] = None,
                        staging: Optional[SnapshotStaging] = None) -> Tree:
    """Device->host leg of the sequence-snapshot path: the tree's tensors
    as host tensors of the same shapes and types, bit for bit. On a card,
    the rows are packed into one device buffer and shipped in ONE copy
    into ``staging``'s pinned buffer (command batching: one copy and one
    wait for all leaves, not one per tensor). ``full_bytes`` is what whole
    rows would have shipped; counted as ``TransferStats`` counts it in the
    JAX package (one naive transfer per tensor, one batched)."""
    leaves = [t for layer in tree for t in layer.values()]
    partial = sum(t.numel() * t.element_size() for t in leaves)
    _count(stats, len(leaves), partial,
           full_bytes if full_bytes is not None else partial)
    device = leaves[0].device
    if device.type != "cuda":
        return [{k: t.clone() for k, t in layer.items()} for layer in tree]
    if staging is None:
        raise ValueError("a snapshot from the card goes through a "
                         "SnapshotStaging buffer")
    starts, total = _layout((t.shape, t.dtype) for t in leaves)
    packed = torch.empty(total, dtype=torch.uint8, device=device)
    for t, s in zip(leaves, starts):
        _view(packed, s, t.shape, t.dtype).copy_(t)
    host = staging.buffer(total)
    host.copy_(packed, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    it = iter(zip(leaves, starts))
    return [{k: _view(host, s, t.shape, t.dtype).clone()
             for k, (t, s) in zip(layer, it)} for layer in tree]


def snapshot_device_put(rows: Tree, like: Tree, device,
                        stats: Optional[TransferStats] = None,
                        staging: Optional[SnapshotStaging] = None) -> Tree:
    """Host->device leg of snapshot restore: each host row of ``rows``
    zero-padded along dim 0 to the shape of its tensor in ``like`` (whole
    rows, as the JAX package restores them), all shipped in ONE copy out
    of ``staging``'s pinned buffer. Returns the padded rows on
    ``device``. The restore ships full rows, so partial == full here (the
    saving was taken on the snapshot leg)."""
    pairs = [(r, ref) for rl, ll in zip(rows, like)
             for r, ref in ((rl[k], ll[k]) for k in rl)]
    starts, total = _layout((ref.shape, ref.dtype) for _, ref in pairs)
    full = sum(ref.numel() * ref.element_size() for _, ref in pairs)
    _count(stats, len(pairs), full, full)
    device = torch.device(device)
    if device.type == "cuda":
        if staging is None:
            raise ValueError("a restore to the card goes through a "
                             "SnapshotStaging buffer")
        host = staging.buffer(total)
    else:
        host = torch.empty(total, dtype=torch.uint8)
    for (r, ref), s in zip(pairs, starts):
        v = _view(host, s, ref.shape, ref.dtype)
        v[:r.shape[0]] = r
        v[r.shape[0]:] = 0
    if device.type == "cuda":
        dev = host.to(device, non_blocking=True)
        staging.record(device)
    else:
        dev = host
    it = iter(zip(pairs, starts))
    return [{k: _view(dev, s, ref.shape, ref.dtype)
             for k, ((_, ref), s) in zip(rl, it)} for rl in rows]


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

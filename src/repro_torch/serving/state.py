"""Per-slot sequence state for the LM engine: a copy of
``SequenceStateManager`` and the slot-state kinds it names from
``repro/serving/state.py``, kept so that the port never imports the JAX
package. A *slot* is one batch row of the engine's preallocated KV cache;
at every instant the slots partition into exactly free | active |
prefilling. The monolithic-prefill engine of the port uses ``acquire``,
``activate``, ``release``, ``active_mask`` and ``decode_positions``; the
chunked-prefill, paging, migration and fault-drain moves (``park``,
``release_prefilling``, ``page_out``, ``evict_all``, ``steal_eligible``)
are kept with the class for the slices that port those features.
``SequenceSnapshot``, ``require_chunkable`` and ``FleetPrefixIndex`` join
with them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, CHUNKABLE_KINDS,
                                RECURRENT, SSM, ModelConfig)


class SlotStateKind:
    """How one block kind stores per-slot sequence state, and what the
    chunked-prefill path carries across a chunk boundary."""
    kinds: Tuple[str, ...] = ()
    chunk_carry: str = ""


class KVCacheSlots(SlotStateKind):
    kinds = (ATTN_GLOBAL,)
    chunk_carry = ("positional K/V rows: chunk K/V scatters at per-token "
                   "offsets, queries attend the written prefix")


class RingBufferSlots(SlotStateKind):
    kinds = (ATTN_LOCAL,)
    chunk_carry = ("window ring rows: chunk K/V lands at ring offsets "
                   "(last-write-per-slot), queries attend the pre-chunk "
                   "ring plus in-chunk keys")


class RecurrentSlots(SlotStateKind):
    kinds = (SSM, RECURRENT)
    chunk_carry = ("recurrent state + causal-conv tail: the chunk "
                   "recurrence seeds from the entering state and the exit "
                   "state scatters back")


SLOT_STATE_KINDS: Dict[str, type] = {
    ATTN_GLOBAL: KVCacheSlots,
    ATTN_LOCAL: RingBufferSlots,
    SSM: RecurrentSlots,
    RECURRENT: RecurrentSlots,
}
# one source of truth with the model layer's mode="chunk" gate
assert set(SLOT_STATE_KINDS) == set(CHUNKABLE_KINDS)


def slot_kinds_for(cfg: Optional[ModelConfig]) -> Tuple[SlotStateKind, ...]:
    """Unique slot-state handlers for a config's layer kinds (unknown
    kinds are skipped here — ``require_chunkable`` is where they fail)."""
    if cfg is None:
        return ()
    seen: Dict[type, SlotStateKind] = {}
    for k in cfg.layer_kinds():
        cls = SLOT_STATE_KINDS.get(k)
        if cls is not None and cls not in seen:
            seen[cls] = cls()
    return tuple(seen.values())


class SequenceStateManager:
    """The per-slot state manager behind ``InferenceEngine``: owns the
    free / active / prefilling partitions, per-slot decode positions, and
    the steal/drain eligibility rules (see the module docstring for the
    contract). Pure bookkeeping — no jax, so the property suite can drive
    thousands of lifecycle interleavings against the partition invariant
    without touching a device."""

    def __init__(self, batch_slots: int, cfg: Optional[ModelConfig] = None):
        if batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        self.batch_slots = batch_slots
        self.slot_kinds = slot_kinds_for(cfg)
        self.free: List[int] = list(range(batch_slots))
        self.active: Dict[int, object] = {}       # slot -> Ticket
        # mid-prefill slot ownership, keyed by ticket OBJECT identity:
        # tids are per-scheduler counters, so a stolen ticket's tid can
        # collide with a local mid-prefill ticket's — keying on id() keeps
        # slot ownership with the object (which is pinned by this map and
        # the pending queue, so its id cannot be recycled underneath us)
        self.prefilling: Dict[int, int] = {}      # id(ticket) -> held slot
        self.pos = np.zeros(batch_slots, np.int32)

    # ---- allocation ------------------------------------------------------
    def acquire(self, ticket) -> int:
        """Slot for this ticket's next prefill chunk: a mid-prefill ticket
        keeps the slot it already owns; a fresh ticket pops a free one
        (admission guarantees one exists — ``free_count`` caps the fresh
        share of every chunk group)."""
        tkey = id(ticket)
        if tkey in self.prefilling:
            return self.prefilling.pop(tkey)
        return self.free.pop()

    def park(self, ticket, slot: int) -> None:
        """Keep ``slot`` across a chunked-prefill continuation: the
        partially-written sequence state lives in that cache row."""
        self.prefilling[id(ticket)] = slot

    def activate(self, ticket, slot: int, pos: int) -> None:
        """Prefill done: the slot joins the decode batch at ``pos``."""
        self.active[slot] = ticket
        self.pos[slot] = pos

    def release(self, slot: int) -> None:
        """Request complete: the slot returns to the free pool."""
        del self.active[slot]
        self.free.append(slot)

    def release_prefilling(self, ticket) -> int:
        """Migration-out: a mid-prefill ticket leaves this replica WITH
        its snapshot, so the slot it held frees (the state now lives in
        the snapshot, not the row). Returns the freed slot. The caller
        snapshots BEFORE calling this — after it the row may be reused."""
        slot = self.prefilling.pop(id(ticket))
        self.free.append(slot)
        return slot

    def page_out(self, slot: int):
        """Host-RAM paging: an ACTIVE slot parks its state to a host
        snapshot and frees the row — the session keeps running, it just
        no longer occupies device state. Returns the evicted ticket; the
        engine holds it (with its snapshot) until the fault-back. The
        partition stays exact: the slot moves active -> free in one
        step, and the paged ticket is tracked engine-side, not here."""
        t = self.active.pop(slot)
        self.pos[slot] = 0
        self.free.append(slot)
        return t

    def evict_all(self) -> List[object]:
        """Fault drain: hand back every slot-holding ticket (decode batch
        in slot order — deterministic re-homing) and reset all slot
        state. The caller resets the tickets/payloads to fresh: the
        device-side sequence state died with the card."""
        out = [t for _, t in sorted(self.active.items())]
        self.active.clear()
        self.prefilling.clear()
        self.free = list(range(self.batch_slots))
        self.pos[:] = 0
        return out

    # ---- decode-side read surface ---------------------------------------
    def active_mask(self) -> np.ndarray:
        """(batch_slots,) bool — which rows are live in the decode batch.
        The model layer freezes inactive rows' per-row state under this
        mask (a dummy decode step must not corrupt a mid-prefill row's
        ring buffer or recurrent state)."""
        m = np.zeros(self.batch_slots, bool)
        for s in self.active:
            m[s] = True
        return m

    def decode_positions(self, park_at: int) -> np.ndarray:
        """Per-slot decode positions; inactive rows park at ``park_at`` —
        a position no request ever attends — so their dummy K/V write
        cannot clobber a chunk offset an in-progress prefill filled."""
        pos_vec = np.full(self.batch_slots, park_at, np.int32)
        for s in self.active:
            pos_vec[s] = self.pos[s]
        return pos_vec

    # ---- capacity / router hooks ----------------------------------------
    @property
    def free_count(self) -> int:
        return len(self.free)

    @property
    def inflight(self) -> int:
        return len(self.active) + len(self.prefilling)

    def steal_eligible(self, ticket) -> bool:
        """Steal veto: continuations and mid-prefill tickets own a slot
        on THIS replica — moving one would strand the partially-written
        cache row. Only fresh, not-yet-started tickets may leave."""
        return not getattr(ticket, "continuation", False) \
            and id(ticket) not in self.prefilling

    # ---- invariant surface (tests) ---------------------------------------
    def check_partition(self) -> None:
        """Assert the slot-partition invariant: free | active | prefilling
        are pairwise disjoint and cover exactly the slot range."""
        free = set(self.free)
        active = set(self.active)
        prefilling = set(self.prefilling.values())
        assert len(free) == len(self.free), "free list duplicated a slot"
        assert not (free & active), (free, active)
        assert not (free & prefilling), (free, prefilling)
        assert not (active & prefilling), (active, prefilling)
        assert free | active | prefilling == set(range(self.batch_slots)), \
            (free, active, prefilling)


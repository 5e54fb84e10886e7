"""LM serving engine of the port (counterpart of ``InferenceEngine`` in
``repro/serving/engine.py``): the shared scheduler admits requests into
free slots, each tick prefills the admitted requests in bucketed batched
calls and then runs one decode step over all slots at per-slot positions,
greedy sampling throughout.

``prefill_chunk=N`` splits prompts into N-token chunks that interleave with
decode steps: a tick runs at most ONE bucket-coherent chunk group, then one
decode step. Mid-prefill requests re-enter the queue as continuation
tickets and keep their slot; each chunk writes its K/V at the row's offset
and attends the row's cache through the flash kernel at a query offset,
so chunked prefill is token-identical to monolithic prefill.

Movable sequence state, on one snapshot contract (``snapshot_slot`` /
``restore_slot``, one batched copy each way): a prefix cache of chunk-
multiple prompt prefixes (``prefix_cache=N``), host-RAM paging of active
sessions when fresh arrivals find no slot (``page_host=True``), and
mid-prefill migration (``export_prefill`` / ``adopt_prefill``).

The KV cache is one list of preallocated per-layer tensors that prefill
and decode update in place: a prefill group writes its K/V straight into
the acquired cache rows, and a decode step writes every row, the inactive
ones writing back what they held. (The JAX engine builds a fresh cache per
prefill group, scatters it into the slot rows, and donates the cache to
every step.) The cache's batch and sequence axes are fixed by construction
(dims 0 and 1 of every K/V tensor; a local layer's dim 1 is its ring of
``min(window_size, max_len)`` slots; a recurrent layer's ``h`` and conv
tail have a batch axis only), so no shape probing is needed.

The stages (prefill per ``(bucket, P, precision)``, chunk prefill per
``(bucket, P, precision)``, decode per ``(precision,)``, the keys the JAX
engine jits under) are built in static form, and on the card the
executor captures each as a CUDA graph and replays it: one replay per
stage call, as the reference makes one dispatch of a jitted executable.
Everything a stage call depends on is in its input buffers, the caches
and the weights, so the caches and ``run_params`` are never reassigned.
``cuda_graphs=False`` runs the same static forms eagerly (to hold the
graphs against them); the CPU always does.

Behind a ``ReplicaRouter`` an engine is one replica (``make_replicas``):
``free_slots``, ``steal_eligible`` and ``drain_tickets`` are the router's
hooks, and ``attach_prefix_index`` joins the fleet-shared prefix tier.
``perf_model`` (by default sized from the weights) prices
``prefill_chunk="auto"``; ``observe_stages`` fits it from the engine's own
replayed stage calls.

``precision="w8a8"`` serves through the §V build step's quantized model
(``models/quantize.py``): every int8-decided projection runs the w8a8
kernel, and ``run_params`` is what the stages run on. The KV cache format
follows the config (``cfg.quant.kv_cache_dtype``). A model whose fp and
int8 forms do not fit the device together is built with
``build_quantized_params(..., release_fp=True)`` and passed in as
``quantized_params``; every leaf the stages read must be on the engine's
device, and an engine refuses a model with one elsewhere.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.core.bucketing import pick_bucket
from repro_torch.core.transfer import (SnapshotStaging, TransferStats,
                                       snapshot_device_get,
                                       snapshot_device_put)
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models.quantize import QuantizedParams, build_quantized_params
from repro_torch.serving.executor import StageExecutor, StaticStage
from repro_torch.serving.perf_model import PerfModel
from repro_torch.serving.scheduler import Scheduler, SizeTimePolicy, Ticket
from repro_torch.serving.state import (SequenceSnapshot, SequenceStateManager,
                                       require_chunkable)
from repro_torch.serving.telemetry import Telemetry


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # prompt token ids (L,)
    max_new_tokens: int = 16
    slo_ms: Optional[float] = None     # per-request latency SLA
    priority: int = 0                  # 0 = most important (priority policy)
    output: List[int] = field(default_factory=list)
    enqueue_t: float = 0.0
    finish_t: float = 0.0
    done: bool = False
    shed: bool = False                 # rejected by admission control
    prefill_pos: int = 0               # prompt tokens already prefilled

    @property
    def latency_ms(self) -> float:
        return (self.finish_t - self.enqueue_t) * 1e3


class InferenceEngine:
    """Greedy-decoding LM server: bucketed batched (or chunked) prefill +
    continuous slot-batched decode (per-slot positions) on ``device``."""

    def __init__(self, cfg: ModelConfig, params: model_mod.Model, *,
                 batch_slots: int = 4, max_len: int = 256,
                 prefill_buckets: Sequence[int] = (32, 64, 128),
                 policy: str = "fifo", slo_ms: Optional[float] = None,
                 max_prefill_batch: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 service_ms_est: Optional[float | str] = None,
                 precision: str = "fp32",
                 quantized_params: Optional[QuantizedParams] = None,
                 quant_budget: float = 0.05,
                 prefill_chunk: Optional[int | str] = None,
                 perf_model: Optional[PerfModel] = None,
                 prefix_cache: Optional[int] = None,
                 page_host: bool = False,
                 page_victim: str = "lru",
                 migrate_min_tokens: Optional[int] = None,
                 cuda_graphs: bool = True,
                 device="cuda"):
        if cfg.encdec is not None:
            # the reference's engine refuses a chunk here and would fail at
            # its first prefill without one (it passes no encoder frames);
            # enc-dec configs serve through ``serving/encdec.py``
            if prefill_chunk is not None:
                require_chunkable(cfg)
            raise ValueError(
                f"{cfg.name}: the engine does not serve an encoder-decoder "
                f"config (layer kind 'decoder', a cross-attention decoder: "
                f"its prefill needs the encoder's frames); use "
                f"serving.encdec.EncDecServer")
        if page_victim not in ("lru", "remaining"):
            raise ValueError(f"page_victim must be 'lru' or 'remaining', "
                             f"got {page_victim!r}")
        if precision not in ("fp32", "w8a8"):
            raise ValueError(f"precision must be 'fp32' or 'w8a8', "
                             f"got {precision!r}")
        self.cfg = cfg
        want = torch.device(device)
        self.device = model_mod.model_device(params)    # e.g. cuda:0
        if self.device.type != want.type or (
                want.index is not None and self.device.index != want.index):
            raise ValueError(f"params live on {self.device}, the engine was "
                             f"asked for {want}")
        # the caller's fp model. A w8a8 engine reads it only to size the
        # perf model (``PerfModel.for_params`` counts its leaves); after a
        # build with ``release_fp=True`` its int8 sites' fp weights are on
        # the host, so it pins none of them on the device
        self.params = params
        self.precision = precision
        self.quant = None                  # QuantizedParams build record
        if precision == "w8a8":
            # §V build step: every dense projection goes per-channel int8
            # (over-budget sites stay fp via the workflow's skip-list)
            if quantized_params is None:
                quantized_params = build_quantized_params(
                    cfg, params, budget=quant_budget)
            self.quant = quantized_params
            self.run_params = quantized_params.params
        else:
            self.run_params = params
        # every leaf the stages read must be on the engine's device: one
        # left on the host (a released fp weight) would run its matmul
        # there, or fail inside a kernel wrapper
        off = model_mod.off_device(self.run_params, self.device)
        if off:
            name, where = off[0]
            raise ValueError(
                f"{'quantized' if precision == 'w8a8' else 'fp'} params: "
                f"{name} lives on {where}, the engine serves on "
                f"{self.device} ({len(off)} leaves off the device)")
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.buckets = tuple(b for b in prefill_buckets if b <= max_len)
        # default admits up to all free slots at once; 1 = per-request
        self.max_prefill_batch = max_prefill_batch or batch_slots
        # the analytic performance model, sized from the fp weights: it
        # prices the auto prefill chunk, the estimator's cold-start priors
        # and the router's per-precision costs; ``observe_stages`` fits it
        # from this engine's replayed stage calls
        self.perf_model = (perf_model if perf_model is not None
                           else PerfModel.for_params(params))
        if prefill_chunk == "auto":
            # the chunk at the model's per-bucket efficiency knee (chunked
            # prefill is token-identical for any chunk, so this moves only
            # the latency/efficiency trade)
            prefill_chunk = self.perf_model.suggest_prefill_chunk(
                self.buckets)
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            require_chunkable(cfg)
            # the chunk ladder: the bucket ladder cut at the chunk size
            self.chunk_buckets = tuple(sorted(
                {b for b in self.buckets if b <= prefill_chunk}
                | {prefill_chunk}))

        self.telemetry = Telemetry()
        self.executor = StageExecutor(
            self.telemetry, graphs=cuda_graphs and self.device.type == "cuda")
        if policy == "sizetime":
            # group on the engine's own buckets, or a "coherent" group
            # still splits into several prefill calls
            policy = SizeTimePolicy(self.chunk_buckets if prefill_chunk
                                    else self.buckets)
        self.scheduler = Scheduler(policy, telemetry=self.telemetry,
                                   default_slo_ms=slo_ms,
                                   max_queue=max_queue,
                                   service_ms_est=service_ms_est,
                                   perf_model=self.perf_model)
        self.caches = model_mod.init_caches(cfg, batch_slots, max_len,
                                            self.device)
        # a chunk call's bounds: the global rows' positions and the local
        # rings' slots (None for a kind the model lacks: both for a model
        # of ssm layers alone, whose chunks nothing bounds)
        self._global_len, self._ring = model_mod.cache_extents(cfg,
                                                               self.caches)
        # per layer: is its state positional (a snapshot slices it to the
        # written prefix)? A ring is, only when max_len clamps it below its
        # window (the JAX package's ``_cache_seq_axes``: the ring's extent
        # then grows with max_len); a recurrent or ssm layer's state never
        # is, and moves whole
        self._positional = [kind == ATTN_GLOBAL or (
            kind == ATTN_LOCAL and cfg.window_size > max_len)
            for kind in cfg.layer_kinds()]
        # an int8 chunk stage holds one graph per dequantized extent
        self._int8_kv = any("k_scale" in c for c in self.caches)
        self.states = SequenceStateManager(batch_slots, cfg)

        # movable sequence state: one snapshot contract, three consumers
        # (prefix cache, host-RAM paging, mid-prefill migration)
        self.transfer_stats = TransferStats()
        self._staging = SnapshotStaging() if self.device.type == "cuda" \
            else None
        if prefix_cache is not None and prefill_chunk is None:
            raise ValueError("prefix_cache requires prefill_chunk: cache "
                             "keys are prompt prefixes at chunk granularity")
        self.prefix_cache = prefix_cache         # max cached prefixes (LRU)
        self._prefix_cache: "OrderedDict[Tuple[int, str], SequenceSnapshot]" \
            = OrderedDict()
        # submit-time hits waiting for their first chunk admission:
        # id(ticket) -> snapshot to restore into the acquired slot
        self._pending_restore: Dict[int, SequenceSnapshot] = {}
        # the fleet-shared prefix tier: the router installs its
        # FleetPrefixIndex here (attach_prefix_index); None keeps the cache
        # per-engine
        self._prefix_index = None
        self._replica_id: Optional[int] = None
        self.page_host = page_host
        self.page_victim = page_victim
        # slot -> decode-step stamp of its most recent token (LRU paging)
        self._last_decode: Dict[int, int] = {}
        # paged-out sessions in fault-back (FIFO) order:
        # id(ticket) -> (ticket, snapshot)
        self._paged: "OrderedDict[int, Tuple[Ticket, SequenceSnapshot]]" \
            = OrderedDict()
        # ship a mid-prefill snapshot only once this many tokens of chunk
        # work would otherwise be redone (default: one chunk)
        self.migrate_min_tokens = (migrate_min_tokens
                                   if migrate_min_tokens is not None
                                   else (prefill_chunk or 0))

    @property
    def free(self) -> List[int]:
        return self.states.free

    @property
    def active(self) -> Dict[int, Ticket]:
        return self.states.active

    @property
    def prefilling(self) -> Dict[int, int]:
        return self.states.prefilling

    @property
    def pos(self) -> np.ndarray:
        return self.states.pos

    # ---- stages ----------------------------------------------------------
    # Each stage is built in static form (``executor.StaticStage``): input
    # buffers of the key's shapes and a body over them and the engine's
    # caches and weights, which stay where they are for the engine's life
    # (a captured graph holds their addresses). The executor captures the
    # body as a CUDA graph on the card, or runs it as it is.
    def _zeros(self, *shape, dtype=torch.int32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _build_prefill(self, bucket: int, P: int) -> StaticStage:
        cfg, params, caches = self.cfg, self.run_params, self.caches

        def buffers(_):
            return {"tokens": self._zeros(P, bucket),
                    "lengths": self._zeros(P),
                    "rows": self._zeros(P, dtype=torch.int64)}

        def body(b, _):
            """tokens (P,bucket), lengths (P,): group row j prefills into
            cache row rows[j] (-1: a padded row, which writes nothing of
            its own). Returns the next tokens (P,)."""
            lengths = b["lengths"]
            valid = torch.arange(bucket, device=self.device)[None, :] \
                < lengths[:, None]
            x, _ = model_mod.forward(params, cfg, {"tokens": b["tokens"]},
                                     mode="prefill", caches=caches,
                                     kv_valid=valid, cache_rows=b["rows"])
            last = x[torch.arange(P, device=self.device), lengths.long() - 1]
            return model_mod.greedy_next(params, cfg, last)

        return StaticStage(buffers, body)

    def _build_chunk(self, bucket: int, P: int) -> StaticStage:
        cfg, params, caches = self.cfg, self.run_params, self.caches

        def buffers(_):
            b = {"tokens": self._zeros(P, bucket),
                 "last_idx": self._zeros(P),
                 "slots": self._zeros(P), "start": self._zeros(P),
                 "lens": self._zeros(P),
                 **{k: self._zeros(P * bucket, dtype=torch.int64)
                    for k in ("write_rows", "write_pos", "src")}}
            if self._ring is not None:
                b.update({k: self._zeros(P * bucket, dtype=torch.int64)
                          for k in ("ring_rows", "ring_pos", "ring_src")},
                         ring_idx=self._zeros(P, self._ring,
                                              dtype=torch.int64),
                         ring_n=self._zeros(P), ring_lens=self._zeros(P))
            return b

        def body(b, dequant_len):
            """tokens (P,bucket) and the coordinates of
            ``attention.chunk_writes``: row j's chunk writes its K/V in
            place into cache row slots[j] and attends that row; padded
            rows (lengths 0) write nothing of their own. ``dequant_len``:
            the keys an int8 cache dequantizes (the variant). Returns the
            next tokens (P,)."""
            x, _ = model_mod.forward(
                params, cfg, {"tokens": b["tokens"]}, mode="chunk",
                caches=caches,
                chunk=attn_mod.chunk_coords(b, bucket, dequant_len))
            hidden = x[torch.arange(P, device=self.device),
                       b["last_idx"].long()]
            return model_mod.greedy_next(params, cfg, hidden)

        return StaticStage(buffers, body)

    def _build_decode(self) -> StaticStage:
        cfg, params, caches, B = (self.cfg, self.run_params, self.caches,
                                  self.batch_slots)

        def buffers(_):
            return {"tokens": self._zeros(B, 1), "pos": self._zeros(B),
                    "active": self._zeros(B, dtype=torch.bool)}

        def body(b, _):
            """Every slot's row decodes one token at pos; the rows
            ``active`` leaves out keep their cache. Returns the next
            tokens (B,)."""
            hidden, _ = model_mod.decode_step(params, cfg, b["tokens"],
                                              caches, b["pos"],
                                              active=b["active"])
            return model_mod.greedy_next(params, cfg, hidden)

        return StaticStage(buffers, body)

    # ---- movable sequence state: serialize / restore ---------------------
    def snapshot_slot(self, slot: int, length: int, *,
                      pos: int = 0) -> SequenceSnapshot:
        """Serialize one slot's sequence state to a host-side
        ``SequenceSnapshot``: every cache tensor's row ``slot`` (dim 0 of
        every tensor is the slot), a positional one (a global row, or a
        ring that ``max_len`` clamps, whose slot is its position) sliced to
        the written prefix ``[0, length)`` of dim 1, a ring moved whole, as
        the JAX package moves state that is not addressable by position;
        shipped in one batched copy, with the partial-vs-full byte
        accounting in ``transfer_stats``."""
        n = min(length, self.max_len)
        rows = [{k: t[slot, :n] if positional else t[slot]
                 for k, t in c.items()}
                for c, positional in zip(self.caches, self._positional)]
        full = sum(t[slot].numel() * t.element_size()
                   for c in self.caches for t in c.values())
        host = snapshot_device_get(rows, self.transfer_stats,
                                   full_bytes=full, staging=self._staging)
        partial = sum(t.numel() * t.element_size()
                      for c in host for t in c.values())
        return SequenceSnapshot(length=length, pos=pos, leaves=host,
                                bytes_partial=partial, bytes_full=full)

    def restore_slot(self, snap: SequenceSnapshot, slot: int) -> None:
        """Restore a snapshot into ANY free slot: the rows zero-pad back to
        full rows (positions >= ``snap.length`` are never attended before
        decode or a chunk rewrites them), ship in one batched copy, and are
        written into row ``slot`` of every cache tensor in place."""
        like = [{k: t[slot] for k, t in c.items()} for c in self.caches]
        dev = snapshot_device_put(snap.leaves, like, self.device,
                                  self.transfer_stats, self._staging)
        for cache, rows in zip(self.caches, dev):
            for k, row in rows.items():
                cache[k][slot].copy_(row)

    # ---- prefix cache (consumer 1) ---------------------------------------
    def _prefix_key(self, tokens: np.ndarray, length: int):
        """Cache key for a prompt prefix: (length, sha1 of the token ids),
        at chunk granularity, so requests that share a system prompt share
        every chunk-multiple prefix key."""
        raw = np.ascontiguousarray(tokens[:length], np.int32).tobytes()
        return (length, hashlib.sha1(raw).hexdigest())

    def _prefix_lookup(self, req: Request) -> Optional[SequenceSnapshot]:
        """Longest cached prefix STRICTLY below the request's prefill
        length, at chunk granularity: the final chunk always recomputes,
        so a hit emits its first token through the same math as a cold
        prefill (token-identical by construction). With a fleet index
        attached, a local miss falls through to its shared host-RAM tier."""
        total = self._prefill_len(req)
        L = ((total - 1) // self.prefill_chunk) * self.prefill_chunk
        while L >= self.prefill_chunk:
            key = self._prefix_key(req.tokens, L)
            snap = self._prefix_cache.get(key)
            if snap is not None:
                self._prefix_cache.move_to_end(key)          # LRU touch
                return snap
            if self._prefix_index is not None:
                snap = self._prefix_index.host_get(key)
                if snap is not None:
                    self._prefix_store(key, snap)
                    self.telemetry.record_prefix_host_hit()
                    return snap
            L -= self.prefill_chunk
        return None

    def _prefix_store(self, key, snap: SequenceSnapshot) -> None:
        """Put one snapshot into the LRU (dedup by content key, bounded by
        ``prefix_cache`` entries) and keep the fleet index exact: an insert
        registers this replica as a holder, an eviction deregisters it and
        parks the evicted snapshot in the shared host-RAM tier."""
        if key in self._prefix_cache:
            self._prefix_cache.move_to_end(key)
            return
        self._prefix_cache[key] = snap
        if self._prefix_index is not None:
            self._prefix_index.add(key, self._replica_id)
        while len(self._prefix_cache) > self.prefix_cache:
            old_key, old_snap = self._prefix_cache.popitem(last=False)
            if self._prefix_index is not None:
                self._prefix_index.discard(old_key, self._replica_id)
                self._prefix_index.host_insert(old_key, old_snap)

    def _prefix_insert(self, req: Request, slot: int) -> None:
        """Admit the slot's written prefix into the cache at a chunk
        boundary."""
        key = self._prefix_key(req.tokens, req.prefill_pos)
        if key in self._prefix_cache:
            self._prefix_cache.move_to_end(key)
            return
        self._prefix_store(key, self.snapshot_slot(slot, req.prefill_pos))

    # ---- fleet-shared prefix tier (ReplicaRouter hooks) -------------------
    def attach_prefix_index(self, index, replica_id: int) -> None:
        """Join a fleet-wide prefix tier: ``index`` is the router's
        ``FleetPrefixIndex``; every local insert and eviction is mirrored
        there and local misses fault in from its host-RAM tier."""
        self._prefix_index = index
        self._replica_id = replica_id

    def prefix_keys(self, req: Request) -> List[Tuple[int, str]]:
        """Candidate prefix keys of a request, longest first (the router's
        steering probe): the walk of ``_prefix_lookup``, on tokens only,
        so any replica of the same config gives the same keys."""
        if not self.prefix_cache or req.prefill_pos:
            return []
        total = self._prefill_len(req)
        L = ((total - 1) // self.prefill_chunk) * self.prefill_chunk
        out = []
        while L >= self.prefill_chunk:
            out.append(self._prefix_key(req.tokens, L))
            L -= self.prefill_chunk
        return out

    def prefix_snapshot(self, key) -> Optional[SequenceSnapshot]:
        """Holder side of a ship: the local snapshot of ``key``
        (LRU-touched), or None if this replica no longer holds it."""
        snap = self._prefix_cache.get(key)
        if snap is not None:
            self._prefix_cache.move_to_end(key)
        return snap

    def prefix_accept(self, key, snap: SequenceSnapshot) -> None:
        """Landing side of a ship: a sibling's snapshot (host tensors of
        the same shapes) enters this replica's cache, so the request the
        router submits here next hits locally."""
        self._prefix_store(key, snap)

    def export_prefix_cache(self) -> List[Tuple[Tuple[int, str],
                                                SequenceSnapshot]]:
        """Drain hook: the local cache's entries, oldest first. They are
        host-side, so they outlive the replica in the shared tier."""
        return list(self._prefix_cache.items())

    # ---- host-RAM paging (consumer 2) ------------------------------------
    def _page_out_one(self) -> bool:
        """Park one active slot to host RAM so a fresh arrival can have
        its row. ``page_victim="lru"`` picks the slot whose last decoded
        token is oldest (ties to the lowest slot); ``"remaining"`` the
        session with the most tokens still to generate (ties to the
        highest slot)."""
        if not self.states.active:
            return False

        def remaining(t: Ticket) -> int:
            req: Request = t.payload
            return req.max_new_tokens - len(req.output)

        if self.page_victim == "lru":
            slot = min(self.states.active,
                       key=lambda s: (self._last_decode.get(s, -1), s))
        else:
            slot = max(self.states.active,
                       key=lambda s: (remaining(self.states.active[s]), s))
        p = int(self.states.pos[slot])
        snap = self.snapshot_slot(slot, p, pos=p)
        t = self.states.page_out(slot)
        self._last_decode.pop(slot, None)
        self._paged[id(t)] = (t, snap)
        self.telemetry.record_paged_out()
        return True

    def _page_in(self) -> None:
        """Fault paged sessions back into whatever slots admission left
        free, oldest first; they rejoin the decode batch where they left
        off."""
        while self._paged and self.states.free_count > 0:
            _, (t, snap) = self._paged.popitem(last=False)
            slot = self.states.acquire(t)
            self.restore_slot(snap, slot)
            self.states.activate(t, slot, snap.pos)
            self._last_decode[slot] = self.telemetry.steps
            self.telemetry.record_paged_in()

    @property
    def cache_pressure(self) -> float:
        """The host-RAM paging backlog per device slot: 0 when every
        admitted session has a row, 1.0 when a full extra batch of sessions
        waits in host RAM."""
        return len(self._paged) / max(self.batch_slots, 1)

    # ---- mid-prefill migration (consumer 3) ------------------------------
    def migration_eligible(self, t: Ticket) -> bool:
        """A mid-prefill continuation may leave, with its snapshot, once
        it has at least ``migrate_min_tokens`` of completed chunk work."""
        return (t.continuation and id(t) in self.states.prefilling
                and t.payload.prefill_pos >= max(self.migrate_min_tokens, 1))

    def export_prefill(self, t: Ticket) -> SequenceSnapshot:
        """Victim side of a migration: serialize the ticket's completed
        chunk prefix and free its slot."""
        slot = self.states.prefilling[id(t)]
        snap = self.snapshot_slot(slot, t.payload.prefill_pos)
        self.states.release_prefilling(t)
        return snap

    def adopt_prefill(self, t: Ticket, snap: SequenceSnapshot) -> None:
        """Thief side: restore the snapshot into a free slot and park it;
        the continuation then chunks on from ``prefill_pos``."""
        slot = self.states.acquire(t)
        self.restore_slot(snap, slot)
        self.states.park(t, slot)
        self.telemetry.record_migrated()

    # ---- main loop -------------------------------------------------------
    def _eff_len(self, req: Request) -> int:
        """Effective prefill length: what admission sizing and bucket
        choice both key on."""
        return min(len(req.tokens), self.max_len - req.max_new_tokens - 1)

    def submit(self, req: Request, *, slo_ms: Optional[float] = None,
               priority: Optional[int] = None) -> Ticket:
        """Enqueue a request; keyword overrides beat the request's own
        slo/priority. ``shed=True`` on the ticket means admission control
        rejected it. A prefix-cache hit enters the queue sized to the
        remaining prefill and carries a pending restore: its first chunk
        admission restores the snapshot and prefill resumes at the prefix
        boundary."""
        hit = None
        if self.prefix_cache and not req.prefill_pos:
            hit = self._prefix_lookup(req)
        size = self._eff_len(req) - (hit.length if hit is not None else 0)
        t = self.scheduler.submit(
            req, size=max(size, 1),
            slo_ms=slo_ms if slo_ms is not None else req.slo_ms,
            priority=priority if priority is not None else req.priority)
        req.enqueue_t = t.enqueue_t
        req.shed = t.shed
        if hit is not None and not t.shed:
            req.prefill_pos = hit.length
            self._pending_restore[id(t)] = hit
            self.telemetry.record_prefix_hit()
        return t

    @property
    def inflight(self) -> int:
        # paged sessions are admitted-but-unfinished work
        return self.states.inflight + len(self._paged)

    @property
    def free_slots(self) -> int:
        """Free slots: how many stolen tickets this replica could start
        now (the router's steal cap). Paged sessions reserve their
        fault-back slots."""
        return max(self.states.free_count - len(self._paged), 0)

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.depth or self.states.inflight
                    or self._paged)

    def steal_eligible(self, t: Ticket) -> bool:
        """Steal veto: continuations and mid-prefill tickets own a slot on
        THIS replica, and a prefix hit's pending snapshot lives in this
        engine's cache; only fresh, not-yet-started tickets may leave."""
        return self.states.steal_eligible(t) \
            and id(t) not in self._pending_restore

    def drain_tickets(self) -> List[Ticket]:
        """Fault-drain hook (``ReplicaRouter.drain_replica``): every
        accepted, unfinished ticket (the pending queue, continuations
        included, the in-flight slots and the paged sessions), reset to
        fresh, since the replica's cache state is given up; each request
        restarts from token zero on its new home and greedy decoding
        gives the same output. Clears every slot. Telemetry keeps the
        work this replica did; only ``served`` counts deliveries."""
        out = self.scheduler.steal_pending(None, include_continuations=True)
        out.extend(self.states.evict_all())
        out.extend(t for t, _ in self._paged.values())
        self._paged.clear()
        self._pending_restore.clear()
        self._last_decode.clear()
        for t in out:
            req: Request = t.payload
            req.output = []
            req.prefill_pos = 0
            req.done = False
            t.reset_fresh()
        return out

    def observe_stages(self, perf_model: Optional[PerfModel] = None) \
            -> PerfModel:
        """Fit ``perf_model`` (default: the engine's) from this engine's
        own stage calls: every call but each stage key's first (the
        warm-up, and on the card the capture), timed to completion by the
        executor. A prefill or chunk call is a ``(bucket, P)`` cell, a
        decode step a ``batch_slots``-token cell, at the engine's
        precision. Returns the model."""
        pm = perf_model if perf_model is not None else self.perf_model
        for (stage, key), times in sorted(
                self.executor.warm_call_s.items()):
            bucket, batch = ((self.batch_slots, 1) if stage == "decode"
                             else (key[0], key[1]))
            for seconds in times:
                pm.observe(stage, bucket=bucket, batch=batch,
                           precision=self.precision, seconds=seconds)
        return pm

    def step_once(self):
        """One engine tick. Chunked: at most ONE chunk group, then one
        decode step. Monolithic: refill every freed slot, then one decode
        step. With ``page_host``, paged sessions fault back in after
        admission (fresh arrivals take the free slots first)."""
        if self.prefill_chunk is not None:
            self._admit_chunk()
        else:
            self._admit()
        if self.page_host:
            self._page_in()
        self._step()

    def _admit(self):
        """Admit up to len(free) tickets, group them by prefill bucket, and
        prefill each group in ONE bucketed call."""
        if self.page_host and not self.free and self.scheduler.fresh_depth:
            # slot-starved with fresh arrivals waiting: park one long-idle
            # session to host RAM (one per tick: bounded churn)
            self._page_out_one()
        while self.free and self.scheduler.depth:
            tickets = self.scheduler.admit(
                min(len(self.free), self.max_prefill_batch))
            if not tickets:
                return
            groups: Dict[int, List[Ticket]] = {}
            lens: Dict[int, List[int]] = {}
            for t in tickets:
                L = self._eff_len(t.payload)
                b = pick_bucket(L, self.buckets)
                groups.setdefault(b, []).append(t)
                lens.setdefault(b, []).append(min(L, b))
            for b, group in groups.items():
                self._prefill_group(b, group, lens[b])

    def _prefill_group(self, bucket: int, group: List[Ticket],
                       lengths: List[int]):
        # pad the group to the next power of two (static shapes, like the
        # buckets): stages per bucket stay bounded at log2(slots)+1 and
        # wasted prefill compute under 2x. Padded rows carry zero tokens /
        # length 1, write nothing of their own (row -1), and their token is
        # discarded.
        g = len(group)
        P = 1 << (g - 1).bit_length()
        toks = np.zeros((P, bucket), np.int32)
        lens = np.ones(P, np.int32)
        for j, (t, L) in enumerate(zip(group, lengths)):
            toks[j, :L] = t.payload.tokens[:L]
            lens[j] = L
        slots = [self.states.acquire(t) for t in group]
        rows = np.full(P, -1, np.int64)             # padded: no write
        rows[:g] = slots
        nxt = self.executor.dispatch(
            "prefill", (bucket, P, self.precision),
            lambda: self._build_prefill(bucket, P),
            {"tokens": toks, "lengths": lens, "rows": rows})
        now = time.perf_counter()
        for j, (t, slot, L) in enumerate(zip(group, slots, lengths)):
            t.payload.output.append(int(nxt[j]))
            t.payload.prefill_pos = L
            self.telemetry.record_ttft((now - t.enqueue_t) * 1e3)
            self.states.activate(t, slot, L)
            self._last_decode[slot] = self.telemetry.steps
        self.telemetry.prefills += g
        self.telemetry.prefill_batches += 1

    # ---- chunked prefill -------------------------------------------------
    def _prefill_len(self, req: Request) -> int:
        """Tokens the chunked path prefills: what the monolithic path runs
        (the effective length, capped by the top bucket)."""
        return max(min(self._eff_len(req), self.buckets[-1]), 1)

    def _chunk_next_len(self, req: Request) -> int:
        return min(self.prefill_chunk,
                   self._prefill_len(req) - req.prefill_pos)

    def _chunk_bucket_of(self, t: Ticket) -> int:
        return pick_bucket(self._chunk_next_len(t.payload),
                           self.chunk_buckets)

    def _admit_chunk(self):
        """Ask the scheduler for ONE bucket-coherent chunk group (fresh
        tickets capped by free slots; continuations hold theirs) and run
        it."""
        if not self.scheduler.depth:
            return
        if self.page_host and not self.free and not self.prefilling \
                and self.scheduler.fresh_depth:
            self._page_out_one()        # the page-out rule of _admit
        if not self.free and not self.prefilling:
            return                      # every slot is decoding
        group = self.scheduler.admit_coherent(
            self.batch_slots, bucket_fn=self._chunk_bucket_of,
            new_cap=len(self.free))
        if group:
            self._chunk_group(self._chunk_bucket_of(group[0]), group)

    def _chunk_group(self, bucket: int, group: List[Ticket]):
        """One prompt chunk for every ticket of the group in a single call,
        each row at its own offset (request A's third chunk can batch with
        request B's first). The group pads to a power of two; padded rows
        repeat the first slot with no real tokens, so they write nothing.
        Unfinished prompts re-enter the queue as continuations; finished
        ones sample their first token and join the decode batch."""
        g = len(group)
        P = 1 << (g - 1).bit_length()       # pad like _prefill_group
        toks = np.zeros((P, bucket), np.int32)
        start = np.zeros(P, np.int32)
        wpos = np.full(P, self.max_len, np.int32)   # padded: no write
        lens = np.zeros(P, np.int32)                # padded: no tokens
        last = np.zeros(P, np.int32)
        slots: List[int] = []
        for j, t in enumerate(group):
            req: Request = t.payload
            off = req.prefill_pos
            clen = min(self._chunk_next_len(req), bucket)
            slots.append(self.states.acquire(t))
            snap = self._pending_restore.pop(id(t), None)
            if snap is not None:
                # prefix hit: the cached prefix lands in the slot before
                # this group's chunk reads the cache
                self.restore_slot(snap, slots[-1])
            toks[j, :clen] = req.tokens[off:off + clen]
            start[j] = off
            wpos[j] = off
            lens[j] = clen
            last[j] = clen - 1
        coords, dequant = attn_mod.chunk_writes(
            slots + [slots[0]] * (P - g), start, wpos, lens, bucket,
            self._global_len, self.batch_slots, ring=self._ring)
        nxt = self.executor.dispatch(
            "chunk_prefill", (bucket, P, self.precision),
            lambda: self._build_chunk(bucket, P),
            dict(coords, tokens=toks, last_idx=last),
            variant=dequant if self._int8_kv else None)
        now = time.perf_counter()
        for j, (t, slot) in enumerate(zip(group, slots)):
            req = t.payload
            req.prefill_pos += int(last[j]) + 1
            if self.prefix_cache \
                    and req.prefill_pos % self.prefill_chunk == 0:
                # a completed chunk boundary: cache the written prefix
                self._prefix_insert(req, slot)
            if req.prefill_pos >= self._prefill_len(req):
                req.output.append(int(nxt[j]))
                self.telemetry.record_ttft((now - t.enqueue_t) * 1e3)
                self.telemetry.prefills += 1
                self.states.activate(t, slot, req.prefill_pos)
                self._last_decode[slot] = self.telemetry.steps
            else:
                self.states.park(t, slot)
                self.scheduler.resubmit(t, size=self._chunk_next_len(req))
        self.telemetry.prefill_batches += 1

    def _step(self):
        if not self.active:
            return
        toks = np.zeros((self.batch_slots, 1), np.int32)
        # inactive rows ride the fixed-shape decode step parked at
        # max_len-1, a position no request attends (decoding stops at
        # max_len-1), and write back what their cache held there
        pos_vec = self.states.decode_positions(self.max_len - 1)
        for s, t in self.active.items():
            toks[s, 0] = t.payload.output[-1]
        nxt = self.executor.dispatch(
            "decode", (self.precision,), self._build_decode,
            {"tokens": toks, "pos": pos_vec,
             "active": self.states.active_mask()})
        self.telemetry.steps += 1
        for s in list(self.active):
            t = self.active[s]
            req: Request = t.payload
            self.pos[s] += 1
            req.output.append(int(nxt[s]))
            self.telemetry.total_tokens += 1
            self._last_decode[s] = self.telemetry.steps
            if len(req.output) >= req.max_new_tokens \
                    or self.pos[s] >= self.max_len - 1:
                req.done = True
                self.scheduler.complete(t)
                req.enqueue_t = t.enqueue_t
                req.finish_t = t.finish_t
                self.states.release(s)
                self._last_decode.pop(s, None)

    def run(self, requests: Sequence[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while self.has_work:
            self.step_once()
        self.telemetry.record_serving_window(time.perf_counter() - t0)
        return list(requests)


def make_replicas(cfg: ModelConfig, params: model_mod.Model, n: int,
                  precisions: Optional[Sequence[str]] = None,
                  quant_budget: float = 0.05,
                  **engine_kw) -> List[InferenceEngine]:
    """N LM engine replicas over one set of weights (distinct KV caches and
    queues; front them with ``ReplicaRouter``). ``precisions`` gives each
    its precision (``"fp32"`` / ``"w8a8"``); the quantized weights are
    built ONCE and every w8a8 replica runs them, and they share the fp
    tensors the build step leaves fp with the fp replicas."""
    if precisions is None:
        precisions = ["fp32"] * n
    if len(precisions) != n:
        raise ValueError(f"precisions has {len(precisions)} entries for "
                         f"{n} replicas")
    qp = None
    if any(p == "w8a8" for p in precisions):
        qp = build_quantized_params(cfg, params, budget=quant_budget)
    return [InferenceEngine(cfg, params, precision=p,
                            quantized_params=qp if p == "w8a8" else None,
                            **engine_kw)
            for p in precisions]

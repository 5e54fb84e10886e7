"""Replica router of the port: a copy of ``repro/serving/router.py``, kept
so that the port never imports the JAX package.

Port notes. The replicas of one fleet share one card (one H100): every
replica's stages run on the current CUDA stream, one ``step_once`` after
another (``run_until_drained`` and the launcher's drive loops), as the
reference steps its replicas in turn. This slice gives no replica a
stream of its own, and that is what keeps the two decode kernels' shared
per-device ticket counters safe (``kernels/decode_attn/ops.py``): their
launches never overlap. Every time a fleet reports (latency, TTFT,
throughput) includes the other replicas' serialized compute on the same
card.

Replica router — the front-end balancer above N engine replicas.

The paper serves mixed production traffic across six accelerator cards
behind one host (§IV deployment): a host-side router places each request
on one card's runtime queue. This module is that layer for our unified
runtime: a ``ReplicaRouter`` fronts N replicas (LM ``InferenceEngine`` or
``DLRMEngine`` — anything satisfying the small replica protocol below),
routes each ticket by **queue depth and deadline slack**, and aggregates
per-replica telemetry into one fleet-level QPS / p50-p95-p99 / SLA-miss /
shed surface (``Telemetry.merged``).

Replica protocol (duck-typed; both engines implement it):

- ``submit(item, ...) -> Ticket``  — enqueue one unit of work; the
  returned ticket has ``shed=True`` if the replica's admission control
  rejected it,
- ``step_once()``                  — make one unit of forward progress
  (admit + serve),
- ``has_work`` (property)          — queued or in-flight work remains,
- ``inflight`` (property)          — admitted-but-unfinished count,
- ``scheduler`` / ``telemetry``    — the shared runtime objects.

Routing rule (deterministic, so the property tests can state a bound):

1. load(replica) = queue depth + in-flight count; candidates are the
   replicas at minimum load — a submit therefore always lands on a
   current minimum, which bounds the ticket-count spread across replicas
   by max(1, initial spread) under any arrival sequence.
2. Among equal-load candidates, a deadline-carrying ticket goes to the
   candidate with the fewest pending deadline tickets (spread the
   urgent traffic so one replica's queue doesn't accumulate all the
   tight-slack work), ties and best-effort tickets round-robin.

Feedback routing (``route="feedback"``, ROADMAP open item): instead of
raw ticket counts, each replica's cost is (load + 1) x the EWMA of its
measured per-step dispatch time, i.e. the estimated time for the new
ticket to clear that replica. Heterogeneous replicas (one card also
hosting sparse shards, a thermally-throttled card, ...) then balance by
*time*, not count: a 3x-slower replica settles at ~1/3 the queue. The
EWMA is fed by the router's own drive loops (``run_until_drained`` /
``run_concurrent`` time every ``step_once``) or by ``record_dispatch``
directly; until a replica has a measurement it inherits the fleet mean,
and with no measurements at all the rule degrades to count-based.

Cross-replica work stealing (``steal=True``): routing balances
*arrivals*, but skewed sizes / hot-keyed streams / heterogeneous cards
still leave one replica backlogged while a sibling idles — and on the
paper's six-cards-one-host shape an idle card wastes the whole fleet's
headroom. ``maybe_steal`` (called each drive round) lets every idle
replica (no pending fresh work, free slots) pull pending FRESH tickets
from the most-backlogged live sibling: steal-half of the victim's
un-startable backlog — or, under ``route="feedback"``, a
time-proportional share sized by the thief/victim EWMA step-time ratio
(a 3x-faster thief takes ~3x the tickets the victim keeps) —
capped by the thief's free slots, chosen as the tickets the victim's
policy would serve LAST. Re-stamping is the
scheduler contract (``Scheduler.steal_pending`` / ``absorb``):
tid / priority / deadline preserved, enqueue rebased only across
timelines, so aging credit, EDF rank, and TTFT-from-original-submit all
survive the move. Continuations and mid-prefill tickets are never
stolen — they own a KV slot on their home replica (engines veto them via
``steal_eligible``).

Mid-prefill migration (``migrate=True``): the steal-veto on
mid-prefill work becomes a cost decision. When an idle thief faces a
victim loaded past the point where restarting locally would be cheaper,
the victim's mid-prefill continuations move WITH their serialized slot
state (``SequenceSnapshot`` — the engines' ``export_prefill`` /
``adopt_prefill`` hooks) and resume from the last completed chunk on
the thief; completed chunk work is never thrown away. Counted in the
thief's ``migrated`` telemetry, separate from ``steals``.

Replica fault drain (``drain_replica(idx)``): a card that degrades or
dies is marked dead and its ENTIRE accepted-but-unfinished load — the
pending queue plus whatever the engine can evict from its slots
(``drain_tickets``, which resets evicted work to fresh: the KV state
died with the card) — is re-homed onto the live replicas, least-loaded
first. Accepted work is never lost to a card failure; the victim's
``telemetry.drained`` counts how much work the fault moved. Dead
replicas take no routes, no steals, and no drive steps.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

from repro_torch.serving.scheduler import Ticket
from repro_torch.serving.state import FleetPrefixIndex
from repro_torch.serving.telemetry import Telemetry


class ReplicaRouter:
    """Least-loaded, deadline-slack-aware balancer over engine replicas."""

    def __init__(self, replicas: Sequence[Any], *, route: str = "count",
                 ewma_alpha: float = 0.25, steal: bool = False,
                 migrate: bool = False, perf_model: Any = None,
                 fleet_prefix: bool = False, prefix_host_entries: int = 0):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if route not in ("count", "feedback"):
            raise ValueError(f"route must be 'count' or 'feedback', "
                             f"got {route!r}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        self.replicas = list(replicas)
        self.route_mode = route
        self.ewma_alpha = ewma_alpha
        self.steal_enabled = steal
        self.migrate_enabled = migrate
        # mixed-precision fleet policy: replicas advertise their execution
        # precision (engines: ``precision``; anything without the attr is
        # fp32). When the fleet mixes precisions, priority-0 (accuracy-
        # sensitive) traffic pins to the fp32 replicas while fp32 capacity
        # exists; a homogeneous fleet routes exactly as before.
        self.precisions = [getattr(r, "precision", "fp32")
                           for r in self.replicas]
        # analytic perf model: prices an unmeasured replica's
        # EWMA seed by its PRECISION instead of the raw fleet mean (an
        # int8 joiner in an fp32-dominated fleet was charged fp32 cost
        # and misrouted until measured). Defaults to whatever model the
        # first replica carries; None degrades to the old fleet mean.
        self.perf_model = (perf_model if perf_model is not None
                           else getattr(self.replicas[0], "perf_model",
                                        None))
        # fleet-shared prefix tier: a directory of which replicas
        # hold which prompt prefix, plus a capacity-bounded shared
        # host-RAM tier behind every replica's local LRU
        # (``prefix_host_entries`` snapshots; 0 = directory only).
        # Replicas without the engine hooks (DLRM, bare sim stubs) simply
        # never register and are skipped by the steering probe.
        self.prefix_index = (FleetPrefixIndex(
            host_capacity=prefix_host_entries) if fleet_prefix else None)
        if self.prefix_index is not None:
            for i, r in enumerate(self.replicas):
                attach = getattr(r, "attach_prefix_index", None)
                if attach is not None:
                    attach(self.prefix_index, i)
        self.ewma_s = [0.0] * len(self.replicas)  # 0 = not yet measured
        self.routed = [0] * len(self.replicas)   # submits per replica
        self.shed = 0                            # fleet admission rejections
        self.dead = [False] * len(self.replicas)  # drained fault replicas
        self.steals_per_replica = [0] * len(self.replicas)  # by the THIEF
        self.rehomed = [0] * len(self.replicas)  # drain re-homes received
        # per-replica clock offset vs the fleet clock (local_now = fleet_now
        # + offset). 0 for replicas sharing the fleet clock; a late-joining
        # replica on its own timeline declares its offset at add_replica
        # time so tickets re-homed onto it are rebased (age and deadline
        # slack preserved on the destination clock — Scheduler.absorb's
        # from_now contract)
        self.clock_offset = [0.0] * len(self.replicas)
        self._rr = 0                             # round-robin tie cursor
        self._serving_s = 0.0

    def add_replica(self, replica: Any, *, clock_offset: float = 0.0,
                    now: Optional[float] = None) -> int:
        """Elastic scale-up: register a fresh replica (engine-factory
        output) as a live routing target and return its index. The new
        replica starts with an empty queue, an unmeasured EWMA (until
        its first measurement it is charged the fleet mean re-priced to
        ITS precision via the perf model — ``_seed_ewma`` — so an int8
        joiner is not misrouted at fp32 cost), and takes traffic
        immediately; cross-replica stealing rebalances existing
        backlog onto it on the next steal round — scale-up needs no
        dedicated work-movement path. ``clock_offset`` is the replica's
        local-clock offset vs the fleet clock for late joiners running
        their own timeline (0 = shared clock); its telemetry records one
        ``scaled_in`` so the fleet surface counts joins."""
        self.replicas.append(replica)
        self.precisions.append(getattr(replica, "precision", "fp32"))
        self.ewma_s.append(0.0)
        self.routed.append(0)
        self.dead.append(False)
        self.steals_per_replica.append(0)
        self.rehomed.append(0)
        self.clock_offset.append(clock_offset)
        if self.prefix_index is not None:
            attach = getattr(replica, "attach_prefix_index", None)
            if attach is not None:
                attach(self.prefix_index, len(self.replicas) - 1)
        replica.telemetry.record_scaled_in()
        return len(self.replicas) - 1

    def _absorb_kw(self, j: int, now: Optional[float]) -> dict:
        """Keyword args for ``Scheduler.absorb`` when re-homing tickets
        carried on the fleet clock onto replica ``j``: a same-clock
        replica takes the stamps verbatim; a late joiner with a nonzero
        ``clock_offset`` gets the from_now rebase so ticket age and
        deadline slack survive the timeline change."""
        off = self.clock_offset[j]
        if not off:
            return {"now": now}
        fleet_now = time.perf_counter() if now is None else now
        return {"now": fleet_now + off, "from_now": fleet_now}

    # ---- routing ---------------------------------------------------------
    def load(self, i: int) -> int:
        # fresh_depth, not depth: a chunked request mid-prefill is both a
        # pending continuation ticket AND an in-flight slot holder —
        # counting it twice would steer traffic away from replicas that
        # are merely chunking a long prompt
        r = self.replicas[i]
        return r.scheduler.fresh_depth + r.inflight

    def record_dispatch(self, i: int, seconds: float):
        """Fold one measured step duration into replica i's EWMA (the
        feedback signal; drive loops call this automatically)."""
        e = self.ewma_s[i]
        self.ewma_s[i] = seconds if e == 0.0 else \
            (1.0 - self.ewma_alpha) * e + self.ewma_alpha * seconds

    def _seed_ewma(self, i: int) -> float:
        """EWMA seed for an unmeasured replica ``i`` (a late joiner from
        ``add_replica``, or any replica before its first measurement).

        With a perf model, each measured sibling's EWMA is re-priced to
        the joiner's precision by the model's predicted per-precision
        step-time ratio, then averaged — an int8 joiner in a mixed fleet
        seeds at ~half the fp32 siblings' step time instead of
        inheriting their fp32-dominated mean (the scale-up misrouting
        bug this fixes). Without a model it degrades to the raw fleet
        mean; with no measurements at all it returns 0 (count-based
        fallback in ``_cost``)."""
        measured = [(e, self.precisions[j])
                    for j, e in enumerate(self.ewma_s) if e > 0.0]
        if not measured:
            return 0.0
        if self.perf_model is None:
            return sum(e for e, _ in measured) / len(measured)
        scale_i = self.perf_model.precision_scale(self.precisions[i])
        return sum(e * scale_i / self.perf_model.precision_scale(p)
                   for e, p in measured) / len(measured)

    def _cost(self, i: int) -> float:
        """Routing cost. Count mode: raw load. Feedback mode: estimated
        clearing time of the new ticket = (load + 1) x EWMA step time
        (an unmeasured replica is charged the precision-scaled fleet
        seed — ``_seed_ewma`` — so it neither hoards nor starves before
        its first measurement)."""
        if self.route_mode != "feedback":
            return float(self.load(i))
        e = self.ewma_s[i] or self._seed_ewma(i)
        if e == 0.0:
            return float(self.load(i))
        return (self.load(i) + 1) * e

    def _deadline_depth(self, i: int) -> int:
        return self.replicas[i].scheduler.deadline_depth

    @property
    def alive(self) -> List[int]:
        """Indices of replicas that have not been fault-drained."""
        return [i for i in range(len(self.replicas)) if not self.dead[i]]

    @property
    def mixed_precision(self) -> bool:
        """True when the fleet serves at more than one precision (the
        precision pin only engages then — a homogeneous fleet has nothing
        to pin to)."""
        return len(set(self.precisions)) > 1

    @property
    def fp32_alive(self) -> List[int]:
        return [i for i in self.alive if self.precisions[i] == "fp32"]

    def free_slots(self, i: int) -> int:
        """Free serving capacity of replica i (steal admission cap). The
        engines expose ``free_slots`` (LM: free KV slots; DLRM: the step
        admission group); a replica without the attribute is treated as
        one slot that is free whenever nothing is in flight."""
        fs = getattr(self.replicas[i], "free_slots", None)
        if fs is not None:
            return int(fs)
        return 1 if self.replicas[i].inflight == 0 else 0

    def route(self, *, has_deadline: bool = False, priority: int = 0) -> int:
        """Pick the replica index for the next ticket (see module doc).
        Fault-drained replicas take no traffic. In a mixed-precision
        fleet, priority-0 (accuracy-sensitive) tickets only consider the
        live fp32 replicas; when the last fp32 replica is gone the pin
        degrades gracefully — the ticket lands on an int8 replica and the
        downgrade is counted (``telemetry.precision_rehomed``)."""
        alive = self.alive
        if not alive:
            raise RuntimeError("every replica is fault-drained; nothing "
                               "can take traffic")
        if self.mixed_precision and priority == 0:
            pinned = self.fp32_alive
            if pinned:
                alive = pinned
            else:
                pick = self._route_among(alive, has_deadline)
                self.replicas[pick].telemetry.record_precision_rehome()
                return pick
        return self._route_among(alive, has_deadline)

    def _route_among(self, alive: List[int], has_deadline: bool) -> int:
        loads = {i: self._cost(i) for i in alive}
        m = min(loads.values())
        cand = [i for i in alive if loads[i] == m]
        if has_deadline and len(cand) > 1:
            dd = [self._deadline_depth(i) for i in cand]
            dmin = min(dd)
            cand = [i for i, d in zip(cand, dd) if d == dmin]
        # rotate the round-robin cursor over the surviving candidates
        pick = cand[self._rr % len(cand)]
        self._rr += 1
        return pick

    def submit(self, item: Any, *, slo_ms: Optional[float] = None,
               priority: Optional[int] = None, **kw) -> Ticket:
        """Route + enqueue one item; returns the replica's ticket (check
        ``.shed`` when the replicas run admission control). ``None``
        slo/priority defer to the item's own fields (LM Requests) or the
        replica defaults."""
        has_deadline = (slo_ms is not None
                        or getattr(item, "slo_ms", None) is not None
                        or any(r.scheduler.default_slo_ms is not None
                               for r in self.replicas))
        eff_priority = priority if priority is not None \
            else (getattr(item, "priority", 0) or 0)
        i = self.route(has_deadline=has_deadline, priority=eff_priority)
        if self.prefix_index is not None:
            i = self._prefix_place(item, i, eff_priority)
        t = self.replicas[i].submit(item, slo_ms=slo_ms,
                                    priority=priority, **kw)
        if t.shed:
            self.shed += 1
        else:
            self.routed[i] += 1
        return t

    # ---- fleet-shared prefix tier --------------------------------
    def _steer_cost_s(self, i: int) -> float:
        """Routing cost of landing the NEXT ticket on replica ``i``, in
        SECONDS — the feedback currency (load + 1) x EWMA step time,
        seeded for unmeasured replicas like ``_cost``. With no
        measurement anywhere the perf model's predicted decode step
        prices a load unit, and with no model either the cost is 0 (the
        steer then degrades to pure hit-affinity)."""
        e = self.ewma_s[i] or self._seed_ewma(i)
        if e == 0.0 and self.perf_model is not None:
            e = self.perf_model.predict_dispatch_s(
                "decode", 1, precision=self.precisions[i])
        return (self.load(i) + 1) * e

    def _prefix_saved_s(self, length: int, chunk: Optional[int],
                        i: int) -> float:
        """Perf-model-predicted prefill time a hit on a ``length``-token
        cached prefix saves replica ``i`` — the chunk-prefill line over
        the chunks the hit skips. Without a model, the skipped chunks
        are priced at the replica's EWMA step time (each chunk displaces
        about one step of the pipeline)."""
        if self.perf_model is not None:
            return self.perf_model.predict_step_s(
                "chunk_prefill", bucket=length,
                precision=self.precisions[i], chunk=chunk)
        e = self.ewma_s[i] or self._seed_ewma(i)
        return (length // max(chunk or length, 1)) * e

    def _prefix_place(self, item: Any, i: int, priority: int) -> int:
        """Locality-aware placement against the fleet prefix index, given
        load balancing's pick ``i``. For the LONGEST cached prefix of the
        item held somewhere alive:

        - landing replica already holds it -> keep ``i`` (plain local
          hit, the engine counts it);
        - **steer** to the cheapest holder when the predicted prefill
          time the hit saves beats the load-imbalance cost of going
          there (``saved >= cost(holder) - cost(i)``, both in the
          (load+1) x EWMA currency);
        - otherwise land on ``i`` and decide **restore-vs-recompute**:
          ship the holder's snapshot into ``i``'s local cache over the
          snapshot transport when the perf model's transfer terms price
          the ship below the chunk-prefill recompute line, else let
          ``i`` recompute the prefix. Both legs are counted
          (``prefix_shipped`` / ``prefix_recomputed``) and either way
          the request lands where load balancing wanted it.

        In a mixed-precision fleet, accuracy-pinned (priority-0) traffic
        only steers to fp32 holders while fp32 capacity exists — the
        steer must not bypass the precision pin that ``route`` applied."""
        probe = next(
            (self.replicas[j] for j in self.alive
             if getattr(self.replicas[j], "prefix_keys", None) is not None),
            None)
        if probe is None:
            return i
        chunk = getattr(probe, "prefill_chunk", None)
        for key in probe.prefix_keys(item):        # longest prefix first
            holders = [j for j in self.prefix_index.holders(key)
                       if not self.dead[j]]
            if self.mixed_precision and priority == 0 and self.fp32_alive:
                holders = [j for j in holders
                           if self.precisions[j] == "fp32"]
            if i in holders:
                return i
            if not holders:
                continue
            j = min(holders, key=lambda k: (self._steer_cost_s(k), k))
            if self._prefix_saved_s(key[0], chunk, j) \
                    >= self._steer_cost_s(j) - self._steer_cost_s(i):
                self.replicas[j].telemetry.record_prefix_remote_hit()
                return j
            holder_snap = getattr(self.replicas[j], "prefix_snapshot", None)
            accept = getattr(self.replicas[i], "prefix_accept", None)
            if holder_snap is None or accept is None:
                return i
            snap = holder_snap(key)
            if snap is None:
                return i
            self.replicas[i].telemetry.record_prefix_remote_hit()
            ship_s = 0.0
            if self.perf_model is not None:
                # the ship's critical-path cost is the restore H2D leg:
                # the snapshot already lives in host RAM on the holder
                ship_s = self.perf_model.transfer_s(
                    h2d_bytes=getattr(snap, "bytes_partial", 0.0))
            if ship_s <= self._prefix_saved_s(key[0], chunk, i):
                accept(key, snap)
                self.replicas[i].telemetry.record_prefix_shipped()
            else:
                self.replicas[i].telemetry.record_prefix_recomputed()
            return i
        return i

    # ---- work stealing / fault drain -------------------------------------
    def _stealable_backlog(self, i: int) -> int:
        """Fresh pending work replica i cannot start right now (its own
        free slots will soak up the rest next tick — stealing that part
        would just add churn)."""
        return max(self.replicas[i].scheduler.fresh_depth
                   - self.free_slots(i), 0)

    def _steal_share(self, thief: int, victim: int, backlog: int) -> int:
        """How much of the victim's un-startable backlog the thief takes.
        Count mode: steal-half. Feedback mode (steal-aware feedback
        routing): the share is time-proportional — with speed
        ratio r = victim_EWMA / thief_EWMA the thief takes r/(1+r) of
        the backlog, so a 3x-faster thief takes ~3x the tickets the
        victim keeps, and r = 1 degrades to exactly steal-half. Either
        replica unmeasured -> count-half fallback."""
        if self.route_mode == "feedback" \
                and self.ewma_s[thief] > 0.0 and self.ewma_s[victim] > 0.0:
            r = self.ewma_s[victim] / self.ewma_s[thief]
            return max(int(round(backlog * r / (1.0 + r))), 1)
        return max(backlog // 2, 1)

    def maybe_steal(self, now: Optional[float] = None) -> int:
        """One stealing round (no-op unless ``steal=True``): every idle
        live replica — no pending fresh work, free slots — pulls pending
        fresh tickets from the most-backlogged live sibling. The stolen
        share is count-half, or time-proportional under feedback routing
        (``_steal_share``), capped by the thief's free slots; the
        victim's ``steal_eligible`` hook vetoes mid-prefill work.
        Deterministic: thieves act in index order, victims break ties by
        lowest index. Returns the number of tickets moved.

        With ``migrate=True`` a migration round follows the fresh-steal
        round: idle thieves may additionally pull MID-PREFILL
        continuations — shipped with their snapshot, resuming from the
        last completed chunk (``_maybe_migrate``)."""
        moved = 0
        if self.steal_enabled:
            moved += self._steal_round(now)
        if self.migrate_enabled:
            moved += self._maybe_migrate(now)
        return moved

    def _steal_round(self, now: Optional[float] = None) -> int:
        moved = 0
        for i in self.alive:
            thief = self.replicas[i]
            if thief.scheduler.fresh_depth > 0:
                continue                    # has its own queue to serve
            cap = self.free_slots(i)
            if cap <= 0:
                continue
            best, best_backlog = -1, 0
            for j in self.alive:
                if j == i:
                    continue
                b = self._stealable_backlog(j)
                if b > best_backlog:
                    best, best_backlog = j, b
            if best < 0:
                continue
            victim = self.replicas[best]
            k = min(cap, self._steal_share(i, best, best_backlog))
            eligible = getattr(victim, "steal_eligible", None)
            if self.mixed_precision and self.precisions[i] != "fp32" \
                    and self.fp32_alive:
                # an int8 thief must not pull accuracy-pinned (priority-0)
                # work while any fp32 replica is live — stealing respects
                # the precision pin
                eligible = (lambda t, base=eligible:
                            (base is None or base(t)) and t.priority > 0)
            stolen = victim.scheduler.steal_pending(
                k, now=now, eligible=eligible)
            if not stolen:
                continue
            thief.scheduler.absorb(stolen, **self._absorb_kw(i, now))
            self.steals_per_replica[i] += len(stolen)
            moved += len(stolen)
        return moved

    def _maybe_migrate(self, now: Optional[float] = None) -> int:
        """Mid-prefill migration round: the steal-veto as a
        cost decision. An idle thief with free slots pulls mid-prefill
        continuations from the most-loaded sibling that is strictly MORE
        loaded than the thief-plus-one (an unloaded victim finishes its
        own prefill sooner than a snapshot round-trip, so nothing moves)
        — but unlike a plain steal the completed chunk work ships too:
        the victim serializes the slot (``export_prefill``), the thief
        restores it into a free slot and parks it (``adopt_prefill``),
        and the continuation resumes from its last completed chunk.
        Re-stamping is the same ``absorb`` contract as stealing (age,
        deadline slack, and priority survive; ``record=False`` — the
        move lands in the thief's ``migrated`` counter, not ``steals``).
        Engines without the snapshot hooks (DLRM, sim stubs) are
        skipped. Returns tickets moved."""
        moved = 0
        for i in self.alive:
            thief = self.replicas[i]
            if getattr(thief, "adopt_prefill", None) is None:
                continue
            if thief.scheduler.fresh_depth > 0:
                continue                # has its own queue to serve
            cap = self.free_slots(i)
            if cap <= 0:
                continue
            best, best_load = -1, self.load(i) + 1
            for j in self.alive:
                if j == i:
                    continue
                victim = self.replicas[j]
                if getattr(victim, "export_prefill", None) is None \
                        or getattr(victim, "migration_eligible",
                                   None) is None:
                    continue
                if self.load(j) > best_load:
                    best, best_load = j, self.load(j)
            if best < 0:
                continue
            victim = self.replicas[best]
            stolen = victim.scheduler.steal_pending(
                cap, now=now, eligible=victim.migration_eligible,
                include_continuations=True)
            if not stolen:
                continue
            for t in stolen:
                # serialize on the victim, restore+park on the thief —
                # the ticket is never queued anywhere without its state
                thief.adopt_prefill(t, victim.export_prefill(t))
            thief.scheduler.absorb(stolen, record=False,
                                   **self._absorb_kw(i, now))
            moved += len(stolen)
        return moved

    def drain_replica(self, idx: int, now: Optional[float] = None) -> int:
        """Fault path: mark replica ``idx`` dead and re-home its entire
        accepted-but-unfinished load onto the live replicas, least-loaded
        first (ties to the lowest index). The engine's ``drain_tickets``
        hook hands back pending work plus evicted in-flight work reset to
        fresh (the card's KV state is gone); a replica without the hook
        contributes its whole pending queue, continuations included.
        Accepted work is never lost: every ticket lands on exactly one
        live queue. Returns the number of tickets re-homed. Idempotent —
        draining a dead replica is a no-op."""
        if self.dead[idx]:
            return 0
        r = self.replicas[idx]
        self.dead[idx] = True
        if self.prefix_index is not None:
            # the dead card's cached prefixes are HOST-side snapshots —
            # they outlive the card, so park them in the shared tier for
            # the fleet, then purge the replica from the directory (the
            # index must never name a dead holder)
            exp = getattr(r, "export_prefix_cache", None)
            if exp is not None:
                for key, snap in exp():
                    self.prefix_index.host_insert(key, snap)
            self.prefix_index.purge_replica(idx)
        drain = getattr(r, "drain_tickets", None)
        if drain is not None:
            tickets = drain()
        else:
            tickets = r.scheduler.steal_pending(
                None, now=now, include_continuations=True)
            for t in tickets:
                t.reset_fresh()
        r.telemetry.record_drained(len(tickets))
        live = self.alive
        if tickets and not live:
            raise RuntimeError(f"replica {idx} drained {len(tickets)} "
                               f"tickets but no live replica remains to "
                               f"re-home them")
        for t in tickets:
            cand = live
            downgrade = False
            if self.mixed_precision and t.priority == 0:
                # accuracy-pinned work prefers a surviving fp32 replica;
                # when the drained card was the LAST fp32, degrade
                # gracefully — re-home to int8 and count the downgrade
                fp32 = [i for i in live if self.precisions[i] == "fp32"]
                if fp32:
                    cand = fp32
                else:
                    downgrade = True
            j = min(cand, key=lambda i: (self.load(i), i))
            self.replicas[j].scheduler.absorb(
                [t], record=False, **self._absorb_kw(j, now))
            if downgrade:
                self.replicas[j].telemetry.record_precision_rehome()
            self.rehomed[j] += 1
        return len(tickets)

    # ---- driving ---------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return any(r.has_work for i, r in enumerate(self.replicas)
                   if not self.dead[i])

    def run_until_drained(self):
        """Drive every live replica to completion, one step each per round
        (with a stealing round first when ``steal=True``). Live-host
        semantics: wall time is shared, so with k replicas on one device
        each request's measured latency includes the other replicas'
        serialized compute — use ``run_concurrent`` when the point is
        fleet latency as N concurrent cards would deliver it."""
        t0 = time.perf_counter()
        while self.has_work:
            self.maybe_steal()
            for i, r in enumerate(self.replicas):
                if not self.dead[i] and r.has_work:
                    s0 = time.perf_counter()
                    r.step_once()
                    self.record_dispatch(i, time.perf_counter() - s0)
        self._serving_s += time.perf_counter() - t0

    def run_concurrent(self):
        """Single-host emulation of N concurrent cards: drain each replica
        to completion in turn, re-basing its pending tickets' enqueue /
        deadline stamps to its own drain start (replicas share no state
        after routing, so a full sequential drain is execution-equivalent
        to the concurrent one). Work stealing deliberately does NOT run
        here: a sequential drain has no meaningful "idle sibling" instant
        (every other replica is either already finished or not yet
        started on its own timeline), so ``steal=True`` only affects the
        live drive loops — ``run_until_drained`` and external loops calling
        ``maybe_steal``; use the fleet sim when the point is stealing
        behaviour under concurrent-card timing. Each request's latency is then queue wait
        + service on its *own* card, and the fleet serving window is the
        slowest replica's drain — what N cards behind one host deliver.
        Requires a fully-routed, not-yet-started fleet (no in-flight
        work)."""
        busiest = 0.0
        for i, r in enumerate(self.replicas):
            if r.inflight:
                raise RuntimeError("run_concurrent needs an idle fleet; "
                                   "use run_until_drained mid-flight")
            t0 = time.perf_counter()
            r.scheduler.rebase_pending(t0)
            while r.has_work:
                s0 = time.perf_counter()
                r.step_once()
                self.record_dispatch(i, time.perf_counter() - s0)
            took = time.perf_counter() - t0
            r.telemetry.record_serving_window(took)
            busiest = max(busiest, took)
        self._serving_s += busiest

    # ---- fleet telemetry -------------------------------------------------
    def fleet_telemetry(self) -> Telemetry:
        """One fleet-level surface over all replicas (pooled samples, see
        ``Telemetry.merged``). The serving window is the router's own
        drain wall time when it drove the fleet (replica windows overlap
        in real time, so summing them would understate fleet QPS)."""
        fleet = Telemetry.merged([r.telemetry for r in self.replicas])
        if self._serving_s > 0:
            fleet.serving_s = self._serving_s
        return fleet

    def summary(self) -> dict:
        out = self.fleet_telemetry().summary()
        out["replicas"] = len(self.replicas)
        out["routed_per_replica"] = list(self.routed)
        out["route"] = self.route_mode
        out["precisions"] = list(self.precisions)
        out["steals_per_replica"] = list(self.steals_per_replica)
        out["dead_replicas"] = [i for i, d in enumerate(self.dead) if d]
        if self.prefix_index is not None:
            out["prefix_host_entries"] = len(self.prefix_index.host)
            out["prefix_host_evicted"] = self.prefix_index.host_evicted
        return out

    def report(self) -> str:
        lines = [f"fleet of {len(self.replicas)} replicas, routed "
                 f"{self.routed} (+{self.shed} shed)"]
        if any(self.steals_per_replica):
            lines.append(f"steals per replica {self.steals_per_replica}")
        if any(self.dead):
            dead = [i for i, d in enumerate(self.dead) if d]
            lines.append(f"dead replicas {dead}, re-homed {self.rehomed}")
        lines.append(self.fleet_telemetry().report())
        return "\n".join(lines)


def spread(router: ReplicaRouter) -> int:
    """Max-min routed-ticket imbalance — the bound the property tests
    assert on (≤ 1 for any pure submit sequence from an empty fleet)."""
    return max(router.routed) - min(router.routed)

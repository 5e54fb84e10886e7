"""Fleet simulator of the port: a copy of ``repro/serving/fleet_sim.py``,
kept so that the port never imports the JAX package. It drives the
port's own router and controller on the same virtual clock and seeds, so
its numbers are the reference's.

Deterministic discrete-event fleet simulator — the harness that makes
the work-stealing and fault-drain claims testable at fleet scale.

Real engines on one CPU cannot demonstrate a stealing win: with every
replica's compute serialized onto the same device, moving queued work
between replicas changes *which* replica burns the wall time, not when
the work finishes. The simulator gives each replica its own virtual
service clock (configurable per-step service time, the paper's
heterogeneous-cards reality) under ONE shared virtual ``now``, so
stealing genuinely shortens completion times exactly as it would across
N concurrent cards — and every run is bit-deterministic (seeded arrival
processes, no wall-clock reads anywhere), which is what lets the
property suite drive thousands of submit/steal/fail/complete
interleavings and assert exact conservation.

``SimReplica`` satisfies the ReplicaRouter replica protocol (submit /
step via ``step(now)`` / has_work / inflight / free_slots /
steal_eligible / drain_tickets), so the router under test is the REAL
router — only the engines are stubs.

Elastic-fleet support: ``FleetSim.replica_factory`` hands the
``FleetController`` a factory whose replicas join BOTH the router and
the sim's conservation tracking; ``halt``/``halted`` model a frozen card
(stops serving and heartbeating, queue accumulates until the failure
detector declares it and the controller drains); the production-shaped
trace generators (``diurnal_trace`` / ``flash_crowd_trace`` /
``hot_burst_trace`` / ``multi_tenant_trace``) and the ``run_elastic``
loop push 10^5+ seeded arrivals through the closed control loop.

Used by ``tests/fleet_sim.py`` (the property-suite harness),
``benchmarks/bench_serving.py`` (``work_stealing`` + ``elastic``
sections), and ``benchmarks/perf_gate.py`` (the CI perf-regression
gate's scenarios).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.scheduler import Scheduler, Ticket


@dataclass
class SimSnapshot:
    """Sim-level prefix snapshot: the only surface the router's
    restore-vs-recompute pricing reads is ``bytes_partial``."""
    bytes_partial: float = 0.0


class SimReplica:
    """Stub replica with configurable per-step service time and a fixed
    slot count, driven on a virtual clock. A ticket admitted at ``now``
    completes at ``now + service_s`` (stamped exactly — completion uses
    the due time, not the tick that observed it)."""

    def __init__(self, service_s: float = 0.01, slots: int = 1,
                 policy: str = "fifo", precision: str = "fp32",
                 prefix_cache: int = 0, hit_service_frac: float = 0.5,
                 prefix_tags: Optional[Dict[int, int]] = None, **sched_kw):
        self.scheduler = Scheduler(policy, **sched_kw)
        self.telemetry = self.scheduler.telemetry
        self.service_s = service_s
        self.slots = slots
        self.precision = precision       # router mixed-precision policy
        self.active: List[Tuple[Ticket, float]] = []   # (ticket, due time)
        # host-RAM paging: parked sessions as (ticket, remaining
        # service) — the sim-level SequenceSnapshot is the frozen
        # remaining service time; a page-in resumes it, never restarts
        self.paged: List[Tuple[Ticket, float]] = []
        # fleet prefix cache (sim level): payloads tagged via the
        # shared ``prefix_tags`` side-channel share a prefix; a local (or
        # host-tier) hit serves at ``hit_service_frac`` of full price.
        # The chunk grain is 1 token — every tagged payload maps to the
        # single key ``(1, "sim<tag>")``.
        self.prefill_chunk = 1
        self.prefix_cache = int(prefix_cache)
        self.hit_service_frac = float(hit_service_frac)
        self._prefix_tags = prefix_tags if prefix_tags is not None else {}
        self._prefix_cache: "OrderedDict" = OrderedDict()
        self._prefix_index = None
        self._replica_id: Optional[int] = None
        self._hits: set = set()          # payloads admitted at hit price

    # ---- replica protocol ------------------------------------------------
    @property
    def inflight(self) -> int:
        # paged sessions are admitted-but-unfinished: they count toward
        # load even while parked in host RAM
        return len(self.active) + len(self.paged)

    @property
    def free_slots(self) -> int:
        return self.slots - len(self.active)

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.depth or self.active or self.paged)

    def submit(self, item, *, slo_ms=None, priority=None, size: int = 0,
               now: Optional[float] = None, **kw) -> Ticket:
        t = self.scheduler.submit(item, size=size,
                                  priority=priority or 0,
                                  slo_ms=slo_ms, now=now)
        if self.prefix_cache and not t.shed:
            for key in self.prefix_keys(item):
                if self._prefix_lookup(key) is not None:
                    self._hits.add(item)
                    self.telemetry.record_prefix_hit()
                    break
        return t

    def steal_eligible(self, t: Ticket) -> bool:
        return not t.continuation

    def drain_tickets(self, now: Optional[float] = None) -> List[Ticket]:
        """Fault path: pending queue + evicted in-flight work, reset to
        fresh (partial service on the dead card is lost)."""
        out = self.scheduler.steal_pending(None, now=now,
                                           include_continuations=True)
        out.extend(t for t, _ in self.active)
        out.extend(t for t, _ in self.paged)
        self.active = []
        self.paged = []
        # the card is gone: its local prefix cache dies with it (the
        # router's drain path has already exported it to the host tier
        # and purged this replica from the fleet index)
        self._prefix_cache.clear()
        self._hits.clear()
        for t in out:
            t.reset_fresh()
        return out

    # ---- movable sequence state (sim level) ------------------------
    def page_out(self, now: float) -> Optional[Ticket]:
        """Park the in-flight ticket with the LONGEST remaining service
        to host RAM (deterministic: latest due, ties by tid), freeing
        its slot. Remaining service is frozen exactly — the sim-level
        snapshot round-trip loses no progress."""
        if not self.active:
            return None
        k = max(range(len(self.active)),
                key=lambda i: (self.active[i][1], self.active[i][0].tid))
        t, due = self.active.pop(k)
        self.paged.append((t, max(due - now, 0.0)))
        self.telemetry.record_paged_out()
        return t

    def page_in(self, now: float) -> Optional[Ticket]:
        """Fault the oldest paged session back into a free slot; its
        frozen remaining service resumes from ``now``."""
        if not self.paged or self.free_slots <= 0:
            return None
        t, remaining = self.paged.pop(0)
        self.active.append((t, now + remaining))
        self.telemetry.record_paged_in()
        return t

    def step(self, now: float) -> List[Ticket]:
        """One virtual tick: complete due work at its exact due time,
        admit into the freed slots, then fault paged sessions back into
        whatever slots admission left free (fresh arrivals take
        precedence for slots, matching the engine's page-in order).
        Returns the completed tickets."""
        done = [(t, due) for t, due in self.active if due <= now]
        self.active = [(t, due) for t, due in self.active if due > now]
        for t, due in done:
            self.scheduler.complete(t, now=due)
            for key in self.prefix_keys(t.payload):
                self.prefix_accept(key, SimSnapshot())
            self._hits.discard(t.payload)
        for t in self.scheduler.admit(self.free_slots, now=now):
            frac = self.hit_service_frac if t.payload in self._hits else 1.0
            self.active.append((t, now + self.service_s * frac))
        while self.paged and self.free_slots > 0:
            self.page_in(now)
        return [t for t, _ in done]

    # ---- fleet prefix-cache hooks (sim level) ---------------------
    # Same duck-typed surface the InferenceEngine exposes, so the REAL
    # router's steering / ship / drain-export paths are exercised by the
    # property suite against stub engines.
    def attach_prefix_index(self, index, replica_id: int) -> None:
        self._prefix_index = index
        self._replica_id = replica_id

    def prefix_keys(self, payload) -> List[Tuple[int, str]]:
        """Cacheable prefix keys for a payload — the single shared-tag
        key, or nothing for untagged traffic."""
        if not self.prefix_cache:
            return []
        tag = self._prefix_tags.get(payload)
        return [] if tag is None else [(1, f"sim{tag}")]

    def _prefix_lookup(self, key):
        snap = self._prefix_cache.get(key)
        if snap is not None:
            self._prefix_cache.move_to_end(key)
            return snap
        if self._prefix_index is not None:
            snap = self._prefix_index.host_get(key)
            if snap is not None:
                self.prefix_accept(key, snap)
                self.telemetry.record_prefix_host_hit()
                return snap
        return None

    def prefix_snapshot(self, key):
        snap = self._prefix_cache.get(key)
        if snap is not None:
            self._prefix_cache.move_to_end(key)
        return snap

    def prefix_accept(self, key, snap) -> None:
        """Insert a prefix entry (local completion or cross-replica
        ship), LRU-evicting into the fleet's host tier."""
        if not self.prefix_cache:
            return
        self._prefix_cache[key] = snap
        self._prefix_cache.move_to_end(key)
        if self._prefix_index is not None:
            self._prefix_index.add(key, self._replica_id)
        while len(self._prefix_cache) > self.prefix_cache:
            old_key, old_snap = self._prefix_cache.popitem(last=False)
            if self._prefix_index is not None:
                self._prefix_index.discard(old_key, self._replica_id)
                self._prefix_index.host_insert(old_key, old_snap)

    def export_prefix_cache(self):
        return list(self._prefix_cache.items())

    @property
    def cache_pressure(self) -> float:
        """Paged fraction — the controller's cache/paging pressure
        signal, same shape as the engine's property."""
        return len(self.paged) / max(self.slots, 1)

    # step_once exists for protocol completeness (wall-clock callers);
    # the simulator always drives step(now) on the virtual clock
    def step_once(self):  # pragma: no cover - sim uses step(now)
        raise RuntimeError("SimReplica runs on a virtual clock; "
                           "drive it with step(now) via FleetSim")


class FleetSim:
    """Discrete-event fleet: N SimReplicas behind the real ReplicaRouter,
    one shared virtual clock, seeded arrivals. Tracks every submitted
    ticket so conservation (submitted = completed + pending-anywhere +
    shed, no duplication) is checkable after ANY interleaving of
    submit / tick / steal / fail. Ticket identity is the sim-global
    ``payload`` sequence number — tids are per-scheduler and collide
    across replicas by construction."""

    def __init__(self, *, replicas: int = 3,
                 service_s: Union[float, Sequence[float]] = 0.01,
                 slots: Union[int, Sequence[int]] = 1, steal: bool = True,
                 policy: str = "fifo", dt: float = 0.005, seed: int = 0,
                 route: str = "count",
                 precisions: Optional[Sequence[str]] = None,
                 fleet_prefix: bool = False, prefix_cache: int = 0,
                 prefix_host_entries: int = 0,
                 hit_service_frac: float = 0.5, **sched_kw):
        if np.isscalar(service_s):
            service_s = [float(service_s)] * replicas
        if np.isscalar(slots):
            slots = [int(slots)] * replicas
        if precisions is None:
            precisions = ["fp32"] * replicas
        self._policy = policy
        self._sched_kw = dict(sched_kw)
        # payload -> prefix tag, shared by every replica (the sim-level
        # stand-in for hashing real token prefixes)
        self.prefix_tags: Dict[int, int] = {}
        self._prefix_kw = dict(prefix_cache=int(prefix_cache),
                               hit_service_frac=float(hit_service_frac),
                               prefix_tags=self.prefix_tags)
        self.replicas = [SimReplica(service_s=float(service_s[i]),
                                    slots=int(slots[i]), policy=policy,
                                    precision=precisions[i],
                                    **self._prefix_kw, **sched_kw)
                         for i in range(replicas)]
        self.router = ReplicaRouter(self.replicas, steal=steal, route=route,
                                    fleet_prefix=fleet_prefix,
                                    prefix_host_entries=prefix_host_entries)
        self.halted: set = set()     # frozen cards: stop serving, queue
        #                              accumulates until the detector fires
        if route == "feedback":
            # seed the EWMAs with the replicas' configured service times,
            # as the live drive loops would measure them — the sim steps
            # replicas directly, so record_dispatch never fires
            for i, s in enumerate(service_s):
                self.router.record_dispatch(i, float(s))
        self.dt = dt
        self.now = 0.0
        self.rng = np.random.default_rng(seed)
        self.submitted: List[Ticket] = []
        self.shed: List[Ticket] = []
        self.completed: List[Ticket] = []

    # ---- event sources ---------------------------------------------------
    def submit(self, *, size: int = 1, priority: int = 0,
               slo_ms: Optional[float] = None,
               pin: Optional[int] = None,
               prefix: Optional[int] = None) -> Ticket:
        """One arrival at virtual ``now``. ``pin`` bypasses the router and
        lands the ticket straight on one replica's queue — the hot-keyed
        / session-affinity skew that work stealing exists to fix.
        ``prefix`` tags the payload as sharing that prefix family, so a
        fleet-prefix sim can steer / ship / hit on it."""
        payload = len(self.submitted)
        if prefix is not None:
            self.prefix_tags[payload] = int(prefix)
        if pin is None:
            t = self.router.submit(payload, slo_ms=slo_ms,
                                   priority=priority, size=size,
                                   now=self.now)
        else:
            t = self.replicas[pin].submit(payload, slo_ms=slo_ms,
                                          priority=priority, size=size,
                                          now=self.now)
        self.submitted.append(t)
        if t.shed:
            self.shed.append(t)
        return t

    def tick(self) -> List[Ticket]:
        """Advance the virtual clock one dt: every live, un-halted
        replica completes due work and admits, then one stealing round.
        Returns tickets completed this tick."""
        self.now += self.dt
        done: List[Ticket] = []
        for i, r in enumerate(self.replicas):
            if not self.router.dead[i] and i not in self.halted:
                done.extend(r.step(self.now))
        self.router.maybe_steal(now=self.now)
        self.completed.extend(done)
        return done

    def fail(self, idx: int) -> int:
        """Kill replica ``idx`` at virtual ``now``: fault drain through
        the real router path. Returns tickets re-homed."""
        return self.router.drain_replica(idx, now=self.now)

    def page_out(self, idx: int) -> Optional[Ticket]:
        """Park replica ``idx``'s longest-remaining in-flight session to
        host RAM (no-op on a dead/empty replica)."""
        if self.router.dead[idx]:
            return None
        return self.replicas[idx].page_out(self.now)

    def page_in(self, idx: int) -> Optional[Ticket]:
        """Fault replica ``idx``'s oldest paged session back in (no-op
        without a free slot or paged work)."""
        if self.router.dead[idx]:
            return None
        return self.replicas[idx].page_in(self.now)

    def migrate(self, src: int, dst: int) -> int:
        """Mid-service migration: move the longest-remaining in-flight
        ticket from ``src`` to a free slot on ``dst`` WITH its frozen
        remaining service (the sim-level snapshot ships — no
        restart-from-zero). tid / priority / deadline move untouched
        (shared virtual clock, so no restamp is needed — the engine path
        goes through ``Scheduler.absorb`` for cross-timeline moves).
        Returns tickets moved (0 or 1)."""
        if src == dst or self.router.dead[src] or self.router.dead[dst] \
                or dst in self.halted:
            return 0
        s, d = self.replicas[src], self.replicas[dst]
        if not s.active or d.free_slots <= 0:
            return 0
        k = max(range(len(s.active)),
                key=lambda i: (s.active[i][1], s.active[i][0].tid))
        t, due = s.active.pop(k)
        d.active.append((t, self.now + max(due - self.now, 0.0)))
        d.telemetry.record_migrated()
        return 1

    def halt(self, idx: int):
        """Freeze replica ``idx`` WITHOUT draining it — the real card-
        death shape: the card stops serving (and, under the elastic
        harness, stops heartbeating) but its queue and in-flight slots
        keep their tickets until the failure detector declares it dead
        and the controller runs the drain. ``fail`` is the
        drain-immediately path; ``halt`` is drain-after-detection."""
        self.halted.add(idx)

    def replica_factory(self, *, service_s: float = 0.01, slots: int = 1,
                        precision: str = "fp32"):
        """Factory for the FleetController's scale-up path: each call
        builds a fresh SimReplica with these knobs and appends it to the
        sim's conservation tracking (the caller — ``add_replica`` —
        registers it with the router, so sim and router indices stay
        aligned: the factory must only be called as the add_replica
        argument)."""
        def make() -> SimReplica:
            r = SimReplica(service_s=service_s, slots=slots,
                           policy=self._policy, precision=precision,
                           **self._prefix_kw, **self._sched_kw)
            self.replicas.append(r)
            return r
        return make

    def drain(self, max_ticks: int = 100_000):
        """Tick until the fleet is empty (bounded — a conservation bug
        that wedges the fleet fails loudly instead of hanging)."""
        for _ in range(max_ticks):
            if not self.router.has_work:
                return
            self.tick()
        raise RuntimeError(f"fleet not drained after {max_ticks} ticks: "
                           f"pending {[r.scheduler.depth for r in self.replicas]}, "
                           f"inflight {[r.inflight for r in self.replicas]}")

    # ---- invariant surface -----------------------------------------------
    def pending_payloads(self) -> List[int]:
        """Every accepted-but-unfinished payload across the fleet: pending
        queues plus in-flight slots plus host-RAM-paged sessions, dead
        replicas included (a correct drain leaves them empty)."""
        out = []
        for r in self.replicas:
            out.extend(t.payload for t in r.scheduler._pending)
            out.extend(t.payload for t, _ in r.active)
            out.extend(t.payload for t, _ in r.paged)
        return out

    def assert_conserved(self):
        """submitted = completed + pending-anywhere + shed, each exactly
        once — across any submit/steal/fail/complete interleaving."""
        accepted = {t.payload for t in self.submitted if not t.shed}
        counts: Dict[int, int] = {}
        for p in [t.payload for t in self.completed] \
                + self.pending_payloads():
            counts[p] = counts.get(p, 0) + 1
        dup = {p: c for p, c in counts.items() if c > 1}
        assert not dup, f"tickets duplicated across queues: {dup}"
        lost = accepted - set(counts)
        assert not lost, f"accepted tickets lost: {sorted(lost)}"
        extra = set(counts) - accepted
        assert not extra, f"unsubmitted tickets materialized: {extra}"
        assert len(self.shed) == sum(t.shed for t in self.submitted)

    def fleet_summary(self) -> dict:
        """Router summary with the serving window pinned to virtual time
        (QPS and latencies are then all on the same clock)."""
        for r in self.replicas:
            r.telemetry.serving_s = self.now
        self.router._serving_s = self.now
        return self.router.summary()

    def served_per_replica(self) -> List[int]:
        return [r.telemetry.served for r in self.replicas]


# --------------------------------------------------------------------------
# Production-shaped traces: seeded arrival processes with the
# load shapes the paper's deployment faces — diurnal curves, flash
# crowds, hot-keyed bursts, multi-tenant priority mixes. All virtual-time
# and bit-deterministic under a fixed seed.
# --------------------------------------------------------------------------

@dataclass
class Arrival:
    """One trace event: submit at virtual time ``t``."""
    t: float
    size: int = 1
    priority: int = 0
    pin: Optional[int] = None        # session-affinity / hot-key target
    slo_ms: Optional[float] = None


def _poisson_times(rng, n: int, mean_gap_s) -> np.ndarray:
    """Cumulative arrival times of a Poisson process whose mean gap may
    vary per arrival (``mean_gap_s`` scalar or length-n array)."""
    return np.cumsum(rng.exponential(1.0, n) * mean_gap_s)


def diurnal_trace(n: int, *, base_gap_s: float = 0.01, amp: float = 0.75,
                  periods: float = 2.0, seed: int = 0,
                  slo_ms: Optional[float] = None) -> List[Arrival]:
    """Diurnal load curve: arrival rate swings sinusoidally by ±``amp``
    around the base rate over ``periods`` full day-cycles — the paper's
    production reality that a fixed fleet must be provisioned for the
    peak and then burns idle replicas all trough long."""
    rng = np.random.default_rng(seed)
    phase = 2.0 * np.pi * periods * np.arange(n) / n
    mean = base_gap_s / (1.0 + amp * np.sin(phase))
    times = _poisson_times(rng, n, mean)
    sizes = rng.integers(1, 4, n)
    return [Arrival(float(t), size=int(s), slo_ms=slo_ms)
            for t, s in zip(times, sizes)]


def flash_crowd_trace(n: int, *, base_gap_s: float = 0.01,
                      crowd_x: float = 8.0, start: float = 0.4,
                      end: float = 0.6, seed: int = 0,
                      slo_ms: Optional[float] = None) -> List[Arrival]:
    """Flash crowd: steady base load, then the arrival rate jumps by
    ``crowd_x`` for the middle [start, end) fraction of the trace — the
    scale-up trigger scenario (a fixed fleet sheds; an elastic one adds
    replicas and sheds less at the same offered load)."""
    rng = np.random.default_rng(seed)
    mean = np.full(n, base_gap_s)
    mean[int(start * n):int(end * n)] /= crowd_x
    times = _poisson_times(rng, n, mean)
    sizes = rng.integers(1, 4, n)
    return [Arrival(float(t), size=int(s), slo_ms=slo_ms)
            for t, s in zip(times, sizes)]


def hot_burst_trace(n: int, *, base_gap_s: float = 0.01, hot: int = 0,
                    skew: float = 0.8, start: float = 0.3,
                    end: float = 0.5, crowd_x: float = 3.0, seed: int = 0,
                    slo_ms: Optional[float] = None) -> List[Arrival]:
    """Hot-keyed burst: during the burst window the rate rises by
    ``crowd_x`` AND ``skew`` of arrivals pin to one replica (session
    affinity the router cannot rebalance at submit time) — stealing and
    scale-up must both engage."""
    rng = np.random.default_rng(seed)
    mean = np.full(n, base_gap_s)
    lo, hi = int(start * n), int(end * n)
    mean[lo:hi] /= crowd_x
    times = _poisson_times(rng, n, mean)
    pins = [hot if lo <= i < hi and rng.random() < skew else None
            for i in range(n)]
    return [Arrival(float(t), size=1, pin=p, slo_ms=slo_ms)
            for t, p in zip(times, pins)]


def multi_tenant_trace(n: int, *, base_gap_s: float = 0.01,
                       mix: Sequence[float] = (0.25, 0.5, 0.25),
                       slos_ms: Sequence[Optional[float]] = (200.0, 1000.0,
                                                            None),
                       seed: int = 0) -> List[Arrival]:
    """Multi-tenant priority mix: classes 0..k-1 drawn per ``mix``, each
    with its own SLO (None = best-effort batch) — the paper's mixed
    latency-critical + batch production traffic."""
    rng = np.random.default_rng(seed)
    times = _poisson_times(rng, n, base_gap_s)
    classes = rng.choice(len(mix), n, p=np.asarray(mix) / sum(mix))
    sizes = rng.integers(1, 4, n)
    return [Arrival(float(t), size=int(s), priority=int(c),
                    slo_ms=slos_ms[int(c)])
            for t, s, c in zip(times, sizes, classes)]


# --------------------------------------------------------------------------
# Elastic scenario loop: FleetSim + FleetController, closed loop.
# --------------------------------------------------------------------------

def run_elastic(sim: FleetSim, controller, arrivals: Sequence[Arrival], *,
                kills: Sequence[Tuple[float, int]] = (),
                control_every: int = 1,
                max_ticks: int = 2_000_000) -> dict:
    """Drive ``sim`` through ``arrivals`` with ``controller`` in the
    loop: each tick every live, un-halted replica heartbeats, then
    (every ``control_every`` ticks) the controller steps — draining
    newly-declared failures and scaling through the one drain path.
    ``kills`` freezes replicas at (virtual time, index): a frozen card
    stops serving AND heartbeating, so only the failure detector can
    notice it. Ticks until the trace is fully offered and the fleet is
    drained; asserts fleet-wide conservation; returns the scenario
    metrics (per-tick live-replica counts included, so callers can
    price capacity burn per load window)."""
    mon = controller.monitor
    pending_kills = sorted(kills)
    live_per_tick: List[int] = []
    i = ticks = 0
    while i < len(arrivals) or sim.router.has_work:
        if ticks >= max_ticks:
            raise RuntimeError(
                f"elastic run not drained after {max_ticks} ticks "
                f"(pending {[r.scheduler.depth for r in sim.replicas]})")
        while i < len(arrivals) and arrivals[i].t <= sim.now:
            a = arrivals[i]
            pin = a.pin
            if pin is not None and (pin >= len(sim.router.dead)
                                    or sim.router.dead[pin]
                                    or pin in sim.halted):
                pin = None           # the hot session re-connects elsewhere
            sim.submit(size=a.size, priority=a.priority,
                       slo_ms=a.slo_ms, pin=pin)
            i += 1
        sim.tick()
        while pending_kills and pending_kills[0][0] <= sim.now:
            sim.halt(pending_kills.pop(0)[1])
        for j in sim.router.alive:
            if j in sim.halted or j not in mon.hosts:
                continue
            if mon.hosts[j].alive:
                mon.beat(j)
        ticks += 1
        if ticks % control_every == 0:
            controller.step(sim.now)
        live_per_tick.append(
            len([j for j in sim.router.alive if j not in sim.halted]))
    sim.assert_conserved()
    accepted = sum(1 for t in sim.submitted if not t.shed)
    return {"submitted": len(sim.submitted),
            "fleet": sim.fleet_summary(),
            "accepted": accepted,
            "completed": len(sim.completed),
            "shed": len(sim.shed),
            "lost": accepted - len(sim.completed),
            "ticks": ticks,
            "scale_ups": controller.scale_ups,
            "scale_downs": controller.scale_downs,
            "faults_drained": controller.faults_drained,
            "live_per_tick": live_per_tick,
            "replica_ticks": int(sum(live_per_tick)),
            "peak_live": max(live_per_tick) if live_per_tick else 0,
            "min_live": min(live_per_tick) if live_per_tick else 0}


def run_fixed(sim: FleetSim, arrivals: Sequence[Arrival], *,
              max_ticks: int = 2_000_000) -> dict:
    """The fixed-fleet control arm: the same arrival loop as
    ``run_elastic`` with no controller — whatever the sim starts with
    serves the whole trace. Comparable metrics dict (live count is
    constant by construction)."""
    i = ticks = 0
    while i < len(arrivals) or sim.router.has_work:
        if ticks >= max_ticks:
            raise RuntimeError(f"fixed run not drained in {max_ticks} ticks")
        while i < len(arrivals) and arrivals[i].t <= sim.now:
            a = arrivals[i]
            sim.submit(size=a.size, priority=a.priority,
                       slo_ms=a.slo_ms, pin=a.pin)
            i += 1
        sim.tick()
        ticks += 1
    sim.assert_conserved()
    accepted = sum(1 for t in sim.submitted if not t.shed)
    n = len(sim.replicas)
    return {"submitted": len(sim.submitted),
            "fleet": sim.fleet_summary(),
            "accepted": accepted,
            "completed": len(sim.completed),
            "shed": len(sim.shed),
            "lost": accepted - len(sim.completed),
            "ticks": ticks,
            "replica_ticks": n * ticks,
            "peak_live": n, "min_live": n}


def elastic_vs_fixed(n: int = 4_000, *, base_gap_s: float = 0.006,
                     crowd_x: float = 6.0, crowd_start: float = 0.25,
                     crowd_end: float = 0.40, service_s: float = 0.01,
                     fixed_replicas: int = 4, initial_replicas: int = 2,
                     min_replicas: int = 2, max_replicas: int = 8,
                     max_queue: int = 32, dt: float = 0.005,
                     seed: int = 0, slo_ms: float = 500.0,
                     heartbeat_timeout_s: float = 0.05,
                     cooldown_s: float = 0.2, down_hold_s: float = 0.5,
                     kills: Sequence[Tuple[float, int]] = (),
                     kill_at_frac: Optional[float] = None,
                     kill_idx: int = 0) -> dict:
    """The elastic-fleet headline scenario (bench ``elastic`` section +
    perf-gate ``elastic`` scenario): the SAME seeded flash-crowd trace
    through (a) a fixed mid-sized fleet and (b) an autoscaled fleet
    under a FleetController. The elastic fleet must shed less at the
    peak (it can grow past the fixed size) AND burn fewer
    replica-seconds over the run (it shrinks through the trough) —
    both bit-deterministic, so the perf gate can hold tight thresholds.
    """
    from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
    from repro_torch.serving.controller import ControllerConfig, FleetController

    arrivals = flash_crowd_trace(n, base_gap_s=base_gap_s,
                                 crowd_x=crowd_x, start=crowd_start,
                                 end=crowd_end, seed=seed, slo_ms=slo_ms)
    if kill_at_frac is not None:
        # freeze a card at this fraction of the trace (elastic arm only —
        # the fixed arm has no detector, so a frozen card would wedge it)
        kills = list(kills) + [(arrivals[int(kill_at_frac * n)].t,
                                kill_idx)]
    fixed_sim = FleetSim(replicas=fixed_replicas, service_s=service_s,
                         slots=1, dt=dt, seed=seed, max_queue=max_queue)
    fixed = run_fixed(fixed_sim, arrivals)

    sim = FleetSim(replicas=initial_replicas, service_s=service_s,
                   slots=1, dt=dt, seed=seed, max_queue=max_queue)
    monitor = HeartbeatMonitor(num_hosts=initial_replicas,
                               timeout_s=heartbeat_timeout_s,
                               clock=lambda: sim.now)
    controller = FleetController(
        sim.router, sim.replica_factory(service_s=service_s), monitor,
        ControllerConfig(min_replicas=min_replicas,
                         max_replicas=max_replicas, slo_ms=slo_ms,
                         cooldown_s=cooldown_s, down_hold_s=down_hold_s))
    elastic = run_elastic(sim, controller, arrivals, kills=kills)

    trough = elastic["live_per_tick"][int(0.9 * len(
        elastic["live_per_tick"])):]
    return {"arrivals": arrivals, "fixed": fixed, "elastic": elastic,
            "controller": controller,
            "shed_improved": elastic["shed"] < fixed["shed"],
            "capacity_improved": (elastic["replica_ticks"] * dt
                                  < fixed["replica_ticks"] * dt),
            "replica_seconds_fixed": fixed["replica_ticks"] * dt,
            "replica_seconds_elastic": elastic["replica_ticks"] * dt,
            "trough_live_mean": (sum(trough) / len(trough))
            if trough else 0.0,
            "zero_lost": fixed["lost"] == 0 and elastic["lost"] == 0}

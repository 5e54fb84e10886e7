"""Failure detection, checkpoint-restart, elastic rescale and straggler
mitigation for the port: copies of ``repro/runtime/fault_tolerance.py``
(``HostState``, ``DeadHostBeat`` and ``HeartbeatMonitor``, which the
fleet's ``FleetController`` uses; ``ElasticPlan``, ``plan_elastic_mesh``,
``TrainSupervisor``, ``HostFailure``, ``HedgePolicy``,
``simulate_hedged_latency`` and ``StepDeadline``, the training side's),
kept so that the port never imports the JAX package.

The detector runs on any clock: the fleet simulator passes its virtual
``now``, a live fleet ``time.monotonic``.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Sequence


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    alive: bool = True      # False once DECLARED dead — only rejoin() clears


class DeadHostBeat(RuntimeError):
    """A heartbeat arrived from a host already declared dead. Silent
    resurrection is the classic split-brain bug: the consumer (e.g. the
    fleet controller) already drained the host's replica, so a late beat
    must not flip it healthy behind the consumer's back — re-admission is
    an explicit lifecycle event (``rejoin``), not a side effect."""


class HeartbeatMonitor:
    """Failure detector: a host missing ``timeout_s`` of heartbeats is dead.

    Detector contract (the fleet controller's drain-exactly-once depends
    on it):

    - ``unhealthy()`` is LEVEL-triggered and PURE: the set of hosts
      currently past the timeout (or already declared dead). Safe to
      poll, never mutates.
    - ``newly_failed()`` is EDGE-triggered: each death is reported
      exactly once, at the poll that declares it. This is the signal to
      wire to ``drain_replica`` — a level signal would re-drain every
      already-dead host on every poll (and instantly re-kill a host that
      rejoined at the same id).
    - the timeout boundary is inclusive-alive: ``now - last == timeout_s``
      is still healthy; one tick past is dead (same boundary convention
      as the SLA deadline semantics).
    - a dead host stays dead until ``rejoin()``; a ``beat`` from it
      raises ``DeadHostBeat`` instead of silently resurrecting it.
    - hosts can join (``add_host`` — elastic scale-up) and leave
      (``remove_host`` — deliberate scale-down, so the departure is
      never mistaken for a death).
    """

    def __init__(self, num_hosts: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.timeout_s = timeout_s
        now = clock()
        self.hosts = {h: HostState(h, now) for h in range(num_hosts)}

    # ---- membership (elastic fleet) -------------------------------------
    def add_host(self, host_id: int) -> None:
        """Register a new host (scale-up); its heartbeat starts fresh."""
        if host_id in self.hosts:
            raise ValueError(f"host {host_id} already registered "
                             f"(use rejoin() to resurrect a dead host)")
        self.hosts[host_id] = HostState(host_id, self.clock())

    def remove_host(self, host_id: int) -> None:
        """Deregister a host (deliberate scale-down): it leaves the
        monitored set entirely, so it can never be reported failed."""
        del self.hosts[host_id]

    def rejoin(self, host_id: int) -> None:
        """Explicitly re-admit a dead host: the only path back to alive.
        Stamps a fresh heartbeat so it does not instantly re-fail."""
        st = self.hosts[host_id]
        st.alive = True
        st.last_heartbeat = self.clock()

    # ---- heartbeats ------------------------------------------------------
    def beat(self, host_id: int):
        st = self.hosts[host_id]
        if not st.alive:
            raise DeadHostBeat(
                f"host {host_id} was declared dead; call rejoin() before "
                f"it may beat again (late beats must not silently "
                f"resurrect a drained host)")
        st.last_heartbeat = self.clock()

    # ---- detection -------------------------------------------------------
    def _timed_out(self, st: HostState, now: float) -> bool:
        # inclusive-alive boundary: exactly timeout_s since the last beat
        # is still healthy, one tick past is dead
        return now - st.last_heartbeat > self.timeout_s

    def unhealthy(self) -> List[int]:
        """LEVEL: every host currently dead or past the timeout. Pure —
        no state transition happens here (detection is separated from
        declaration, so pollers can't race the edge signal)."""
        now = self.clock()
        return sorted(st.host_id for st in self.hosts.values()
                      if not st.alive or self._timed_out(st, now))

    def newly_failed(self) -> List[int]:
        """EDGE: declare dead every alive host past the timeout and
        return exactly those. Each death is reported once — subsequent
        polls return [] until the host rejoins and dies again. Wire THIS
        to ``drain_replica``."""
        now = self.clock()
        out = []
        for st in self.hosts.values():
            if st.alive and self._timed_out(st, now):
                st.alive = False
                out.append(st.host_id)
        return sorted(out)

    def failed_hosts(self) -> List[int]:
        """Deprecated alias for the LEVEL signal (the old name promised a
        getter but mutated health state and re-reported every dead host
        forever — wired to a drain path that double-drains). Kept for
        callers that want the level view; new code should choose
        ``unhealthy()`` or ``newly_failed()`` explicitly."""
        return self.unhealthy()

    def healthy_count(self) -> int:
        """Hosts alive and within the timeout — pure (no longer relies on
        a detection side effect to refresh health bits)."""
        now = self.clock()
        return sum(st.alive and not self._timed_out(st, now)
                   for st in self.hosts.values())


@dataclass
class ElasticPlan:
    """Re-plan the mesh after losing hosts. Shrinks the data axis to the
    largest feasible power-of-two slice (model axis is preserved: TP groups
    must stay intact, so whole TP groups are dropped)."""
    old_data: int
    old_model: int
    new_data: int
    new_model: int

    @property
    def changed(self) -> bool:
        return (self.old_data, self.old_model) != (self.new_data, self.new_model)


def plan_elastic_mesh(data: int, model: int, hosts_per_group: int,
                      failed: Sequence[int]) -> ElasticPlan:
    """Each data-axis slice maps to ``hosts_per_group`` hosts. A failed host
    removes its whole slice; the data axis shrinks to the largest power of
    two <= surviving slices (keeps batch divisibility)."""
    dead_groups = {h // hosts_per_group for h in failed}
    surviving = data - len([g for g in dead_groups if g < data])
    new_data = 1
    while new_data * 2 <= surviving:
        new_data *= 2
    return ElasticPlan(data, model, max(new_data, 1), model)


class TrainSupervisor:
    """Checkpoint-restart loop: run steps, detect (simulated) failures,
    restore from the latest checkpoint onto the (possibly smaller) mesh.

    ``run_step(step) -> None`` may raise HostFailure; ``save(step)`` /
    ``restore() -> step`` wrap the CheckpointManager."""

    def __init__(self, run_step, save, restore, *, ckpt_every: int = 10,
                 max_restarts: int = 8):
        self.run_step = run_step
        self.save = save
        self.restore = restore
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.restarts = 0
        self.steps_done = 0
        self.log: List[str] = []

    def run(self, total_steps: int) -> int:
        step = 0
        while step < total_steps:
            try:
                self.run_step(step)
                self.steps_done += 1
                step += 1
                if step % self.ckpt_every == 0:
                    self.save(step)
            except HostFailure as e:
                self.restarts += 1
                self.log.append(f"step {step}: {e}; restart #{self.restarts}")
                if self.restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                step = self.restore()
        return step


class HostFailure(RuntimeError):
    pass


# --------------------------------------------------------------------------
# Straggler mitigation
# --------------------------------------------------------------------------

@dataclass
class HedgePolicy:
    """Serving-side: hedge a request to a second replica once its latency
    exceeds the p95 of recent requests (paper: queue+multiple devices; the
    runtime 'distributes requests to devices as they become available').

    The window is a ``deque(maxlen=window)``: ``observe`` sits on the hot
    serving path (once per completed request), and a list's ``pop(0)`` is
    O(window) per call — the deque evicts in O(1)."""
    history: Deque[float] = field(default_factory=deque)
    window: int = 256
    quantile: float = 0.95

    def __post_init__(self):
        self.history = deque(self.history, maxlen=self.window)

    def observe(self, latency_s: float):
        self.history.append(latency_s)      # maxlen evicts the oldest

    def hedge_deadline(self) -> float:
        if len(self.history) < 8:
            return float("inf")
        xs = sorted(self.history)
        return xs[min(int(len(xs) * self.quantile), len(xs) - 1)]

    def should_hedge(self, elapsed_s: float) -> bool:
        return elapsed_s > self.hedge_deadline()


def simulate_hedged_latency(latencies: Sequence[float],
                            hedge_after: float) -> List[float]:
    """Latency of hedged execution: min(primary, hedge_after + clone)."""
    out = []
    lat = list(latencies)
    for i, l in enumerate(lat):
        clone = lat[(i * 7 + 3) % len(lat)]       # deterministic "replica"
        out.append(min(l, hedge_after + clone) if l > hedge_after else l)
    return out


@dataclass
class StepDeadline:
    """Training-side straggler detection: per-step wall-time watchdog. A step
    exceeding k x median flags the slowest host for replacement (with SPMD
    collectives one slow host stalls everyone — detect, then evict via the
    elastic plan)."""
    k: float = 3.0
    history: List[float] = field(default_factory=list)

    def observe(self, step_time_s: float) -> bool:
        self.history.append(step_time_s)
        if len(self.history) < 5:
            return False
        # standard (interpolated) median — taking the upper of the two
        # middle elements for even windows biased the threshold high, so
        # a borderline straggler at exactly k x median slipped through
        med = statistics.median(self.history[-50:])
        return step_time_s > self.k * med

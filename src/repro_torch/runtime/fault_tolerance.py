"""Failure detection for the port's fleet: copies of ``HostState``,
``DeadHostBeat`` and ``HeartbeatMonitor`` from
``repro/runtime/fault_tolerance.py`` (what ``FleetController`` needs of
it), kept so that the port never imports the JAX package. The reference
module's training-side hooks (checkpoint-restart, elastic mesh plans,
hedging, step deadlines) belong to the training slice and are not here.

The detector runs on any clock: the fleet simulator passes its virtual
``now``, a live fleet ``time.monotonic``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List


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

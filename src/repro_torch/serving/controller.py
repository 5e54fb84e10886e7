"""Elastic fleet controller of the port: a copy of
``repro/serving/controller.py``, kept so that the port never imports the
JAX package. It makes the reference's decisions on the same inputs,
including its known gap (ROADMAP C: at some seeds a scale-down picks the
last fp32 replica of a mixed fleet), which the port's tests hold as a
deterministic expected failure rather than fix in one copy only.

Elastic fleet controller — closes the loop from observed health and
load back to fleet size.

The paper's deployment story is a card fleet that survives faults and
diurnal production traffic without dropping latency-bounded work. The
router already has the fault half (``drain_replica`` re-homes a
dead card's entire accepted load with zero loss) — this module adds the
control half: a ``FleetController`` watches fleet telemetry and a
``HeartbeatMonitor`` and scales the fleet through the EXISTING machinery,
so there is exactly one drain path:

- **missed heartbeat** → ``monitor.newly_failed()`` (edge-triggered: each
  death reported exactly once — the level-triggered ``failed_hosts`` of
  the old detector would re-drain every dead host forever) →
  ``router.drain_replica`` → accepted work re-homed, zero loss;
- **deliberate scale-down** → same ``drain_replica`` on the chosen
  victim, plus ``monitor.remove_host`` so the departure is never
  mistaken for a death;
- **scale-up** → ``router.add_replica(factory())``: the fresh replica
  takes new routes immediately and cross-replica work stealing
  rebalances the existing backlog onto it — no dedicated migration path.

Decision inputs (Park et al. 1811.09886 / Gupta et al. 1906.03109: the
queueing layer, not the kernel, dominates serving tails under load
swings — so the controller keys off queue-side telemetry, which the
runtime already emits):

- ``queue_per_live``  — fleet load (fresh queue depth + in-flight) per
  live replica,
- ``shed_delta``      — admission rejections since the last control
  step: any shedding means accepted-capacity is exhausted,
- ``miss_frac``       — SLA misses / completions in the window, the
  p99-vs-SLO signal in recent-window form (miss fraction above 1%
  IS p99 past the SLO, and it is O(1) per step instead of re-sorting
  pooled latency samples at every tick),
- ``est_wait_ms``     — queue_per_live x mean per-replica EWMA step
  time, the feedback-routing signal reused as a queueing-delay
  forecast (inactive until the EWMAs are measured).

Hysteresis: any scale event starts a ``cooldown_s`` window in which the
controller holds — scale-up and scale-down share the window, so the
fleet can never flap up/down faster than the cooldown (a property test
pins this). Scale-down is additionally gated on EVERY down-signal being
quiet (no sheds, low queue, miss_frac below the down threshold).

Safety invariants (property-pinned in tests/test_scheduler_properties.py):

- the controller never drains the last live replica (a deliberate
  scale-down below ``min_replicas`` is refused; a FAULT on the last
  replica first registers a replacement from the factory, then drains —
  replace-then-drain, so re-homing always has a destination);
- while mixed-precision class-0 pinning is active the controller never
  scale-downs the last live fp32 replica (the drain path itself would
  degrade gracefully, but a *deliberate* decision must not burn the
  accuracy pin);
- decisions are a pure function of (router state, telemetry, clock):
  fixed seed → identical decision log;
- ticket conservation holds across any interleaving of scale events
  (inherited from drain/absorb, asserted fleet-wide by the sim harness).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from repro_torch.runtime.fault_tolerance import HeartbeatMonitor


@dataclass(frozen=True)
class ControllerConfig:
    """Scaling thresholds. Defaults suit the fleet sim's virtual-second
    timescale; live deployments tune these like any SLO knob."""
    min_replicas: int = 1
    max_replicas: int = 8
    # queue-depth thresholds (fresh queue + in-flight, per live replica)
    up_queue_per_replica: float = 4.0
    down_queue_per_replica: float = 0.5
    # any shed in a control window is an up signal; scale-down requires a
    # completely shed-free window
    shed_up: int = 1
    # SLA-window thresholds (p99-vs-SLO in recent-miss-fraction form);
    # both inactive when the traffic carries no deadlines
    up_miss_frac: float = 0.01
    down_miss_frac: float = 0.01
    # queueing-delay forecast gate: est_wait_ms > slo_ms x ratio -> up
    # (needs slo_ms AND measured EWMAs; inactive otherwise)
    slo_ms: Optional[float] = None
    up_wait_ratio: float = 1.0
    # hysteresis: minimum spacing between ANY two scale decisions, plus a
    # sustained-underload requirement for scale-down — one instantaneous
    # empty-queue sample at moderate load is noise, not a trough, so the
    # down signals must hold continuously for down_hold_s before a
    # replica is drained (scale-up stays single-sample: reacting late to
    # overload costs latency, reacting late to a trough only costs watts)
    cooldown_s: float = 0.25
    down_hold_s: float = 1.0
    # scale-down reads an EWMA of queue_per_live rather than the raw
    # sample — a Poisson blip above threshold must not reset the trough
    # timer, and a single empty sample must not read as a trough
    down_smooth_alpha: float = 0.05
    # cache/paging pressure gate: mean paged-fraction across live
    # replicas above this threshold is an up signal (cards are spilling
    # KV state to host RAM — the fleet is short on resident slots even
    # if the queue looks calm). None (default) disables the rule.
    up_cache_pressure: Optional[float] = None


@dataclass
class Decision:
    """One controller action (or deliberate hold), for audit/testing.
    ``action`` is one of up / down / drain_failed / replace / hold."""
    now: float
    action: str
    reason: str
    replica: Optional[int] = None     # joined (up/replace) or drained idx
    live: int = 0                     # live replicas AFTER the action
    queue_per_live: float = 0.0
    shed_delta: int = 0
    miss_frac: float = 0.0


class FleetController:
    """Heartbeat- and telemetry-driven autoscaler over a ReplicaRouter.

    ``factory()`` builds one fresh replica (engine-factory output — an
    ``InferenceEngine``, ``SimReplica``, anything satisfying the replica
    protocol). ``monitor`` host ids are router replica indices; the
    controller registers/deregisters hosts as the fleet resizes (indices
    are append-only, so an id is never reused and a late beat from a
    drained card can never resurrect the wrong replica).

    Drive it by calling ``step(now)`` at control-loop cadence — every
    sim tick, or a few times per second on a wall clock. Each step polls
    the failure detector first (faults preempt scaling), then makes at
    most one scale decision.
    """

    def __init__(self, router: Any, factory: Callable[[], Any],
                 monitor: HeartbeatMonitor,
                 config: ControllerConfig = ControllerConfig(),
                 perf_model: Optional[Any] = None):
        self.router = router
        self.factory = factory
        self.monitor = monitor
        self.config = config
        # optional analytic PerfModel: when present (and slo_ms is set)
        # the scale-up wait gate switches from the reactive EWMA estimate
        # to a predictive forecast — predicted decode step time x queue
        # depth — which fires BEFORE the first slow completions land
        self.perf_model = perf_model
        self.decisions: List[Decision] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.faults_drained = 0
        self._last_scale_t: Optional[float] = None
        self._under_since: Optional[float] = None
        self._q_smooth: Optional[float] = None
        # cumulative-counter snapshots for window deltas (sums run over
        # ALL replicas, dead included, so they stay monotone across
        # drains)
        self._last_shed = 0
        self._last_sla_total = 0
        self._last_sla_miss = 0

    # ---- signal surface --------------------------------------------------
    def _totals(self):
        shed = self.router.shed
        sla_total = sla_miss = 0
        for r in self.router.replicas:
            t = r.telemetry
            shed += t.shed
            sla_total += t.sla_total
            sla_miss += t.sla_misses
        return shed, sla_total, sla_miss

    def signals(self, now: float) -> dict:
        """The controller's decision inputs, computed fresh (pure —
        reading signals never advances window snapshots)."""
        live = self.router.alive
        n = max(len(live), 1)
        queue = sum(self.router.load(i) for i in live)
        shed, sla_total, sla_miss = self._totals()
        done = sla_total - self._last_sla_total
        miss = sla_miss - self._last_sla_miss
        ewma = [self.router.ewma_s[i] for i in live
                if self.router.ewma_s[i] > 0.0]
        est_wait_ms = (queue / n) * (sum(ewma) / len(ewma)) * 1e3 \
            if ewma else 0.0
        # cache/paging pressure: mean paged-fraction across live replicas
        # (duck-typed — replicas without the property contribute nothing)
        pressure = [getattr(self.router.replicas[i], "cache_pressure", None)
                    for i in live]
        pressure = [p for p in pressure if p is not None]
        cache_pressure = sum(pressure) / len(pressure) if pressure else 0.0
        # predictive wait forecast: model-predicted decode step time x
        # queue depth per live replica — nonzero from the very first
        # tick, unlike est_wait_ms which needs measured EWMAs
        wait_forecast_ms = 0.0
        if self.perf_model is not None:
            step_s = self.perf_model.predict_dispatch_s("decode", 1)
            wait_forecast_ms = (queue / n) * step_s * 1e3
        return {"live": len(live), "queue": queue,
                "queue_per_live": queue / n,
                "shed_delta": shed - self._last_shed,
                "completions_delta": done,
                "miss_frac": miss / done if done else 0.0,
                "est_wait_ms": est_wait_ms,
                "cache_pressure": cache_pressure,
                "wait_forecast_ms": wait_forecast_ms}

    def _advance_window(self):
        self._last_shed, self._last_sla_total, self._last_sla_miss = \
            self._totals()

    # ---- decision rules --------------------------------------------------
    def _overloaded(self, sig: dict) -> Optional[str]:
        c = self.config
        if sig["queue_per_live"] > c.up_queue_per_replica:
            return (f"queue_per_live {sig['queue_per_live']:.2f} > "
                    f"{c.up_queue_per_replica}")
        if sig["shed_delta"] >= c.shed_up:
            return f"shed {sig['shed_delta']} tickets in window"
        if sig["completions_delta"] and sig["miss_frac"] > c.up_miss_frac:
            return (f"window miss_frac {sig['miss_frac']:.3f} > "
                    f"{c.up_miss_frac} (p99 past SLO)")
        if c.up_cache_pressure is not None \
                and sig["cache_pressure"] > c.up_cache_pressure:
            return (f"cache pressure {sig['cache_pressure']:.2f} > "
                    f"{c.up_cache_pressure} (paging to host RAM)")
        if c.slo_ms is not None:
            # predictive forecast when a perf model is attached; the
            # reactive EWMA estimate otherwise (identical defaults)
            if self.perf_model is not None:
                if sig["wait_forecast_ms"] > c.up_wait_ratio * c.slo_ms:
                    return (f"forecast wait {sig['wait_forecast_ms']:.1f}ms"
                            f" > {c.up_wait_ratio} x SLO {c.slo_ms}ms")
            elif sig["est_wait_ms"] > c.up_wait_ratio * c.slo_ms:
                return (f"est wait {sig['est_wait_ms']:.1f}ms > "
                        f"{c.up_wait_ratio} x SLO {c.slo_ms}ms")
        return None

    def _underloaded(self, sig: dict) -> Optional[str]:
        c = self.config
        q = sig.get("queue_smooth", sig["queue_per_live"])
        if q >= c.down_queue_per_replica:
            return None
        if sig["shed_delta"] > 0:
            return None
        if sig["completions_delta"] and sig["miss_frac"] > c.down_miss_frac:
            return None
        return (f"smoothed queue_per_live {q:.2f} < "
                f"{c.down_queue_per_replica}, window quiet")

    def _scale_down_victim(self) -> Optional[int]:
        """Least-loaded live replica, ties to the lowest index — EXCEPT
        the last live fp32 replica while mixed-precision class-0 pinning
        is active (deliberately burning the accuracy pin is never worth
        a trough's capacity saving)."""
        cand = list(self.router.alive)
        if getattr(self.router, "mixed_precision", False):
            fp32 = self.router.fp32_alive
            if len(fp32) == 1:
                cand = [i for i in cand if i != fp32[0]]
        if not cand:
            return None
        return min(cand, key=lambda i: (self.router.load(i), i))

    # ---- the control step ------------------------------------------------
    def step(self, now: float) -> List[Decision]:
        """One control iteration: drain newly-failed replicas (edge
        signal, so each fault drains exactly once), then make at most one
        scale decision gated by the hysteresis cooldown. Returns the
        decisions taken this step (holds are recorded only when a signal
        fired but was refused — cooldown, fleet bounds, pin protection)."""
        made: List[Decision] = []
        sig = self.signals(now)
        a = self.config.down_smooth_alpha
        q = sig["queue_per_live"]
        self._q_smooth = q if self._q_smooth is None \
            else a * q + (1.0 - a) * self._q_smooth
        sig["queue_smooth"] = self._q_smooth

        # -- fault path: missed heartbeats, one drain per death ------------
        for idx in self.monitor.newly_failed():
            if idx >= len(self.router.dead) or self.router.dead[idx]:
                continue                    # already drained (e.g. by hand)
            if len(self.router.alive) <= 1:
                # replace-then-drain: the fault hit the last live replica,
                # so register a replacement first — drain re-homing always
                # needs a live destination
                j = self.router.add_replica(self.factory())
                self.monitor.add_host(j)
                self.scale_ups += 1
                made.append(Decision(now, "replace",
                                     "fault on last live replica", j,
                                     live=len(self.router.alive)))
            n = self.router.drain_replica(idx, now=now)
            self.monitor.remove_host(idx)
            self.faults_drained += 1
            made.append(Decision(now, "drain_failed",
                                 f"missed heartbeat; re-homed {n} tickets",
                                 idx, live=len(self.router.alive)))
            self._last_scale_t = now        # a fault resets the cooldown:
            # the fleet just changed size, so scaling on the same stale
            # window would double-react
            self._under_since = None

        # -- scale path: at most one decision per step ---------------------
        c = self.config
        in_cooldown = (self._last_scale_t is not None
                       and now - self._last_scale_t < c.cooldown_s)
        up_reason = self._overloaded(sig)
        down_reason = None if up_reason else self._underloaded(sig)
        if down_reason:
            if self._under_since is None:
                self._under_since = now
            if now - self._under_since < c.down_hold_s:
                down_reason = None          # quiet, but not yet a trough
        else:
            self._under_since = None
        if up_reason:
            if in_cooldown:
                made.append(self._hold(now, sig, f"cooldown ({up_reason})"))
            elif sig["live"] >= c.max_replicas:
                made.append(self._hold(now, sig,
                                       f"at max_replicas ({up_reason})"))
            else:
                j = self.router.add_replica(self.factory())
                self.monitor.add_host(j)
                self.scale_ups += 1
                self._last_scale_t = now
                self._under_since = None
                made.append(Decision(now, "up", up_reason, j,
                                     live=len(self.router.alive),
                                     queue_per_live=sig["queue_per_live"],
                                     shed_delta=sig["shed_delta"],
                                     miss_frac=sig["miss_frac"]))
        elif down_reason:
            if in_cooldown:
                made.append(self._hold(now, sig,
                                       f"cooldown ({down_reason})"))
            elif sig["live"] <= c.min_replicas:
                made.append(self._hold(now, sig,
                                       f"at min_replicas ({down_reason})"))
            else:
                victim = self._scale_down_victim()
                if victim is None:
                    made.append(self._hold(now, sig,
                                           "precision pin protects the "
                                           "only drainable replica"))
                else:
                    n = self.router.drain_replica(victim, now=now)
                    self.monitor.remove_host(victim)
                    self.scale_downs += 1
                    self._last_scale_t = now
                    self._under_since = None
                    made.append(Decision(
                        now, "down",
                        f"{down_reason}; re-homed {n} tickets", victim,
                        live=len(self.router.alive),
                        queue_per_live=sig["queue_per_live"],
                        shed_delta=sig["shed_delta"],
                        miss_frac=sig["miss_frac"]))

        self._advance_window()
        self.decisions.extend(made)
        return made

    def _hold(self, now: float, sig: dict, reason: str) -> Decision:
        return Decision(now, "hold", reason, None, live=sig["live"],
                        queue_per_live=sig["queue_per_live"],
                        shed_delta=sig["shed_delta"],
                        miss_frac=sig["miss_frac"])

    # ---- reporting -------------------------------------------------------
    def summary(self) -> dict:
        return {"scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "faults_drained": self.faults_drained,
                "live": len(self.router.alive),
                "replicas_total": len(self.router.replicas),
                "decisions": len(self.decisions)}

    def report(self) -> str:
        s = self.summary()
        return (f"controller: +{s['scale_ups']} up / -{s['scale_downs']} "
                f"down / {s['faults_drained']} fault drains; "
                f"{s['live']}/{s['replicas_total']} replicas live")

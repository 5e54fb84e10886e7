"""Request scheduler of the port: a copy of ``repro/serving/scheduler.py``
(the JAX package's shared request scheduler), kept so that the port never
imports the JAX package. ``perf_model`` stays an optional duck-typed
argument (any object with ``service_ratio``); the port passes none.

The shared request scheduler is the Glow runtime's multi-request queue
(paper §IV-C) factored out of the engines.

One admission layer serves every workload: requests enter as *tickets*
carrying an arbitrary engine payload plus scheduling metadata (size,
enqueue time, absolute deadline). A pluggable policy picks which waiting
tickets to admit when the engine reports free capacity:

- ``fifo``       — arrival order (the seed engines' behaviour),
- ``edf``        — earliest-deadline-first for latency-SLA traffic,
- ``sizetime``   — size x time batch formation: group tickets whose
                   padded size falls in the same bucket so one compiled
                   executable serves the whole admitted batch, scoring
                   groups by (members waiting) x (age of oldest) so big
                   coherent batches win but nothing starves,
- ``priority``   — preemption-free strict priority with linear aging
                   (paper: mixed production traffic; 1811.09886 finds
                   co-locating latency-critical and batch traffic without
                   priority isolation is the dominant SLA-miss cause).
                   A ticket of priority ``p`` outranks every fresher
                   ticket of priority ``q > p``; aging guarantees bounded
                   starvation — after waiting ``p * aging_s`` seconds a
                   ticket outranks any freshly-arrived priority-0 ticket.

Backpressure / load shedding (429-style): give the scheduler a
``max_queue`` bound and/or a per-ticket service-time estimate
(``service_ms_est``) and ``submit`` *sheds* tickets that either overflow
the queue or provably cannot meet their deadline — the feasibility check
charges each ticket the estimated service time of every pending ticket
that outranks it (same or better priority class). Shed tickets are
returned with ``shed=True``, are never enqueued (so they can never reach
``admit`` or consume an executor dispatch), and are counted in a
*rejection* counter separate from SLA misses.

Completion flows back through the scheduler so latency / SLA-miss
accounting lands in the shared Telemetry regardless of engine.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.bucketing import DEFAULT_BUCKETS, pick_bucket
from repro_torch.serving.telemetry import Telemetry, percentile

# pass as slo_ms to submit() to force a deadline-less (best-effort) ticket
# even when the scheduler carries a default_slo_ms
NO_SLO = math.inf


@dataclass
class Ticket:
    """One queued unit of work (an LM request, a DLRM batch, ...)."""
    tid: int
    payload: Any
    size: int = 0                       # tokens / rows — policy hint
    size0: int = 0                      # size at submit (resubmit shrinks
                                        # ``size`` to the next chunk)
    priority: int = 0                   # 0 = most important (like nice)
    enqueue_t: float = 0.0
    deadline_t: Optional[float] = None  # absolute perf_counter deadline
    admit_t: Optional[float] = None     # stamped at FIRST admission
    finish_t: float = 0.0
    shed: bool = False                  # rejected at admission (429)
    continuation: bool = False          # re-enqueued chunked-prefill ticket
    stolen: bool = False                # re-homed by cross-replica stealing

    @property
    def latency_ms(self) -> float:
        return (self.finish_t - self.enqueue_t) * 1e3

    def age(self, now: float) -> float:
        return now - self.enqueue_t

    def slack_s(self, now: float) -> float:
        """Time left until the deadline (inf for best-effort tickets)."""
        return (math.inf if self.deadline_t is None
                else self.deadline_t - now)

    def reset_fresh(self):
        """Reset to a not-yet-started ticket — the fault-drain re-homing
        contract (one definition, shared by every drain path): any
        partial service is forfeit, so the ticket re-enters its new home
        as fresh work. tid / priority / enqueue / deadline stay — only
        progress state clears. Engines layer their payload/slot cleanup
        on top (the scheduler cannot know payload semantics)."""
        self.continuation = False
        self.admit_t = None
        self.size = self.size0


# ---- admission policies ---------------------------------------------------

class Policy:
    """Picks <= k tickets to admit; must not reorder its return value
    arbitrarily — the scheduler admits exactly what is returned."""

    def select(self, pending: List[Ticket], k: int,
               now: float) -> List[Ticket]:
        raise NotImplementedError


class FIFOPolicy(Policy):
    def select(self, pending, k, now):
        return pending[:k]


class EDFPolicy(Policy):
    """Earliest-deadline-first; deadline-less tickets sort last, ties
    break by arrival order."""

    def select(self, pending, k, now):
        ranked = sorted(pending,
                        key=lambda t: (t.deadline_t if t.deadline_t
                                       is not None else float("inf"),
                                       t.enqueue_t))
        return ranked[:k]


class SizeTimePolicy(Policy):
    """Batch formation over size buckets (paper T5 meets §IV-C): admit a
    group of same-bucket tickets so the engine can serve them with one
    compiled executable. Group score = waiting-count x oldest-age, so a
    lone old request still beats a large fresh cohort eventually."""

    def __init__(self, buckets: Sequence[int] = (32, 64, 128, 256)):
        self.buckets = tuple(buckets)

    def select(self, pending, k, now):
        groups: Dict[int, List[Ticket]] = {}
        for t in pending:
            groups.setdefault(pick_bucket(t.size, self.buckets),
                              []).append(t)
        best = max(groups.values(),
                   key=lambda g: (len(g) * max(g[0].age(now), 1e-6),
                                  -g[0].enqueue_t))
        return best[:k]


class PriorityAgingPolicy(Policy):
    """Preemption-free strict priority with linear aging.

    Rank key is ``priority - age / aging_s``: a fresh priority-0 ticket
    scores 0, so a priority-``p`` ticket outranks *any* fresh
    priority-0 arrival once it has waited more than ``p * aging_s``
    seconds. That bounds starvation: under continuous admission a
    ticket waits at most ``p * aging_s`` longer than the work already
    ahead of it, however many higher-class tickets keep arriving.
    Within a class (equal effective rank), ties break by arrival order
    then tid, so the policy is deterministic under a virtual clock.
    """

    def __init__(self, aging_s: float = 1.0):
        if aging_s <= 0:
            raise ValueError("aging_s must be positive")
        self.aging_s = aging_s

    def rank(self, t: Ticket, now: float) -> float:
        return t.priority - t.age(now) / self.aging_s

    def select(self, pending, k, now):
        ranked = sorted(pending, key=lambda t: (self.rank(t, now),
                                                t.enqueue_t, t.tid))
        return ranked[:k]


POLICIES: Dict[str, Callable[[], Policy]] = {
    "fifo": FIFOPolicy,
    "edf": EDFPolicy,
    "sizetime": SizeTimePolicy,
    "priority": PriorityAgingPolicy,
}


def make_policy(name_or_policy) -> Policy:
    if isinstance(name_or_policy, Policy):
        return name_or_policy
    try:
        return POLICIES[name_or_policy]()
    except KeyError:
        raise ValueError(f"unknown policy {name_or_policy!r}; "
                         f"choose from {sorted(POLICIES)}")


# ---- live service-time estimation -----------------------------------------

class ServiceEstimator:
    """Admission-estimator calibration from live telemetry (ROADMAP open
    item): the per-ticket service estimate the feasibility check charges
    is the p50 of recent completions in the ticket's size bucket, not a
    hand-tuned constant.

    Cold-start precedence (pinned by regression tests, most specific
    first):

    1. warm bucket — its own p50 once it holds ``min_samples``,
    2. pooled fallback, SIZE-RESCALED — the pooled p50 anchored at the
       median sampled bucket and rescaled to the target bucket.  The old
       raw pooled p50 priced every cold size off whatever bucket
       happened to be warm (a 32-token sample set priced a 512-token
       prefill, and a warm bucket silently flipped the size-aware static
       prior OFF for every other still-cold bucket),
    3. static prior — ``fallback_ms`` (the estimate at ``buckets[0]``)
       rescaled to the target bucket,
    4. ``None`` (no estimate, no feasibility shedding).

    The rescaling ratio comes from the analytic perf model when one is
    wired (``PerfModel.service_ratio`` — sublinear, because the fixed
    dispatch cost amortizes with bucket size) and falls back to the
    linear ``COLD_PRIOR_SCALE`` guess without one."""

    # linear cold prior used when no perf model is wired: estimate
    # scales as (bucket / base) ** COLD_PRIOR_SCALE. 1.0 = linear in
    # padded prefill length, the rough shape of the bucketed
    # executables; the perf model's fitted t_fix/t_tok line replaces
    # this with the measured sublinear curve.
    COLD_PRIOR_SCALE = 1.0

    def __init__(self, fallback_ms: Optional[float] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 window: int = 64, min_samples: int = 5,
                 perf_model=None):
        self.fallback_ms = fallback_ms
        self.buckets = tuple(buckets)
        self.window = window
        self.min_samples = min_samples
        self.perf_model = perf_model
        self._samples: Dict[int, List[float]] = {}
        # pooled fallback keeps (bucket, service_ms) pairs so the
        # estimate can be re-anchored to the target bucket's size
        self._pooled: List[tuple] = []

    def observe(self, size: int, service_ms: float):
        b = pick_bucket(size, self.buckets)
        s = self._samples.setdefault(b, [])
        s.append(service_ms)
        del s[:-self.window]
        self._pooled.append((b, service_ms))
        del self._pooled[:-self.window * 4]

    def _ratio(self, bucket: float, base: float) -> float:
        """Predicted service-time ratio bucket/base: perf-model curve
        when wired, linear guess otherwise."""
        if bucket == base:
            return 1.0
        if self.perf_model is not None:
            return self.perf_model.service_ratio(bucket, base)
        return (bucket / base) ** self.COLD_PRIOR_SCALE

    def estimate(self, size: int) -> Optional[float]:
        b = pick_bucket(size, self.buckets)
        s = self._samples.get(b, [])
        if len(s) >= self.min_samples:
            return percentile(sorted(s), 0.5)
        if len(self._pooled) >= self.min_samples:
            # pooled fallback, rescaled: anchor the pooled p50 at the
            # median sampled bucket, then scale to the target bucket —
            # a small bucket is never priced off a large-bucket sample
            # set (or vice versa)
            ms = percentile(sorted(m for _, m in self._pooled), 0.5)
            anchor = percentile(sorted(float(k) for k, _ in self._pooled),
                                0.5)
            return ms * self._ratio(b, anchor)
        if self.fallback_ms is None:
            return None
        # static cold-start prior (see class docstring)
        return self.fallback_ms * self._ratio(b, self.buckets[0])


# ---- the scheduler --------------------------------------------------------

class Scheduler:
    """Single request queue + admission + completion accounting.

    Engines call ``submit`` on arrival, ``admit(k)`` when k units of
    capacity free up (continuous batching: every freed slot triggers a
    refill attempt), and ``complete`` when a ticket's response is done.

    Admission control (both optional, off by default):

    - ``max_queue``       — bounded queue: submits past the bound shed,
    - ``service_ms_est``  — estimated per-ticket service time; a ticket
      whose deadline slack cannot cover the estimated service of every
      pending ticket in the same-or-better priority class *plus its own*
      is shed at submit time (it would only be served to miss). Pass the
      string ``"auto"`` to calibrate the estimate from live telemetry
      instead (p50 of recent completions per size bucket — see
      ``ServiceEstimator``); ``service_ms_fallback`` seeds the check
      until enough completions exist.

    Shed tickets come back with ``shed=True``, never enter the queue,
    and count in ``telemetry.shed`` — not in SLA misses.
    """

    def __init__(self, policy: str | Policy = "fifo", *,
                 telemetry: Optional[Telemetry] = None,
                 default_slo_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 service_ms_est: Optional[float | str] = None,
                 service_ms_fallback: Optional[float] = None,
                 perf_model=None):
        self.policy = make_policy(policy)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.default_slo_ms = default_slo_ms
        self.max_queue = max_queue
        if service_ms_est == "auto":
            self.service_ms_est = None
            self._svc_auto: Optional[ServiceEstimator] = \
                ServiceEstimator(fallback_ms=service_ms_fallback,
                                 perf_model=perf_model)
        elif isinstance(service_ms_est, str):
            raise ValueError(f"service_ms_est must be a number, 'auto', or "
                             f"None; got {service_ms_est!r}")
        else:
            self.service_ms_est = service_ms_est
            self._svc_auto = None
        self._pending: List[Ticket] = []
        self._ids = itertools.count()

    # -- queue side --------------------------------------------------------
    def service_ms_for(self, size: int) -> Optional[float]:
        """Current per-ticket service estimate for a ticket of ``size``
        (None = no estimate yet, so no feasibility shedding)."""
        if self._svc_auto is not None:
            return self._svc_auto.estimate(size)
        return self.service_ms_est

    def _infeasible(self, t: Ticket, now: float) -> bool:
        """Deadline-feasibility: can ``t`` still meet its SLA behind the
        pending work that outranks it? Work ahead = pending tickets of
        the same or a better (numerically <=) priority class — under the
        priority policy those are served first, and under FIFO/EDF every
        ticket is class 0 so this is simply the whole queue."""
        if t.deadline_t is None:
            return False
        own = self.service_ms_for(t.size)
        if own is None:
            return False
        ahead = [p for p in self._pending if p.priority <= t.priority]
        if self._svc_auto is None:
            need_ms = (len(ahead) + 1) * own
        else:
            # per-ticket estimates: the work ahead is charged at each
            # pending ticket's own size-bucket p50
            need_ms = own + sum(self.service_ms_for(p.size) or own
                                for p in ahead)
        return t.slack_s(now) < need_ms / 1e3

    def submit(self, payload: Any, *, size: int = 0, priority: int = 0,
               slo_ms: Optional[float] = None,
               now: Optional[float] = None) -> Ticket:
        """Enqueue a payload. ``slo_ms=None`` inherits ``default_slo_ms``;
        pass ``NO_SLO`` for an explicitly deadline-less (best-effort)
        ticket that never counts toward SLA accounting. The returned
        ticket has ``shed=True`` (and is NOT queued) if admission control
        rejected it — callers opting into ``max_queue`` /
        ``service_ms_est`` must check."""
        now = time.perf_counter() if now is None else now
        slo = slo_ms if slo_ms is not None else self.default_slo_ms
        deadline = (now + slo / 1e3) if slo is not None \
            and math.isfinite(slo) else None
        t = Ticket(next(self._ids), payload, size=size, size0=size,
                   priority=priority, enqueue_t=now, deadline_t=deadline)
        if (self.max_queue is not None
                and len(self._pending) >= self.max_queue) \
                or self._infeasible(t, now):
            t.shed = True
            self.telemetry.record_shed()
            return t
        self._pending.append(t)
        return t

    def resubmit(self, ticket: Ticket, *, size: Optional[int] = None,
                 now: Optional[float] = None) -> Ticket:
        """Re-enqueue a partially-served ticket — the chunked-prefill
        *continuation*: the next chunk of a long prompt re-enters the
        queue so waiting traffic can interleave between chunks. The
        ticket keeps its tid, enqueue time, priority, and deadline, so
        aging credit and EDF rank carry over (a continuation never loses
        ground to fresher arrivals — the bounded-starvation guarantee
        holds across chunk boundaries). Continuations bypass admission
        control entirely: the work was already accepted, so shedding it
        mid-flight would break conservation. ``size`` updates the policy
        hint to the remaining chunk length. Appended at the back of the
        queue, so FIFO naturally rotates waiting requests in between a
        long prompt's chunks."""
        if ticket.shed:
            raise ValueError("cannot resubmit a shed ticket")
        if size is not None:
            ticket.size = size
        ticket.continuation = True
        self._pending.append(ticket)
        self.telemetry.record_continuation()
        return ticket

    @property
    def depth(self) -> int:
        return len(self._pending)

    @property
    def fresh_depth(self) -> int:
        """Pending tickets that are NOT continuations. A continuation's
        request is already counted in the engine's in-flight set (it
        holds a KV slot), so load accounting that sums queue depth and
        in-flight work must use this or count chunked requests twice."""
        return sum(1 for t in self._pending if not t.continuation)

    @property
    def deadline_depth(self) -> int:
        """Pending tickets that carry a deadline (router slack routing)."""
        return sum(1 for t in self._pending if t.deadline_t is not None)

    def __len__(self) -> int:
        return len(self._pending)

    # -- engine side -------------------------------------------------------
    def admit(self, k: int, now: Optional[float] = None) -> List[Ticket]:
        """Pop up to k tickets chosen by the policy; stamps admit_t on
        first admission (continuation re-admissions keep the original
        stamp, so service = first-admit -> finish spans the whole
        chunked prefill)."""
        if k <= 0 or not self._pending:
            return []
        now = time.perf_counter() if now is None else now
        self.telemetry.record_queue_depth(len(self._pending))
        chosen = self.policy.select(self._pending, k, now)
        picked = set(id(t) for t in chosen)
        self._pending = [t for t in self._pending if id(t) not in picked]
        for t in chosen:
            if t.admit_t is None:
                t.admit_t = now
        return chosen

    def admit_coherent(self, k: int, now: Optional[float] = None, *,
                       bucket_fn: Callable[[Ticket], int],
                       new_cap: Optional[int] = None) -> List[Ticket]:
        """Admit up to ``k`` tickets forming ONE bucket-coherent group —
        the chunked-prefill admission: one compiled chunk executable
        serves the whole group, and the engine runs at most one group
        per decode tick. The policy ranks all pending work as usual; the
        group seeds from the best-ranked admissible ticket and fills
        with same-``bucket_fn``-bucket tickets in rank order.

        ``new_cap`` bounds how many of the admitted tickets may be fresh
        (non-continuation): fresh tickets need a free KV slot, while
        continuations already own one — without the cap a policy could
        hand the engine more new work than it has slots. Continuations
        are never cap-filtered, so whenever one is pending the group is
        non-empty and mid-prefill work cannot deadlock behind
        slot-starved fresh arrivals."""
        if k <= 0 or not self._pending:
            return []
        now = time.perf_counter() if now is None else now
        self.telemetry.record_queue_depth(len(self._pending))
        ranked = self.policy.select(self._pending, len(self._pending), now)
        group: List[Ticket] = []
        bucket = None
        fresh = 0
        for t in ranked:
            if len(group) >= k:
                break
            if not t.continuation and new_cap is not None \
                    and fresh >= new_cap:
                continue
            b = bucket_fn(t)
            if bucket is None:
                bucket = b
            elif b != bucket:
                continue
            group.append(t)
            fresh += not t.continuation
        picked = set(id(t) for t in group)
        self._pending = [t for t in self._pending if id(t) not in picked]
        for t in group:
            if t.admit_t is None:
                t.admit_t = now
        return group

    # -- cross-replica work movement (ReplicaRouter stealing / drain) ------
    def steal_pending(self, k: Optional[int] = None,
                      now: Optional[float] = None, *,
                      eligible: Optional[Callable[[Ticket], bool]] = None,
                      include_continuations: bool = False) -> List[Ticket]:
        """Remove and return up to ``k`` pending tickets for re-homing on a
        sibling replica (``None`` = every eligible ticket — the fault-drain
        path). Selection is the *reverse* of the policy ranking: the thief
        takes the tickets this replica would serve LAST, so the victim's
        most urgent work stays local and the move maximizes the latency
        win for the back of the queue. Policies without a total order
        (size x time returns one coherent group) fall back to arrival
        order, which is what they tie-break on anyway.

        Continuations (and anything ``eligible`` vetoes — the engines veto
        mid-prefill tickets) are never stolen: a continuation owns a KV
        slot on its home replica, so moving it would strand device state.
        ``include_continuations=True`` is reserved for ``drain_replica``,
        where the home card is dead and the caller resets the tickets to
        fresh. The removed tickets are NOT re-stamped here — pair with
        ``absorb`` on the destination scheduler."""
        if not self._pending:
            return []
        now = time.perf_counter() if now is None else now
        ranked = self.policy.select(self._pending, len(self._pending), now)
        if len(ranked) != len(self._pending):
            ranked = self._pending          # partial-order policy: arrival
        victims: List[Ticket] = []
        for t in reversed(ranked):
            if k is not None and len(victims) >= k:
                break
            if t.continuation and not include_continuations:
                continue
            if eligible is not None and not eligible(t):
                continue
            victims.append(t)
        picked = set(id(t) for t in victims)
        self._pending = [t for t in self._pending if id(t) not in picked]
        return victims

    def absorb(self, tickets: Sequence[Ticket],
               now: Optional[float] = None, *,
               from_now: Optional[float] = None, record: bool = True):
        """Accept tickets removed from a sibling via ``steal_pending``.

        Re-stamping rules (the work-stealing contract): ``tid``,
        ``priority``, and the deadline are preserved verbatim, so EDF rank
        and the strict-priority class survive the move. When the
        destination runs on a different timeline (``from_now`` = the
        source clock at steal time), enqueue/deadline shift by the clock
        delta — ``rebase_pending``-style accounting — so the ticket's AGE
        (its aging credit toward the bounded-starvation guarantee) and
        its deadline slack are preserved exactly rather than its raw
        stamps. On a shared clock (``from_now=None``) the stamps are
        already right and move untouched.

        ``record=True`` marks the tickets stolen and counts them in this
        replica's ``telemetry.steals`` (per-replica steal attribution);
        the fault-drain path passes ``record=False`` and accounts the
        move in the victim's ``drained`` counter instead."""
        if from_now is not None:
            now = time.perf_counter() if now is None else now
            dt = now - from_now
        else:
            dt = 0.0
        for t in tickets:
            if t.shed:
                raise ValueError("cannot absorb a shed ticket")
            if dt:
                t.enqueue_t += dt
                if t.deadline_t is not None:
                    t.deadline_t += dt
                if t.admit_t is not None:
                    # a rebased ticket that somehow carries an admission
                    # stamp (custom eligible hooks can hand one over)
                    # must shift it too, or the destination's service-
                    # time observation spans two clocks
                    t.admit_t += dt
            if record:
                t.stolen = True
            self._pending.append(t)
        if record and tickets:
            self.telemetry.record_steal(len(tickets))

    def rebase_pending(self, now: Optional[float] = None):
        """Shift every pending ticket's enqueue/deadline stamp so its age
        is zero at ``now`` — the single-host emulation of a card whose
        queue was handed over at routing time but which starts working at
        ``now`` (``ReplicaRouter.run_concurrent`` drains replicas one
        after another and uses this to keep each replica's latencies on
        its own timeline). Only valid before any admission: callers must
        not rebase a queue with admitted-but-unfinished work."""
        now = time.perf_counter() if now is None else now
        for t in self._pending:
            dt = now - t.enqueue_t
            t.enqueue_t = now
            if t.deadline_t is not None:
                t.deadline_t += dt

    def complete(self, ticket: Ticket, now: Optional[float] = None):
        """Stamp finish time and fold latency/SLA into telemetry. With
        ``service_ms_est="auto"``, also feeds the live estimator: the
        observed service is admit -> finish (queue wait excluded — the
        feasibility check adds the queue itself on top)."""
        now = time.perf_counter() if now is None else now
        ticket.finish_t = now
        missed = (None if ticket.deadline_t is None
                  else now > ticket.deadline_t)
        self.telemetry.record_latency(ticket.latency_ms, missed)
        self.telemetry.served += 1
        if self._svc_auto is not None and ticket.admit_t is not None:
            # size0 + first-admit stamp: a chunked ticket's observation
            # covers the WHOLE prefill+decode under its submitted size,
            # not the last chunk's sliver under a tiny bucket
            self._svc_auto.observe(ticket.size0,
                                   (now - ticket.admit_t) * 1e3)

"""Serving telemetry: a copy of ``Telemetry`` and ``percentile`` from
``repro/serving/telemetry.py``, kept so that the port never imports the JAX
package. The counters of features the port has not taken over yet (the
fleet, chunked prefill, the prefix cache, paging) stay, at zero, so that
the two summaries keep the same keys.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


# keep the most recent N samples of each distribution: percentiles stay a
# rolling window and a long-lived server doesn't grow without bound
MAX_SAMPLES = 8192


def percentile(sorted_vals: List[float], p: float) -> float:
    """Linearly interpolated percentile of an ascending-sorted list
    (0 if empty).

    A nearest-rank form (``ceil(n*p)-1``) would return the LOWER middle
    element at p=0.5 for even n. Interpolated rank ``p*(n-1)`` agrees with ``statistics.median`` at
    p=0.5 and is exact at p=0/p=1 (min/max).
    """
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    rank = min(max(p, 0.0), 1.0) * (n - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * frac


@dataclass
class Telemetry:
    """Counters + distributions for one serving runtime instance.

    The scheduler stamps request lifecycle events (``record_latency``,
    ``record_queue_depth``), the executor stamps compile/dispatch events
    (``record_compile``, ``record_dispatch``), and the engines stamp
    work-item counters directly (``served``/``steps``/``prefills``/...).
    """
    # engine counters (names kept from the old EngineStats for callers)
    served: int = 0
    steps: int = 0
    prefills: int = 0              # requests prefilled
    prefill_batches: int = 0       # prefill *dispatches* (batched calls)
    total_tokens: int = 0
    wall_start: float = field(default_factory=time.perf_counter)
    serving_s: float = 0.0         # accumulated in-serving wall time

    # scheduler-side distributions
    latencies_ms: List[float] = field(default_factory=list)
    ttft_ms: List[float] = field(default_factory=list)   # time-to-first-token
    sla_misses: int = 0
    sla_total: int = 0             # completions that carried a deadline
    shed: int = 0                  # admission rejections (429) — NOT misses
    continuations: int = 0         # chunked-prefill re-enqueues (not submits)
    steals: int = 0                # tickets this replica pulled from siblings
    drained: int = 0               # tickets re-homed OFF this replica by a
                                   # fault drain (the card died)
    precision_rehomed: int = 0     # high-class tickets this replica accepted
                                   # onto a LOWER precision than the pin asked
                                   # for (no fp32 replica was live)
    scaled_in: int = 0             # 1 if this replica joined the fleet via
                                   # elastic scale-up (fleet merge = joins)
    prefix_hits: int = 0           # requests admitted with their prompt
                                   # prefix restored from the prefix cache
    prefix_remote_hits: int = 0    # fleet-index hits whose holder was NOT
                                   # where load balancing would have landed
                                   # the request (steered or shipped)
    prefix_shipped: int = 0        # holder snapshots shipped cross-replica
                                   # into this replica's local cache
    prefix_recomputed: int = 0     # remote hits where the perf model priced
                                   # the ship ABOVE the chunk-prefill line —
                                   # recomputed locally instead
    prefix_host_hits: int = 0      # local misses faulted in from the
                                   # fleet-shared host-RAM prefix tier
    paged_out: int = 0             # active slots parked to host RAM
    paged_in: int = 0              # paged sessions faulted back to a slot
    migrated: int = 0              # mid-prefill tickets this replica adopted
                                   # with their snapshot (no restart-from-zero)
    queue_depths: List[int] = field(default_factory=list)

    # executor-side counters
    compiles: Dict[str, int] = field(default_factory=dict)
    stage_calls: Dict[str, int] = field(default_factory=dict)
    stage_dispatch_s: Dict[str, float] = field(default_factory=dict)

    # ---- executor hooks --------------------------------------------------
    def record_compile(self, stage: str):
        self.compiles[stage] = self.compiles.get(stage, 0) + 1

    def record_dispatch(self, stage: str, seconds: float):
        self.stage_calls[stage] = self.stage_calls.get(stage, 0) + 1
        self.stage_dispatch_s[stage] = \
            self.stage_dispatch_s.get(stage, 0.0) + seconds

    # ---- scheduler hooks -------------------------------------------------
    def record_queue_depth(self, depth: int):
        self.queue_depths.append(depth)
        if len(self.queue_depths) > MAX_SAMPLES:
            del self.queue_depths[:-MAX_SAMPLES]

    def record_shed(self):
        """One admission rejection (ticket shed before it was queued).
        Deliberately separate from SLA misses: a shed ticket never ran,
        so it must not pollute latency percentiles or the miss fraction
        the feasibility check is calibrated against."""
        self.shed += 1

    def record_continuation(self):
        """One chunked-prefill continuation re-entered the queue. Tracked
        apart from submits so conservation stays checkable: submitted =
        finally-admitted + pending + shed, with continuations as
        intermediate re-admissions of already-accepted work."""
        self.continuations += 1

    def record_steal(self, n: int = 1):
        """``n`` tickets pulled from a backlogged sibling's queue onto this
        replica (cross-replica work stealing). Counted on the THIEF —
        per-replica attribution of who did the balancing work; the router
        keeps the per-replica breakdown in ``steals_per_replica``."""
        self.steals += n

    def record_drained(self, n: int = 1):
        """``n`` accepted tickets re-homed off this replica by a fault
        drain (the card died mid-run). Counted on the VICTIM: the fleet
        total says how much accepted work survived card failures."""
        self.drained += n

    def record_precision_rehome(self, n: int = 1):
        """``n`` accuracy-pinned (priority-0) tickets landed on this
        replica at LOWER precision than the mixed-precision routing
        policy asked for, because no fp32 replica was live — the
        graceful-degradation path of the precision pin (work is served
        int8 rather than dropped, and the downgrade is counted)."""
        self.precision_rehomed += n

    def record_prefix_hit(self, n: int = 1):
        """``n`` requests hit the prefix cache at submit: their prompt
        prefix is restored from a host-side snapshot instead of being
        re-prefilled from token zero (the system-prompt TTFT cliff)."""
        self.prefix_hits += n

    def record_prefix_remote_hit(self, n: int = 1):
        """``n`` requests found their prefix through the FLEET index on a
        replica other than where load balancing would have landed them.
        Counted on the replica the request finally lands on — whether it
        was steered to the holder or the snapshot was shipped/priced out."""
        self.prefix_remote_hits += n

    def record_prefix_shipped(self, n: int = 1):
        """``n`` prefix snapshots shipped cross-replica into THIS
        replica's local cache (the restore-vs-recompute decision priced
        the snapshot transport below the chunk-prefill line)."""
        self.prefix_shipped += n

    def record_prefix_recomputed(self, n: int = 1):
        """``n`` remote hits where shipping the holder's snapshot was
        priced ABOVE recomputing the prefix (short prefix, byte-heavy
        state): this replica recomputes the prefill instead. The other
        leg of the restore-vs-recompute decision — counted so the bench
        can show the decision fires in both directions."""
        self.prefix_recomputed += n

    def record_prefix_host_hit(self, n: int = 1):
        """``n`` local prefix-cache misses faulted their snapshot in from
        the fleet-shared host-RAM tier (a prefix evicted from one card
        survived for the fleet)."""
        self.prefix_host_hits += n

    def record_paged_out(self, n: int = 1):
        """``n`` active slots parked their sequence state to host RAM
        (host-RAM paging): slot count stops bounding concurrent sessions;
        the session faults back in before its next token."""
        self.paged_out += n

    def record_paged_in(self, n: int = 1):
        """``n`` paged sessions restored their snapshot into a free slot
        and resumed decode where they left off."""
        self.paged_in += n

    def record_migrated(self, n: int = 1):
        """``n`` mid-prefill tickets adopted WITH their snapshot (counted
        on the adopting replica, like steals): the completed chunks moved
        with the ticket, so prefill resumes at the last chunk boundary
        instead of restarting from token zero."""
        self.migrated += n

    def record_scaled_in(self, n: int = 1):
        """This replica joined a running fleet via elastic scale-up
        (``ReplicaRouter.add_replica``). Counted on the JOINER, so the
        fleet merge totals how many replicas autoscaling added."""
        self.scaled_in += n

    def record_ttft(self, ttft_ms: float):
        """Time-to-first-token for one request: enqueue -> first generated
        token materialized. The paper's latency-bounded traffic cares
        about this, not end-to-end latency — a long prefill ahead of you
        is pure TTFT; decode steps are per-token."""
        self.ttft_ms.append(ttft_ms)
        if len(self.ttft_ms) > MAX_SAMPLES:
            del self.ttft_ms[:-MAX_SAMPLES]

    def record_latency(self, latency_ms: float,
                       deadline_missed: Optional[bool] = None):
        self.latencies_ms.append(latency_ms)
        if len(self.latencies_ms) > MAX_SAMPLES:
            del self.latencies_ms[:-MAX_SAMPLES]
        if deadline_missed is not None:
            self.sla_total += 1
            if deadline_missed:
                self.sla_misses += 1

    # fields that are NOT traffic: they survive reset and merge specially
    _KEEP_ON_RESET = frozenset({"compiles"})

    def reset_serving_stats(self):
        """Zero every traffic-scoped counter/distribution (after warm-up) —
        including per-stage dispatch counts/times, so summary() stays
        internally consistent. Only ``compiles`` survives: executables are
        cumulative engine state, not traffic.

        Iterates the dataclass fields instead of naming them, so a newly
        added counter can never be silently left carrying warm-up traffic
        (the recurring "new counter forgotten in reset/merge" bug class)."""
        for f in dataclasses.fields(self):
            if f.name in self._KEEP_ON_RESET:
                continue
            if f.name == "wall_start":
                self.wall_start = time.perf_counter()
                continue
            cur = getattr(self, f.name)
            if isinstance(cur, int):
                setattr(self, f.name, 0)
            elif isinstance(cur, float):
                setattr(self, f.name, 0.0)
            elif isinstance(cur, list):
                setattr(self, f.name, [])
            elif isinstance(cur, dict):
                setattr(self, f.name, {})
            else:                           # a new field of an unknown kind
                raise TypeError(f"don't know how to reset Telemetry field "
                                f"{f.name!r} of type {type(cur).__name__}")

    # ---- derived ---------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """Total builder invocations across all compiled stages."""
        return sum(self.compiles.values())

    def record_serving_window(self, seconds: float):
        """Engines report each production run/serve window here so QPS
        excludes construction, warm-up/compile traffic, and idle time
        between calls."""
        self.serving_s += seconds

    def qps(self) -> float:
        denom = self.serving_s if self.serving_s > 0 \
            else time.perf_counter() - self.wall_start
        return self.served / max(denom, 1e-9)

    def latency_percentiles(self) -> Dict[str, float]:
        s = sorted(self.latencies_ms)
        return {"p50": percentile(s, 0.50), "p95": percentile(s, 0.95),
                "p99": percentile(s, 0.99),
                "max": s[-1] if s else 0.0}

    def ttft_percentiles(self) -> Dict[str, float]:
        s = sorted(self.ttft_ms)
        return {"p50": percentile(s, 0.50), "p95": percentile(s, 0.95),
                "p99": percentile(s, 0.99),
                "max": s[-1] if s else 0.0}

    @property
    def sla_miss_frac(self) -> float:
        return self.sla_misses / max(self.sla_total, 1)

    @property
    def mean_queue_depth(self) -> float:
        return sum(self.queue_depths) / max(len(self.queue_depths), 1)

    # ---- fleet aggregation ----------------------------------------------
    @classmethod
    def merged(cls, parts: List["Telemetry"]) -> "Telemetry":
        """Fleet-level aggregate of per-replica telemetry (the router's
        one QPS / p50-p95-p99 / SLA-miss surface over N replicas).

        Raw latency / queue-depth samples are *pooled*, not re-binned, so
        fleet percentiles are exactly the percentiles of the union of the
        replicas' samples. Counters sum; ``serving_s`` takes the longest
        replica window (replicas serve concurrently, so the fleet window
        is the slowest replica's, and fleet QPS = total served / that).
        The merge is a snapshot — don't keep recording into it.

        Like ``reset_serving_stats``, the merge iterates the dataclass
        fields generically (ints sum, sample lists pool, per-stage dicts
        sum per key; ``serving_s`` takes the slowest replica's window and
        ``wall_start`` the earliest) — a newly added counter merges
        correctly by construction instead of silently vanishing from the
        fleet surface.
        """
        out = cls()
        if not parts:
            return out
        for f in dataclasses.fields(cls):
            vals = [getattr(p, f.name) for p in parts]
            if f.name == "serving_s":       # replicas serve concurrently:
                out.serving_s = max(vals)   # the fleet window is the
                continue                    # slowest replica's
            if f.name == "wall_start":
                out.wall_start = min(vals)
                continue
            cur = getattr(out, f.name)
            if isinstance(cur, int):
                setattr(out, f.name, sum(vals))
            elif isinstance(cur, list):     # pooled raw samples: fleet
                pooled = []                 # percentiles are exactly the
                for v in vals:              # percentiles of the union
                    pooled.extend(v)
                setattr(out, f.name, pooled)
            elif isinstance(cur, dict):
                merged_d: Dict = {}
                for v in vals:
                    for k, x in v.items():
                        merged_d[k] = merged_d.get(k, 0) + x
                setattr(out, f.name, merged_d)
            else:
                raise TypeError(f"don't know how to merge Telemetry field "
                                f"{f.name!r} of type {type(cur).__name__}")
        return out

    def summary(self) -> Dict[str, float]:
        """Flat dict for JSON emission (benchmarks/BENCH_serving.json)."""
        out = {"served": self.served, "qps": self.qps(),
               "steps": self.steps, "prefills": self.prefills,
               "prefill_batches": self.prefill_batches,
               "total_tokens": self.total_tokens,
               "compile_count": self.compile_count,
               "sla_miss_frac": self.sla_miss_frac,
               "shed": self.shed,
               "continuations": self.continuations,
               "steals": self.steals,
               "drained": self.drained,
               "precision_rehomed": self.precision_rehomed,
               "scaled_in": self.scaled_in,
               "prefix_hits": self.prefix_hits,
               "prefix_remote_hits": self.prefix_remote_hits,
               "prefix_shipped": self.prefix_shipped,
               "prefix_recomputed": self.prefix_recomputed,
               "prefix_host_hits": self.prefix_host_hits,
               "paged_out": self.paged_out,
               "paged_in": self.paged_in,
               "migrated": self.migrated,
               "mean_queue_depth": self.mean_queue_depth}
        for k, v in self.latency_percentiles().items():
            out[f"latency_ms_{k}"] = v
        for k in ("p50", "p95", "p99"):
            out[f"ttft_ms_{k}"] = self.ttft_percentiles()[k]
        for stage, n in self.stage_calls.items():
            out[f"dispatches_{stage}"] = n
        return out

    def report(self) -> str:
        """One-paragraph human-readable summary for launchers/examples."""
        pct = self.latency_percentiles()
        decode = (f" ({self.total_tokens} tokens, {self.steps} decode "
                  f"steps)" if self.steps else "")
        lines = [f"served {self.served} requests at {self.qps():.1f} QPS"
                 + decode,
                 f"latency ms: p50={pct['p50']:.1f} p95={pct['p95']:.1f} "
                 f"p99={pct['p99']:.1f} max={pct['max']:.1f}"]
        if self.ttft_ms:
            tp = self.ttft_percentiles()
            lines.append(f"TTFT ms: p50={tp['p50']:.1f} p95={tp['p95']:.1f} "
                         f"p99={tp['p99']:.1f} max={tp['max']:.1f}")
        if self.continuations:
            lines.append(f"{self.continuations} chunked-prefill "
                         f"continuations")
        if self.steals:
            lines.append(f"{self.steals} tickets stolen from backlogged "
                         f"siblings")
        if self.drained:
            lines.append(f"{self.drained} tickets re-homed by fault drain")
        if self.precision_rehomed:
            lines.append(f"{self.precision_rehomed} high-class tickets "
                         f"served below their precision pin (no fp32 live)")
        if self.scaled_in:
            lines.append(f"{self.scaled_in} replicas joined via elastic "
                         f"scale-up")
        if self.prefix_hits:
            lines.append(f"{self.prefix_hits} prefix-cache hits (prefill "
                         f"restored from snapshot)")
        if self.prefix_remote_hits:
            lines.append(f"{self.prefix_remote_hits} fleet-index remote "
                         f"hits ({self.prefix_shipped} snapshots shipped, "
                         f"{self.prefix_recomputed} priced-out recomputes)")
        if self.prefix_host_hits:
            lines.append(f"{self.prefix_host_hits} prefixes faulted in "
                         f"from the shared host-RAM tier")
        if self.paged_out or self.paged_in:
            lines.append(f"host-RAM paging: {self.paged_out} slots parked, "
                         f"{self.paged_in} faulted back")
        if self.migrated:
            lines.append(f"{self.migrated} mid-prefill tickets migrated "
                         f"with their snapshot")
        if self.sla_total:
            lines.append(f"SLA: {self.sla_misses}/{self.sla_total} misses "
                         f"({self.sla_miss_frac * 100:.1f}%)")
        if self.shed:
            lines.append(f"shed {self.shed} requests at admission (429)")
        if self.compiles:
            c = ", ".join(f"{k}={v}" for k, v in sorted(self.compiles.items()))
            lines.append(f"compiled stages: {c}")
        if self.queue_depths:
            lines.append(f"mean queue depth {self.mean_queue_depth:.1f}")
        return "\n".join(lines)

"""Paper T2 (Fig. 6 right) on the port: N-stage pipelined execution
(counterpart of ``repro/core/pipeline.py``).

Each stage is ``(name, fn)`` with ``fn(x, req) -> x``: ``x`` is the
previous stage's output (``None`` for stage 0, which reads the raw request
— e.g. the DLRM engine's host-side T6 ingest). The pipeline
software-pipelines the request stream, keeping one request in flight per
stage. PyTorch enqueues work on the card and returns, which gives the
overlap JAX's async dispatch gives the reference: host-side stages
(ingest) overlap the device stages of earlier requests. Where the
reference calls ``jax.block_until_ready``, the port waits on a CUDA event
recorded after the output (nothing to wait for on the CPU).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

StageFn = Callable[[Any, Any], Any]          # (prev_out, request) -> out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def ready_event(x) -> Optional[torch.cuda.Event]:
    """An event recorded after the work that produces ``x`` (on the
    current stream of the card its first CUDA tensor lives on), or None
    when ``x`` holds no CUDA tensor."""
    for t in _tensors(x):
        if t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            return ev
    return None


def block_until_ready(x):
    """``x`` once the work that produces it has completed."""
    ev = ready_event(x)
    if ev is not None:
        ev.synchronize()
    return x


@dataclass
class PipelineStats:
    num_requests: int = 0
    wall_time_s: float = 0.0
    # per-stage times, measured sequentially under measure=True
    stage_time_s: Dict[str, float] = field(default_factory=dict)

    @property
    def qps(self) -> float:
        return self.num_requests / max(self.wall_time_s, 1e-9)

    # back-compat accessors for the original two-stage pipeline
    @property
    def sparse_time_s(self) -> float:
        return self.stage_time_s.get("sparse", 0.0)

    @property
    def dense_time_s(self) -> float:
        return self.stage_time_s.get("dense", 0.0)


class Pipeline:
    """N-stage software pipeline over a request stream.

    stages: sequence of ``(name, fn)`` pairs (or bare fns, auto-named
    ``stage0..``). In steady state request i runs stage s while request
    i+1 runs stage s-1 — the generalization of "request N's dense
    overlaps request N+1's sparse".
    """

    def __init__(self, stages: Sequence):
        norm: List[Tuple[str, StageFn]] = []
        for i, s in enumerate(stages):
            if callable(s):
                norm.append((f"stage{i}", s))
            else:
                name, fn = s
                norm.append((str(name), fn))
        if not norm:
            raise ValueError("Pipeline needs at least one stage")
        self.stages = norm

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def stage_names(self) -> List[str]:
        return [n for n, _ in self.stages]

    def run(self, requests: Iterable[Any], measure: bool = False,
            on_result: Optional[Callable[[int, Any], None]] = None) \
            -> Tuple[List[Any], PipelineStats]:
        """Software-pipelined pass: at tick t, stage s runs request t-s.

        Deeper stages dispatch first each tick so a request's next stage
        is enqueued before the following request enters the pipe.
        ``on_result(i, val)`` fires per request as its output is realized
        (in order), so callers can stamp per-request completion times
        instead of one timestamp for the whole pass.
        """
        stats = PipelineStats()
        reqs = list(requests)
        n, S = len(reqs), len(self.stages)
        vals: List[Any] = [None] * n
        # each request's completion event, recorded as its last stage is
        # enqueued (an event recorded later would wait for later requests)
        done: List[Optional[torch.cuda.Event]] = [None] * n
        t0 = time.perf_counter()
        for t in range(n + S - 1):
            for s in range(S - 1, -1, -1):
                i = t - s
                if 0 <= i < n:
                    vals[i] = self.stages[s][1](vals[i], reqs[i])
                    if s == S - 1:
                        done[i] = ready_event(vals[i])
        for i in range(n):
            if done[i] is not None:
                done[i].synchronize()
            if on_result is not None:
                on_result(i, vals[i])
        stats.wall_time_s = time.perf_counter() - t0
        stats.num_requests = n

        if measure and reqs:
            stats.stage_time_s = self.measure_stages(reqs)
        return vals, stats

    def measure_stages(self, requests: Iterable[Any]) -> Dict[str, float]:
        """Per-stage sequential timing: feed every request through the
        prefix of stages, timing only the stage under measurement. NOTE:
        this re-executes every stage, including any host-side stage with
        side effects — callers that meter stage 0 (e.g. transfer stats)
        should disable collection around this."""
        reqs = list(requests)
        carries: List[Any] = [None] * len(reqs)
        times: Dict[str, float] = {}
        for name, fn in self.stages:
            ts = time.perf_counter()
            carries = [block_until_ready(fn(c, r))
                       for c, r in zip(carries, reqs)]
            times[name] = time.perf_counter() - ts
        return times

    def run_sequential(self, requests: Iterable[Any],
                       on_result: Optional[Callable[[int, Any], None]]
                       = None) -> Tuple[List[Any], PipelineStats]:
        """Unpipelined baseline: block between every stage."""
        stats = PipelineStats()
        reqs = list(requests)
        outs = []
        t0 = time.perf_counter()
        for i, req in enumerate(reqs):
            x: Any = None
            for _, fn in self.stages:
                x = block_until_ready(fn(x, req))
            outs.append(x)
            if on_result is not None:
                on_result(i, x)
        stats.wall_time_s = time.perf_counter() - t0
        stats.num_requests = len(reqs)
        return outs, stats


class TwoStagePipeline(Pipeline):
    """Back-compat alias: the paper's sparse/dense two-stage pipeline as a
    2-entry stage list. ``sparse_fn(request) -> intermediates``,
    ``dense_fn(intermediates, request) -> output``."""

    def __init__(self, sparse_fn: Callable, dense_fn: Callable):
        super().__init__([
            ("sparse", lambda x, req: sparse_fn(req)),
            ("dense", lambda x, req: dense_fn(x, req)),
        ])


def steady_state_speedup(*stage_times: float) -> float:
    """Analytic pipeline speedup: sum(stages) / max(stage)."""
    return sum(stage_times) / max(max(stage_times, default=0.0), 1e-12)

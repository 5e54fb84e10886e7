"""DLRM serving engine of the port (counterpart of
``repro/serving/dlrm_engine.py``) — the paper's Fig. 6 pipeline end to end
as a 4-stage instance of the shared N-stage pipeline:

  stage 0 ingest: host feature ingestion (partial transfers + command
                  batching through pinned buffers, T6 — core/transfer.py)
  stage 1 sparse: SLS over the slab (T1) through the SLS kernel
  stage 2 dense:  bottom MLP + interaction + top MLP
  stage 3 post:   output normalization (float32 logits)

with request N's dense overlapping request N+1's sparse (T2) and request
N+2's host ingest: the stages enqueue their work on the card and return.
Stages live in the shared StageExecutor; admission/latency/SLA accounting
flows through the shared Scheduler + Telemetry. The parameters must live
on ``device`` (default ``"cuda"``; ``"cpu"`` runs the kernels' plain
versions). Replicas behind a router (``make_replicas``) come with the
fleet layer.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.dlrm_paper import DLRMConfig
from repro_torch.core.partitioner import TableAssignment
from repro_torch.core.pipeline import Pipeline, PipelineStats
from repro_torch.core.transfer import (PinnedStaging, SparseBatch,
                                       TransferStats, command_batched_transfer)
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.serving.executor import StageExecutor
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.telemetry import Telemetry


@dataclass
class DLRMEngine:
    cfg: DLRMConfig
    assignment: TableAssignment
    params: Any
    policy: str = "fifo"
    slo_ms: Optional[float] = None
    max_queue: Optional[int] = None
    service_ms_est: Optional[float | str] = None   # number or "auto"
    step_group: int = 4       # max batches admitted per step_once (>=2
                              # keeps the T2 stage overlap alive within a
                              # step)
    device: Any = "cuda"
    transfer_stats: TransferStats = field(default_factory=TransferStats)

    def __post_init__(self):
        cfg, asn = self.cfg, self.assignment
        want = torch.device(self.device)
        have = dlrm_mod.params_device(self.params)
        if have.type != want.type or (want.index is not None
                                      and have.index != want.index):
            raise ValueError(f"params live on {have}, the engine was asked "
                             f"for {want}")
        self.device = have
        self.telemetry = Telemetry()
        self.stats = self.telemetry
        self.executor = StageExecutor(self.telemetry)
        self.scheduler = Scheduler(self.policy, telemetry=self.telemetry,
                                   default_slo_ms=self.slo_ms,
                                   max_queue=self.max_queue,
                                   service_ms_est=self.service_ms_est)
        self._collect_transfer_stats = True
        # two pinned buffers per request (indices + lengths, dense), one
        # request in flight per pipeline stage
        self._staging = PinnedStaging(depth=8)

        def build_sparse():
            @torch.inference_mode()
            def sparse_fn(params, indices, lengths):
                return dlrm_mod.sls_forward(params, cfg, asn, indices,
                                            lengths)
            return sparse_fn

        def build_dense():
            @torch.inference_mode()
            def dense_fn(params, pooled, dense_x):
                return dlrm_mod.dense_forward(params, cfg, dense_x, pooled)
            return dense_fn

        def build_post():
            return lambda logits: logits.to(torch.float32)

        ex = self.executor
        self._pipeline = Pipeline([
            ("ingest", lambda x, req: self.ingest(req)),
            ("sparse", lambda x, req: {
                "pooled": ex.dispatch("sparse", (), build_sparse,
                                      self.params, *x["sls"]),
                "dense": x["dense"]}),
            ("dense", lambda x, req: ex.dispatch(
                "dense", (), build_dense, self.params, x["pooled"],
                x["dense"])),
            ("post", lambda x, req: ex.dispatch("post", (), build_post, x)),
        ])

    def ingest(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Host->device input path with the paper's T6 optimizations."""
        sb = SparseBatch(batch["indices"], batch["lengths"])
        stats = self.transfer_stats if self._collect_transfer_stats else None
        idx_dev, len_dev = command_batched_transfer(
            sb, stats, self.device, staging=self._staging)
        dense = np.ascontiguousarray(batch["dense"], np.float32)
        if self.device.type == "cuda":
            dense_dev, = self._staging.to_device([dense], self.device)
        else:
            dense_dev = torch.from_numpy(dense.copy())
        return {"sls": (idx_dev, len_dev), "dense": dense_dev}

    def submit(self, batch: Dict[str, np.ndarray], *,
               slo_ms: Optional[float] = None,
               priority: Optional[int] = None):
        """Enqueue one raw host batch; returns the scheduler ticket
        (``shed=True`` if admission control rejected it)."""
        return self.scheduler.submit(batch, size=len(batch["lengths"]),
                                     slo_ms=slo_ms,
                                     priority=priority or 0)

    @property
    def has_work(self) -> bool:
        return self.scheduler.depth > 0

    def step_once(self) -> List[Any]:
        """Admit one policy-formed group (at most ``step_group`` batches)
        and run it through the 4-stage pipeline, completing tickets as
        outputs realize."""
        group = self.scheduler.admit(min(self.scheduler.depth,
                                         self.step_group))
        if not group:
            return []
        done = lambda i, _v: self.scheduler.complete(group[i])
        outs, _ = self._pipeline.run([t.payload for t in group],
                                     on_result=done)
        return outs

    def serve(self, batches: Sequence[Dict[str, np.ndarray]],
              pipelined: bool = True, warm: bool = False,
              measure: bool = False) -> Tuple[List[Any], PipelineStats]:
        """Run raw host batches through admission + the 4-stage pipeline.

        ``warm=True`` marks warm-up traffic: it is excluded from transfer
        stats and from latency/QPS telemetry.
        """
        if warm:
            with self._suppress_traffic_stats():
                if pipelined:
                    return self._pipeline.run(batches, measure=measure)
                return self._pipeline.run_sequential(batches)
        tickets = [self.scheduler.submit(b, size=len(b["lengths"]))
                   for b in batches]
        # drain the queue group by group: a batch-forming policy (sizetime)
        # returns one size-coherent group per admit() call
        admitted = []
        while self.scheduler.depth:
            got = self.scheduler.admit(len(tickets))
            if not got:
                break
            admitted.append(got)
        outs, stats = [], PipelineStats()
        t0 = time.perf_counter()
        for group in admitted:
            reqs = [t.payload for t in group]
            # per-ticket completion as each output is realized, so tail
            # latency reflects position in the pipeline
            done = lambda i, _v: self.scheduler.complete(group[i])
            if pipelined:
                o, s = self._pipeline.run(reqs, on_result=done)
            else:
                o, s = self._pipeline.run_sequential(reqs, on_result=done)
            outs.extend(o)
            stats.num_requests += s.num_requests
            stats.wall_time_s += s.wall_time_s
        self.telemetry.record_serving_window(time.perf_counter() - t0)
        if measure:
            # stage re-execution for timing must not double-count the
            # T6 transfer stats or dispatch telemetry collected by the
            # production pass above
            with self._suppress_traffic_stats():
                stats.stage_time_s = self._pipeline.measure_stages(
                    [t.payload for g in admitted for t in g])
        return outs, stats

    @contextmanager
    def _suppress_traffic_stats(self):
        """Exclude non-production traffic (warm-up, measurement re-runs)
        from transfer stats and per-stage dispatch telemetry."""
        self._collect_transfer_stats = False
        calls = dict(self.telemetry.stage_calls)
        disp = dict(self.telemetry.stage_dispatch_s)
        try:
            yield
        finally:
            self._collect_transfer_stats = True
            self.telemetry.stage_calls = calls
            self.telemetry.stage_dispatch_s = disp

"""LM serving engine of the port (counterpart of ``InferenceEngine`` in
``repro/serving/engine.py``, monolithic-prefill path): the shared scheduler
admits requests into free slots, each tick prefills the admitted requests
in bucketed batched calls and then runs one decode step over all slots at
per-slot positions, greedy sampling throughout.

The KV cache is one list of preallocated per-layer tensors that prefill
and decode update in place: a prefill group writes its K/V straight into
the acquired cache rows, and a decode step writes only the active rows.
(The JAX engine builds a fresh cache per prefill group, scatters it into
the slot rows, and donates the cache to every step.) The cache's batch and
sequence axes are fixed by construction (dims 0 and 1 of every tensor), so
no shape probing is needed.

``precision="w8a8"`` serves through the §V build step's quantized model
(``models/quantize.py``): every int8-decided projection runs the w8a8
kernel, and ``run_params`` is what the stages run on. The KV cache format
follows the config (``cfg.quant.kv_cache_dtype``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bucketing import pick_bucket
from repro_torch.models import model as model_mod
from repro_torch.models.quantize import QuantizedParams, build_quantized_params
from repro_torch.serving.executor import StageExecutor
from repro_torch.serving.scheduler import Scheduler, SizeTimePolicy, Ticket
from repro_torch.serving.state import SequenceStateManager
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
    """Greedy-decoding LM server: bucketed batched prefill + continuous
    slot-batched decode (per-slot positions) on ``device``."""

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
                 device="cuda"):
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
        self.params = params               # fp reference weights
        self.precision = precision
        self.quant = None                  # QuantizedParams build record
        if precision == "w8a8":
            # §V build step: every dense projection goes per-channel int8
            # (over-budget sites stay fp via the workflow's skip-list)
            if quantized_params is None:
                quantized_params = build_quantized_params(
                    cfg, params, budget=quant_budget)
            qdev = model_mod.model_device(quantized_params.params)
            if qdev != self.device:
                raise ValueError(f"quantized params live on {qdev}, the "
                                 f"engine serves on {self.device}")
            self.quant = quantized_params
            self.run_params = quantized_params.params
        else:
            self.run_params = params
        self.max_len = max_len
        self.batch_slots = batch_slots
        self.buckets = tuple(b for b in prefill_buckets if b <= max_len)
        # default admits up to all free slots at once; 1 = per-request
        self.max_prefill_batch = max_prefill_batch or batch_slots

        self.telemetry = Telemetry()
        self.executor = StageExecutor(self.telemetry)
        if policy == "sizetime":
            # group on the engine's own buckets, or a "coherent" group
            # still splits into several prefill calls
            policy = SizeTimePolicy(self.buckets)
        self.scheduler = Scheduler(policy, telemetry=self.telemetry,
                                   default_slo_ms=slo_ms,
                                   max_queue=max_queue,
                                   service_ms_est=service_ms_est)
        self.caches = model_mod.init_caches(cfg, batch_slots, max_len,
                                            self.device)
        self.states = SequenceStateManager(batch_slots, cfg)

    @property
    def free(self) -> List[int]:
        return self.states.free

    @property
    def active(self) -> Dict[int, Ticket]:
        return self.states.active

    @property
    def pos(self) -> np.ndarray:
        return self.states.pos

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---- stages ----------------------------------------------------------
    def _build_prefill(self, bucket: int):
        cfg = self.cfg

        @torch.inference_mode()
        def fn(params, caches, tokens, lengths, rows):
            """tokens (P,bucket), lengths (P,): group row j prefills into
            cache row rows[j] (padded rows past len(rows) write nothing).
            Returns the next tokens (P,) on the host."""
            valid = torch.arange(bucket, device=tokens.device)[None, :] \
                < lengths[:, None]
            x, _ = model_mod.forward(params, cfg, {"tokens": tokens},
                                     mode="prefill", caches=caches,
                                     kv_valid=valid, cache_rows=rows)
            last = x[torch.arange(x.shape[0], device=x.device),
                     lengths.long() - 1]
            return model_mod.greedy_next(params, cfg, last).cpu().numpy()

        return fn

    def _build_decode(self):
        cfg = self.cfg

        @torch.inference_mode()
        def fn(params, caches, tokens, pos_vec, active):
            hidden, _ = model_mod.decode_step(params, cfg, tokens, caches,
                                              pos_vec, active=active)
            return model_mod.greedy_next(params, cfg, hidden).cpu().numpy()

        return fn

    # ---- main loop -------------------------------------------------------
    def _eff_len(self, req: Request) -> int:
        """Effective prefill length: what admission sizing and bucket
        choice both key on."""
        return min(len(req.tokens), self.max_len - req.max_new_tokens - 1)

    def submit(self, req: Request, *, slo_ms: Optional[float] = None,
               priority: Optional[int] = None) -> Ticket:
        """Enqueue a request; keyword overrides beat the request's own
        slo/priority. ``shed=True`` on the ticket means admission control
        rejected it."""
        t = self.scheduler.submit(
            req, size=max(self._eff_len(req), 1),
            slo_ms=slo_ms if slo_ms is not None else req.slo_ms,
            priority=priority if priority is not None else req.priority)
        req.enqueue_t = t.enqueue_t
        req.shed = t.shed
        return t

    @property
    def inflight(self) -> int:
        return self.states.inflight

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.depth or self.states.inflight)

    def step_once(self):
        """One engine tick: refill every freed slot, then one decode
        step."""
        self._admit()
        self._step()

    def _admit(self):
        """Admit up to len(free) tickets, group them by prefill bucket, and
        prefill each group in ONE bucketed call."""
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
        # length 1, write no cache row, and their token is discarded.
        g = len(group)
        P = 1 << (g - 1).bit_length()
        toks = np.zeros((P, bucket), np.int32)
        lens = np.ones(P, np.int32)
        for j, (t, L) in enumerate(zip(group, lengths)):
            toks[j, :L] = t.payload.tokens[:L]
            lens[j] = L
        slots = [self.states.acquire(t) for t in group]
        nxt = self.executor.dispatch(
            "prefill", (bucket, P, self.precision),
            lambda: self._build_prefill(bucket), self.run_params,
            self.caches, self._to_device(toks), self._to_device(lens),
            self._to_device(np.asarray(slots, np.int64)))
        now = time.perf_counter()
        for j, (t, slot, L) in enumerate(zip(group, slots, lengths)):
            t.payload.output.append(int(nxt[j]))
            t.payload.prefill_pos = L
            self.telemetry.record_ttft((now - t.enqueue_t) * 1e3)
            self.states.activate(t, slot, L)
        self.telemetry.prefills += g
        self.telemetry.prefill_batches += 1

    def _step(self):
        if not self.active:
            return
        toks = np.zeros((self.batch_slots, 1), np.int32)
        # inactive rows ride the fixed-shape decode step parked at
        # max_len-1, a position no request attends (decoding stops at
        # max_len-1), and write no K/V
        pos_vec = self.states.decode_positions(self.max_len - 1)
        active_mask = self.states.active_mask()
        for s, t in self.active.items():
            toks[s, 0] = t.payload.output[-1]
        nxt = self.executor.dispatch(
            "decode", (self.precision,), self._build_decode,
            self.run_params, self.caches,
            self._to_device(toks), self._to_device(pos_vec), active_mask)
        self.telemetry.steps += 1
        for s in list(self.active):
            t = self.active[s]
            req: Request = t.payload
            self.pos[s] += 1
            req.output.append(int(nxt[s]))
            self.telemetry.total_tokens += 1
            if len(req.output) >= req.max_new_tokens \
                    or self.pos[s] >= self.max_len - 1:
                req.done = True
                self.scheduler.complete(t)
                req.enqueue_t = t.enqueue_t
                req.finish_t = t.finish_t
                self.states.release(s)

    def run(self, requests: Sequence[Request]) -> List[Request]:
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while self.has_work:
            self.step_once()
        self.telemetry.record_serving_window(time.perf_counter() - t0)
        return list(requests)

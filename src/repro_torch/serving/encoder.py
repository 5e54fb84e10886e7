"""Bucketed encoder serving (XLM-R, paper T5 and §VII): the encoder half of
``examples/serve_lm_bucketed.py`` in the port.

Sentences are served in batches of a fixed number of rows. A batch pads to
the bucket of its longest sentence (``core/bucketing.py``), and each bucket
is one stage of the executor under the key ``("encode", bucket)``: on the
card one CUDA graph, captured after the bucket's first (eager) call, as the
reference jits one executable per bucket. A short batch is padded with
empty rows (length 0), so a bucket has one shape and one graph. The stage
runs the model's ``forward(mode="full")`` (non-causal for an encoder
config) with the padding mask as ``kv_valid``, so no query attends a
padded key and a sentence's embedding does not depend on its bucket, then
mean-pools the real tokens' hidden states in f32 (``encode_pooled``).
(The example's ``build_for_bucket`` passes no mask to its forward, and
pools in the model's type.)
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bucketing import (DEFAULT_BUCKETS, BucketedExecutable,
                                        pick_bucket)
from repro_torch.models import model as model_mod
from repro_torch.serving.executor import StageExecutor, StaticStage
from repro_torch.serving.telemetry import percentile


def encode_pooled(params: model_mod.Model, cfg: ModelConfig,
                  tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """tokens (B,S) int, mask (B,S) bool (the real tokens of right-padded
    rows) -> the mean of each row's real hidden states, (B,d) f32: the
    masked sum divided by ``max(count, 1)`` (an empty row gives 0)."""
    x, _ = model_mod.forward(params, cfg, {"tokens": tokens}, mode="full",
                             caches=None, kv_valid=mask)
    m = mask.to(device=x.device, dtype=torch.float32)[..., None]
    return (x.float() * m).sum(1) / m.sum(1).clamp(min=1.0)


def arrival_batches(n: int, batch_size: int) -> List[List[int]]:
    """Naive batching: sentences in arrival order, ``batch_size`` a batch."""
    return [list(range(i, min(i + batch_size, n)))
            for i in range(0, n, batch_size)]


def padding_waste(lengths: Sequence[int], batches: Sequence[Sequence[int]],
                  buckets: Sequence[int]) -> float:
    """Share of the padded tokens of ``batches`` that are padding, each
    batch padded to the bucket of its longest sentence (the example's
    measure; the empty rows that fill a short batch are not counted)."""
    padded = sum(len(b) * pick_bucket(max(lengths[i] for i in b), buckets)
                 for b in batches)
    return 1.0 - sum(lengths[i] for b in batches for i in b) / max(padded, 1)


@dataclass
class EncodeRun:
    """One pass over a set of batches: the pooled embeddings (N,d) f32 in
    sentence order, and each batch's bucket and wall seconds (host
    padding, the copies in and out, and the stage call)."""
    embeds: np.ndarray
    batches: List[List[int]]
    buckets: List[int]
    seconds: List[float]
    wall_s: float
    tokens: int

    def by_bucket(self) -> Dict[int, List[float]]:
        out: Dict[int, List[float]] = {}
        for b, s in zip(self.buckets, self.seconds):
            out.setdefault(b, []).append(s)
        return dict(sorted(out.items()))

    def report(self) -> str:
        n = sum(len(b) for b in self.batches)
        lines = [f"{n} sentences in {len(self.batches)} batches, "
                 f"{self.wall_s:.4f} s: {n / self.wall_s:.1f} sentences/s, "
                 f"{self.tokens / self.wall_s:.0f} real tokens/s"]
        for b, secs in self.by_bucket().items():
            s = sorted(x * 1e3 for x in secs)
            lines.append(f"  bucket {b}: {len(s)} batches, latency p50 "
                         f"{percentile(s, 0.5):.3f} ms p99 "
                         f"{percentile(s, 0.99):.3f} ms")
        return "\n".join(lines)


class EncoderServer:
    """Serves an encoder config's pooled sentence embeddings in batches of
    ``batch_size`` rows, one stage (a CUDA graph on the card, unless
    ``cuda_graphs=False``) per bucket reached. ``exe.compile_count``
    counts the buckets built."""

    def __init__(self, cfg: ModelConfig, params: model_mod.Model, *,
                 batch_size: int = 8,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 cuda_graphs: bool = True):
        if cfg.family != "encoder":
            raise ValueError(f"{cfg.name} is not an encoder config "
                             f"(family {cfg.family!r})")
        self.cfg, self.params, self.batch_size = cfg, params, batch_size
        self.device = model_mod.model_device(params)
        self.executor = StageExecutor(
            graphs=cuda_graphs and self.device.type == "cuda")
        self.exe = BucketedExecutable(self._build, tuple(buckets),
                                      device=str(self.device))

    def stage(self, bucket: int) -> StaticStage:
        """The static form of bucket ``bucket``'s stage: buffers ``tokens``
        (batch_size, bucket) int32 and ``mask`` bool, and a body that
        returns their pooled embeddings."""
        B, dev = self.batch_size, self.device

        def buffers(_variant):
            return {"tokens": torch.zeros((B, bucket), dtype=torch.int32,
                                          device=dev),
                    "mask": torch.zeros((B, bucket), dtype=torch.bool,
                                        device=dev)}

        def body(buf, _variant):
            return encode_pooled(self.params, self.cfg, buf["tokens"],
                                 buf["mask"])

        return StaticStage(buffers, body)

    def _build(self, bucket: int):
        stage = self.stage(bucket)

        def run(tokens: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
            return self.executor.dispatch("encode", bucket, lambda: stage,
                                          {"tokens": tokens, "mask": mask})
        return run

    def encode(self, seqs: Sequence[np.ndarray]) -> np.ndarray:
        """One batch of 1..batch_size sentences -> their pooled embeddings
        (len(seqs), d) f32 on the host; the batch is padded with empty
        rows to ``batch_size``."""
        n = len(seqs)
        if not 0 < n <= self.batch_size:
            raise ValueError(f"a batch holds 1..{self.batch_size} "
                             f"sentences, got {n}")
        empty = [np.zeros(0, np.int32)] * (self.batch_size - n)
        return self.exe(list(seqs) + empty)[:n]

    def serve(self, sents: Sequence[np.ndarray],
              batches: Sequence[Sequence[int]]) -> EncodeRun:
        """Every batch of ``batches`` (index lists into ``sents``), in
        order."""
        embeds = np.zeros((len(sents), self.cfg.d_model), np.float32)
        seconds, buckets = [], []
        t0 = time.perf_counter()
        for b in batches:
            t = time.perf_counter()
            embeds[b] = self.encode([sents[i] for i in b])
            seconds.append(time.perf_counter() - t)
            buckets.append(pick_bucket(max(len(sents[i]) for i in b),
                                       self.exe.buckets))
        wall = time.perf_counter() - t0
        return EncodeRun(embeds, [list(b) for b in batches], buckets,
                         seconds, wall,
                         sum(min(len(sents[i]), self.exe.buckets[-1])
                             for b in batches for i in b))

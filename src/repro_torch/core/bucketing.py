"""Shape bucketing (paper T5): variable-length inputs pad up to a bucket
ladder (32/64/128/...) so the runtime keeps one compiled stage per bucket
and switches between them ("build multiple copies of the XLM-R model
corresponding to multiple padding boundaries"); the LM engines' prefill
reuses one stage per bucket too. The port's copy of
``repro/core/bucketing.py`` (whose module imports JAX):
``BucketedExecutable`` builds one callable per bucket (the encoder's is a
CUDA graph of its stage) and hands it torch tensors on the device the
caller names, where the reference hands ``jnp`` arrays to a ``jax.jit``
executable; the rest keeps the reference's arithmetic.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (last bucket caps/truncates)."""
    i = bisect.bisect_left(buckets, length)
    return buckets[min(i, len(buckets) - 1)]


def pad_to_bucket(tokens: np.ndarray, bucket: int,
                  pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """tokens (B, L<=bucket) -> (padded (B,bucket), valid mask (B,bucket))."""
    B, L = tokens.shape
    L = min(L, bucket)
    out = np.full((B, bucket), pad_id, tokens.dtype)
    out[:, :L] = tokens[:, :L]
    mask = np.zeros((B, bucket), bool)
    mask[:, :L] = True
    return out, mask


def pad_ragged_to_bucket(seqs: Sequence[np.ndarray], bucket: int,
                         pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged token lists -> (B,bucket) padded batch + mask."""
    B = len(seqs)
    out = np.full((B, bucket), pad_id, np.int32)
    mask = np.zeros((B, bucket), bool)
    for i, s in enumerate(seqs):
        L = min(len(s), bucket)
        out[i, :L] = s[:L]
        mask[i, :L] = True
    return out, mask


@dataclass
class BucketedExecutable:
    """Compile-per-bucket cache: the paper's 'switch between multiple
    compiled networks at runtime'. A call pads its sequences to the bucket
    of the longest and hands the callable the padded tokens (int32) and
    the mask (bool) as tensors on ``device``."""
    build_fn: Callable[[int], Callable]        # bucket -> callable
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    device: str = "cpu"
    _cache: Dict[int, Callable] = field(default_factory=dict)
    compile_count: int = 0

    def get(self, length: int) -> Tuple[int, Callable]:
        b = pick_bucket(length, self.buckets)
        if b not in self._cache:
            self._cache[b] = self.build_fn(b)
            self.compile_count += 1
        return b, self._cache[b]

    def __call__(self, seqs: Sequence[np.ndarray], *args, **kw):
        L = max(len(s) for s in seqs)
        b, fn = self.get(L)
        tokens, mask = pad_ragged_to_bucket(seqs, b)
        return fn(torch.from_numpy(tokens).to(self.device),
                  torch.from_numpy(mask).to(self.device), *args, **kw)


def wasted_compute_fraction(lengths: Sequence[int],
                            buckets: Sequence[int]) -> float:
    """Fraction of padded-token compute wasted (paper: 'naive batching
    approaches combine smaller sentences with larger sentences, leading to
    wasted compute')."""
    tot = sum(lengths)
    padded = sum(pick_bucket(l, buckets) for l in lengths)
    return 1.0 - tot / max(padded, 1)


def length_sorted_batches(lengths: Sequence[int], batch_size: int):
    """Smarter batching (paper §VII): group similar lengths to cut padding
    waste. Returns list of index batches."""
    order = np.argsort(lengths)
    return [order[i:i + batch_size].tolist()
            for i in range(0, len(order), batch_size)]

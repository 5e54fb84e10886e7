"""Shape bucketing (paper T5): variable-length prompts pad up to a bucket
ladder so the runtime reuses one prefill stage per bucket. The port's copy
of ``pick_bucket`` and ``DEFAULT_BUCKETS`` from ``repro/core/bucketing.py``
(whose module imports JAX)."""
from __future__ import annotations

import bisect
from typing import Sequence

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (last bucket caps/truncates)."""
    i = bisect.bisect_left(buckets, length)
    return buckets[min(i, len(buckets) - 1)]

"""Stage executor: a cache of stage callables keyed by ``(stage, shape
key)`` with build-count and per-stage dispatch telemetry (counterpart of
``repro/serving/executor.py``).

In the JAX package a build is a ``jax.jit`` compile. Here the stages run
eagerly on the card, so a build only makes the Python callable; capturing
each stage in a CUDA graph is later work. A stage that returns host values
(the engine's stages end in a copy of the next tokens to the host) is
timed to its end, so ``stage_dispatch_s`` is its wall time.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

from repro_torch.serving.telemetry import Telemetry

StageKey = Tuple[str, Hashable]


class StageExecutor:
    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._cache: Dict[StageKey, Callable] = {}

    def get(self, stage: str, key: Hashable,
            build_fn: Callable[[], Callable]) -> Callable:
        """Callable for (stage, key), building via build_fn on miss."""
        k = (stage, key)
        fn = self._cache.get(k)
        if fn is None:
            fn = self._cache[k] = build_fn()
            self.telemetry.record_compile(stage)
        return fn

    def dispatch(self, stage: str, key: Hashable,
                 build_fn: Callable[[], Callable], *args, **kw) -> Any:
        """get() + call, recording per-stage dispatch count/time."""
        fn = self.get(stage, key, build_fn)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.telemetry.record_dispatch(stage, time.perf_counter() - t0)
        return out

    def compiles_for(self, stage: str) -> int:
        return self.telemetry.compiles.get(stage, 0)

    def cached_keys(self, stage: Optional[str] = None):
        return [k for k in self._cache if stage is None or k[0] == stage]

    def __len__(self) -> int:
        return len(self._cache)

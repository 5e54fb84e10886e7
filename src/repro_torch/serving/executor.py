"""Stage executor: a cache of stages keyed by ``(stage, shape key)`` with
build-count and per-stage dispatch telemetry (counterpart of
``repro/serving/executor.py``, the paper's T5: "multiple compiled networks,
switch at runtime").

In the JAX package a build is a ``jax.jit`` compile and a call is one
dispatch of the compiled executable. Here a stage the engines give in
static form (``StaticStage``: fixed input buffers and a body that reads
them) is captured as a CUDA graph on the card, and a call is one replay:

- the first call of a stage (of each ``variant``, see below) allocates its
  buffers, copies the inputs in and runs the body eagerly on them. That run
  is the warm-up (every first-call CUDA API call, library load, plan and
  cached device tensor happens in it) and its result is the call's result.
  Then the body is captured with ``torch.cuda.graph`` into the executor's
  one memory pool, which every graph of the executor shares (one engine's
  prefill ladder holds one pool, not one per key). The buffers and the
  graph's output live as long as the graph;
- every later call copies its inputs into the buffers (``copy_``),
  replays the graph on the current stream, and copies the output out: to
  a host numpy array (the LM stages) or to a fresh device tensor (DLRM
  dense), since the next replay overwrites it.

A capture or a replay that fails raises; nothing falls back to eager.
On the CPU, or with ``graphs=False`` (the engines' ``cuda_graphs=False``,
which holds graphs against eager execution on the card as
``jax.disable_jit`` does for the reference), the same buffers and body run
directly on every call. A stage given as a plain callable (DLRM's sparse
stage, whose lookup count varies per request, and its one-cast post
stage) runs eagerly.

A ``variant`` names a shape that still varies within one key; the stage
holds one graph (and one set of buffers) per value: the number of keys an
int8 KV cache's chunk call dequantizes (at most ``max_len / 128`` values),
and DLRM dense's batch size (one ``jit`` traces once per shape).

The kernels' ``launches`` counters are Python increments, which a replay
skips. So a capture records how far each counter rose while the body was
captured (and puts them back: a capture launches nothing), and every
replay adds that much; a graphed stage counts what its eager run counts.

``stage_dispatch_s`` is each call's wall time to completion (the stages
end in a copy of their output to the host, or DLRM's in a device copy the
pipeline waits on). ``warm_call_s`` keeps those times per stage key for
every call but each variant's first (the warm-up and the capture): the
replays, which the performance model is fitted from.
"""
from __future__ import annotations

import gc
import time
from collections import Counter, deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Hashable, Optional, Set, \
    Tuple

import torch

from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_int8
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.kernels.sls.ops import sls, sls_int4, sls_int8
from repro_torch.kernels.w8a8.ops import w8a8_matmul
from repro_torch.serving.telemetry import Telemetry

StageKey = Tuple[str, Hashable]
# the most recent warm calls kept per stage key
WARM_CALLS_KEPT = 256

# every launch counter of the kernel wrappers, as (wrapper, attribute)
COUNTERS = tuple((fn, "launches") for fn in (
    flash_attn, decode_attn, decode_attn_int8, w8a8_matmul, sls, sls_int8,
    sls_int4)) + ((flash_attn, "offset_launches"),
                  (flash_attn, "window_launches"),
                  (flash_attn, "noncausal_launches"))


@dataclass
class StaticStage:
    """A stage in static form. ``buffers(variant)`` allocates the input
    buffers of one variant (name -> tensor, on the engine's device);
    ``body(buffers, variant)`` computes the stage from them and returns its
    output tensor. The body reads the call's inputs only from the buffers,
    does no host sync and keeps no tensor it allocates past the call but
    the output, so that a CUDA graph of it is the stage. ``to_host``: a
    call returns the output as a host numpy array, else as a device tensor
    of its own."""
    buffers: Callable[[Hashable], Dict[str, torch.Tensor]]
    body: Callable[[Dict[str, torch.Tensor], Hashable], torch.Tensor]
    to_host: bool = True


def capture(body: Callable[[], torch.Tensor], pool) -> Tuple[Any, Any]:
    """Capture ``body`` as a CUDA graph in memory pool ``pool`` (None: a
    new one, then ``graph.pool()``); returns (graph, the static output).
    The garbage collector is off while the body is captured (it runs just
    before): a collection inside the capture could destroy another
    engine's graphs, whose freed memory goes back to the device, which a
    capture forbids."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = body()
    finally:
        if collecting:
            gc.enable()
    return graph, out


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for fn, attr in COUNTERS)


def _add_counts(deltas: Tuple[int, ...]) -> None:
    for (fn, attr), n in zip(COUNTERS, deltas):
        setattr(fn, attr, getattr(fn, attr) + n)


class _Variant:
    """One variant of a static stage: its buffers, and once captured its
    graph, static output and the launches a replay stands for."""

    def __init__(self, buffers: Dict[str, torch.Tensor]):
        self.buffers = buffers
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Tuple[int, ...] = ()


class _StageRunner:
    """The callable the executor caches for a ``StaticStage``, called as
    ``runner(inputs, variant=None)`` with ``inputs`` name -> a host array or
    tensor of its buffer's shape."""

    def __init__(self, executor: "StageExecutor", name: str,
                 stage: StaticStage):
        self.executor, self.name, self.stage = executor, name, stage
        self.variants: Dict[Hashable, _Variant] = {}

    @torch.inference_mode()
    def __call__(self, inputs: Dict[str, Any], variant: Hashable = None):
        rec = self.variants.get(variant)
        first = rec is None
        if first:
            rec = self.variants[variant] = _Variant(
                self.stage.buffers(variant))
        if set(inputs) != set(rec.buffers):
            raise ValueError(f"stage {self.name}: inputs {sorted(inputs)}, "
                             f"buffers {sorted(rec.buffers)}")
        for name, value in inputs.items():
            buf = rec.buffers[name]
            value = torch.as_tensor(value)
            if value.shape != buf.shape:
                raise ValueError(f"stage {self.name}: input {name} has shape "
                                 f"{tuple(value.shape)}, its buffer "
                                 f"{tuple(buf.shape)}")
            buf.copy_(value)
        ex = self.executor
        if not ex.graphs or first:
            out = self.stage.body(rec.buffers, variant)
            if ex.graphs:
                self._capture(rec, variant)
        else:
            rec.graph.replay()
            _add_counts(rec.launches)
            ex.replays[self.name] += 1
            out = rec.out if self.stage.to_host else rec.out.clone()
        return out.cpu().numpy() if self.stage.to_host else out

    def _capture(self, rec: _Variant, variant: Hashable) -> None:
        ex = self.executor
        before = _counts()
        t0 = time.perf_counter()
        try:
            rec.graph, rec.out = capture(
                lambda: self.stage.body(rec.buffers, variant), ex.pool)
            rec.launches = tuple(a - b for a, b in zip(_counts(), before))
        except BaseException:
            # no half-built variant stays: the next call warms up and
            # captures again (and raises again), never replays
            del self.variants[variant]
            raise
        finally:
            _add_counts(tuple(b - a for a, b in zip(_counts(), before)))
        if ex.pool is None:
            ex.pool = rec.graph.pool()
        ex.captures[self.name] += 1
        ex.capture_s[self.name] += time.perf_counter() - t0


class StageExecutor:
    """Stage cache + dispatch wrapper; ``graphs=True`` captures each
    ``StaticStage`` as CUDA graphs (the engines pass it on the card unless
    asked for ``cuda_graphs=False``)."""

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 graphs: bool = False):
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.graphs = graphs
        self.pool = None                 # the graphs' memory pool
        self.captures: Counter = Counter()     # stage -> graphs captured
        self.capture_s: Counter = Counter()    # stage -> seconds capturing
        self.replays: Counter = Counter()      # stage -> graph replays
        # (stage, key) -> wall seconds of its recent calls after each
        # variant's first
        self.warm_call_s: Dict[StageKey, Deque[float]] = {}
        self._called: Set[Tuple[str, Hashable, Hashable]] = set()
        self._cache: Dict[StageKey, Callable] = {}

    def get(self, stage: str, key: Hashable,
            build_fn: Callable[[], Any]) -> Callable:
        """Callable for (stage, key), building via build_fn on miss."""
        k = (stage, key)
        fn = self._cache.get(k)
        if fn is None:
            built = build_fn()
            if isinstance(built, StaticStage):
                built = _StageRunner(self, stage, built)
            fn = self._cache[k] = built
            self.telemetry.record_compile(stage)
        return fn

    def dispatch(self, stage: str, key: Hashable,
                 build_fn: Callable[[], Any], *args, **kw) -> Any:
        """get() + call, recording per-stage dispatch count/time (and the
        time of a warm call per key)."""
        fn = self.get(stage, key, build_fn)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds = time.perf_counter() - t0
        self.telemetry.record_dispatch(stage, seconds)
        call = (stage, key, kw.get("variant"))
        if call in self._called:
            self.warm_call_s.setdefault(
                (stage, key), deque(maxlen=WARM_CALLS_KEPT)).append(seconds)
        else:
            self._called.add(call)
        return out

    def compiles_for(self, stage: str) -> int:
        return self.telemetry.compiles.get(stage, 0)

    def cached_keys(self, stage: Optional[str] = None):
        return [k for k in self._cache if stage is None or k[0] == stage]

    def __len__(self) -> int:
        return len(self._cache)

"""Performance model of the port: a copy of ``repro/serving/perf_model.py``,
kept so that the port never imports the JAX package. Port notes:

- the default spec is the H100's (``core/backend.py``), and
  ``for_params`` counts a torch model's parameters;
- the model is fitted only from the port's own measurements: an engine's
  replayed stage calls (``InferenceEngine.observe_stages``: the wall time
  to completion of every call but each stage key's first, which warms up
  and captures). Nothing is loaded from the JAX package's published bench
  terms, which priced another machine; ``load_precision_scale`` stays for
  a file the port writes itself.

Serving-level analytic performance model (paper §V method): predicted
step time = pure-FLOP floor x measured overhead factor, plus transfer
terms at the backend spec's asymmetric H2D/D2H bandwidths.

The paper's co-design loop never trusted a simulator: it priced every
knob off a two-term model — an analytic floor (what the dense FLOPs
would cost at peak) and a measured overhead factor (what the real kernel
actually sustained; the bring-up kernels ran ~3.9x over their FMAC
floor) — and the per-bucket efficiency-curve method of Park et al.
(1811.09886) picked batch/bucket knobs from where that curve knees.

This module is that loop for the serving runtime.  It holds measured
per-``(stage, bucket, batch, precision)`` dispatch times, fits a
two-parameter dispatch-cost line per stage

    t(tokens) = t_fix + tokens * t_tok

(the fixed dispatch/launch cost plus a marginal per-token cost), and
answers three knob questions that used to be hand-set:

- ``suggest_prefill_chunk(buckets)``: the efficiency knee — the smallest
  bucket whose per-token efficiency ``tokens*t_tok / t(tokens)`` reaches
  ``KNEE_FRAC`` of the top bucket's.  Consumed by
  ``InferenceEngine(prefill_chunk="auto")``.
- ``suggest_buckets(lengths)``: a bucket ladder from the traffic size
  distribution (interpolated percentile marks, padded up to the
  quantum).
- ``service_ratio(bucket, base)``: the cold-start service-time prior for
  ``ServiceEstimator`` — sublinear in bucket size because ``t_fix``
  amortizes, unlike the old linear ``COLD_PRIOR_SCALE`` guess.

Unmeasured, the model falls back to an analytic default line (overhead
``DEFAULT_OVERHEAD`` over the FLOP floor, fixed cost worth
``DEFAULT_FIX_TOKENS`` tokens) so every consumer has a cold answer; the
answers sharpen as ``observe()`` feeds real dispatch timings.  All fits
are medians + least squares over the stored samples — same samples in,
same fitted terms and same suggestions out (calibration is
deterministic; the bench and the property suite both pin this).
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.backend import DEFAULT_BACKEND, BackendSpec
from repro_torch.core.bucketing import DEFAULT_BUCKETS
from repro_torch.core.transfer import TransferStats
from repro_torch.serving.telemetry import percentile

# Measured overhead of the bring-up kernel over its pure-FMAC floor
# (45783 measured cycles / 11760 FMAC cycles ~= 3.89): the cold default
# until observe() provides real dispatch timings.
DEFAULT_OVERHEAD = 3.89
# Cold fixed dispatch cost, expressed in marginal-token equivalents: a
# dispatch costs like ~24 tokens of extra work before any payload token
# computes.  Sets the cold efficiency knee; replaced by the fitted
# t_fix as soon as two cells of a stage are measured.
DEFAULT_FIX_TOKENS = 24.0
# Efficiency-knee fraction: the auto chunk is the smallest bucket whose
# per-token efficiency reaches this fraction of the top bucket's.
KNEE_FRAC = 0.75
# Reference dispatch size for precision-scale fitting: the cross-
# precision ratio is taken on the WHOLE predicted cost of a dispatch
# this many tokens wide, not on the raw fitted slopes — a degenerate
# fit that shifts cost between t_fix and t_tok leaves the whole cost
# (what routing prices) intact while the slope ratio goes unbounded.
_SCALE_REF_TOKENS = 256.0


def _median(vals: Sequence[float]) -> float:
    return percentile(sorted(vals), 0.5)


class PerfModel:
    """Analytic + measured per-bucket dispatch-cost model for one model
    architecture (``flops_per_token`` of dense forward work) on one
    backend spec."""

    def __init__(self, flops_per_token: float = 1.0, *,
                 spec: BackendSpec = DEFAULT_BACKEND):
        self.spec = spec
        self.flops_per_token = float(flops_per_token)
        # (stage, bucket, batch, precision) -> measured dispatch seconds
        self._samples: Dict[Tuple[str, int, int, str], List[float]] = {}
        # (stage, precision) -> (t_fix_s, t_tok_s) pinned directly via
        # set_dispatch_cost (reloaded published calibration)
        self._fixed: Dict[Tuple[str, str], Tuple[float, float]] = {}
        # precision -> measured step-time multiplier vs fp32, pinned via
        # set_precision_scale / load_precision_scale: replaces
        # the spec's hard-coded §V constant once real fp32-vs-int8
        # timings exist
        self._precision_scale: Dict[str, float] = {}

    @classmethod
    def for_params(cls, params, *,
                   spec: BackendSpec = DEFAULT_BACKEND) -> "PerfModel":
        """Model sized from a torch model's weights (its parameters and
        buffers, as the reference counts every leaf of its parameter
        pytree): dense forward FLOPs per token ~= 2 x weight count (every
        weight is one multiply-add)."""
        n = sum(int(t.numel()) for t in params.state_dict().values())
        return cls(2.0 * max(n, 1), spec=spec)

    # ---- calibration -----------------------------------------------------
    def observe(self, stage: str, *, bucket: int, batch: int = 1,
                precision: str = "fp32", seconds: float) -> None:
        """One measured dispatch: ``stage`` ran a ``(bucket, batch)``
        cell (``bucket*batch`` padded tokens of compute) in ``seconds``."""
        key = (stage, int(bucket), int(batch), precision)
        self._samples.setdefault(key, []).append(float(seconds))

    def _floor_per_token_s(self, precision: str) -> float:
        return self.flops_per_token / self.spec.peak_flops(precision)

    def flop_floor_s(self, tokens: float, precision: str = "fp32") -> float:
        """Pure-FLOP floor: what ``tokens`` of dense forward work would
        cost at the spec's peak rate (the denominator of the overhead
        factor)."""
        return tokens * self._floor_per_token_s(precision)

    def _cells(self, stage: str,
               precision: str) -> List[Tuple[float, float]]:
        """Measured ``(tokens, median_seconds)`` cells of one stage at
        one precision, in deterministic (sorted-key) order."""
        out = []
        for (st, bucket, batch, prec), vals in sorted(self._samples.items()):
            if st == stage and prec == precision:
                out.append((float(bucket * batch), _median(vals)))
        return out

    def _default_line(self, precision: str) -> Tuple[float, float]:
        t_tok = self._floor_per_token_s(precision) * DEFAULT_OVERHEAD
        return DEFAULT_FIX_TOKENS * t_tok, t_tok

    def set_dispatch_cost(self, stage: str, t_fix_s: float, t_tok_s: float,
                          *, precision: str = "fp32") -> None:
        """Pin a stage's fitted line directly — e.g. reload the bench's
        published calibration (``fitted_terms``) instead of re-measuring.
        A pinned line takes precedence over stored samples."""
        self._fixed[(stage, precision)] = (float(t_fix_s), float(t_tok_s))

    def fit_dispatch_cost(self, stage: str, *, precision: str = "fp32") \
            -> Tuple[float, float]:
        """Fitted ``(t_fix_s, t_tok_s)`` for one stage: least squares of
        median cell time against cell tokens.

        Fallback ladder: a pinned line (``set_dispatch_cost``) wins;
        fewer than two distinct token counts at this precision -> the
        analytic default line rescaled through the measured medians; a
        different precision measured -> its fit scaled by the spec's
        precision ratio; nothing measured -> the analytic default line.
        Deterministic for a given sample set.
        """
        pinned = self._fixed.get((stage, precision))
        if pinned is not None:
            return pinned
        cells = self._cells(stage, precision)
        if not cells:
            others = {p for (st, _, _, p) in self._samples if st == stage}
            others |= {p for (st, p) in self._fixed if st == stage}
            for other in sorted(others - {precision}):
                t_fix, t_tok = self.fit_dispatch_cost(stage, precision=other)
                scale = (self.spec.precision_scale(precision)
                         / self.spec.precision_scale(other))
                return t_fix * scale, t_tok * scale
            return self._default_line(precision)
        xs = [x for x, _ in cells]
        ys = [y for _, y in cells]
        if len(set(xs)) < 2:
            # one token count: rescale the default line through the
            # measured median (keeps the default fix/marginal ratio)
            d_fix, d_tok = self._default_line(precision)
            scale = _median(ys) / max(d_fix + xs[0] * d_tok, 1e-30)
            return d_fix * scale, d_tok * scale
        n = float(len(xs))
        mx, my = sum(xs) / n, sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        t_tok = sxy / max(sxx, 1e-30)
        t_fix = my - t_tok * mx
        # clamp to a physical line: nonnegative fixed cost, positive
        # marginal cost (a degenerate fit must not invert the knee)
        t_tok = max(t_tok, 1e-12)
        return max(t_fix, 0.0), t_tok

    # ---- prediction ------------------------------------------------------
    def predict_dispatch_s(self, stage: str, tokens: float, *,
                           precision: str = "fp32") -> float:
        """Predicted wall time of ONE dispatch of ``tokens`` padded
        tokens through ``stage``."""
        t_fix, t_tok = self.fit_dispatch_cost(stage, precision=precision)
        return t_fix + tokens * t_tok

    def predict_step_s(self, stage: str = "prefill", *, bucket: int,
                       batch: int = 1, precision: str = "fp32",
                       chunk: Optional[int] = None) -> float:
        """Predicted time to prefill a ``(batch, bucket)`` cell through
        ``stage`` — monolithic (one dispatch of ``bucket*batch`` tokens)
        or chunked (``ceil(bucket/chunk)`` dispatches of ``chunk*batch``
        tokens each, the fixed cost paid per chunk)."""
        if chunk is not None and 0 < chunk < bucket:
            n = math.ceil(bucket / chunk)
            return n * self.predict_dispatch_s(stage, chunk * batch,
                                               precision=precision)
        return self.predict_dispatch_s(stage, bucket * batch,
                                       precision=precision)

    def cell_overhead(self, stage: str, *, bucket: int, batch: int = 1,
                      precision: str = "fp32") -> float:
        """Measured-over-floor overhead factor of one cell (the paper's
        §V efficiency number); falls back to the fitted line where the
        cell itself is unmeasured."""
        key = (stage, int(bucket), int(batch), precision)
        vals = self._samples.get(key)
        t = (_median(vals) if vals
             else self.predict_dispatch_s(stage, bucket * batch,
                                          precision=precision))
        return t / max(self.flop_floor_s(bucket * batch, precision), 1e-30)

    def precision_scale(self, precision: str) -> float:
        """Step-time multiplier of ``precision`` vs the fp32 baseline.
        The router's scale-up seed uses this to re-price a joiner whose
        precision differs from the measured fleet.

        Resolution ladder: a pinned measured scale
        (``set_precision_scale`` / ``load_precision_scale``) wins; next a
        ratio FITTED from this model's own samples — the marginal-token
        ratio of stages measured at BOTH precisions
        (``fit_precision_scale``); finally the spec's hard-coded §V
        constant (1.0 fp32, 0.5 on a 2x-int8 part)."""
        pinned = self._precision_scale.get(precision)
        if pinned is not None:
            return pinned
        fitted = self.fit_precision_scale(precision)
        if fitted is not None:
            return fitted
        return self.spec.precision_scale(precision)

    def set_precision_scale(self, precision: str, scale: float) -> None:
        """Pin a measured precision multiplier (vs fp32). Overrides both
        the fitted ratio and the spec constant."""
        if scale <= 0.0:
            raise ValueError(f"precision scale must be positive, "
                             f"got {scale}")
        self._precision_scale[precision] = float(scale)

    def fit_precision_scale(self, precision: str, *,
                            base: str = "fp32") -> Optional[float]:
        """Measured ``precision``-vs-``base`` step-time ratio from this
        model's own data: for every stage with its OWN samples or pinned
        line at BOTH precisions, the WHOLE-dispatch-cost ratio
        ``(t_fix + N·t_tok)(precision) / (t_fix + N·t_tok)(base)`` at
        ``_SCALE_REF_TOKENS`` tokens; the median across such stages.
        None when no stage is measured at both precisions — the caller
        falls back to the spec constant. The whole-cost ratio (not the
        raw slope ratio) is load-bearing: a noisy least-squares fit can
        push nearly all of a stage's cost into ``t_fix`` and clamp the
        slope to epsilon, and the slope ratio then explodes by orders
        of magnitude while the total measured cost — what routing
        actually prices — barely moved. Restricting to
        both-sides-measured stages keeps this fit independent of
        ``fit_dispatch_cost``'s cross-precision fallback (which itself
        consumes the spec ratio)."""
        if precision == base:
            return 1.0

        def own_stages(prec: str) -> set:
            stages = {st for (st, _, _, p) in self._samples if p == prec}
            stages |= {st for (st, p) in self._fixed if p == prec}
            return stages

        common = own_stages(precision) & own_stages(base)
        ratios = []
        n = _SCALE_REF_TOKENS
        for stage in sorted(common):
            fix_p, tok_p = self.fit_dispatch_cost(stage,
                                                  precision=precision)
            fix_b, tok_b = self.fit_dispatch_cost(stage, precision=base)
            cost_b = fix_b + n * tok_b
            if cost_b > 0.0:
                ratios.append((fix_p + n * tok_p) / cost_b)
        return _median(ratios) if ratios else None

    def load_precision_scale(self, path: str, *, precision: str = "w8a8",
                             base: str = "fp32") -> Optional[float]:
        """Pin ``precision``'s multiplier from the published bench JSON's
        measured fitted terms (``perf_model.fitted_terms``): the median
        whole-dispatch-cost ratio at ``_SCALE_REF_TOKENS`` tokens across
        stages the bench calibrated at both precisions (same robust
        ratio as ``fit_precision_scale`` — raw slope ratios blow up
        when a fit degenerates). Returns the pinned scale, or None —
        bench JSON absent, unreadable, or missing a both-precision
        stage — in which case nothing is pinned and ``precision_scale``
        keeps the spec constant."""
        try:
            with open(path) as f:
                terms = json.load(f)["perf_model"]["fitted_terms"]
            ratios = []
            n = _SCALE_REF_TOKENS
            for name in sorted(terms):
                stage, _, prec = name.rpartition("/")
                if prec != precision:
                    continue
                b = terms.get(f"{stage}/{base}")
                if b is None:
                    continue
                cost_b = (float(b["t_fix_ms"]) * 1e-3
                          + n * float(b["t_tok_us"]) * 1e-6)
                cost_p = (float(terms[name]["t_fix_ms"]) * 1e-3
                          + n * float(terms[name]["t_tok_us"]) * 1e-6)
                if cost_b > 0.0:
                    ratios.append(cost_p / cost_b)
        except (OSError, KeyError, TypeError, ValueError):
            return None
        if not ratios:
            return None
        scale = _median(ratios)
        self.set_precision_scale(precision, scale)
        return scale

    # ---- transfer terms --------------------------------------------------
    def transfer_s(self, *, h2d_bytes: float = 0.0,
                   d2h_bytes: float = 0.0) -> float:
        """Transfer cost at the spec's asymmetric link rates — the D2H
        readback leg is ~3x slower than H2D ingest (gather contention),
        so snapshot (D2H) and restore (H2D) price differently."""
        return (h2d_bytes / self.spec.h2d_bw
                + d2h_bytes / self.spec.d2h_bw)

    def snapshot_transfer_terms(self, stats: TransferStats) \
            -> Dict[str, float]:
        """Predicted per-snapshot transfer cost calibrated from an
        engine's measured ``transfer_stats``: mean bytes per batched
        transfer (the partial-transfer bytes actually shipped), charged
        once per direction — the snapshot leg at ``d2h_bw``, the restore
        leg at ``h2d_bw``."""
        n = max(stats.num_transfers_batched, 1)
        mean_bytes = stats.bytes_partial / n
        return {
            "bytes_per_transfer": mean_bytes,
            "d2h_s": mean_bytes / self.spec.d2h_bw,
            "h2d_s": mean_bytes / self.spec.h2d_bw,
            "d2h_h2d_ratio": self.spec.h2d_bw / self.spec.d2h_bw,
            "bytes_saved_frac": stats.bytes_saved_frac,
        }

    # ---- knob suggestions ------------------------------------------------
    def efficiency(self, tokens: float, *, stage: str = "chunk_prefill",
                   precision: str = "fp32") -> float:
        """Per-token efficiency of a dispatch: marginal work over total
        time on the fitted line — the y-axis of the per-bucket
        efficiency curve."""
        t_fix, t_tok = self.fit_dispatch_cost(stage, precision=precision)
        return (tokens * t_tok) / max(t_fix + tokens * t_tok, 1e-30)

    def suggest_prefill_chunk(self, buckets: Sequence[int], *,
                              stage: str = "chunk_prefill",
                              precision: str = "fp32",
                              knee_frac: float = KNEE_FRAC) -> int:
        """The efficiency knee: the smallest bucket whose per-token
        efficiency reaches ``knee_frac`` of the top bucket's.  A smaller
        chunk interleaves with decode more often (better tail TTFT); the
        knee is where shrinking further starts paying the fixed dispatch
        cost on too few tokens."""
        ladder = sorted({int(b) for b in buckets})
        if not ladder:
            raise ValueError("suggest_prefill_chunk needs a bucket ladder")
        target = knee_frac * self.efficiency(ladder[-1], stage=stage,
                                             precision=precision)
        for b in ladder:
            if self.efficiency(b, stage=stage, precision=precision) >= target:
                return b
        return ladder[-1]

    def suggest_buckets(self, lengths: Iterable[int], *,
                        max_len: Optional[int] = None,
                        coverage: Sequence[float] = (0.5, 0.75, 0.9, 0.99),
                        quantum: int = 8) -> Tuple[int, ...]:
        """Bucket ladder from the traffic size distribution: the
        interpolated percentile lengths at the ``coverage`` marks plus
        the observed max, each padded UP to the ``quantum`` (static
        shapes want a padding grain), deduped, ascending.  Requests at a
        coverage mark pad to their own bucket instead of the next
        hand-set power of two — the wasted-compute fraction the ladder
        carries is set by the trace, not by convention."""
        s = sorted(int(x) for x in lengths if x > 0)
        if not s:
            return tuple(b for b in DEFAULT_BUCKETS
                         if max_len is None or b <= max_len)
        marks = [percentile(s, p) for p in coverage] + [float(s[-1])]
        out = set()
        for m in marks:
            b = max(int(math.ceil(m / quantum)) * quantum, quantum)
            if max_len is not None:
                b = min(b, max_len)
            out.add(b)
        return tuple(sorted(out))

    def service_ratio(self, bucket: int, base_bucket: int, *,
                      stage: str = "prefill",
                      precision: str = "fp32") -> float:
        """Predicted service-time ratio between two buckets — the
        ``ServiceEstimator`` cold-start prior.  Sublinear in bucket size
        (the fixed dispatch cost amortizes), unlike the old linear
        ``COLD_PRIOR_SCALE`` guess that over-priced large buckets."""
        base = self.predict_step_s(stage, bucket=base_bucket,
                                   precision=precision)
        return self.predict_step_s(stage, bucket=bucket,
                                   precision=precision) / max(base, 1e-30)

    # ---- reporting -------------------------------------------------------
    def fitted_terms(self) -> Dict[str, Dict[str, float]]:
        """Fitted ``(t_fix, t_tok)`` per measured (stage, precision) —
        the bench's record of what calibration produced."""
        out: Dict[str, Dict[str, float]] = {}
        for stage, prec in sorted({(st, p)
                                   for (st, _, _, p) in self._samples}
                                  | set(self._fixed)):
            t_fix, t_tok = self.fit_dispatch_cost(stage, precision=prec)
            out[f"{stage}/{prec}"] = {"t_fix_ms": t_fix * 1e3,
                                      "t_tok_us": t_tok * 1e6}
        return out

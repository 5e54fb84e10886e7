"""Greedy-token agreement for quantized LM serving: the port's copy of
``token_agreement`` from the JAX package's ``core/metrics.py`` (that module
imports JAX)."""
from __future__ import annotations

from typing import Sequence, Tuple


def token_agreement(pairs: Sequence[Tuple[Sequence[int],
                                          Sequence[int]]]) -> float:
    """Attributable greedy-token agreement between paired generations.

    For each (got, ref) output pair, tokens are compared only up to and
    including the FIRST mismatch: up to that point both decoders saw the
    identical context, so every counted disagreement is genuinely caused
    by the numerics under test. Tokens after a divergence are conditioned
    on different prefixes — greedy decoding cascades chaotically there
    (one flip near a logit tie rewrites the whole continuation), which
    measures decode stability, not quantization error, so they are
    excluded. Returns matched/counted in [0, 1]; 1.0 for empty input."""
    matched = counted = 0
    for got, ref in pairs:
        for a, b in zip(got, ref):
            counted += 1
            if a == b:
                matched += 1
            else:
                break
    return matched / counted if counted else 1.0

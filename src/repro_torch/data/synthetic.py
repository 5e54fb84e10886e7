"""Synthetic data of the port (numpy copies of ``lm_token_batches``,
``zipf_indices``, ``dlrm_batches`` and ``xlmr_sentences`` from
``repro/data/synthetic.py``, held to the originals by
``tests/test_torch_serving.py`` and ``tests/test_torch_checkpoint.py``):
LM token streams, DLRM click logs (dense features, power-law sparse bags
padded to ``max_lookups_per_table``, and labels) and XLM-R's
variable-length sentences, from a numpy seed, so both packages see the
same data."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.dlrm_paper import DLRMConfig


def lm_token_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                     structured: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite LM batches. ``structured`` makes tokens learnable (Markov-ish
    next = (3*tok + noise) % vocab) so training loss visibly decreases."""
    rng = np.random.default_rng(seed)
    while True:
        if structured:
            toks = np.empty((batch, seq + 1), np.int32)
            toks[:, 0] = rng.integers(0, vocab, batch)
            noise = rng.integers(0, 2, (batch, seq))
            for t in range(seq):
                toks[:, t + 1] = (3 * toks[:, t] + noise[:, t]) % vocab
        else:
            toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def zipf_indices(rng, rows: int, size, alpha: float = 1.1) -> np.ndarray:
    """Power-law row popularity (the paper's embedding access pattern)."""
    raw = rng.zipf(alpha, size=size)
    return np.minimum(raw - 1, rows - 1).astype(np.int32)


def dlrm_batches(cfg: DLRMConfig, batch: int, *, seed: int = 0,
                 learnable: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Click-log batches: dense (B,13), per-table ragged bags (padded to
    ``max_lookups_per_table``) + lengths, binary labels.

    ``learnable``: labels correlate with dense features + a few 'golden'
    embedding rows so NE improves under training and degrades measurably
    under quantization."""
    rng = np.random.default_rng(seed)
    T = cfg.num_tables
    L = cfg.max_lookups_per_table
    avg = np.asarray(cfg.avg_lookups_per_table)
    while True:
        dense = rng.normal(size=(batch, cfg.num_dense_features)).astype(np.float32)
        lengths = np.minimum(
            rng.poisson(avg[None, :], (batch, T)) + 1, L).astype(np.int32)
        indices = np.zeros((batch, T, L), np.int32)
        for t in range(T):
            indices[:, t] = zipf_indices(rng, cfg.table_rows[t], (batch, L))
        if learnable:
            sig = (0.8 * dense[:, 0] - 0.5 * dense[:, 1]
                   + 0.3 * (indices[:, 0, 0] % 7 == 0)
                   + 0.2 * (indices[:, 1 % T, 0] % 5 == 0))
            p = 1.0 / (1.0 + np.exp(-(sig - 0.2)))
            labels = (rng.random(batch) < p).astype(np.float32)
        else:
            labels = rng.integers(0, 2, batch).astype(np.float32)
        yield {"dense": dense, "indices": indices, "lengths": lengths,
               "labels": labels}


def xlmr_sentences(vocab: int, n: int, *, seed: int = 0,
                   min_len: int = 4, max_len: int = 256) -> list:
    """Variable-length 'sentences' with the paper's skew (short dominates)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(3.2, 0.8, n).astype(int), min_len, max_len)
    return [rng.integers(0, vocab, l, dtype=np.int32) for l in lens]

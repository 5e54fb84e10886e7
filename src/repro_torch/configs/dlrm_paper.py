"""DLRM configs of the port (a copy of ``repro/configs/dlrm_paper.py``;
``tests/test_torch_serving.py`` holds the copy to the original) — the
paper's centerpiece workload (Table I, Fig. 2/6).

The paper serves a "less complex" (70 GParams, 0.02 GFLOPs/batch) and a
"more complex" (>100 GParams, 0.1 GFLOPs/batch) recommendation model; both
are dominated by embedding tables (SLS) with a small dense MLP side.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.configs.base import QuantConfig


@dataclass(frozen=True)
class DLRMConfig:
    name: str
    num_dense_features: int
    # one entry per sparse feature (embedding table): number of rows
    table_rows: Tuple[int, ...]
    embed_dim: int
    # average lookups (bag size) per table — drives SLS load balancing (T8)
    avg_lookups_per_table: Tuple[int, ...]
    max_lookups_per_table: int          # static upper bound for compilation (T6)
    bottom_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]
    interaction: str = "dot"            # pairwise dot interactions [52]
    quant: QuantConfig = field(default_factory=lambda: QuantConfig(
        embedding_bits=8, dense_int8=True))
    param_dtype: str = "float32"

    @property
    def num_tables(self) -> int:
        return len(self.table_rows)

    def embedding_params(self) -> int:
        return sum(self.table_rows) * self.embed_dim

    def dense_params(self) -> int:
        n = 0
        dims = (self.num_dense_features,) + self.bottom_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            n += a * b + b
        n_int = self.num_tables + 1
        inter = n_int * (n_int - 1) // 2
        dims = (self.bottom_mlp[-1] + inter,) + self.top_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            n += a * b + b
        return n

    def flops_per_sample(self) -> float:
        f = 0.0
        dims = (self.num_dense_features,) + self.bottom_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            f += 2 * a * b
        n_int = self.num_tables + 1
        f += 2 * n_int * n_int * self.embed_dim     # interaction matmul
        inter = n_int * (n_int - 1) // 2
        dims = (self.bottom_mlp[-1] + inter,) + self.top_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            f += 2 * a * b
        return f


def _powerlaw_rows(num_tables: int, total_rows: int, alpha: float = 1.05,
                   min_rows: int = 1000) -> Tuple[int, ...]:
    """Deterministic power-law table-size profile (large head, long tail)."""
    weights = [1.0 / (i + 1) ** alpha for i in range(num_tables)]
    s = sum(weights)
    rows = [max(min_rows, int(total_rows * w / s)) for w in weights]
    return tuple(rows)


# Paper "less complex": ~70B params -> 64 tables, ~1.09B rows @ dim 64
PAPER_BASE = DLRMConfig(
    name="dlrm-paper-base",
    num_dense_features=13,
    table_rows=_powerlaw_rows(64, 1_093_750_000),
    embed_dim=64,
    avg_lookups_per_table=tuple(1 + (i % 20) for i in range(64)),
    max_lookups_per_table=64,
    bottom_mlp=(512, 256, 64),
    top_mlp=(1024, 512, 256, 1),
)

# Paper "more complex" (the served 5x model): >100B params, ~5x dense GFLOPs
PAPER_COMPLEX = DLRMConfig(
    name="dlrm-paper-complex",
    num_dense_features=13,
    table_rows=_powerlaw_rows(96, 1_171_875_000),
    embed_dim=96,
    avg_lookups_per_table=tuple(1 + (i * 7) % 40 for i in range(96)),
    max_lookups_per_table=128,
    bottom_mlp=(1024, 512, 96),
    top_mlp=(2048, 2048, 1024, 512, 1),
)


def reduce_for_smoke(cfg: DLRMConfig) -> DLRMConfig:
    n = min(cfg.num_tables, 8)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        table_rows=tuple(100 + 10 * i for i in range(n)),
        embed_dim=16,
        avg_lookups_per_table=tuple(1 + i % 4 for i in range(n)),
        max_lookups_per_table=8,
        bottom_mlp=(32, 16),
        top_mlp=(64, 32, 1),
    )


# The port's one-card configuration: PAPER_COMPLEX at its published widths
# with every table's rows halved, the one cut one 80 GB card forces (the
# full row-wise int8 slab is 117 GB; half is 58.6 GB). The JAX launcher
# partitions the full table set over six cards.
PAPER_COMPLEX_ONE_CARD = dataclasses.replace(
    PAPER_COMPLEX,
    name="dlrm-paper-complex-1card",
    table_rows=tuple(r // 2 for r in PAPER_COMPLEX.table_rows),
)

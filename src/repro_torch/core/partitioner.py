"""Embedding-table partitioning of the port (paper T1/T8; a numpy-only
copy of ``TableAssignment``, ``_greedy_assign`` and ``partition_tables``
from ``repro/core/partitioner.py``, held to the original by
``tests/test_torch_serving.py``).

Tables are assigned whole to shards, then laid out in one flat slab whose
shard *s* owns rows ``[s * rows_per_shard, (s + 1) * rows_per_shard)``.
Load balancing uses the paper's length information: cost(table) =
avg_lookups * row_bytes (LPT greedy). The DLRM slice on one card uses one
shard; ``balance_report`` and ``allocate_cores`` come with the fleet
layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TableAssignment:
    """Result of partitioning ``num_tables`` tables over ``num_shards``."""
    num_shards: int
    shard_of_table: Tuple[int, ...]         # table -> shard
    tables_of_shard: Tuple[Tuple[int, ...], ...]
    # flat-slab layout
    table_offset: Tuple[int, ...]           # table -> first row in the slab
    rows_per_shard: int                     # equal (padded) rows per shard
    # balance diagnostics
    shard_cost: Tuple[float, ...]
    imbalance: float                        # max/mean shard cost

    @property
    def total_rows(self) -> int:
        return self.rows_per_shard * self.num_shards


def _greedy_assign(costs: Sequence[float], num_shards: int) -> List[int]:
    """LPT greedy bin packing: biggest cost to least-loaded shard."""
    order = np.argsort(-np.asarray(costs, dtype=np.float64))
    load = np.zeros(num_shards)
    assign = [0] * len(costs)
    for t in order:
        s = int(np.argmin(load))
        assign[int(t)] = s
        load[s] += costs[int(t)]
    return assign


def partition_tables(table_rows: Sequence[int],
                     num_shards: int,
                     avg_lookups: Optional[Sequence[int]] = None,
                     embed_dim: int = 1,
                     row_bytes: Optional[float] = None) -> TableAssignment:
    """Assign tables to shards.

    With ``avg_lookups`` (the paper's length information), the balanced cost
    is expected SLS traffic: lookups x bytes/row. Without it, falls back to
    memory-only balancing (rows) — the paper's naive baseline.
    """
    n = len(table_rows)
    rb = row_bytes if row_bytes is not None else float(embed_dim)
    if avg_lookups is not None:
        costs = [float(l) * rb for l in avg_lookups]
    else:
        costs = [float(r) for r in table_rows]
    assign = _greedy_assign(costs, num_shards)

    tables_of_shard = tuple(
        tuple(t for t in range(n) if assign[t] == s) for s in range(num_shards))
    # slab layout: tables of shard s occupy contiguous rows
    shard_rows = [sum(table_rows[t] for t in ts) for ts in tables_of_shard]
    rows_per_shard = max(max(shard_rows), 1)
    # align so int4 packing / 8-row tiles stay clean
    rows_per_shard = ((rows_per_shard + 7) // 8) * 8
    offsets = [0] * n
    for s, ts in enumerate(tables_of_shard):
        cur = s * rows_per_shard
        for t in ts:
            offsets[t] = cur
            cur += table_rows[t]

    if avg_lookups is not None:
        true_cost = [float(l) * rb for l in avg_lookups]
    else:
        true_cost = costs
    shard_cost = tuple(sum(true_cost[t] for t in ts) for ts in tables_of_shard)
    mean = max(sum(shard_cost) / num_shards, 1e-12)
    return TableAssignment(
        num_shards=num_shards,
        shard_of_table=tuple(assign),
        tables_of_shard=tables_of_shard,
        table_offset=tuple(offsets),
        rows_per_shard=rows_per_shard,
        shard_cost=shard_cost,
        imbalance=max(shard_cost) / mean,
    )

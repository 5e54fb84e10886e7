"""DLRM of the port (counterpart of ``repro/models/dlrm.py``) — the paper's
centerpiece workload (Fig. 2): sparse embeddings pooled by SLS over one
flat slab laid out by ``core.partitioner``, then the dense side (bottom
MLP, pairwise dot interaction, top MLP), exposed as separate stages for
pipelining (T2).

Parameters are a plain dict, as the JAX pytree: ``slab`` (R,D) f32, or
``slab_q`` = ``{"q8"|"q4", "scale", "bias"}`` for a row-wise int8/int4
slab (T3), plus ``bottom`` and ``top`` lists of ``{"w", "b"}``.

``sls_forward`` runs the single-device branch of the reference: it
flattens (B,T,L) to B·T bags of global slab indices and pools them with
the SLS kernel that matches the slab (``kernels/sls``); on the card that
kernel runs or the call raises. The row-sharded branch (``shard_map`` and
a psum over the table shards) waits for ``torch.distributed``. The dense
side is plain ``torch.matmul``, as the reference leaves it to XLA; like
the reference it does not read ``quant.dense_int8``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List

import torch

from repro_torch.configs.dlrm_paper import DLRMConfig
from repro_torch.core.partitioner import TableAssignment, partition_tables
from repro_torch.core.quantization import quantize_rows
from repro_torch.kernels.sls.ops import sls, sls_int4, sls_int8

# rows generated (and quantized) at a time by init_dlrm: no f32 copy of a
# whole quantized slab ever exists
INIT_CHUNK_ROWS = 1 << 21


def make_assignment(cfg: DLRMConfig, num_shards: int,
                    length_aware: bool = True) -> TableAssignment:
    return partition_tables(
        cfg.table_rows, num_shards,
        avg_lookups=cfg.avg_lookups_per_table if length_aware else None,
        embed_dim=cfg.embed_dim)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _mlp_init(gen: torch.Generator, dims, dtype, device) -> List[Dict]:
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=gen, device=device) / math.sqrt(a)
        layers.append({"w": w.to(dtype),
                       "b": torch.zeros((b,), dtype=dtype, device=device)})
    return layers


def init_dlrm(cfg: DLRMConfig, assignment: TableAssignment,
              gen: torch.Generator, device="cuda",
              quantize: bool = False) -> Dict[str, Any]:
    """Random weights with the reference's distributions: slab rows
    N(0, 1/D), quantized row-wise when ``quantize`` and
    ``cfg.quant.embedding_bits`` say so; MLP weights N(0, 1/fan_in), zero
    biases. ``gen`` lives on ``device``. The slab is made
    ``INIT_CHUNK_ROWS`` rows at a time (generate, scale, quantize, write),
    so a quantized slab needs no room for its f32 values."""
    dt = getattr(torch, cfg.param_dtype)
    total, D = assignment.total_rows, cfg.embed_dim
    bits = cfg.quant.embedding_bits if quantize else None
    params: Dict[str, Any] = {}
    if bits:
        cols = {8: D, 4: D // 2}.get(bits)
        if cols is None:
            raise ValueError(f"unsupported embedding bits {bits}")
        slab = {"q8" if bits == 8 else "q4":
                torch.empty((total, cols), dtype=torch.uint8, device=device),
                "scale": torch.empty((total,), dtype=torch.float16,
                                     device=device),
                "bias": torch.empty((total,), dtype=torch.float16,
                                    device=device)}
        params["slab_q"] = slab
    else:
        slab = params["slab"] = torch.empty((total, D), dtype=dt,
                                            device=device)
    for r0 in range(0, total, INIT_CHUNK_ROWS):
        r1 = min(r0 + INIT_CHUNK_ROWS, total)
        x = torch.randn((r1 - r0, D), generator=gen, device=device) \
            / math.sqrt(D)
        if bits:
            for k, v in quantize_rows(x, bits).items():
                slab[k][r0:r1] = v
        else:
            slab[r0:r1] = x
    dims_bot = (cfg.num_dense_features,) + cfg.bottom_mlp
    n_int = cfg.num_tables + 1
    inter = n_int * (n_int - 1) // 2
    dims_top = (cfg.bottom_mlp[-1] + inter,) + cfg.top_mlp
    params["bottom"] = _mlp_init(gen, dims_bot, dt, device)
    params["top"] = _mlp_init(gen, dims_top, dt, device)
    return params


def params_to(params: Dict[str, Any], device) -> Dict[str, Any]:
    """The same parameters on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return [params_to(v, device) for v in params]


def params_device(params: Dict[str, Any]) -> torch.device:
    slab = params.get("slab_q", params.get("slab"))
    return (slab["scale"] if isinstance(slab, dict) else slab).device


# --------------------------------------------------------------------------
# sparse stage: SLS over the slab (T1)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _table_offsets(assignment: TableAssignment,
                   device: torch.device) -> torch.Tensor:
    if assignment.total_rows > 2**31 - 1:
        raise ValueError(f"a slab of {assignment.total_rows} rows has "
                         f"global indices past int32")
    return torch.tensor(assignment.table_offset, dtype=torch.int32,
                        device=device)


def sls_forward(params, cfg: DLRMConfig, assignment: TableAssignment,
                indices: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """indices (B,T,L) int32 per-table bag indices, lengths (B,T) int32 ->
    pooled embeddings (B,T,D) f32, through the SLS kernel of the slab's
    type."""
    B, T, L = indices.shape
    gidx = indices + _table_offsets(assignment, indices.device)[None, :, None]
    gidx, lens = gidx.reshape(B * T, L), lengths.reshape(B * T)
    slab = params.get("slab_q", params.get("slab"))
    if isinstance(slab, dict):
        if "q8" in slab:
            pooled = sls_int8(slab["q8"], slab["scale"], slab["bias"], gidx,
                              lens)
        else:
            pooled = sls_int4(slab["q4"], slab["scale"], slab["bias"], gidx,
                              lens)
    else:
        pooled = sls(slab, gidx, lens)
    return pooled.reshape(B, T, -1)


# --------------------------------------------------------------------------
# dense stage: bottom MLP + interaction + top MLP
# --------------------------------------------------------------------------

def _mlp_apply(layers, x, final_linear=False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


@functools.lru_cache(maxsize=16)
def _upper_pairs(n: int, device: torch.device) -> torch.Tensor:
    """The (i, j), i < j, pairs of an n x n matrix in row-major order
    (``np.triu_indices(n, k=1)``)."""
    return torch.triu_indices(n, n, offset=1, device=device)


def dense_forward(params, cfg: DLRMConfig, dense_x: torch.Tensor,
                  pooled: torch.Tensor) -> torch.Tensor:
    """dense_x (B,13), pooled (B,T,D) -> logits (B,)."""
    bot = _mlp_apply(params["bottom"], dense_x.to(torch.float32))
    cat = torch.cat([bot[:, None, :], pooled], dim=1)          # (B,T+1,D)
    Z = torch.bmm(cat, cat.transpose(1, 2))
    iu, ju = _upper_pairs(cat.shape[1], cat.device)
    inter = Z[:, iu, ju]                                       # (B, n(n-1)/2)
    top_in = torch.cat([bot, inter], dim=1)
    out = _mlp_apply(params["top"], top_in, final_linear=True)
    return out[:, 0]


def dlrm_forward(params, cfg: DLRMConfig, assignment: TableAssignment,
                 dense_x, indices, lengths) -> torch.Tensor:
    pooled = sls_forward(params, cfg, assignment, indices, lengths)
    return dense_forward(params, cfg, dense_x, pooled)

"""The port's DLRM slice against the JAX package's, on the CPU: row-wise
embedding quantizers, partitioner, synthetic batches, the converter, the
model's sparse and dense stages, the T6 transfers, the engine and the
launcher.

Inputs and batches are made with numpy and fed to both packages; weights
are made by the JAX package and carried across with
``repro_torch.convert.dlrm_params_from_jax``. On the CPU the port's SLS
wrappers run their plain versions, and the JAX model gathers with jnp
(``models/dlrm.py:78-91``). Tolerances: pooled embeddings 1e-5 for an
fp32 slab and 1e-4 for int8/int4 (the SLS kernels' own, from
``kernels/sls/ops.py``); logits 2e-3 (the port's f32 rule); integer data
bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_paper as jax_cfgs
from repro.core import quantization as jax_quant
from repro.core import transfer as jax_transfer
from repro.data import synthetic as jax_synth
from repro.models import dlrm as jax_dlrm
from repro.serving.dlrm_engine import DLRMEngine as JaxDLRMEngine
from repro_torch import convert
from repro_torch.configs import dlrm_paper as cfgs
from repro_torch.core import quantization as quant
from repro_torch.core import transfer
from repro_torch.core.pipeline import Pipeline, TwoStagePipeline
from repro_torch.data import synthetic as synth
from repro_torch.kernels.sls.ops import sls, sls_int4, sls_int8
from repro_torch.models import dlrm
from repro_torch.serving.dlrm_engine import DLRMEngine

ROOT = Path(__file__).resolve().parent.parent
POOL_TOL = {None: 1e-5, 8: 1e-4, 4: 1e-4}
LOGIT_TOL = 2e-3


def _np(x):
    return np.asarray(x)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfg_pair(bits=8):
    """The reduced PAPER_COMPLEX of both packages, with ``bits``-bit
    embeddings."""
    out = []
    for mod in (jax_cfgs, cfgs):
        c = mod.reduce_for_smoke(mod.PAPER_COMPLEX)
        out.append(dataclasses.replace(
            c, quant=dataclasses.replace(c.quant, embedding_bits=bits)))
    return out


# ---- configs, quantizers, partitioner, batches ---------------------------

@pytest.mark.parametrize("name", ["PAPER_BASE", "PAPER_COMPLEX"])
def test_configs_equal_the_originals(name):
    j, t = getattr(jax_cfgs, name), getattr(cfgs, name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(cfgs.reduce_for_smoke(t)) \
        == dataclasses.asdict(jax_cfgs.reduce_for_smoke(j))
    assert (t.embedding_params(), t.dense_params(), t.flops_per_sample()) \
        == (j.embedding_params(), j.dense_params(), j.flops_per_sample())


def test_one_card_config_halves_the_rows_only():
    full, half = cfgs.PAPER_COMPLEX, cfgs.PAPER_COMPLEX_ONE_CARD
    assert half.table_rows == tuple(r // 2 for r in full.table_rows)
    assert dataclasses.replace(half, name=full.name,
                               table_rows=full.table_rows) == full
    asn = dlrm.make_assignment(half, 1)
    assert asn.total_rows == 585_937_456 < 2**31


@pytest.mark.parametrize("bits", [8, 4])
def test_row_quantizers_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    table = rng.standard_normal((257, 24)).astype(np.float32)
    table[3] = 0.75                                  # a constant row
    table[5, ::2] = 0.5                              # repeated values
    got = quant.quantize_rows(torch.from_numpy(table), bits)
    want = jax_quant.quantize_rows(jnp.asarray(table), bits)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].numpy().dtype == _np(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]), err_msg=k)
    np.testing.assert_array_equal(
        quant.dequantize_rows(got).numpy(),
        _np(jax_quant.dequantize_rows(want)))


def test_int4_needs_an_even_dim():
    with pytest.raises(ValueError):
        quant.quantize_rows_int4(torch.zeros(4, 7))
    with pytest.raises(ValueError):
        quant.quantize_rows(torch.zeros(4, 8), 3)


@pytest.mark.parametrize("shards", [1, 2, 6])
@pytest.mark.parametrize("aware", [True, False])
def test_partitioner_equals_the_original(shards, aware):
    for name in ("PAPER_COMPLEX", "PAPER_BASE"):
        jc = getattr(jax_cfgs, name)
        got = dlrm.make_assignment(getattr(cfgs, name), shards, aware)
        want = jax_dlrm.make_assignment(jc, shards, aware)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_dlrm_batches_equal_the_original():
    jc, tc = _cfg_pair()
    for seed in range(3):
        got = next(synth.dlrm_batches(tc, 16, seed=seed))
        want = next(jax_synth.dlrm_batches(jc, 16, seed=seed))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- converter, init -----------------------------------------------------

def _jax_params(jc, shards, bits, seed=0):
    """(JAX assignment, JAX params, the same params on the port, CPU)."""
    asn = jax_dlrm.make_assignment(jc, shards)
    jp = jax_dlrm.init_dlrm(jc, asn, jax.random.PRNGKey(seed),
                            quantize=bits is not None)
    return asn, jp, convert.dlrm_params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_converter_carries_every_leaf(bits):
    jc, _ = _cfg_pair(bits or 8)
    _, jp, tp = _jax_params(jc, 2, bits)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert b.numpy().dtype == _np(a).dtype, path
        np.testing.assert_array_equal(b.numpy(), _np(a), err_msg=str(path))
    with pytest.raises(ValueError):
        convert.dlrm_params_from_jax({"bottom": [], "top": []}, device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_init_quantizes_the_fp_init(bits, monkeypatch):
    """init_dlrm(quantize=True) is the row-wise quantization of the fp
    slab the same seed makes, chunk by chunk (a small chunk here), and
    draws the same MLP weights."""
    monkeypatch.setattr(dlrm, "INIT_CHUNK_ROWS", 100)
    _, tc = _cfg_pair(bits)
    asn = dlrm.make_assignment(tc, 3)
    fp = dlrm.init_dlrm(tc, asn, torch.Generator().manual_seed(3), "cpu")
    q = dlrm.init_dlrm(tc, asn, torch.Generator().manual_seed(3), "cpu",
                       quantize=True)
    assert fp["slab"].shape == (asn.total_rows, tc.embed_dim)
    want = quant.quantize_rows(fp["slab"], bits)
    for k in want:
        assert torch.equal(q["slab_q"][k], want[k]), k
    for side in ("bottom", "top"):
        for a, b in zip(fp[side], q[side]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    std = fp["slab"].std().item()
    assert abs(std * np.sqrt(tc.embed_dim) - 1) < 0.05


# ---- the model -----------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 6])
@pytest.mark.parametrize("bits", [None, 8, 4])
def test_sls_and_logits_match_jax(bits, shards):
    jc, tc = _cfg_pair(bits or 8)
    asn, jp, tp = _jax_params(jc, shards, bits, seed=shards)
    tasn = dlrm.make_assignment(tc, shards)
    assert dataclasses.asdict(tasn) == dataclasses.asdict(asn)
    batch = next(jax_synth.dlrm_batches(jc, 12, seed=4))
    batch["lengths"][0, :3] = 0                     # some empty bags
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pooled = dlrm.sls_forward(tp, tc, tasn, tb["indices"], tb["lengths"])
    want = jax_dlrm.sls_forward(jp, jc, asn, jb["indices"], jb["lengths"])
    assert pooled.shape == (12, tc.num_tables, tc.embed_dim)
    _close(pooled, want, POOL_TOL[bits])
    assert torch.equal(pooled[0, :3], torch.zeros(3, tc.embed_dim))
    logits = dlrm.dlrm_forward(tp, tc, tasn, tb["dense"], tb["indices"],
                               tb["lengths"])
    assert logits.shape == (12,) and logits.dtype == torch.float32
    _close(logits, jax_dlrm.dlrm_forward(jp, jc, asn, jb["dense"],
                                         jb["indices"], jb["lengths"]),
           LOGIT_TOL)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_sls_forward_runs_the_matching_kernel(bits, monkeypatch):
    """sls_forward flattens (B,T,L) to B*T bags of global indices and
    calls exactly the wrapper of the slab's type."""
    calls = []
    mod = dlrm
    for name, fn in (("sls", sls), ("sls_int8", sls_int8),
                     ("sls_int4", sls_int4)):
        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, tuple(args[-2].shape)))
            return _fn(*args)
        monkeypatch.setattr(mod, name, spy)
    jc, tc = _cfg_pair(bits or 8)
    _, _, tp = _jax_params(jc, 2, bits)
    tasn = dlrm.make_assignment(tc, 2)
    b = next(synth.dlrm_batches(tc, 5, seed=1))
    dlrm.sls_forward(tp, tc, tasn, torch.from_numpy(b["indices"]),
                     torch.from_numpy(b["lengths"]))
    name = {None: "sls", 8: "sls_int8", 4: "sls_int4"}[bits]
    assert calls == [(name, (5 * tc.num_tables, tc.max_lookups_per_table))]


# ---- transfers -----------------------------------------------------------

def _packed(seed):
    rng = np.random.default_rng(seed)
    bags = [[[int(x) for x in rng.integers(0, 100, rng.integers(0, 5))]
             for _ in range(6)] for _ in range(4)]
    return bags


@pytest.mark.parametrize("seed", [0, 1])
def test_command_batched_equals_naive_and_the_original(seed):
    sb = transfer.pack_sparse_inputs(_packed(seed), num_tables=6,
                                     max_lookups=8)
    jsb = jax_transfer.pack_sparse_inputs(_packed(seed), num_tables=6,
                                          max_lookups=8)
    np.testing.assert_array_equal(sb.indices, jsb.indices)
    stats, nstats = transfer.TransferStats(), transfer.TransferStats()
    idx, lens = transfer.command_batched_transfer(sb, stats)
    nidx, nlens = transfer.naive_transfer(sb, nstats)
    assert idx.dtype == lens.dtype == torch.int32
    assert torch.equal(idx, nidx) and torch.equal(lens, nlens)
    np.testing.assert_array_equal(idx.numpy(), sb.indices)
    jstats, jnstats = jax_transfer.TransferStats(), jax_transfer.TransferStats()
    jidx, _ = jax_transfer.command_batched_transfer(jsb, jstats)
    jax_transfer.naive_transfer(jsb, jnstats)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert dataclasses.asdict(nstats) == dataclasses.asdict(jnstats)
    assert stats.bytes_saved_frac == jstats.bytes_saved_frac > 0


def test_command_batched_on_dlrm_batches_equals_the_original():
    """On click-log batches (padding past a bag's length holds indices)
    the unpacked layout is the reference's: each table's used prefix, zeros
    beyond; and the bags pool the same as the naive layout's."""
    jc, tc = _cfg_pair()
    b = next(synth.dlrm_batches(tc, 16, seed=2))
    b["lengths"][:, 1] = 0                            # an unused table
    sb = transfer.SparseBatch(b["indices"], b["lengths"])
    stats, jstats = transfer.TransferStats(), jax_transfer.TransferStats()
    idx, lens = transfer.command_batched_transfer(sb, stats)
    jidx, jlens = jax_transfer.command_batched_transfer(
        jax_transfer.SparseBatch(b["indices"], b["lengths"]), jstats)
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_array_equal(lens.numpy(), _np(jlens))
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    asn = dlrm.make_assignment(tc, 1)
    params = dlrm.init_dlrm(tc, asn, torch.Generator().manual_seed(0), "cpu")
    nidx, nlens = transfer.naive_transfer(sb)
    assert torch.equal(dlrm.sls_forward(params, tc, asn, idx, lens),
                       dlrm.sls_forward(params, tc, asn, nidx, nlens))


def test_transfer_of_an_all_empty_batch():
    sb = transfer.pack_sparse_inputs([[[], []], [[], []]], 2, 4)
    idx, lens = transfer.command_batched_transfer(sb)
    assert idx.shape == (2, 2, 4) and not idx.any() and not lens.any()


def test_transfer_to_the_card_needs_a_staging_ring():
    sb = transfer.pack_sparse_inputs([[[1], [2, 3]]], 2, 4)
    with pytest.raises(ValueError, match="PinnedStaging"):
        transfer.command_batched_transfer(sb, device="cuda")


# ---- pipeline and engine -------------------------------------------------

def test_pipeline_runs_stages_in_order_and_measures():
    log = []
    p = Pipeline([("a", lambda x, r: log.append(("a", r)) or r + 1),
                  ("b", lambda x, r: log.append(("b", r)) or x * 10)])
    seen = []
    outs, stats = p.run([1, 2, 3], measure=True,
                        on_result=lambda i, v: seen.append((i, v)))
    assert outs == [20, 30, 40] and seen == list(enumerate(outs))
    # pipelined: at tick t stage b runs request t-1 before stage a takes
    # request t; then the measurement re-runs each stage over all requests
    assert log == [("a", 1), ("b", 1), ("a", 2), ("b", 2), ("a", 3),
                   ("b", 3), ("a", 1), ("a", 2), ("a", 3), ("b", 1),
                   ("b", 2), ("b", 3)]
    assert set(stats.stage_time_s) == {"a", "b"} and stats.num_requests == 3
    seq, _ = TwoStagePipeline(lambda r: r + 1,
                              lambda x, r: x * 10).run_sequential([1, 2, 3])
    assert seq == outs


def _engine_pair(bits, shards=1):
    jc, tc = _cfg_pair(bits or 8)
    asn, jp, tp = _jax_params(jc, shards, bits, seed=7)
    return (JaxDLRMEngine(jc, asn, jp),
            DLRMEngine(tc, dlrm.make_assignment(tc, shards), tp, device="cpu"),
            jc)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_engine_matches_the_jax_engine(bits):
    jeng, eng, jc = _engine_pair(bits, shards=2)
    batches = [next(jax_synth.dlrm_batches(jc, 8, seed=s)) for s in range(5)]
    want, _ = jeng.serve(batches, pipelined=True)
    got, stats = eng.serve(batches, pipelined=True)
    assert stats.num_requests == len(batches) == eng.telemetry.served
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (8,)
        _close(g, w, LOGIT_TOL)
    assert dataclasses.asdict(eng.transfer_stats) \
        == dataclasses.asdict(jeng.transfer_stats)


def test_engine_pipelined_equals_sequential_bit_for_bit():
    _, eng, jc = _engine_pair(8)
    batches = [next(jax_synth.dlrm_batches(jc, 8, seed=s)) for s in range(5)]
    outs_p, _ = eng.serve(batches, pipelined=True)
    outs_s, _ = eng.serve(batches, pipelined=False)
    for a, b in zip(outs_p, outs_s):
        assert torch.equal(a, b)
    assert eng.transfer_stats.bytes_saved_frac > 0.0


def test_engine_warm_and_measure_keep_stats_clean():
    """Warm-up and the measurement re-run count no transfer bytes and no
    stage dispatches; the measured pass times all four stages."""
    _, eng, jc = _engine_pair(8)
    batches = [next(jax_synth.dlrm_batches(jc, 8, seed=s)) for s in range(3)]
    eng.serve(batches, warm=True)
    assert eng.transfer_stats.bytes_full == 0
    assert eng.telemetry.served == 0 and not eng.telemetry.stage_calls
    _, stats = eng.serve(batches, measure=True)
    assert set(stats.stage_time_s) == {"ingest", "sparse", "dense", "post"}
    assert eng.telemetry.stage_calls == {"sparse": 3, "dense": 3, "post": 3}
    full = eng.transfer_stats.bytes_full
    assert full == sum(b["indices"].nbytes + b["lengths"].nbytes
                       for b in batches)


def test_engine_step_once_and_drain():
    """Each step admits one group of at most ``step_group`` batches; steps
    drain the queue."""
    _, eng, jc = _engine_pair(4)
    batches = [next(jax_synth.dlrm_batches(jc, 4, seed=s)) for s in range(6)]
    for b in batches:
        eng.submit(b)
    assert eng.has_work
    outs = eng.step_once()
    assert len(outs) == eng.step_group == 4 and eng.scheduler.depth == 2
    assert len(eng.step_once()) == 2 and not eng.has_work
    assert eng.step_once() == [] and eng.telemetry.served == 6


def test_engine_refuses_params_on_another_device():
    _, tc = _cfg_pair()
    asn = dlrm.make_assignment(tc, 1)
    params = dlrm.init_dlrm(tc, asn, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        DLRMEngine(tc, asn, params)                     # device="cuda"


def test_launcher_serves_dlrm_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "dlrm",
         "--device", "cpu", "--requests", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 batches x64 on cpu" in out.stdout

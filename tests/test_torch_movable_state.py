"""The port's movable sequence state against the JAX package's contracts,
on the CPU: snapshot -> restore is an identity bit for bit (f32 and int8
caches), a prefix-cache hit gives the tokens of a cold engine, host paging
(more sessions than slots) gives the tokens of a big-slot engine, a
migrated mid-prefill ticket resumes from its chunk and matches, and the
``TransferStats`` of a prefix-and-paging trace match the JAX engine's;
and the launcher's ``--prefix-cache 16 --verify-prefix``."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import model as jax_model
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.transfer import (TransferStats, snapshot_device_get,
                                       snapshot_device_put)
from repro_torch.serving.engine import InferenceEngine, Request

ROOT = os.path.join(os.path.dirname(__file__), "..")
KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48),
          prefill_chunk=8)


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, cfg, jparams, params


def _mixed_trace(cls, vocab, seed=5, lens=(40, 5, 9, 30, 3, 12, 26, 7)):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=4) for i, n in enumerate(lens)]


def _shared_prefix_trace(cls, vocab, seed=3, lens=(10, 6, 12, 9)):
    """Requests that share one 24-token system prompt."""
    shared = np.random.default_rng(0).integers(0, vocab, 24).astype(np.int32)
    rng = np.random.default_rng(seed)
    return [cls(i, np.concatenate([shared, rng.integers(0, vocab, n)])
                .astype(np.int32), max_new_tokens=4)
            for i, n in enumerate(lens)]


def _run_checked(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work:
        eng.step_once()
        eng.states.check_partition()
    return [r.output for r in reqs]


def _rows_equal(a, b):
    for la, lb in zip(a, b):
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k])


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_snapshot_restore_round_trip_bit_for_bit(smoke, cache):
    """After a chunked run (a group of 3 padded to 4), slot 0's 16-token
    prefix restores into another slot bit for bit, the rest of the row
    zero, and a second hop lands identically; the snapshot ships the
    prefix only."""
    cfg, params = smoke[1], smoke[3]
    if cache == "int8":
        cfg = _int8_kv(cfg)
    eng = InferenceEngine(cfg, params, device="cpu", **KW)
    eng.run(_mixed_trace(Request, cfg.vocab_size, seed=7, lens=(16, 9, 5)))
    assert {t.dtype for c in eng.caches for t in c.values()} == (
        {torch.int8, torch.float16} if cache == "int8" else {torch.float32})
    src = eng.snapshot_slot(0, 16)
    assert src.length == 16 and src.bytes_partial * 4 == src.bytes_full
    assert eng.transfer_stats.num_transfers_batched == 1
    eng.restore_slot(src, 2)
    _rows_equal(src.leaves, eng.snapshot_slot(2, 16).leaves)
    for c in eng.caches:
        assert all(not t[2, 16:].any() for t in c.values())
    eng.restore_slot(eng.snapshot_slot(2, 16), 1)
    _rows_equal(src.leaves, eng.snapshot_slot(1, 16).leaves)
    st = eng.transfer_stats
    assert (st.num_transfers_batched, st.num_transfers_naive) == (
        6, 6 * len(eng.caches) * len(eng.caches[0]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int8])
def test_snapshot_legs_keep_every_type_bit_for_bit(dtype):
    """The batched legs on their own: rows of mixed lengths and types out
    and back, the put zero-padding each row to its full extent."""
    rng = np.random.default_rng(0)
    full = [{"k": torch.from_numpy(rng.standard_normal((12, 3, 5)))
             .to(dtype), "s": torch.from_numpy(rng.standard_normal((12, 3)))
             .to(torch.float16)} for _ in range(2)]
    rows = [{k: t[:7] for k, t in layer.items()} for layer in full]
    stats = TransferStats()
    host = snapshot_device_get(rows, stats, full_bytes=999)
    _rows_equal(rows, host)
    back = snapshot_device_put(host, full, "cpu", stats)
    for layer, want in zip(back, full):
        for k, t in layer.items():
            assert t.shape == want[k].shape and t.dtype == want[k].dtype
            assert torch.equal(t[:7], want[k][:7]) and not t[7:].any()
    assert (stats.num_transfers_naive, stats.num_transfers_batched) == (8, 2)
    nbytes = sum(t.numel() * t.element_size() for l in full
                 for t in l.values())
    assert stats.bytes_full == 999 + nbytes
    assert stats.bytes_partial == nbytes * 7 // 12 + nbytes


def test_prefix_hits_match_a_cold_engine(smoke):
    """Warm admissions restore the shared prefix and emit the tokens of a
    cold engine; hit tickets are steal-vetoed until their restore lands;
    the cache stays within its cap."""
    cfg, params = smoke[1], smoke[3]
    cold = _run_checked(InferenceEngine(cfg, params, device="cpu", **KW),
                        _shared_prefix_trace(Request, cfg.vocab_size))
    eng = InferenceEngine(cfg, params, prefix_cache=2, device="cpu", **KW)
    eng.run(_shared_prefix_trace(Request, cfg.vocab_size))
    assert 0 < len(eng._prefix_cache) <= 2
    hits = eng.telemetry.prefix_hits
    warm = _shared_prefix_trace(Request, cfg.vocab_size)
    tickets = [eng.submit(r) for r in warm]
    assert eng.telemetry.prefix_hits - hits == len(warm)
    assert all(r.prefill_pos > 0 and r.prefill_pos % 8 == 0 for r in warm)
    assert not any(eng.steal_eligible(t) for t in tickets)
    while eng.has_work:
        eng.step_once()
        eng.states.check_partition()
    assert [r.output for r in warm] == cold
    assert not eng._pending_restore


def test_paging_serves_more_sessions_than_slots(smoke):
    """A 2-slot engine with host paging serves 6 sessions token-identical
    to a 6-slot engine, every page-out faulted back in."""
    cfg, params = smoke[1], smoke[3]
    lens = (40, 5, 9, 30, 3, 12)
    ref = _run_checked(InferenceEngine(cfg, params, device="cpu",
                                       **dict(KW, batch_slots=6)),
                       _mixed_trace(Request, cfg.vocab_size, 9, lens))
    eng = InferenceEngine(cfg, params, page_host=True, device="cpu",
                          **dict(KW, batch_slots=2))
    got = _run_checked(eng, _mixed_trace(Request, cfg.vocab_size, 9, lens))
    tel = eng.telemetry
    assert tel.served == len(lens)
    assert tel.paged_out > 0 and tel.paged_in == tel.paged_out
    assert not eng._paged and eng.cache_pressure == 0.0
    assert got == ref


def test_page_victim_orderings(smoke):
    """``lru`` parks the slot idle longest; ``remaining`` the session with
    the most tokens still to generate."""
    cfg, params = smoke[1], smoke[3]
    kw = dict(KW, page_host=True)
    victims = {}
    for policy in ("lru", "remaining"):
        eng = InferenceEngine(cfg, params, page_victim=policy, device="cpu",
                              **kw)
        for i, mnt in enumerate((20, 24, 30)):
            rng = np.random.default_rng(40 + i)
            eng.submit(Request(i, rng.integers(0, cfg.vocab_size, 5 + i)
                               .astype(np.int32), max_new_tokens=mnt))
        while len(eng.states.active) < 3:
            eng.step_once()
        slots = {s: t.payload.rid for s, t in eng.states.active.items()}
        eng._last_decode = {0: 9, 1: 2, 2: 7}       # slot 1 idle longest
        assert eng._page_out_one() and eng.cache_pressure == 1 / 3
        (t, _), = eng._paged.values()
        victims[policy] = (t.payload.rid, slots)
    assert victims["lru"][0] == victims["lru"][1][1]
    assert victims["remaining"][0] == 2
    with pytest.raises(ValueError):
        InferenceEngine(cfg, params, page_victim="mru", device="cpu", **kw)


def test_mid_prefill_migration_resumes_from_its_chunk(smoke):
    """The router's migration round by hand: the victim's eligible
    mid-prefill continuations leave with their snapshots, the thief
    restores and parks them and resumes at the chunk boundary; outputs
    match an unmigrated engine."""
    cfg, params = smoke[1], smoke[3]
    lens = (40, 38, 36, 30, 33, 12)
    ref = _run_checked(InferenceEngine(cfg, params, device="cpu", **KW),
                       _mixed_trace(Request, cfg.vocab_size, 5, lens))
    victim, thief = (InferenceEngine(cfg, params, device="cpu", **KW)
                     for _ in range(2))
    got = _mixed_trace(Request, cfg.vocab_size, 5, lens)
    for r in got:
        victim.submit(r)
    victim.step_once()
    stolen = victim.scheduler.steal_pending(
        3, eligible=victim.migration_eligible, include_continuations=True)
    assert stolen
    for t in stolen:
        snap = victim.export_prefill(t)
        assert snap.length == t.payload.prefill_pos == 8
        thief.adopt_prefill(t, snap)
    thief.scheduler.absorb(stolen, record=False)
    while victim.has_work or thief.has_work:
        for eng in (victim, thief):
            if eng.has_work:
                eng.step_once()
            eng.states.check_partition()
    assert thief.telemetry.migrated == len(stolen)
    assert [r.output for r in got] == ref
    for eng in (victim, thief):
        assert sorted(eng.free) == [0, 1, 2]


def test_transfer_stats_match_jax_on_the_same_trace(smoke):
    """A shared-prefix trace served twice on a 2-slot paging engine with a
    prefix cache, by the port and by the JAX package: the same hits, page
    traffic, bytes and batched copies. The JAX cache stacks each scan
    position's layers into one array, so it counts one naive transfer per
    stacked array where the port counts one per layer's tensor."""
    jcfg, cfg, jparams, params = smoke
    kw = dict(KW, batch_slots=2, prefix_cache=4, page_host=True)
    jeng = JaxEngine(jcfg, jparams, **kw)
    eng = InferenceEngine(cfg, params, device="cpu", **kw)
    for _ in range(2):
        jeng.run(_shared_prefix_trace(JaxRequest, cfg.vocab_size))
        eng.run(_shared_prefix_trace(Request, cfg.vocab_size))
    for name in ("prefix_hits", "paged_out", "paged_in", "served"):
        assert getattr(eng.telemetry, name) == getattr(jeng.telemetry,
                                                       name), name
    assert eng.telemetry.prefix_hits > 0 and eng.telemetry.paged_out > 0
    st, jst = eng.transfer_stats, jeng.transfer_stats
    assert (st.bytes_partial, st.bytes_full, st.num_transfers_batched) == (
        jst.bytes_partial, jst.bytes_full, jst.num_transfers_batched)
    _, repeats, _ = jcfg.scan_plan()
    assert st.num_transfers_naive == jst.num_transfers_naive * repeats


def test_serve_launcher_verify_prefix_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--prefill-chunk", "16", "--prefix-cache", "16", "--verify-prefix"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "verify-prefix OK: 16 requests replayed, 16 prefix-cache hits" \
        in out.stdout

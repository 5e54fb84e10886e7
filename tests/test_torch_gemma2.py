"""gemma2-27b serving in the port against the JAX package, on the CPU.

Reduced gemma2-27b (``reduce_for_smoke`` at 4 layers: local, global,
local, global; window 8, both logit softcaps, sandwich norms, the
embedding multiplier, GeGLU; f32) with the JAX package's initial weights
carried across by ``repro_torch.convert``:

- the parameters and ring caches carry across and back bit for bit, and
  the w8a8 build step decides the same sites as the JAX package's;
- the port's engine and the JAX engine agree on greedy tokens
  (``token_agreement`` >= 0.95), fp and w8a8 + int8 KV;
- within the port, chunked prefill (8, 16) is token-identical to
  monolithic for the JAX package's ``local`` and ``hybrid-local-global``
  configs (``tests/test_serving_runtime.py:265-290``);
- a snapshot moves a ring whole (the byte accounting the JAX engine's),
  restores bit for bit, and a prefix hit serves what a cold engine does;
- the new stages pass the CPU capture proxy of ``test_torch_graphs.py``;
- the launcher serves ``--arch gemma2-27b --smoke`` chunked and verified.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.configs.base import ATTN_LOCAL as JAX_LOCAL
from repro.core.metrics import token_agreement
from repro.models import model as jax_model
from repro.models import quantize as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import ATTN_LOCAL, get_config, reduce_for_smoke
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request
from test_torch_graphs import _record

ROOT = os.path.join(os.path.dirname(__file__), "..")
KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48))
LENS = (40, 5, 9, 30, 3, 12)          # the JAX package's stateful trace


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jax_reduce(jax_get_config("gemma2-27b")),
                               num_layers=4)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma2-27b")),
                              num_layers=4)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, cfg, jparams, params


def _trace(cls, vocab, seed=5, lens=LENS, new=4):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=new) for i, n in enumerate(lens)]


def _shared_prefix_trace(cls, vocab, seed=3, lens=(10, 6, 12, 9)):
    """Requests that share one 24-token system prompt (3 windows)."""
    shared = np.random.default_rng(0).integers(0, vocab, 24).astype(np.int32)
    rng = np.random.default_rng(seed)
    return [cls(i, np.concatenate([shared, rng.integers(0, vocab, n)])
                .astype(np.int32), max_new_tokens=4)
            for i, n in enumerate(lens)]


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# ---- weights, caches and the build step -------------------------------------

def test_params_and_ring_caches_carry_across_and_back(smoke):
    jcfg, cfg, jparams, params = smoke
    assert [l.kind for l in params.layers] == list(cfg.layer_kinds())
    assert all(hasattr(l, "post_norm") and hasattr(l, "post_mlp_norm")
               for l in params.layers)
    assert sum(p.numel() for p in params.parameters()) \
        == sum(x.size for x in jax.tree.leaves(jparams))
    back = _leaves(convert.params_to_jax(params, cfg))
    want = _leaves(jax.tree.map(np.asarray, jparams))
    assert [p for p, _ in back] == [p for p, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(back, want))
    for c in (jcfg, _int8_kv(jcfg)):
        rng = np.random.default_rng(0)
        jc = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 50).astype(a.dtype),
            jax_model.init_caches(c, 2, 32))
        port = convert.caches_from_jax(jax.tree.map(np.asarray, jc), cfg,
                                       "cpu")
        assert [t["k"].shape[1] for t in port] == [8, 32, 8, 32]
        got, ref = _leaves(convert.caches_to_jax(port, cfg)), _leaves(jc)
        assert all(np.array_equal(g, np.asarray(w))
                   for (_, g), (_, w) in zip(got, ref))


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_build_step_decides_the_same_sites_as_jax(smoke, budget):
    """Sites ``scan0.*`` (the local layers) and ``scan1.*`` (the global
    ones), the same decisions and int8 leaves as the JAX build step."""
    jcfg, cfg, jparams, params = smoke
    calib = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jb = jax_quantize.build_quantized_params(
        jcfg, jparams, calib_tokens=jnp.asarray(calib), budget=budget)
    tb = quantize_mod.build_quantized_params(
        cfg, params, calib_tokens=torch.from_numpy(calib), budget=budget)
    assert tb.schemes == jb.schemes
    assert {n.split(".")[0] for n in tb.schemes} == {"scan0", "scan1"}
    assert tb.result.metric_delta == jb.result.metric_delta
    got = _leaves(convert.params_to_jax(tb.params, cfg))
    want = _leaves(jax.tree.map(np.asarray, jb.params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), path


# ---- the engine ------------------------------------------------------------

@pytest.mark.parametrize("precision", ["fp32", "w8a8"])
def test_engine_agrees_with_the_jax_engine(smoke, precision):
    """The same trace (prompts up to 5 windows) through both engines, fp
    and w8a8 + int8 KV (each building its quantized weights from the same
    weights and calibration tokens)."""
    jcfg, cfg, jparams, params = smoke
    kw = dict(KW)
    if precision == "w8a8":
        jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
        calib = np.random.default_rng(9).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)
        kw_j = dict(kw, precision="w8a8",
                    quantized_params=jax_quantize.build_quantized_params(
                        jcfg, jparams, calib_tokens=jnp.asarray(calib)))
        kw_t = dict(kw, precision="w8a8",
                    quantized_params=quantize_mod.build_quantized_params(
                        cfg, params, calib_tokens=torch.from_numpy(calib)))
    else:
        kw_j = kw_t = kw
    jreqs = JaxEngine(jcfg, jparams, **kw_j).run(
        _trace(JaxRequest, cfg.vocab_size))
    eng = InferenceEngine(cfg, params, device="cpu", **kw_t)
    reqs = eng.run(_trace(Request, cfg.vocab_size))
    agreement = token_agreement([(r.output, j.output)
                                 for r, j in zip(reqs, jreqs)])
    print(f"{precision} greedy-token agreement with the JAX engine: "
          f"{agreement:.4f}")
    assert agreement >= 0.95
    assert all(r.done and len(r.output) == 4 for r in reqs)


def _arch_cfg(name):
    """The JAX package's ``local`` and ``hybrid-local-global`` smoke
    configs (``tests/test_serving_runtime.py:265-290``)."""
    if name == "local":
        return dataclasses.replace(
            reduce_for_smoke(get_config("deepseek-7b")),
            block_pattern=(ATTN_LOCAL,), window_size=8)
    return reduce_for_smoke(get_config("gemma2-27b"))


@pytest.mark.parametrize("arch", ["local", "hybrid-local-global"])
def test_chunked_prefill_token_identical_to_monolithic(arch):
    """The JAX package's stateful chunked-prefill acceptance on the port:
    chunks 8 and 16 against monolithic prefill, two trace seeds."""
    cfg = _arch_cfg(arch)
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    mono = InferenceEngine(cfg, params, device="cpu", **KW)
    chunked = {c: InferenceEngine(cfg, params, prefill_chunk=c,
                                  device="cpu", **KW) for c in (8, 16)}
    for seed in (5, 11):
        ref = _trace(Request, cfg.vocab_size, seed=seed)
        mono.run(ref)
        for chunk, eng in chunked.items():
            before = eng.telemetry.continuations
            got = _trace(Request, cfg.vocab_size, seed=seed)
            eng.run(got)
            for a, b in zip(got, ref):
                assert a.output == b.output, (arch, seed, chunk, a.rid)
            assert eng.telemetry.continuations > before
            assert all(r.done for r in got)


def test_jax_local_config_is_the_ports(smoke):
    jcfg = dataclasses.replace(jax_reduce(jax_get_config("deepseek-7b")),
                               block_pattern=(JAX_LOCAL,), window_size=8)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(_arch_cfg("local"))


# ---- movable state -----------------------------------------------------------

@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_snapshot_moves_rings_whole_and_restores_bit_for_bit(smoke, cache):
    """A 30-token prefix (past the window): the rings ship whole, the
    global rows their prefix; the bytes are the JAX engine's; a restore
    into another slot and a second hop give the same rows."""
    jcfg, cfg, jparams, params = smoke
    if cache == "int8":
        jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
    eng = InferenceEngine(cfg, params, device="cpu", **KW)
    eng.run(_trace(Request, cfg.vocab_size, seed=7, lens=(30, 9, 5)))
    jeng = JaxEngine(jcfg, jparams, **KW)
    jeng.run(_trace(JaxRequest, cfg.vocab_size, seed=7, lens=(30, 9, 5)))
    src = eng.snapshot_slot(0, 30)
    jsrc = jeng.snapshot_slot(0, 30)
    assert (src.bytes_partial, src.bytes_full) == (jsrc.bytes_partial,
                                                   jsrc.bytes_full)
    assert [l["k"].shape[0] for l in src.leaves] == [8, 30, 8, 30]
    eng.restore_slot(src, 2)
    for a, b in zip(src.leaves, eng.snapshot_slot(2, 30).leaves):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for c, kind in zip(eng.caches, cfg.layer_kinds()):
        if kind != ATTN_LOCAL:
            assert all(not t[2, 30:].any() for t in c.values())
    eng.restore_slot(eng.snapshot_slot(2, 30), 1)
    for a, b in zip(src.leaves, eng.snapshot_slot(1, 30).leaves):
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("max_len", [6, 8])
def test_a_ring_clamped_to_max_len_stays_positional(smoke, max_len):
    """Window 8 over max_len 6: the ring is clamped to the row, whose slot
    is its position, so a snapshot slices it to the written prefix like a
    global row; over max_len 8 it is a ring of its window and moves whole.
    Both as the JAX engine does, bytes and all."""
    jcfg, cfg, jparams, params = smoke
    kw = dict(KW, max_len=max_len, prefill_buckets=(4,))
    eng = InferenceEngine(cfg, params, device="cpu", **kw)
    jeng = JaxEngine(jcfg, jparams, **kw)
    for e, cls in ((eng, Request), (jeng, JaxRequest)):
        e.run(_trace(cls, cfg.vocab_size, lens=(4,), new=1))
    src, jsrc = eng.snapshot_slot(0, 4), jeng.snapshot_slot(0, 4)
    assert (src.bytes_partial, src.bytes_full) == (jsrc.bytes_partial,
                                                   jsrc.bytes_full)
    assert [l["k"].shape[0] for l in src.leaves] == (
        [4] * 4 if max_len == 6 else [8, 4, 8, 4])


def test_prefix_hits_match_a_cold_engine(smoke):
    cfg, params = smoke[1], smoke[3]
    cold = InferenceEngine(cfg, params, device="cpu", **KW)
    want = [r.output for r in cold.run(
        _shared_prefix_trace(Request, cfg.vocab_size))]
    eng = InferenceEngine(cfg, params, prefix_cache=4, prefill_chunk=8,
                          device="cpu", **KW)
    eng.run(_shared_prefix_trace(Request, cfg.vocab_size))
    hits = eng.telemetry.prefix_hits
    warm = eng.run(_shared_prefix_trace(Request, cfg.vocab_size))
    assert eng.telemetry.prefix_hits - hits == len(warm)
    assert [r.output for r in warm] == want


# ---- the capture proxy -------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_ring_stages_are_capturable(smoke, int8):
    """Prefill, chunk (C 16 over the ring of 8, offsets past the window)
    and decode (positions past the window) of the gemma2 engine: two calls
    of each run the same aten ops on the same shapes, none of them a host
    sync, a boolean-mask index or a copy to the host."""
    cfg, params = smoke[1], smoke[3]
    if int8:
        cfg = _int8_kv(cfg)
    eng = InferenceEngine(cfg, params, batch_slots=4, max_len=64,
                          prefill_buckets=(16,), device="cpu")
    rng = np.random.default_rng(8)
    toks = lambda *s: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
    calls = [([1, 2, 0, 1], [0, 16, 8, 0], [0, 16, 8, 64], [16, 8, 5, 0]),
             ([3, 0, 2, 1], [24, 0, 32, 8], [24, 0, 32, 8], [16, 2, 9, 7])]
    chunk = []
    for slots, start, wpos, lengths in calls:
        arrays, dequant = attn_mod.chunk_writes(
            slots, start, wpos, lengths, 16, 64, 4, ring=eng._ring)
        chunk.append(dict(arrays, tokens=toks(4, 16), last_idx=np.maximum(
            np.asarray(lengths, np.int32) - 1, 0)))
    cases = [
        (eng._build_decode(), [
            {"tokens": toks(4, 1), "pos": np.array([3, 9, 0, 39], np.int32),
             "active": np.array([True, True, False, False])},
            {"tokens": toks(4, 1), "pos": np.array([39, 1, 20, 7], np.int32),
             "active": np.array([False, True, True, True])}], None),
        (eng._build_prefill(16, 4), [
            {"tokens": toks(4, 16), "lengths": np.array([16, 3, 9, 1],
                                                        np.int32),
             "rows": np.array([2, 0, 3, 1])},
            {"tokens": toks(4, 16), "lengths": np.array([5, 12, 7, 1],
                                                        np.int32),
             "rows": np.array([1, 3, 0, -1])}], None),
        (eng._build_chunk(16, 4), chunk, dequant if int8 else None)]
    for stage, inputs, variant in cases:
        _record(stage, inputs[0], variant)          # the warm-up
        first, second = (_record(stage, x, variant) for x in inputs)
        assert first.ops and not first.bad and not second.bad, \
            (first.bad, second.bad)
        assert first.ops == second.ops


# ---- the launcher ---------------------------------------------------------------

def test_serve_launcher_gemma2_chunked_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-27b", "--smoke", "--device", "cpu", "--requests", "4",
         "--new-tokens", "3", "--prefill-chunk", "8", "--verify-chunked"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "verify-chunked OK: 4 requests" in out.stdout

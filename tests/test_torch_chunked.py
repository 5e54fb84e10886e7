"""The port's chunked prefill against the JAX package's, on the CPU.

- The flash kernel's plain version at a per-row query offset (``q_off``)
  and cache row (``kv_rows``), held against the JAX package's jnp chunk
  attention (``repro/models/attention.py:366-387``) and its flash oracle
  on the equivalent monolithic rows (at G 6 and 12 its Pallas kernel in
  interpret mode too); 2e-3 in f32, 2e-2 in bf16.
- ``chunk_prefill_step`` against JAX ``model.chunk_prefill_step`` on the
  same weights (carried across by ``repro_torch.convert``): hidden states
  of the real chunk tokens within 2e-3 (f32 math on both sides); the fp
  cache's written prefix within 2e-3, the int8 cache's bit for bit.
- The engine with ``prefill_chunk`` 8 and 16: token-identical to the
  port's monolithic engine in f32, greedy agreement >= 0.95 with the JAX
  chunked engine, and over an int8 KV cache >= 0.95 with the monolithic
  int8 engine (``tests/test_serving_runtime.py:404`` holds the JAX engine
  so).
- The launcher's ``--prefill-chunk 16 --verify-chunked``.
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
from repro.core.metrics import token_agreement
from repro.kernels.flash_attn.ops import flash_attn as jax_flash_attn
from repro.kernels.flash_attn.ref import flash_attention_ref as jax_flash_ref
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.models import model as model_mod
from repro_torch.serving.engine import InferenceEngine, Request

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-3
ENGINE_KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32))


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


# ---- the flash plain version at a query offset ------------------------------

# name -> (cache rows Bk, T, K, G, hd, C, slots, start, lengths, window,
# dtype): offsets off the 32- and 128-key tiles, a short last chunk, a
# padded row (lengths 0, repeating the first slot), a group smaller than
# the cache, G 1/4/8, a window; G 6 and 12 (which leave pad rows in the
# card kernel's 128-row tile) at offsets off its 21- and 10-position tiles
CHUNK_CASES = {
    "off_tile_C40_T200": (3, 200, 2, 2, 32, 40, [2, 0], [100, 37], [40, 40],
                          0, "f32"),
    "short_last_chunk": (3, 128, 2, 1, 16, 32, [1, 0, 2], [96, 0, 64],
                         [13, 32, 1], 0, "f32"),
    "padded_row_G4": (4, 160, 2, 4, 32, 48, [3, 1, 3, 3], [112, 48, 0, 0],
                      [48, 30, 0, 0], 0, "f32"),
    "G8_hd64": (2, 300, 1, 8, 64, 64, [1, 0], [236, 130], [64, 17], 0,
                "f32"),
    "window40": (3, 256, 2, 2, 32, 64, [0, 2], [150, 20], [64, 50], 40,
                 "f32"),
    "bf16_G4_hd128": (2, 256, 2, 4, 128, 32, [1, 0], [129, 200], [32, 9],
                      0, "bf16"),
    "bf16_G6_hd128_off_tile": (2, 200, 1, 6, 128, 40, [1, 0], [131, 45],
                               [40, 23], 0, "bf16"),
    "G12_hd64_off_tile": (3, 180, 1, 12, 64, 30, [2, 0], [97, 150],
                          [30, 17], 0, "f32"),
}
# the G's that leave pad rows, also against the JAX Pallas kernel
PALLAS_CHUNK_CASES = ("bf16_G6_hd128_off_tile", "G12_hd64_off_tile")


def _chunk_inputs(name):
    Bk, T, K, G, hd, C, slots, start, lengths, window, dt = CHUNK_CASES[name]
    rng = np.random.default_rng(sorted(CHUNK_CASES).index(name))
    P = len(slots)
    q = rng.standard_normal((P, C, K * G, hd), np.float32)
    k = rng.standard_normal((Bk, T, K, hd), np.float32)
    v = rng.standard_normal((Bk, T, K, hd), np.float32)
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    if dt == "bf16":       # the bf16 values, back in f32 for the JAX side
        q, k, v = (x.float().numpy() for x in t)
    start, lengths = np.asarray(start), np.asarray(lengths)
    return (q, k, v, t, np.asarray(slots), start, lengths, window,
            2e-2 if dt == "bf16" else TOL)


def _port_chunk(t, slots, start, lengths, window):
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    return flash_attn(*t, i32(start + lengths), window=window,
                      q_off=i32(start), kv_rows=i32(slots)).float().numpy()


@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_flash_plain_at_offsets_matches_jax_chunk_attention(name):
    """Each row's chunk against the JAX package's flash oracle run on the
    row's whole cache row with the chunk's queries at their absolute
    positions (every query, padded ones too: both sides mask keys past
    start + lengths), and, without a window, against the jnp chunk
    attention of the JAX model (its real queries: it masks padded
    queries' keys differently)."""
    q, k, v, t, slots, start, lengths, window, tol = _chunk_inputs(name)
    P, C = q.shape[:2]
    got = _port_chunk(t, slots, start, lengths, window)
    for j in range(P):
        s = start[j]
        qfull = np.zeros((1, s + C) + q.shape[2:], np.float32)
        qfull[0, s:] = q[j]
        want = jax_flash_ref(jnp.asarray(qfull),
                             jnp.asarray(k[slots[j]][None]),
                             jnp.asarray(v[slots[j]][None]),
                             jnp.asarray([s + lengths[j]], jnp.int32),
                             causal=True, window=window)
        np.testing.assert_allclose(got[j], np.asarray(want)[0, s:],
                                   rtol=tol, atol=tol)
    if window:
        return
    cfg = jax_reduce(jax_get_config("deepseek-7b"))
    T = k.shape[1]
    pos_bc = start[:, None] + np.arange(C)[None, :]
    mask = np.arange(T)[None, None, :] <= pos_bc[:, :, None]
    scores = jax_attn._gqa_scores(jnp.asarray(q), jnp.asarray(k[slots]), cfg)
    scores = jnp.where(jnp.asarray(mask)[:, None, None], scores,
                       jax_attn.NEG_INF)
    want = np.asarray(jax_attn._gqa_out(
        jax.nn.softmax(scores.astype(jnp.float32), axis=-1),
        jnp.asarray(v[slots])))
    real = np.arange(C)[None, :] < lengths[:, None]
    np.testing.assert_allclose(got[real], want[real], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", PALLAS_CHUNK_CASES)
def test_flash_plain_at_offsets_matches_pallas_kernel(name):
    """Each row's chunk against the JAX package's Pallas flash kernel in
    interpret mode, every row's queries at their absolute positions of one
    zero-padded query batch over the rows' own cache rows."""
    q, k, v, t, slots, start, lengths, window, tol = _chunk_inputs(name)
    P, C = q.shape[:2]
    got = _port_chunk(t, slots, start, lengths, window)
    qfull = np.zeros((P, start.max() + C) + q.shape[2:], np.float32)
    for j in range(P):
        qfull[j, start[j]:start[j] + C] = q[j]
    want = np.asarray(jax_flash_attn(
        jnp.asarray(qfull), jnp.asarray(k[slots]), jnp.asarray(v[slots]),
        jnp.asarray(start + lengths, jnp.int32), window=window, bq=32,
        bk=32, interpret=True))
    for j in range(P):
        np.testing.assert_allclose(got[j], want[j, start[j]:start[j] + C],
                                   rtol=tol, atol=tol)


def test_flash_plain_defaults_are_offset_zero_and_own_rows():
    """``q_off`` 0 and ``kv_rows`` arange give exactly the output without
    them (the function before chunks)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 40, 4, 32),
                                                    np.float32))
               for _ in range(3))
    lens = torch.tensor([40, 17, 0], dtype=torch.int32)
    for kw in ({}, {"window": 9}, {"causal": False}, {"softcap": 30.0}):
        plain = flash_attention_ref(q, k, v, lens, **kw)
        assert torch.equal(plain, flash_attention_ref(
            q, k, v, lens, q_off=torch.zeros(3, dtype=torch.int32),
            kv_rows=torch.arange(3, dtype=torch.int32), **kw))
        assert torch.equal(plain, flash_attn(q, k, v, lens, **kw))


def test_flash_wrapper_checks_offset_and_row_arrays():
    q = torch.zeros(2, 8, 4, 16)
    k = torch.zeros(5, 32, 2, 16)                  # a 5-row cache
    rows = torch.tensor([4, 0], dtype=torch.int32)
    assert flash_attn(q, k, k, kv_rows=rows).shape == q.shape
    with pytest.raises(ValueError, match="batch"):     # no kv_rows
        flash_attn(q, k, k)
    with pytest.raises(ValueError, match="q_off"):
        flash_attn(q, k, k, q_off=torch.zeros(2), kv_rows=rows)
    with pytest.raises(ValueError, match="kv_rows"):
        flash_attn(q, k, k, kv_rows=rows[:1])


def test_flash_rows_outside_the_cache_give_zero():
    """A kv row outside [0, Bk) reads no key (as the kernel does: its
    tensor-core route loads zero tiles there), and the model layer refuses
    such slots on the host."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((3, 8, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 24, 2, 16), np.float32))
    lens = torch.tensor([20, 20, 20], dtype=torch.int32)
    off = torch.tensor([12, 12, 12], dtype=torch.int32)
    got = flash_attn(q, k, k, lens, q_off=off,
                     kv_rows=torch.tensor([1, 2, -1], dtype=torch.int32))
    assert not got[1:].any()
    assert torch.equal(got[0], flash_attn(q[:1], k[1:], k[1:], lens[:1],
                                          q_off=off[:1])[0])


# ---- chunk_prefill_step ---------------------------------------------------

MAX_LEN, C = 40, 8
# (slots, start, write_pos, lengths) of three successive chunk calls on a
# 3-slot cache: rows at different offsets, a short chunk, a padded row
# (write_pos max_len, lengths 0), a chunk ending at max_len
STEPS = [([2, 0], [0, 0], [0, 0], [8, 5]),
         ([0, 2, 1, 0], [5, 8, 0, 0], [5, 8, 0, MAX_LEN], [8, 3, 8, 0]),
         ([1, 2], [8, 11], [8, 11], [8, 8]),
         ([2], [32], [32], [8])]


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, cfg, jparams, params


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("cache", ["fp", "int8"])
def test_chunk_prefill_step_matches_jax(smoke, cache):
    """Four chunk calls on both sides from empty caches: hidden states of
    the real tokens within 2e-3, and after each call every slot's written
    prefix (fp within 2e-3; int8 values and fp16 scales bit for bit)."""
    jcfg, cfg, jparams, params = smoke
    if cache == "int8":
        jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
    jcaches = jax_model.init_caches(jcfg, 3, MAX_LEN)
    caches = model_mod.init_caches(cfg, 3, MAX_LEN, "cpu")
    written = np.zeros(3, int)
    rng = np.random.default_rng(3)
    for slots, start, wpos, lengths in STEPS:
        toks = rng.integers(0, cfg.vocab_size,
                            (len(slots), C)).astype(np.int32)
        hj, jcaches = jax_model.chunk_prefill_step(
            jparams, jcfg, jnp.asarray(toks), jcaches,
            *(jnp.asarray(a, jnp.int32) for a in (slots, start, wpos,
                                                  lengths)))
        with torch.inference_mode():
            h, caches = model_mod.chunk_prefill_step(
                params, cfg, torch.from_numpy(toks), caches, slots, start,
                wpos, lengths)
        real = np.arange(C)[None, :] < np.asarray(lengths)[:, None]
        np.testing.assert_allclose(h.numpy()[real], np.asarray(hj)[real],
                                   rtol=TOL, atol=TOL)
        for s, w, n in zip(slots, wpos, lengths):
            if n:
                written[s] = max(written[s], w + n)
        mask = np.arange(MAX_LEN)[None, :] < written[:, None]
        back = convert.caches_to_jax(caches, cfg)
        for (path, got), (_, want) in zip(_leaves(back), _leaves(jcaches)):
            want = np.asarray(want)
            assert got.dtype == want.dtype, path
            if cache == "int8":
                assert np.array_equal(got[:, mask], want[:, mask]), path
            else:
                np.testing.assert_allclose(got[:, mask], want[:, mask],
                                           rtol=TOL, atol=TOL)
    assert written.tolist() == [13, 16, 40]
    with pytest.raises(ValueError, match="outside the cache"):
        model_mod.chunk_prefill_step(params, cfg, torch.zeros(
            1, C, dtype=torch.int32), caches, [3], [0], [0], [C])


def test_chunk_writes_only_the_real_tokens(smoke):
    """A padded row and the positions past a row's real tokens keep what
    the cache held: only [write_pos, write_pos + lengths) is written."""
    cfg, params = smoke[1], smoke[3]
    caches = model_mod.init_caches(cfg, 3, MAX_LEN, "cpu")
    for c in caches:
        for t in c.values():
            t.fill_(7.0)
    with torch.inference_mode():
        model_mod.chunk_prefill_step(
            params, cfg, torch.zeros(2, C, dtype=torch.int32), caches,
            [1, 1], [4, 0], [4, MAX_LEN], [3, 0])
    for c in caches:
        for t in c.values():
            changed = (t != 7.0).flatten(2).any(-1)
            assert changed[1, 4:7].all()
            changed[1, 4:7] = False
            assert not changed.any()


# ---- the engine ------------------------------------------------------------

def _requests(cls, n=6, seed=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 30, n)
    new = rng.integers(2, 9, n)
    return [cls(i, rng.integers(0, 256, int(L)).astype(np.int32),
                max_new_tokens=int(m))
            for i, (L, m) in enumerate(zip(lens, new))]


@pytest.fixture(scope="module")
def monolithic(smoke):
    _, cfg, _, params = smoke
    out = {}
    for name, c in (("fp", cfg), ("int8", _int8_kv(cfg))):
        eng = InferenceEngine(c, params, device="cpu", **ENGINE_KW)
        out[name] = [r.output for r in eng.run(_requests(Request))]
    return out


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_engine_matches_monolithic_and_jax(smoke, monolithic, chunk):
    jcfg, cfg, jparams, params = smoke
    eng = InferenceEngine(cfg, params, prefill_chunk=chunk, device="cpu",
                          **ENGINE_KW)
    reqs = eng.run(_requests(Request))
    assert [r.output for r in reqs] == monolithic["fp"]
    assert eng.telemetry.continuations > 0
    jeng = JaxEngine(jcfg, jparams, prefill_chunk=chunk, **ENGINE_KW)
    jreqs = jeng.run(_requests(JaxRequest))
    agreement = token_agreement([(r.output, j.output)
                                 for r, j in zip(reqs, jreqs)])
    assert agreement >= 0.95
    for name in ("served", "prefills", "prefill_batches", "steps",
                 "total_tokens", "continuations"):
        assert getattr(eng.telemetry, name) == getattr(jeng.telemetry,
                                                        name), name
    # one stage per (bucket, padded group, precision), keyed as the JAX
    # engine keys its executables
    assert sorted(eng.executor.cached_keys("chunk_prefill")) == sorted(
        jeng.executor.cached_keys("chunk_prefill"))
    eng.states.check_partition()
    assert not eng.has_work and sorted(eng.free) == [0, 1, 2]


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_int8_kv_engine_agrees_with_monolithic(smoke, monolithic,
                                                       chunk):
    """Over an int8 cache a chunk attends the dequantized cached prefix
    while monolithic prefill attends its exact K/V, so the contract is
    greedy agreement >= 0.95, not identity."""
    cfg, params = _int8_kv(smoke[1]), smoke[3]
    eng = InferenceEngine(cfg, params, prefill_chunk=chunk, device="cpu",
                          **ENGINE_KW)
    outputs = [r.output for r in eng.run(_requests(Request))]
    assert token_agreement(zip(outputs, monolithic["int8"])) >= 0.95


def test_chunked_engine_rejects_auto_and_orphan_prefix_cache(smoke):
    """``prefill_chunk="auto"`` is no longer refused now that the port has
    the performance model: unmeasured, it takes the model's cold knee on
    the bucket ladder, the chunk the JAX engine takes. A prefix cache
    without chunks is still refused."""
    jcfg, cfg, jparams, params = smoke
    eng = InferenceEngine(cfg, params, prefill_chunk="auto", device="cpu")
    assert eng.prefill_chunk in eng.buckets
    assert eng.prefill_chunk == JaxEngine(jcfg, jparams,
                                          prefill_chunk="auto").prefill_chunk
    with pytest.raises(ValueError, match="requires prefill_chunk"):
        InferenceEngine(cfg, params, prefix_cache=4, device="cpu")


def test_serve_launcher_verify_chunked_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--prefill-chunk", "16", "--verify-chunked"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "verify-chunked OK: 16 requests" in out.stdout

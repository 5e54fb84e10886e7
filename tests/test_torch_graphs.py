"""The port's compiled stages on the CPU: the static forms the executor
captures as CUDA graphs on the card, held against the JAX package and
against the writes they replace.

- Decode with inactive rows (the reference's ``guard``): active rows'
  hidden states and cache entries against JAX ``decode_step(active=...)``
  within 2e-3 (f32; an int8 cache's entries bit for bit), inactive rows'
  cache bit for bit as before the step.
- Fixed-shape writes: a prefill group of 3 padded to 4 rows and a chunk
  call with a padded row and a row crossing ``max_len`` leave the caches
  bit for bit as a write of the real tokens alone, fp and int8 KV; the
  chunk's caches and hidden states match JAX ``chunk_prefill_step`` at
  the real positions (2e-3 fp, int8 bit for bit).
- A capture proxy: each stage's static form, once warmed up as the
  executor warms it before a capture, run on two inputs of one key under a
  dispatch recorder issues the same aten ops on the same shapes, dtypes and
  devices, and none that waits on the device or depends on a value
  (``nonzero``, ``_local_scalar_dense``, ``masked_select``, boolean-mask
  indexing, a copy to the host).
- The executor's bookkeeping with the capture stubbed: one build per key,
  the launch counters advanced at every replay by what the capture saw, a
  failing capture raising every time and never answering eagerly. Every
  test here leaves the launch counters as it found them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import model as jax_model
from repro_torch import convert
from repro_torch.configs import dlrm_paper, get_config, reduce_for_smoke
from repro_torch.data.synthetic import dlrm_batches
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.models import attention as attn_mod
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import model as model_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.dlrm_engine import DLRMEngine
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.executor import StageExecutor, StaticStage

TOL = 2e-3
MAX_LEN, C = 40, 8


@pytest.fixture(autouse=True)
def _restore_launch_counters(monkeypatch):
    """Every kernel wrapper's launch counter is module-global, and the
    stub stages below raise them: pin each to its value before the test,
    so teardown puts it back and no later test in the process sees the
    launches this file pretended to make."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


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


def _random_caches(jcfg, batch, seed):
    """A JAX cache tree of ``batch`` rows filled with seeded values (int8
    values and positive fp16 scales for an int8 cache), as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax_model.init_caches(jcfg, batch, MAX_LEN))[0]:
        shape, dt = leaf.shape, np.dtype(leaf.dtype)
        if dt == np.int8:
            val = rng.integers(-127, 128, shape).astype(np.int8)
        elif dt == np.float16:
            val = rng.uniform(0.005, 0.05, shape).astype(np.float16)
        else:
            val = rng.standard_normal(shape).astype(dt)
        out[jax.tree_util.keystr(path)] = val
    tree = jax_model.init_caches(jcfg, batch, MAX_LEN)
    return jax.tree_util.tree_map_with_path(
        lambda p, _: out[jax.tree_util.keystr(p)], tree)


def _pair(smoke, cache):
    jcfg, cfg, jparams, params = smoke
    if cache == "int8":
        jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
    return jcfg, cfg, jparams, params


def _clone(caches):
    return [{k: t.clone() for k, t in c.items()} for c in caches]


def _assert_caches(got, want, cfg, where, int8):
    """``got`` (port caches) against ``want`` (a JAX cache tree) on the
    (row, position) mask ``where``: int8 bit for bit, fp within 2e-3."""
    back = jax.tree_util.tree_flatten_with_path(
        convert.caches_to_jax(got, cfg))[0]
    for (path, g), w in zip(back, jax.tree.leaves(want)):
        w = np.asarray(w)
        if int8:
            assert np.array_equal(g[:, where], w[:, where]), path
        else:
            np.testing.assert_allclose(g[:, where], w[:, where], rtol=TOL,
                                       atol=TOL, err_msg=str(path))


# ---- decode with inactive rows ---------------------------------------------

@pytest.mark.parametrize("cache", ["fp", "int8"])
def test_decode_guard_matches_jax(smoke, cache):
    """Rows 1 and 3 inactive (row 3 parked at max_len - 1, as the engine
    parks free slots): the active rows against JAX, the inactive rows'
    cache untouched, with ``active`` a device bool tensor as the decode
    stage's buffer holds it."""
    jcfg, cfg, jparams, params = _pair(smoke, cache)
    jcaches = _random_caches(jcfg, 4, seed=1)
    caches = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                     "cpu")
    before = _clone(caches)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)
    pos = np.array([17, 5, 0, MAX_LEN - 1], np.int32)
    active = np.array([True, False, True, False])
    hj, jc2 = jax_model.decode_step(jparams, jcfg, jnp.asarray(toks),
                                    jcaches, jnp.asarray(pos),
                                    active=jnp.asarray(active))
    with torch.inference_mode():
        h, caches = model_mod.decode_step(
            params, cfg, torch.from_numpy(toks), caches,
            torch.from_numpy(pos), active=torch.from_numpy(active))
    np.testing.assert_allclose(h.numpy()[active], np.asarray(hj)[active],
                               rtol=TOL, atol=TOL)
    written = np.zeros((4, MAX_LEN), bool)
    written[np.flatnonzero(active), pos[active]] = True
    _assert_caches(caches, jc2, cfg, written, cache == "int8")
    for layer, old in zip(caches, before):
        for name, t in layer.items():
            assert torch.equal(t[~torch.from_numpy(active)],
                               old[name][~torch.from_numpy(active)]), name
            unwritten = ~torch.from_numpy(written)
            assert torch.equal(t[unwritten], old[name][unwritten]), name


# ---- fixed-shape writes ----------------------------------------------------

@pytest.mark.parametrize("cache", ["fp", "int8"])
def test_prefill_group_padded_to_four_writes_the_real_rows(smoke, cache):
    """A group of 3 on 5 slots padded to P = 4 (the padded row -1) against
    the same call with the padded row sent to the spare slot 3: slots 4, 0
    and 2 bit for bit, slots 1 and 3 and every position past the bucket
    untouched; the written rows match JAX prefill within 2e-3 (fp)."""
    jcfg, cfg, jparams, params = _pair(smoke, cache)
    bucket = 16
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (4, bucket)).astype(np.int32)
    lens = np.array([16, 9, 3, 1])
    valid = torch.from_numpy(np.arange(bucket)[None, :] < lens[:, None])
    base = convert.caches_from_jax(
        jax.tree.map(np.asarray, _random_caches(jcfg, 5, seed=5)), cfg, "cpu")
    got, ref = _clone(base), _clone(base)
    with torch.inference_mode():
        for caches, rows in ((got, [4, 0, 2, -1]), (ref, [4, 0, 2, 3])):
            model_mod.forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                              mode="prefill", caches=caches, kv_valid=valid,
                              cache_rows=torch.tensor(rows))
    for g, r, b in zip(got, ref, base):
        for name in g:
            assert torch.equal(g[name][[4, 0, 2]], r[name][[4, 0, 2]]), name
            assert torch.equal(g[name][[1, 3]], b[name][[1, 3]]), name
            assert torch.equal(g[name][:, bucket:], b[name][:, bucket:]), name
    if cache == "fp":
        _, jc = jax_model.forward(
            jparams, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
            caches=jax_model.init_caches(jcfg, 4, MAX_LEN),
            kv_valid=jnp.asarray(valid.numpy()))[:2]
        real = np.zeros((4, MAX_LEN), bool)
        real[:3, :bucket] = valid.numpy()[:3]
        mine = [{k: t[[4, 0, 2, 1]] for k, t in c.items()} for c in got]
        _assert_caches(mine, jc, cfg, real, False)


# slots, start, write_pos, lengths of a group of 3 padded to 4: a full
# chunk, a chunk crossing max_len (positions 35..42 of 40), a short chunk,
# and the padded row (repeating slots[0], lengths 0, write_pos max_len)
CHUNK_CALL = ([1, 2, 0, 1], [0, 35, 8, 0], [0, 35, 8, MAX_LEN], [8, 8, 5, 0])


def _real_only(cc, slots, wpos, lengths):
    """``cc`` with the write reduced to the real tokens: the variable-length
    write that the fixed-shape one replaces."""
    j, i = np.nonzero(np.arange(C)[None, :] < np.asarray(lengths)[:, None])
    keep = np.asarray(wpos)[j] + i < MAX_LEN
    j, i = j[keep], i[keep]
    return dataclasses.replace(
        cc, write_rows=torch.tensor(np.asarray(slots)[j]),
        write_pos=torch.tensor(np.asarray(wpos)[j] + i),
        src=torch.tensor(j * C + i))


@pytest.mark.parametrize("cache", ["fp", "int8"])
def test_chunk_fixed_write_equals_the_real_tokens_write(smoke, cache):
    jcfg, cfg, jparams, params = _pair(smoke, cache)
    slots, start, wpos, lengths = CHUNK_CALL
    jcaches = _random_caches(jcfg, 3, seed=6)
    base = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                   "cpu")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, C)).astype(np.int32)
    arrays, dequant = attn_mod.chunk_writes(slots, start, wpos, lengths, C,
                                            MAX_LEN, 3)
    assert all(a.shape == (4 * C,) for k, a in arrays.items()
               if k in ("write_rows", "write_pos", "src"))
    cc = attn_mod.chunk_coords({k: torch.from_numpy(a)
                                for k, a in arrays.items()}, C, dequant)
    got, ref = _clone(base), _clone(base)
    with torch.inference_mode():
        h, _ = model_mod.forward(params, cfg, {"tokens": torch.from_numpy(
            toks)}, mode="chunk", caches=got, chunk=cc)
        model_mod.forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                          mode="chunk", caches=ref,
                          chunk=_real_only(cc, slots, wpos, lengths))
    for g, r in zip(got, ref):
        for name in g:
            assert torch.equal(g[name], r[name]), name
    hj, jc = jax_model.chunk_prefill_step(
        jparams, jcfg, jnp.asarray(toks), jcaches,
        *(jnp.asarray(a, jnp.int32) for a in CHUNK_CALL))
    real = np.arange(C)[None, :] < np.asarray(lengths)[:, None]
    np.testing.assert_allclose(h.numpy()[real], np.asarray(hj)[real],
                               rtol=TOL, atol=TOL)
    written = np.zeros((3, MAX_LEN), bool)
    for s, w, n in zip(slots, wpos, lengths):
        written[s, w:min(w + n, MAX_LEN)] = True
    _assert_caches(got, jc, cfg, written, cache == "int8")
    for g, b in zip(got, base):
        for name in g:
            assert torch.equal(g[name][~torch.from_numpy(written)],
                               b[name][~torch.from_numpy(written)]), name


def test_chunk_writes_refuses_bad_slots_and_empty_calls():
    with pytest.raises(ValueError, match="outside the cache"):
        attn_mod.chunk_writes([3], [0], [0], [C], C, MAX_LEN, 3)
    with pytest.raises(ValueError, match="at least one token"):
        attn_mod.chunk_writes([0, 0], [0, 0], [MAX_LEN, MAX_LEN], [0, 8], C,
                              MAX_LEN, 3)


# ---- the capture proxy -----------------------------------------------------

BANNED = {"aten.nonzero.default", "aten._local_scalar_dense.default",
          "aten.masked_select.default", "aten.item.default"}


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    if isinstance(x, torch.ScriptObject):    # a handle, e.g. a profiler span's
        return ("ScriptObject", str(x._type()))
    return repr(x)


class _Recorder(TorchDispatchMode):
    """Records (op, argument signature, output signature) of every aten op,
    and the ops that would break or falsify a CUDA graph capture."""

    def __init__(self):
        super().__init__()
        self.ops, self.bad = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        self.ops.append((name, _sig(args), _sig(kwargs), _sig(out)))
        tensors = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        if name in BANNED:
            self.bad.append(name)
        if name.startswith(("aten.index.", "aten.index_put",
                            "aten._index_put")):
            idx = args[1] if len(args) > 1 else []
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                   for t in idx):
                self.bad.append(f"{name} with a boolean mask")
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if any(t.device.type != "cpu" for t in tensors) \
                and any(t.device.type == "cpu" for t in outs):
            self.bad.append(f"{name} to the host")
        return out


def _record(stage, inputs, variant=None):
    bufs = stage.buffers(variant)
    with torch.inference_mode():
        for k, v in inputs.items():
            bufs[k].copy_(torch.as_tensor(v))
        with _Recorder() as rec:
            stage.body(bufs, variant)
    return rec


def _chunk_inputs(eng, call, seed, bucket=C):
    slots, start, wpos, lengths = call
    arrays, dequant = attn_mod.chunk_writes(
        slots, start, wpos, lengths, bucket, eng.max_len, eng.batch_slots)
    rng = np.random.default_rng(seed)
    return dict(arrays, tokens=rng.integers(
        0, eng.cfg.vocab_size, (len(slots), bucket)).astype(np.int32),
        last_idx=np.maximum(np.asarray(lengths, np.int32) - 1, 0)), dequant


def _lm_stage_cases(cfg, params):
    eng = InferenceEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                          prefill_buckets=(8, 16), device="cpu")
    rng = np.random.default_rng(8)
    toks = lambda *s: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
    decode = [{"tokens": toks(4, 1), "pos": np.array([3, 9, 0, 39], np.int32),
               "active": np.array([True, True, False, False])},
              {"tokens": toks(4, 1), "pos": np.array([39, 1, 20, 7], np.int32),
               "active": np.array([False, True, True, True])}]
    prefill = [{"tokens": toks(4, 16), "lengths": np.array([16, 3, 9, 1],
                                                            np.int32),
                "rows": np.array([2, 0, 3, 1])},
               {"tokens": toks(4, 16), "lengths": np.array([5, 12, 7, 1],
                                                            np.int32),
                "rows": np.array([1, 3, 0, -1])}]
    calls = [([1, 2, 0, 1], [0, 16, 8, 0], [0, 16, 8, MAX_LEN], [8, 8, 5, 0]),
             ([3, 0, 2, 1], [24, 0, 32, 8], [24, 0, 32, 8], [8, 2, 8, 7])]
    chunk = [_chunk_inputs(eng, c, seed=i) for i, c in enumerate(calls)]
    assert chunk[0][1] == chunk[1][1]          # one variant
    return [("decode", eng._build_decode(), decode, None),
            ("prefill", eng._build_prefill(16, 4), prefill, None),
            ("chunk", eng._build_chunk(C, 4), [c[0] for c in chunk],
             chunk[0][1])]


@pytest.fixture(scope="module")
def stage_cases(smoke):
    cfg, params = smoke[1], smoke[3]
    cases = _lm_stage_cases(cfg, params)
    name, stage, inputs, variant = _lm_stage_cases(_int8_kv(cfg), params)[2]
    cases.append(("chunk int8", stage, inputs, variant))
    dcfg = dlrm_paper.reduce_for_smoke(dlrm_paper.PAPER_COMPLEX)
    asn = dlrm_mod.make_assignment(dcfg, 1)
    deng = DLRMEngine(dcfg, asn, dlrm_mod.init_dlrm(
        dcfg, asn, torch.Generator().manual_seed(0), "cpu", quantize=True),
        device="cpu")
    dense = []
    for seed in (0, 1):
        b = next(dlrm_batches(dcfg, 6, seed=seed))
        pooled = dlrm_mod.sls_forward(
            deng.params, dcfg, asn, torch.from_numpy(b["indices"]),
            torch.from_numpy(b["lengths"]))
        dense.append({"pooled": pooled, "dense_x": b["dense"]})
    cases.append(("dense", deng._build_dense(), dense, 6))
    return cases


@pytest.mark.parametrize("which", ["decode", "prefill", "chunk",
                                   "chunk int8", "dense"])
def test_stage_static_form_is_capturable(stage_cases, which):
    name, stage, inputs, variant = next(c for c in stage_cases
                                        if c[0] == which)
    _record(stage, inputs[0], variant)       # the executor's warm-up
    first, second = (_record(stage, x, variant) for x in inputs)
    assert first.ops, name
    assert not first.bad and not second.bad, (first.bad, second.bad)
    assert [o[0] for o in first.ops] == [o[0] for o in second.ops]
    assert first.ops == second.ops


# ---- the executor's bookkeeping --------------------------------------------

class _StubGraph:
    """What ``executor.capture`` returns, on the CPU: a replay recomputes
    the body into the static output and, like a graph, runs no Python, so
    it moves no launch counter."""

    def __init__(self, body, out):
        self.body, self.out, self.replays = body, out, 0

    def replay(self):
        saved = executor_mod._counts()
        self.out.copy_(self.body())
        executor_mod._add_counts(tuple(
            b - a for a, b in zip(executor_mod._counts(), saved)))
        self.replays += 1

    def pool(self):
        return "pool of the first graph"


def _counting_stage(built):
    """A static stage whose body 'launches' flash twice and decode once."""
    built.append(1)

    def body(b, variant):
        flash_attn.launches += 2
        decode_attn.launches += 1
        return b["x"] * (2 if variant is None else variant)

    return StaticStage(lambda v: {"x": torch.zeros(3)}, body)


def test_executor_replays_count_what_the_capture_saw(monkeypatch):
    pools = []

    def stub(body, pool):
        pools.append(pool)
        out = body()
        return _StubGraph(body, out), out

    monkeypatch.setattr(executor_mod, "capture", stub)
    ex = StageExecutor(graphs=True)
    built = []
    f0, d0 = flash_attn.launches, decode_attn.launches
    for i in range(4):
        x = np.arange(3, dtype=np.float32) + i
        out = ex.dispatch("s", ("k",), lambda: _counting_stage(built),
                          {"x": x})
        np.testing.assert_array_equal(out, 2 * x)
        assert flash_attn.launches - f0 == 2 * (i + 1)
        assert decode_attn.launches - d0 == i + 1
    out = ex.dispatch("s", ("k",), lambda: _counting_stage(built),
                      {"x": np.ones(3, np.float32)}, variant=5)
    np.testing.assert_array_equal(out, 5 * np.ones(3))
    assert flash_attn.launches - f0 == 10 and decode_attn.launches - d0 == 5
    assert len(built) == 1 and ex.compiles_for("s") == 1
    assert ex.cached_keys() == [("s", ("k",))]
    assert ex.captures["s"] == 2 and ex.replays["s"] == 3
    assert set(ex.capture_s) == {"s"} and ex.capture_s["s"] >= 0
    assert pools == [None, "pool of the first graph"]
    with pytest.raises(ValueError, match="shape"):
        ex.dispatch("s", ("k",), lambda: _counting_stage(built),
                    {"x": np.ones(4, np.float32)})


def test_executor_capture_failure_raises_every_call(monkeypatch):
    def failing(body, pool):
        body()
        raise RuntimeError("capture failed")

    monkeypatch.setattr(executor_mod, "capture", failing)
    ex = StageExecutor(graphs=True)
    built = []
    f0 = flash_attn.launches
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            ex.dispatch("s", ("k",), lambda: _counting_stage(built),
                        {"x": np.ones(3, np.float32)})
    # each call's warm-up ran (and counts); the failed captures count nothing
    assert flash_attn.launches - f0 == 4
    assert len(built) == 1 and ex.captures["s"] == 0 \
        and ex.replays["s"] == 0


def test_executor_without_graphs_runs_the_body_every_call(monkeypatch):
    def never(body, pool):
        raise AssertionError("captured with graphs off")

    monkeypatch.setattr(executor_mod, "capture", never)
    ex = StageExecutor(graphs=False)
    built = []
    for i in range(3):
        out = ex.dispatch("s", (), lambda: _counting_stage(built),
                          {"x": np.full(3, i, np.float32)})
        np.testing.assert_array_equal(out, np.full(3, 2 * i))
    assert len(built) == 1 and not ex.captures and not ex.replays


def test_engines_graph_only_on_the_card(smoke):
    cfg, params = smoke[1], smoke[3]
    assert not InferenceEngine(cfg, params, device="cpu").executor.graphs

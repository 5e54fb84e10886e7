"""dbrx-132b's mixture of experts in the port against the JAX package, on
the CPU.

Reduced dbrx-132b (``reduce_for_smoke``: 2 global layers of d_model 64, 4
heads over 4 kv heads of 16, 4 experts top-2 of d_expert 32, vocab 256,
f32), reduced kimi-k2 (4 experts padded to 512) and a cut with one shared
expert, with the JAX package's weights carried across by
``repro_torch.convert`` and inputs drawn with numpy from fixed seeds:

- ``_capacity``, ``_route`` (indices exactly; weights and the aux loss
  within 2e-3) and ``_dispatch_indices`` (slots and keep mask bit for bit,
  on ids full of ties, over one shard and two, and over 512 padded
  experts);
- ``moe_apply`` against the reference's ``moe_apply`` without a mesh
  within 2e-3 in f32, at capacity factor 1.25 (some entries dropped) and
  16, padded experts, a shared expert; one bf16 case by relative error
  2e-2;
- the model's prefill and 6 decode steps at capacity factor 16 (no drop,
  so the batch's composition does not matter), its chunk calls, and a
  prefill at 1.25 on the reference's shapes, drops included;
- parameters carried across and back with the padded experts and the
  shared one;
- the engine at capacity factor 16: chunked (8, 16) == monolithic, a
  prefix hit == cold, snapshot -> restore, paging and migration, and the
  stages through the CPU capture proxy of ``test_torch_graphs.py``;
- the w8a8 build's sites (the reference's ``_collect_sites``: attention
  alone, no ``moe`` leaf), the launcher, and the card's layers check
  (``chip_smoke.check_moe_layers``) on the host at a small width with its
  planted faults.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import quantize as jax_quantize
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import MoEConfig
from repro_torch.core.quantization import QuantDense
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request
from test_torch_graphs import _record
from test_torch_recurrentgemma import (LENS, MAX_LEN, _chunk_calls, _leaves,
                                       _np, _run_checked,
                                       _shared_prefix_trace, _trace)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-3                     # f32, elementwise
REL_TOL = 2e-2                 # bf16, ||got - want|| / ||want||
KW = dict(batch_slots=3, max_len=MAX_LEN, prefill_buckets=(8, 16, 32))
NO_DROP = 16.0                 # a capacity factor at which nothing drops


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _configs(arch="dbrx-132b", factor=1.25, **kw):
    """(JAX config, port config): ``arch`` through ``reduce_for_smoke`` at
    capacity factor ``factor``, with ``kw`` (``moe`` a dict of MoEConfig
    fields to change) replaced on both."""
    moe = kw.pop("moe", {})
    jc = jax_reduce(jax_get_config(arch))
    c = reduce_for_smoke(get_config(arch))
    jm = dataclasses.replace(jc.moe, capacity_factor=factor, **moe)
    jc = dataclasses.replace(jc, moe=jm, **kw)
    c = dataclasses.replace(c, moe=MoEConfig(**dataclasses.asdict(jm)), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(c)
    return jc, c


# the moe_apply cases: (arch, capacity factor, config changes)
CASES = {"dbrx-drops": ("dbrx-132b", 1.25, {}),
         "dbrx-no-drop": ("dbrx-132b", NO_DROP, {}),
         "kimi-padded": ("kimi-k2-1t-a32b", 1.25, {}),
         "shared-expert": ("dbrx-132b", 1.25,
                           {"moe": {"num_shared_experts": 1}}),
         "dbrx-bf16": ("dbrx-132b", 1.25,
                       {"param_dtype": "bfloat16",
                        "activation_dtype": "bfloat16"})}


def _moe_pair(case):
    """(JAX config, port config, the JAX MoE leaves, the port's MoE)."""
    arch, factor, kw = CASES[case]
    jc, c = _configs(arch, factor, **dict(kw))
    jp = jax_moe.init_moe(jc, jax.random.PRNGKey(3))
    p = moe_mod.MoE(c, torch.Generator(), "cpu")
    flat = convert._flatten(jax.tree.map(np.asarray, jp), "", {})
    p.load_state_dict({k: convert._to_torch(v) for k, v in flat.items()})
    return jc, c, jp, p


def _x(d, shape, seed, dtype="float32"):
    """Tokens about one shared direction (the router then favours a few
    experts, as on real text, and a capacity factor of 1.25 drops)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (d,)) + 2.0 * rng.standard_normal(d)
    x = x.astype(np.float32)
    return x, jnp.asarray(x, jnp.dtype(dtype))


def _close(got, want, dtype="float32", err=""):
    """Elementwise within 2e-3 in f32; by relative error 2e-2 in bf16."""
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=err)
        return
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert rel <= REL_TOL, (err, rel)


# ---- the pieces against repro/models/moe.py ---------------------------------

@pytest.mark.parametrize("T", [1, 3, 4, 12, 64])
def test_capacity_matches_jax(T):
    """Reduced dbrx, its kimi-k2 cut and full dbrx: the capacity of a call
    of T tokens, the floor of min(4, T k) included."""
    for jc, c in (_configs(), _configs("kimi-k2-1t-a32b"),
                  (jax_get_config("dbrx-132b"), get_config("dbrx-132b"))):
        assert moe_mod._capacity(T, c) == jax_moe._capacity(T, jc)
    full = get_config("dbrx-132b")
    assert moe_mod._capacity(4, full) == 4            # decode at 4 slots
    assert moe_mod._capacity(4 * 4096, full) == 5120  # a 4 x 4096 prefill


def test_route_matches_jax():
    """24 tokens through reduced dbrx's router: the top-2 ids exactly, the
    renormalised weights and the switch aux loss within 2e-3."""
    jc, c, jp, p = _moe_pair("dbrx-drops")
    x, jx = _x(c.d_model, (24,), seed=1)
    idx_j, w_j, aux_j = jax_moe._route(jx, jp["router"], jc)
    idx, w, aux = moe_mod._route(torch.from_numpy(x), p.router, c)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(w, w_j, err="weights")
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)
    _close(aux, aux_j, err="aux")


@pytest.mark.parametrize("n,E,E_local,C,ES", [
    (48, 4, 4, 12, 1), (200, 8, 4, 10, 2), (64, 4, 512, 3, 1)],
    ids=["one-shard", "two-shards", "padded"])
def test_dispatch_indices_bitwise(n, E, E_local, C, ES):
    """Slots and keep mask equal the reference's bit for bit: on ids drawn
    with many ties (the stable sort keeps entry order, so the first C of
    each expert are kept), over two shards, and over 512 padded experts."""
    e = np.random.default_rng(n).integers(0, E, n).astype(np.int32)
    slot_j, keep_j = jax_moe._dispatch_indices(jnp.asarray(e), E_local, C,
                                               ES)
    slot, keep = moe_mod._dispatch_indices(torch.from_numpy(e).long(),
                                           E_local, C, ES)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert (~keep).any() and keep.any()
    for x in range(E):                  # first come, first served
        kept = np.flatnonzero(e == x)[:C]
        assert keep.numpy()[kept].all()


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case):
    """2 x 24 tokens through ``moe_apply`` on both sides: the output
    (within 2e-3 in f32, by relative error 2e-2 in bf16) and the aux loss.
    At capacity factor 1.25 some entries are dropped (asserted, so the
    drop path runs); at 16 none."""
    jc, c, jp, p = _moe_pair(case)
    dtype = c.param_dtype
    x, jx = _x(c.d_model, (2, 24), seed=2, dtype=dtype)
    yj, aux_j = jax_moe.moe_apply(jp, jx, jc)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.inference_mode():
        y, aux = moe_mod.moe_apply(p, xt, c)
        idx, _, _ = moe_mod._route(xt.reshape(48, -1), p.router, c)
        _, keep = moe_mod._dispatch_indices(
            idx.reshape(-1), c.moe.padded_experts,
            moe_mod._capacity(48, c), 1)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    assert bool((~keep).any()) == (c.moe.capacity_factor == 1.25)
    _close(y, yj, dtype, "out")
    _close(aux, aux_j, err="aux")


# ---- weights ----------------------------------------------------------------

def _smoke(arch="dbrx-132b", factor=NO_DROP, **kw):
    jc, c = _configs(arch, factor, **kw)
    jparams = jax_model.init_params(jc, jax.random.PRNGKey(0))
    return jc, c, jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), c, "cpu")


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


@pytest.mark.parametrize("arch,kw", [
    ("kimi-k2-1t-a32b", {}),
    ("dbrx-132b", {"moe": {"num_shared_experts": 1}})],
    ids=["padded-experts", "shared-expert"])
def test_params_carry_across_and_back(arch, kw):
    """A block holds ``moe`` in place of ``mlp``: the port's leaves are the
    reference's (the padded experts' rows, the shared expert's MLP), and
    the round trip is bit for bit."""
    jc, c, jparams, params = _smoke(arch, **kw)
    names = set(dict(params.layers[0].named_parameters()))
    assert {"moe.router", "moe.wg", "moe.wu", "moe.wd"} <= names
    assert not any(n.startswith("mlp.") for n in names)
    Ep = c.moe.padded_experts
    assert params.layers[0].moe.wg.shape == (Ep, c.d_model, c.moe.d_expert)
    assert params.layers[0].moe.router.shape == (c.d_model,
                                                 c.moe.num_experts)
    assert params.layers[0].moe.router.dtype == torch.float32
    if c.moe.num_shared_experts:
        assert params.layers[0].moe.shared.w_down.shape == (
            c.moe.d_expert, c.d_model)
    assert sum(p.numel() for p in params.parameters()) \
        == sum(x.size for x in jax.tree.leaves(jparams))
    back = _leaves(convert.params_to_jax(params, c))
    want = _leaves(jax.tree.map(np.asarray, jparams))
    assert [p for p, _ in back] == [p for p, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(back, want))


def test_full_width_and_the_cut():
    """dbrx-132b at its published widths: 131.6 B parameters (263.2 GB in
    bf16); the 8-layer cut ``chip_smoke.py`` serves: 27.31 B (54.6 GB),
    per layer 88.08 M attention and 3.171 B expert parameters."""
    full = get_config("dbrx-132b")
    model_mod.check_supported(full)
    cut = dataclasses.replace(full, num_layers=8)
    meta = model_mod.Model(cut, None, "meta")
    layer = dict(meta.layers[0].named_parameters())
    attn = sum(t.numel() for n, t in layer.items() if n.startswith("attn."))
    experts = sum(layer[f"moe.{w}"].numel() for w in ("wg", "wu", "wd"))
    assert (attn, experts) == (88_080_384, 3_170_893_824)
    n = sum(t.numel() for t in meta.parameters())
    assert round(n / 1e9, 2) == 27.31 and round(2 * n / 1e9, 1) == 54.6
    assert (full.num_heads // full.num_kv_heads, full.head_dim) == (6, 128)


# ---- the whole model against the JAX model ---------------------------------

B = 3
_jit = lambda fn, *static: jax.jit(fn, static_argnames=static)
jax_forward = _jit(jax_model.forward, "cfg", "mode")
jax_chunk_prefill_step = _jit(jax_model.chunk_prefill_step, "cfg")
jax_decode_step = _jit(jax_model.decode_step, "cfg")


def _prompts(vocab, S=20, lens=(20, 13, 1)):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return tokens, np.arange(S)[None, :] < np.asarray(lens)[:, None]


def _assert_caches(got, jcaches, cfg, filled=None):
    """Every cache against the JAX one; with ``filled`` (a length per cache
    row), positions 0..filled-1 of each row (a chunk call writes its whole
    chunk, pads included, where the reference writes its real tokens: no
    query reads past a row's length)."""
    want = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                   "cpu")
    for l, (g, w) in enumerate(zip(got, want)):
        for name in g:
            rows = range(g[name].shape[0]) if filled is None else \
                range(len(filled))
            for r in rows:
                n = None if filled is None else filled[r]
                _close(g[name][r, :n], _np(w[name][r, :n]),
                       err=f"layer {l} {name} row {r}")


def _prefill(smoke, tokens, valid):
    jcfg, cfg, jparams, params = smoke
    hj, jcaches = jax_forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jcfg, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]
    with torch.inference_mode():
        h, caches = model_mod.forward(
            params, cfg, {"tokens": torch.from_numpy(tokens)},
            mode="prefill", caches=model_mod.init_caches(cfg, B, MAX_LEN,
                                                         "cpu"),
            kv_valid=torch.from_numpy(valid))
    return hj, jcaches, h, caches


def test_model_prefill_and_decode_match_jax(smoke):
    """Capacity factor 16: a prefill of 3 right-padded rows, then 6 decode
    steps with row 2 inactive on odd steps: hidden states at the real
    tokens and every cache."""
    jcfg, cfg, jparams, params = smoke
    tokens, valid = _prompts(cfg.vocab_size)
    hj, jcaches, h, caches = _prefill(smoke, tokens, valid)
    _close(_np(h)[valid], np.asarray(hj)[valid], err="prefill")
    _assert_caches(caches, jcaches, cfg)
    rng = np.random.default_rng(1)
    pos = valid.sum(-1).astype(np.int32)
    for step in range(6):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        active = np.array([True, True, step % 2 == 0])
        hj, jcaches = jax_decode_step(
            jparams, jcfg, jnp.asarray(tok), jcaches, jnp.asarray(pos),
            active=jnp.asarray(active))
        with torch.inference_mode():
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(tok), caches,
                torch.from_numpy(pos), active=active)
        _close(_np(h)[active], np.asarray(hj)[active], err=f"step {step}")
        pos = pos + active
    _assert_caches(caches, jcaches, cfg)


def test_model_prefill_with_drops_matches_jax(monkeypatch):
    """Capacity factor 1.25 on the reference's shapes: every token of the
    call routes, pads included, so the same drops happen on both sides
    (counted here: some must)."""
    smoke = _smoke(factor=1.25)
    dropped = []
    real = moe_mod._dispatch_indices

    def counting(*args):
        slot, keep = real(*args)
        dropped.append(int((~keep).sum()))
        return slot, keep
    monkeypatch.setattr(moe_mod, "_dispatch_indices", counting)
    tokens, valid = _prompts(smoke[1].vocab_size)
    hj, jcaches, h, caches = _prefill(smoke, tokens, valid)
    assert len(dropped) == smoke[1].num_layers and sum(dropped) > 0, dropped
    _close(_np(h)[valid], np.asarray(hj)[valid], err="prefill")
    _assert_caches(caches, jcaches, smoke[1])


@pytest.mark.parametrize("C", [8, 16])
def test_chunk_calls_match_jax_chunk_prefill(smoke, C):
    """Prompts of 37, 21 and 9 tokens prefilled C at a time (3 padded to 4
    group rows while all run) against the JAX package's
    ``chunk_prefill_step``: the real tokens' hidden states and the K/V of
    the positions written so far after every call."""
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 21, 9)]
    jcaches = jax_model.init_caches(jcfg, 3, MAX_LEN)
    caches = model_mod.init_caches(cfg, 3, MAX_LEN, "cpu")
    filled = [0] * 3
    for slots, start, wpos, lens in _chunk_calls([len(p) for p in prompts],
                                                 C):
        toks = np.zeros((len(slots), C), np.int32)
        for j, (s, n) in enumerate(zip(slots, lens)):
            toks[j, :n] = prompts[s][start[j]:start[j] + n]
        hj, jcaches = jax_chunk_prefill_step(
            jparams, jcfg, jnp.asarray(toks), jcaches,
            *(jnp.asarray(a) for a in (slots, start, wpos, lens)))
        with torch.inference_mode():
            h, caches = model_mod.chunk_prefill_step(
                params, cfg, torch.from_numpy(toks), caches, slots, start,
                wpos, lens)
        real = np.arange(C)[None, :] < lens[:, None]
        _close(_np(h)[real], np.asarray(hj)[real])
        for s, a, n in zip(slots, start, lens):
            filled[s] = max(filled[s], a + n)
        _assert_caches(caches, jcaches, cfg, filled)


# ---- the engine at capacity factor 16 -----------------------------------------

def test_chunked_prefill_token_identical_to_monolithic(smoke):
    cfg, params = smoke[1], smoke[3]
    mono = InferenceEngine(cfg, params, device="cpu", **KW)
    ref = _trace(Request, cfg.vocab_size)
    mono.run(ref)
    for chunk in (8, 16):
        eng = InferenceEngine(cfg, params, prefill_chunk=chunk,
                              device="cpu", **KW)
        got = eng.run(_trace(Request, cfg.vocab_size))
        assert [r.output for r in got] == [r.output for r in ref], chunk
        assert eng.telemetry.continuations > 0
        assert all(r.done and len(r.output) == 4 for r in got)


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


def test_snapshot_restore_is_the_identity(smoke):
    """A 30-token prefix's K/V rows: a restore into another slot and a
    second hop give the same rows bit for bit."""
    cfg, params = smoke[1], smoke[3]
    eng = InferenceEngine(cfg, params, device="cpu", **KW)
    eng.run(_trace(Request, cfg.vocab_size, seed=7, lens=(30, 9, 5), new=1))
    src = eng.snapshot_slot(0, 30)
    eng.restore_slot(src, 2)
    for a, b in zip(src.leaves, eng.snapshot_slot(2, 30).leaves):
        assert all(torch.equal(a[k], b[k]) for k in a)
    eng.restore_slot(eng.snapshot_slot(2, 30), 1)
    for a, b in zip(src.leaves, eng.snapshot_slot(1, 30).leaves):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_paging_serves_like_more_slots(smoke):
    """A 2-slot chunked engine with host paging serves 6 sessions
    token-identical to a 6-slot engine, every page-out faulted back in."""
    cfg, params = smoke[1], smoke[3]
    kw = dict(KW, prefill_chunk=8)
    ref = _run_checked(InferenceEngine(cfg, params, device="cpu",
                                       **dict(kw, batch_slots=6)),
                       _trace(Request, cfg.vocab_size, seed=9))
    eng = InferenceEngine(cfg, params, page_host=True, device="cpu",
                          **dict(kw, batch_slots=2))
    got = _run_checked(eng, _trace(Request, cfg.vocab_size, seed=9))
    tel = eng.telemetry
    assert tel.served == len(LENS)
    assert tel.paged_out > 0 and tel.paged_in == tel.paged_out
    assert got == ref


def test_mid_prefill_migration_serves_like_no_migration(smoke):
    """Mid-prefill continuations leave with their snapshots after one
    chunk and resume on a thief; outputs match an unmigrated engine."""
    cfg, params = smoke[1], smoke[3]
    kw = dict(KW, prefill_chunk=8)
    lens = (40, 38, 36, 30, 33, 12)
    ref = _run_checked(InferenceEngine(cfg, params, device="cpu", **kw),
                       _trace(Request, cfg.vocab_size, lens=lens))
    victim, thief = (InferenceEngine(cfg, params, device="cpu", **kw)
                     for _ in range(2))
    got = _trace(Request, cfg.vocab_size, lens=lens)
    for r in got:
        victim.submit(r)
    victim.step_once()
    stolen = victim.scheduler.steal_pending(
        3, eligible=victim.migration_eligible, include_continuations=True)
    assert stolen
    for t in stolen:
        thief.adopt_prefill(t, victim.export_prefill(t))
    thief.scheduler.absorb(stolen, record=False)
    while victim.has_work or thief.has_work:
        for eng in (victim, thief):
            if eng.has_work:
                eng.step_once()
            eng.states.check_partition()
    assert thief.telemetry.migrated == len(stolen)
    assert [r.output for r in got] == ref


def test_moe_stages_are_capturable(smoke):
    """Prefill (a padded group row), chunk (a padded row) and decode
    (inactive rows) of the dbrx engine: two calls of each run the same
    aten ops on the same shapes (the MoE's sort, searchsorted and index
    copies fixed by the call's T), none of them a host sync, a
    boolean-mask index or a copy to the host."""
    cfg, params = smoke[1], smoke[3]
    eng = InferenceEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                          prefill_buckets=(16,), device="cpu")
    rng = np.random.default_rng(8)
    toks = lambda *s: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
    chunk = []
    for slots, start, wpos, lengths in (
            ([1, 2, 0, 1], [0, 16, 8, 0], [0, 16, 8, MAX_LEN], [8, 8, 5, 0]),
            ([3, 0, 2, 1], [24, 0, 32, 8], [24, 0, 32, 8], [8, 2, 8, 7])):
        arrays, _ = attn_mod.chunk_writes(slots, start, wpos, lengths, 8,
                                          eng._global_len, 4)
        chunk.append(dict(arrays, tokens=toks(4, 8), last_idx=np.maximum(
            np.asarray(lengths, np.int32) - 1, 0)))
    cases = [
        (eng._build_decode(), [
            {"tokens": toks(4, 1), "pos": np.array([3, 9, 0, 39], np.int32),
             "active": np.array([True, True, False, False])},
            {"tokens": toks(4, 1), "pos": np.array([39, 1, 20, 7], np.int32),
             "active": np.array([False, True, True, True])}]),
        (eng._build_prefill(16, 4), [
            {"tokens": toks(4, 16), "lengths": np.array([16, 3, 9, 1],
                                                        np.int32),
             "rows": np.array([2, 0, 3, 1])},
            {"tokens": toks(4, 16), "lengths": np.array([5, 12, 7, 1],
                                                        np.int32),
             "rows": np.array([1, 3, 0, -1])}]),
        (eng._build_chunk(8, 4), chunk)]
    for stage, inputs in cases:
        _record(stage, inputs[0])                   # the warm-up
        first, second = (_record(stage, x) for x in inputs)
        assert first.ops and not first.bad and not second.bad, \
            (first.bad, second.bad)
        assert first.ops == second.ops
        assert any("sort" in op[0] for op in first.ops)


# ---- the w8a8 build and the launcher -----------------------------------------

def test_build_quantizes_the_attention_sites_alone(smoke):
    """The reference's skip-list: ``QUANT_SITES`` has no ``moe``, so the
    sites are the attention projections, named and counted as the JAX
    package's ``_collect_sites`` names them, and no MoE leaf is
    quantized; the w8a8 engine serves every request."""
    jcfg, cfg, jparams, params = smoke
    want = jax_quantize._collect_sites(jparams)
    got = quantize_mod._collect_sites(params, cfg)
    assert sorted(got) == sorted(want) == [
        f"scan0.attn.{w}" for w in ("wk", "wo", "wq", "wv")]
    qp = quantize_mod.build_quantized_params(cfg, params)
    assert qp.quantized_sites + qp.fallback_sites == 4
    for layer in qp.params.layers:
        assert not any(isinstance(m, QuantDense)
                       for m in layer.moe.modules())
    reqs = InferenceEngine(cfg, params, precision="w8a8",
                           quantized_params=qp, device="cpu", **KW).run(
        _trace(Request, cfg.vocab_size))
    assert all(r.done and len(r.output) == 4 for r in reqs)


@pytest.mark.parametrize("extra,expect", [
    ((), "served 4 requests"),
    (("--precision", "w8a8"), "4 sites int8")], ids=["plain", "w8a8"])
def test_serve_launcher_dbrx_on_cpu(extra, expect, capsys):
    serve_mod.main(["--arch", "dbrx-132b", "--smoke", "--device", "cpu",
                    "--requests", "4", "--new-tokens", "3", *extra])
    assert expect in capsys.readouterr().out


def test_full_config_is_refused_before_allocating(monkeypatch):
    """264 GB of weights: ``SystemExit`` names the bytes and the card's
    memory before any weight or kernel exists."""
    def no(*a, **k):
        raise AssertionError("allocated before refusing")
    monkeypatch.setattr(model_mod, "init_params", no)
    monkeypatch.setattr(serve_mod._build, "build_all", no)
    with pytest.raises(SystemExit, match=r"263\.2 GB in bfloat16, past the "
                                         r"card's 80\.0 GB.*serve-dbrx"):
        serve_mod.main(["--arch", "dbrx-132b", "--full-config", "--device",
                        "cpu"])


# ---- the card's layers check, on the host -----------------------------------

@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_layers_check_holds_and_sees_the_planted_faults(chip_smoke,
                                                        monkeypatch, capsys):
    """``check_moe_layers`` on the host, both sides on the plain versions:
    2 bf16 layers of d_model 256 (12 heads over 2 kv heads of 64, 16
    experts top-4 of 512, capacity factor 1.25) on prompts of 1, 65, 200
    and 300 tokens: the worst token within its bound, entries dropped, each
    planted fault past the bound."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = chip_smoke.reduce_dbrx("bfloat16")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    chip_smoke.draw_norms(params, seed=3)
    chip_smoke.check_moe_layers("check-layers", cfg, params,
                                lens=(1, 65, 200, 300))
    line = capsys.readouterr().out
    got = float(line.split("worst token ")[1].split()[0])
    dropped = float(line.split("dropped ")[1].split()[0].rstrip("%;,"))
    faults = [float(line.split(f"{name} ")[1].split()[0].rstrip(";,"))
              for name in chip_smoke.MOE_FAULTS.values()]
    assert got <= chip_smoke.MOE_LAYERS_TOL < min(faults), (got, faults)
    assert dropped > 0

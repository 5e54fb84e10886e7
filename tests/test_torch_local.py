"""The port's local (sliding-window) attention against the JAX package's,
on the CPU.

Reduced gemma2-27b (``reduce_for_smoke`` at 4 layers: local, global,
local, global; window 8, both logit softcaps, sandwich norms, the
embedding multiplier; f32) with the JAX package's initial weights carried
across by ``repro_torch.convert``, and prompts longer than the window, so
every ring wraps. Hidden states of the real tokens agree within 2e-3 (f32
math on both sides; the port's attention goes through its kernels' plain
versions); fp rings and the written prefix of global rows within 2e-3,
int8 caches bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro_torch import convert
from repro_torch.configs import ATTN_GLOBAL, ATTN_LOCAL, get_config, \
    reduce_for_smoke
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.serving import executor as executor_mod

TOL = 2e-3
B, S, MAX_LEN = 3, 20, 48
LENS = np.array([20, 13, 5])          # right-padded rows: two past window 8


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


def _configs(int8=False):
    jcfg = dataclasses.replace(jax_reduce(jax_get_config("gemma2-27b")),
                               num_layers=4)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma2-27b")),
                              num_layers=4)
    return (_int8_kv(jcfg), _int8_kv(cfg)) if int8 else (jcfg, cfg)


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = _configs()
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, cfg, jparams, params


def _with(smoke, int8):
    jcfg, cfg, jparams, params = smoke
    return (_int8_kv(jcfg), _int8_kv(cfg)) if int8 else (jcfg, cfg)


def _prompts():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    return tokens, np.arange(S)[None, :] < LENS[:, None]


def _written(cfg, done):
    """Per layer, the (row, position-or-slot) mask of the cache a
    comparison reads: a ring whole, a global row up to ``done[row]``."""
    out = []
    for kind in cfg.layer_kinds():
        slots = attn_mod.cache_slots(cfg, MAX_LEN, kind)
        if kind == ATTN_LOCAL:
            out.append(np.ones((len(done), slots), bool))
        else:
            out.append(np.arange(slots)[None, :]
                       < np.asarray(done)[:, None])
    return out


def _assert_caches(got, jcaches, cfg, done, exact):
    want = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                   "cpu")
    for g, w, mask in zip(got, want, _written(cfg, done)):
        m = torch.from_numpy(mask)
        for name in g:
            assert g[name].shape == w[name].shape, name
            if exact:
                assert torch.equal(g[name][m], w[name][m]), name
            else:
                np.testing.assert_allclose(g[name][m].float().numpy(),
                                           w[name][m].float().numpy(),
                                           rtol=TOL, atol=TOL)


def test_config_equals_the_reference_field_for_field():
    assert dataclasses.asdict(jax_get_config("gemma2-27b")) \
        == dataclasses.asdict(get_config("gemma2-27b"))
    jcfg, cfg = _configs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.layer_kinds() == (ATTN_LOCAL, ATTN_GLOBAL) * 2
    assert cfg.window_size == 8 and cfg.attn_logit_softcap == 50.0
    model_mod.check_supported(get_config("gemma2-27b"))


@pytest.mark.parametrize("seed", range(4))
def test_ring_newest_positions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    win = int(rng.integers(1, 40))
    last = rng.integers(-3, 200, 16).astype(np.int32)
    want = np.asarray(jax_attn._ring_newest_positions(jnp.asarray(last),
                                                      win))
    got = attn_mod._ring_newest_positions(torch.from_numpy(last), win)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["chunked_jnp", "flash_pallas"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_prefill_hidden_and_rings_match_jax(smoke, impl, int8):
    """Prefill past the window: the hidden states of the real tokens, the
    rings (written whole: slot r the newest real position p = r mod 8, 0
    where none was written) and the global rows' real positions."""
    jcfg, cfg = _with(smoke, int8)
    jparams, params = smoke[2], smoke[3]
    tokens, valid = _prompts()
    jc = dataclasses.replace(jcfg, attention_impl=impl)
    hj, cj = jax_model.forward(
        jparams, jc, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jc, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]
    with torch.inference_mode():
        h, caches = model_mod.forward(
            params, cfg, {"tokens": torch.from_numpy(tokens)},
            mode="prefill", caches=model_mod.init_caches(cfg, B, MAX_LEN,
                                                         "cpu"),
            kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(h.numpy()[valid], np.asarray(hj)[valid],
                               rtol=TOL, atol=TOL)
    assert [c["k"].shape[1] for c in caches] == [8, MAX_LEN] * 2
    _assert_caches(caches, cj, cfg, LENS, exact=int8)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_decode_past_the_window_matches_jax(smoke, int8):
    """Decode steps that wrap every ring, with a row inactive on odd steps:
    hidden states and caches as the JAX model's, and the inactive row's
    rings and rows bit for bit as they were."""
    jcfg, cfg = _with(smoke, int8)
    jparams, params = smoke[2], smoke[3]
    tokens, valid = _prompts()
    _, jcaches = jax_model.forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jcfg, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]
    caches = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                     "cpu")
    rng = np.random.default_rng(1)
    pos = LENS.astype(np.int32)
    for step in range(11):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        active = np.array([True, True, step % 2 == 0])
        before = [{k: t[2].clone() for k, t in c.items()} for c in caches]
        hj, jcaches, _ = jax_model.forward(
            jparams, jcfg, {"tokens": jnp.asarray(tok)}, mode="decode",
            caches=jcaches, pos=jnp.asarray(pos),
            active=jnp.asarray(active))
        with torch.inference_mode():
            h, caches = model_mod.forward(
                params, cfg, {"tokens": torch.from_numpy(tok)},
                mode="decode", caches=caches, pos=torch.from_numpy(pos),
                active=active)
        np.testing.assert_allclose(h.numpy()[active], np.asarray(hj)[active],
                                   rtol=TOL, atol=TOL)
        if not active[2]:
            for c, old in zip(caches, before):
                for k, t in c.items():
                    assert torch.equal(t[2], old[k]), k
        pos = pos + active
    _assert_caches(caches, jcaches, cfg, pos, exact=int8)


def _chunk_calls(lengths, C):
    """The engine's chunk calls for prompts of ``lengths`` at chunk C, all
    rows in every call until each is done: (slots, start, write_pos,
    lengths) host arrays per call, padded to a power of two with repeats of
    the first slot at write_pos max_len and no tokens."""
    done = [0] * len(lengths)
    while any(d < n for d, n in zip(done, lengths)):
        rows = [j for j, n in enumerate(lengths) if done[j] < n]
        P = 1 << (len(rows) - 1).bit_length()
        slots = np.array(rows + [rows[0]] * (P - len(rows)), np.int32)
        start = np.zeros(P, np.int32)
        wpos = np.full(P, MAX_LEN, np.int32)
        lens = np.zeros(P, np.int32)
        for j, r in enumerate(rows):
            start[j] = wpos[j] = done[r]
            lens[j] = min(C, lengths[r] - done[r])
            done[r] += lens[j]
        yield slots, start, wpos, lens, list(done)


@pytest.mark.parametrize("C", [4, 8, 16])
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_chunk_calls_match_jax_chunk_prefill(smoke, C, int8):
    """Prompts of 37, 21 and 9 tokens prefilled C at a time (C 16 > window
    8: one chunk evicts its own first keys from the ring) against the JAX
    package's ``chunk_prefill_step`` from the same caches: the real
    tokens' hidden states, and after every call the rings whole and the
    global rows' written prefixes."""
    jcfg, cfg = _with(smoke, int8)
    jparams, params = smoke[2], smoke[3]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 21, 9)]
    jcaches = jax_model.init_caches(jcfg, 3, MAX_LEN)
    caches = model_mod.init_caches(cfg, 3, MAX_LEN, "cpu")
    pos = [0, 0, 0]
    for slots, start, wpos, lens, done in _chunk_calls(
            [len(p) for p in prompts], C):
        toks = np.zeros((len(slots), C), np.int32)
        for j, (s, n) in enumerate(zip(slots, lens)):
            toks[j, :n] = prompts[s][start[j]:start[j] + n]
        hj, jcaches = jax_model.chunk_prefill_step(
            jparams, jcfg, jnp.asarray(toks), jcaches,
            *(jnp.asarray(a) for a in (slots, start, wpos, lens)))
        with torch.inference_mode():
            h, caches = model_mod.chunk_prefill_step(
                params, cfg, torch.from_numpy(toks), caches, slots, start,
                wpos, lens)
        real = np.arange(C)[None, :] < lens[:, None]
        np.testing.assert_allclose(h.numpy()[real], np.asarray(hj)[real],
                                   rtol=TOL, atol=TOL)
        pos = done
        _assert_caches(caches, jcaches, cfg, pos, exact=int8)


def test_ring_writes_keep_each_slots_last_real_write():
    """C 16 over a ring of 8: only the last 8 real tokens of a row are
    kept, padded and superseded entries repeat the first kept write, and
    the reads put the pre-chunk ring in position order."""
    arrays, _ = attn_mod.chunk_writes(
        [2, 0, 2, 2], [5, 16, 0, 0], [5, 16, MAX_LEN, MAX_LEN],
        [16, 3, 0, 0], 16, MAX_LEN, 3, ring=8)
    keep = np.zeros(64, bool)
    keep[8:16] = True                       # row 0: tokens 8..15
    keep[16:19] = True                      # row 1: its 3 tokens
    assert np.array_equal(arrays["ring_src"][keep], np.flatnonzero(keep))
    assert (arrays["ring_src"][~keep] == 8).all()
    assert sorted(arrays["ring_pos"][8:16]) == list(range(8))
    assert arrays["ring_pos"][8] == (5 + 8) % 8
    assert list(arrays["ring_pos"][16:19]) == [0, 1, 2]
    assert list(arrays["ring_n"]) == [5, 8, 0, 0]
    assert list(arrays["ring_lens"]) == [21, 11, 0, 0]
    assert list(arrays["ring_idx"][0, :5]) == [0, 1, 2, 3, 4]
    assert list(arrays["ring_idx"][1]) == [0, 1, 2, 3, 4, 5, 6, 7]
    arrays, _ = attn_mod.chunk_writes([1], [13], [13], [2], 4, MAX_LEN, 3,
                                      ring=8)
    assert list(arrays["ring_idx"][0]) == [5, 6, 7, 0, 1, 2, 3, 4]

"""mamba2-130m serving in the port against the JAX package, on the CPU.

Reduced mamba2-130m (``reduce_for_smoke``: ssm layers of d_model 64,
d_inner 128 in 8 SSD heads of 16, d_state 16, d_conv 4, SSD chunk 32,
tied embeddings, vocab 256; f32) and one bf16 cut at the published SSM
dims (d_state 128, heads of 64, chunk 256) over 2 layers of d_model 128,
with the JAX package's initial weights carried across by
``repro_torch.convert`` and the leaves that init leaves at 0 or 1
(``A_log``, ``D``, ``dt_bias``, ``conv_b``, ``norm_scale``, the norms'
scales) drawn nonzero, so that a port that dropped one still fails:

- the mixer's pieces against ``repro/models/ssm.py`` within 2e-3: the SSD
  scan at 1, 2 and 4 chunks, the sequence form with and without ``valid``
  and the state and conv tail it returns, the chunk step (a first chunk
  over a stale row, a continuation, a padded group row that writes
  nothing), the decode step with ``active`` (frozen rows bit for bit),
  and decode stepped over a sequence against the sequence form;
- parameters and caches carry across and back bit for bit, the f32
  leaves of a bf16 model;
- the whole model's prefill and 6 decode steps, and its chunk calls,
  against the JAX model (the bf16 cut by relative error 2e-2); the
  engine's greedy tokens against the JAX engine's;
- within the port: chunked (8, 16) == monolithic tokens, prefix hit ==
  cold, snapshot -> restore bit for bit with the state moved whole, host
  paging and mid-prefill migration against unpaged and unmigrated
  engines, and the stages through the CPU capture proxy of
  ``test_torch_graphs.py``;
- the w8a8 build's zero sites (``tests/test_quantization.py``'s no-op),
  the launcher, and the card's block check (``chip_smoke.check_ssm_block``)
  on the host at a small width with its planted faults.
"""
import dataclasses
import importlib.util
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
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.core.metrics import token_agreement
from repro.models import model as jax_model
from repro.models import quantize as jax_quantize
from repro.models import ssm as jax_ssm
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import SSM, get_config, reduce_for_smoke
from repro_torch.configs.base import SSMConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request
from test_torch_graphs import _record
from test_torch_recurrentgemma import (LENS, _chunk_calls, _leaves, _np,
                                       _run_checked, _shared_prefix_trace,
                                       _trace)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-3                     # f32, elementwise
REL_TOL = 2e-2                 # bf16, ||got - want|| / ||want||
KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48))
B, MAX_LEN = 3, 80
ROW_LENS = np.array([64, 41, 1])      # right-padded rows

# the leaves init leaves at 0 or 1, drawn in every comparison
DRAWN = ("A_log", "D", "dt_bias", "conv_b", "norm_scale", "scale")


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _configs(num_layers=3, **kw):
    kw = dict(num_layers=num_layers, **kw)
    jkw = dict(kw)
    if "ssm" in kw:
        jkw["ssm"] = JaxSSMConfig(**dataclasses.asdict(kw["ssm"]))
    return (dataclasses.replace(jax_reduce(jax_get_config("mamba2-130m")),
                                **jkw),
            dataclasses.replace(reduce_for_smoke(get_config("mamba2-130m")),
                                **kw))


def _bf16_configs():
    """2 layers of d_model 128 at the published SSM dims, bf16: d_inner
    256 in 4 heads of 64, d_state 128, chunk 256."""
    return _configs(num_layers=2, d_model=128,
                    ssm=SSMConfig(d_state=128, head_dim=64, chunk_size=256),
                    param_dtype="bfloat16", activation_dtype="bfloat16")


def _draw(jparams, seed):
    """The JAX tree with ``DRAWN`` leaves drawn from a seeded generator:
    ``A_log`` so that A lies in [1, 16] (Mamba2's init range), ``dt_bias``
    so that softplus(dt_bias) lies in about [0.02, 0.3], ``D`` about 1,
    the rest about 0."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = path[-1].key
        if name not in DRAWN:
            return a
        if name == "A_log":
            v = rng.uniform(0.0, np.log(16.0), a.shape)
        elif name == "dt_bias":
            v = rng.uniform(-4.0, -1.0, a.shape)
        elif name == "D":
            v = 1.0 + 0.5 * rng.standard_normal(a.shape)
        else:
            v = 0.3 * rng.standard_normal(a.shape)
        return jnp.asarray(v.astype(np.float32), a.dtype)
    return jax.tree_util.tree_map_with_path(draw, jparams)


def _carry(jcfg, cfg, jparams):
    return jcfg, cfg, jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = _configs()
    return _carry(jcfg, cfg, _draw(jax_model.init_params(
        jcfg, jax.random.PRNGKey(0)), seed=1))


@pytest.fixture(scope="module")
def smoke_bf16():
    jcfg, cfg = _bf16_configs()
    return _carry(jcfg, cfg, _draw(jax_model.init_params(
        jcfg, jax.random.PRNGKey(0)), seed=2))


def _pair(request, dtype):
    return request.getfixturevalue("smoke" if dtype == "float32"
                                   else "smoke_bf16")


# the JAX functions compiled whole
_jit = lambda fn, *static: jax.jit(fn, static_argnames=static)
jax_ssd_chunked = _jit(jax_ssm.ssd_chunked, "chunk")
jax_ssm_forward = _jit(jax_ssm.ssm_forward, "cfg", "return_state")
jax_ssm_chunk_step = _jit(jax_ssm.ssm_chunk_step, "cfg")
jax_ssm_decode_step = _jit(jax_ssm.ssm_decode_step, "cfg")
jax_forward = _jit(jax_model.forward, "cfg", "mode")
jax_chunk_prefill_step = _jit(jax_model.chunk_prefill_step, "cfg")
jax_decode_step = _jit(jax_model.decode_step, "cfg")


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


# ---- the mixer's pieces against repro/models/ssm.py -----------------------

def _layer0(smoke):
    jcfg, cfg, jparams, params = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["scan"][0]["ssm"])
    return jcfg, cfg, jp, params.layers[0].ssm


def _x(cfg, shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,))
    return x.astype(np.float32)


def _state(jcfg, cfg, batch, seed):
    """An ssm layer's state of ``batch`` rows with seeded values, on both
    sides."""
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32), a.dtype),
        jax_ssm.init_ssm_cache(jcfg, batch))
    return jc, {k: convert._to_torch(np.asarray(v)) for k, v in jc.items()}


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_ssd_chunked_matches_jax(n_chunks):
    """The scan alone on seeded inputs (2 rows, 3 heads of 4, d_state 5,
    chunks of 8): y and the final state."""
    rng = np.random.default_rng(n_chunks)
    b, l, h, p, n = 2, 8 * n_chunks, 3, 4, 5
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dtA = -rng.uniform(0.0, 1.0, (b, l, h)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, l, n)).astype(np.float32)
              for _ in range(2))
    yj, fj = jax_ssd_chunked(*(jnp.asarray(a) for a in (x, dtA, Bm, Cm)),
                             chunk=8)
    y, final = ssm_mod.ssd_chunked(*(torch.from_numpy(a)
                                     for a in (x, dtA, Bm, Cm)), 8)
    assert final.dtype == torch.float32
    _close(y, yj, err="y")
    _close(final, fj, err="state")


@pytest.mark.parametrize("S", [64, 70], ids=["2-chunks", "one-chunk"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "valid"])
def test_ssm_forward_and_its_state_match_jax(smoke, S, ragged):
    """The sequence form over rows of 64, 41 and 1 real tokens (or all S):
    at S 64 in chunks of 32, at 70 as one chunk (the reference's choice);
    the output at the real tokens, and the exit state it writes: the SSD
    state after each row's last real token and the conv tail ending there
    (``xBC_raw_tail`` without ``valid``)."""
    jcfg, cfg, jp, p = _layer0(smoke)
    x = _x(cfg, (B, S), seed=1)
    valid = (np.arange(S)[None, :] < ROW_LENS[:, None]) if ragged else None
    yj, cj = jax_ssm_forward(
        jp, jnp.asarray(x), jcfg, return_state=True,
        valid=None if valid is None else jnp.asarray(valid))
    cache = ssm_mod.init_ssm_cache(cfg, B, "cpu")
    with torch.inference_mode():
        y = ssm_mod.ssm_forward(
            p, torch.from_numpy(x),
            valid=None if valid is None else torch.from_numpy(valid),
            cache=cache, rows=torch.arange(B))
    keep = valid if ragged else np.ones((B, S), bool)
    _close(_np(y)[keep], np.asarray(yj)[keep])
    assert cache["state"].dtype == torch.float32
    for name in ("state", "conv"):
        _close(cache[name], cj[name], err=name)


def test_ssm_chunk_step_matches_jax(smoke):
    """Two chunk calls of 4 group rows, C 8, from a state of seeded values
    (stale rows): first chunks of slots 0 and 2 (which must ignore what
    the rows held), a continuation of slot 1, and a padded group row
    (lengths 0, repeating slot 0) that writes nothing; then continuations
    of slots 0 and 2 and a first chunk of slot 3. Outputs at the real
    tokens, the whole state after each call, and the row no call names
    bit for bit as before."""
    jcfg, cfg, jp, p = _layer0(smoke)
    jc, cache = _state(jcfg, cfg, 5, seed=2)
    before = {k: t.clone() for k, t in cache.items()}
    C = 8
    calls = [([0, 2, 1, 0], [0, 0, 16, 0], [8, 5, 7, 0]),
             ([0, 2, 3, 2], [8, 5, 0, 5], [3, 8, 8, 0])]
    for i, (slots, start, lengths) in enumerate(calls):
        x = _x(cfg, (4, C), seed=10 + i)
        arrays = [np.asarray(a, np.int32) for a in (slots, start, start,
                                                    lengths)]
        yj, jc = jax_ssm_chunk_step(jp, jnp.asarray(x), jc, jcfg,
                                    tuple(jnp.asarray(a) for a in arrays))
        with torch.inference_mode():
            y = ssm_mod.ssm_chunk_step(
                p, torch.from_numpy(x), cache, *(torch.from_numpy(a) for a
                                                 in (arrays[0], arrays[1],
                                                     arrays[3])))
        real = np.arange(C)[None, :] < np.asarray(lengths)[:, None]
        _close(_np(y)[real], np.asarray(yj)[real])
        for name in ("state", "conv"):
            _close(cache[name], jc[name], err=name)
    assert all(torch.equal(cache[k][4], before[k][4]) for k in cache)


def test_ssm_decode_step_matches_jax_with_inactive_rows(smoke):
    """Five steps from a seeded state, row 1 inactive on odd steps and row
    2 never active: active rows as the JAX step's, inactive rows' state
    and conv tail bit for bit as they were."""
    jcfg, cfg, jp, p = _layer0(smoke)
    jc, cache = _state(jcfg, cfg, 3, seed=3)
    for step in range(5):
        x = _x(cfg, (3, 1), seed=20 + step)
        active = np.array([True, step % 2 == 0, False])
        before = {k: t.clone() for k, t in cache.items()}
        yj, jc = jax_ssm_decode_step(jp, jnp.asarray(x), jc, jcfg,
                                     active=jnp.asarray(active))
        with torch.inference_mode():
            y = ssm_mod.ssm_decode_step(p, torch.from_numpy(x), cache,
                                        active=torch.from_numpy(active))
        _close(_np(y)[active], np.asarray(yj)[active])
        for name in ("state", "conv"):
            _close(cache[name], jc[name], err=name)
            for r in np.flatnonzero(~active):
                assert torch.equal(cache[name][r], before[name][r])


def test_decode_steps_match_the_sequence_form(smoke):
    """The reference's recurrent identity on the port: 64 tokens (two
    32-token chunks) stepped one at a time from a zero state give the
    sequence form's outputs (1e-4 relative, 1e-5 absolute)."""
    _, cfg, _, p = _layer0(smoke)
    x = torch.from_numpy(_x(cfg, (2, 64), seed=4) * 0.5)
    with torch.inference_mode():
        want = ssm_mod.ssm_forward(p, x)
        cache = ssm_mod.init_ssm_cache(cfg, 2, "cpu")
        got = torch.cat([ssm_mod.ssm_decode_step(p, x[:, t:t + 1], cache)
                         for t in range(64)], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# ---- weights, caches and the build step -----------------------------------

def test_config_and_support():
    """The cuts are the reference's field for field (the config itself:
    ``test_torch_serving.py``); the published widths give 129.10 M
    parameters (the tied vocab padded to 50432) and 19.13 MB of state a
    slot; the model accepts it."""
    full = get_config("mamba2-130m")
    for jc, c in (_configs(), _bf16_configs()):
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
    model_mod.check_supported(full)
    assert full.layer_kinds() == (SSM,) * 24
    assert (full.ssm.d_inner(768), full.ssm.num_heads(768)) == (1536, 24)
    meta = model_mod.Model(full, None, "meta")
    assert sum(t.numel() for t in meta.parameters()) == 129_100_224
    assert meta.embed.shape == (50432, 768) and not hasattr(meta, "lm_head")
    state = model_mod.init_caches(full, 1, 32768, "meta")
    assert state[0]["state"].shape == (1, 24, 64, 128)
    assert state[0]["conv"].shape == (1, 3, 1792)
    assert sum(t.numel() * t.element_size() for c in state
               for t in c.values()) == 19_132_416


def test_params_and_caches_carry_across_and_back(smoke):
    """An ssm block holds its pre-norm and mixer alone (no MLP, no
    ``pre_mlp_norm``): the port's leaves are the reference's, and both
    round trips are bit for bit."""
    jcfg, cfg, jparams, params = smoke
    assert [l.kind for l in params.layers] == list(cfg.layer_kinds())
    assert set(dict(params.layers[0].named_parameters())) == {
        "pre_norm.scale", "ssm.in_proj", "ssm.conv_w", "ssm.conv_b",
        "ssm.A_log", "ssm.D", "ssm.dt_bias", "ssm.norm_scale",
        "ssm.out_proj"}
    assert sum(p.numel() for p in params.parameters()) \
        == sum(x.size for x in jax.tree.leaves(jparams))
    back = _leaves(convert.params_to_jax(params, cfg))
    want = _leaves(jax.tree.map(np.asarray, jparams))
    assert [p for p, _ in back] == [p for p, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(back, want))
    rng = np.random.default_rng(0)
    jc = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 50).astype(
        a.dtype), jax_model.init_caches(jcfg, 2, 32))
    port = convert.caches_from_jax(jax.tree.map(np.asarray, jc), cfg, "cpu")
    assert sorted(port[0]) == ["conv", "state"]
    assert port[0]["state"].shape == (2, 8, 16, 16) \
        and port[0]["conv"].shape == (2, 3, 160)
    got, ref = _leaves(convert.caches_to_jax(port, cfg)), _leaves(jc)
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(np.array_equal(g, np.asarray(w))
               for (_, g), (_, w) in zip(got, ref))


def test_bf16_params_keep_the_f32_leaves(smoke_bf16):
    """In a bf16 model ``A_log``, ``D`` and ``dt_bias`` stay f32, as the
    reference's (the port's seeded init too)."""
    jcfg, cfg, jparams, params = smoke_bf16
    want = jax.eval_shape(lambda: jax_model.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert [(p, a.dtype) for p, a in _leaves(jparams)] \
        == [(p, a.dtype) for p, a in _leaves(want)]
    for model in (params, model_mod.init_params(cfg, seed=0, device="cpu")):
        assert {n for n, t in model.layers[0].ssm.named_parameters()
                if t.dtype == torch.float32} == {"A_log", "D", "dt_bias"}


def test_build_step_has_no_site(smoke):
    """SSM mixers touch their weights directly, so the stack has zero
    dense-projection sites, as the JAX package's: the build decides
    nothing and a w8a8 engine serves the fp weights, token for token."""
    jcfg, cfg, jparams, params = smoke
    assert jax_quantize._collect_sites(jparams) == {}
    assert quantize_mod._collect_sites(params, cfg) == {}
    qp = quantize_mod.build_quantized_params(cfg, params)
    assert qp.quantized_sites == 0 and qp.fallback_sites == 0
    assert not qp.schemes
    assert all(torch.equal(a, b) for a, b in zip(qp.params.parameters(),
                                                 params.parameters()))
    want = InferenceEngine(cfg, params, device="cpu", **KW).run(
        _trace(Request, cfg.vocab_size))
    got = InferenceEngine(cfg, params, precision="w8a8", quantized_params=qp,
                          device="cpu", **KW).run(
        _trace(Request, cfg.vocab_size))
    assert [r.output for r in got] == [r.output for r in want]


# ---- the whole model against the JAX model ---------------------------------

def _prompts(vocab, S):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lens = np.minimum(ROW_LENS * S // 64, S)
    return tokens, np.arange(S)[None, :] < np.maximum(lens, 1)[:, None]


def _assert_caches(got, jcaches, cfg, dtype="float32"):
    want = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                   "cpu")
    for l, (g, w) in enumerate(zip(got, want)):
        for name in g:
            _close(g[name], _np(w[name]), dtype, f"layer {l} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_prefill_and_decode_match_jax(request, dtype):
    """A prefill of 3 right-padded rows (f32: S 64, two 32-token chunks;
    the bf16 cut: S 512, two 256-token chunks), then 6 decode steps with
    row 2 inactive on odd steps: hidden states at the real tokens and
    every cache after the prefill and at the end; the inactive row's
    state bit for bit as it was."""
    jcfg, cfg, jparams, params = _pair(request, dtype)
    S = 64 if dtype == "float32" else 512
    tokens, valid = _prompts(cfg.vocab_size, S)
    hj, jcaches = jax_forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jcfg, B, S + 8),
        kv_valid=jnp.asarray(valid))[:2]
    with torch.inference_mode():
        h, caches = model_mod.forward(
            params, cfg, {"tokens": torch.from_numpy(tokens)},
            mode="prefill", caches=model_mod.init_caches(cfg, B, S + 8,
                                                         "cpu"),
            kv_valid=torch.from_numpy(valid))
    _close(_np(h)[valid], np.asarray(hj, np.float32)[valid], dtype,
           "prefill")
    _assert_caches(caches, jcaches, cfg, dtype)
    rng = np.random.default_rng(1)
    pos = valid.sum(-1).astype(np.int32)
    for step in range(6):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        active = np.array([True, True, step % 2 == 0])
        before = [{k: t[2].clone() for k, t in c.items()} for c in caches]
        hj, jcaches = jax_decode_step(
            jparams, jcfg, jnp.asarray(tok), jcaches, jnp.asarray(pos),
            active=jnp.asarray(active))
        with torch.inference_mode():
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(tok), caches,
                torch.from_numpy(pos), active=active)
        _close(_np(h)[active], np.asarray(hj, np.float32)[active], dtype,
               f"step {step}")
        if not active[2]:
            for c, old in zip(caches, before):
                assert all(torch.equal(t[2], old[k]) for k, t in c.items())
        pos = pos + active
    _assert_caches(caches, jcaches, cfg, dtype)


def test_model_full_matches_jax(smoke):
    jcfg, cfg, jparams, params = smoke
    tokens, _ = _prompts(cfg.vocab_size, 64)
    hj = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})[0]
    with torch.inference_mode():
        h, _ = model_mod.forward(params, cfg, {
            "tokens": torch.from_numpy(tokens)}, mode="full", caches=None)
    _close(h, hj)


@pytest.mark.parametrize("C", [8, 16])
def test_chunk_calls_match_jax_chunk_prefill(smoke, C):
    """Prompts of 37, 21 and 9 tokens prefilled C at a time against the
    JAX package's ``chunk_prefill_step`` from the same caches (3 padded to
    4 rows while all run): the real tokens' hidden states and every cache
    after every call. The model has no attention layer, so nothing bounds
    a chunk's writes (``cache_extents`` (None, None))."""
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 21, 9)]
    jcaches = jax_model.init_caches(jcfg, 3, MAX_LEN)
    caches = model_mod.init_caches(cfg, 3, MAX_LEN, "cpu")
    assert model_mod.cache_extents(cfg, caches) == (None, None)
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
        _assert_caches(caches, jcaches, cfg)


# ---- the engine ---------------------------------------------------------------

def test_engine_agrees_with_the_jax_engine(smoke):
    """The same trace through both engines (>= 0.95; identical expected),
    every request served."""
    jcfg, cfg, jparams, params = smoke
    jreqs = JaxEngine(jcfg, jparams, **KW).run(
        _trace(JaxRequest, cfg.vocab_size))
    reqs = InferenceEngine(cfg, params, device="cpu", **KW).run(
        _trace(Request, cfg.vocab_size))
    agreement = token_agreement([(r.output, j.output)
                                 for r, j in zip(reqs, jreqs)])
    print(f"greedy-token agreement with the JAX engine: {agreement:.4f}")
    assert agreement >= 0.95
    assert all(r.done and len(r.output) == 4 for r in reqs)


def test_chunked_prefill_token_identical_to_monolithic(smoke):
    """The JAX package's stateful chunked-prefill acceptance (its ``ssm``
    arch) on the port: chunks 8 and 16 against monolithic prefill, two
    trace seeds, on seed-0 and on drawn weights."""
    cfg = reduce_for_smoke(get_config("mamba2-130m"))
    for params in (model_mod.init_params(cfg, seed=0, device="cpu"),
                   smoke[3]):
        c = cfg if params is not smoke[3] else smoke[1]
        mono = InferenceEngine(c, params, device="cpu", **KW)
        chunked = {n: InferenceEngine(c, params, prefill_chunk=n,
                                      device="cpu", **KW) for n in (8, 16)}
        for seed in (5, 11):
            ref = _trace(Request, c.vocab_size, seed=seed)
            mono.run(ref)
            for chunk, eng in chunked.items():
                before = eng.telemetry.continuations
                got = _trace(Request, c.vocab_size, seed=seed)
                eng.run(got)
                for a, b in zip(got, ref):
                    assert a.output == b.output, (seed, chunk, a.rid)
                assert eng.telemetry.continuations > before
                assert all(r.done for r in got)


def test_engine_flags_and_extents(smoke):
    """No layer's state is positional (the reference's
    ``_cache_seq_axes``: -1 for ``state`` and ``conv``), none is an int8
    K/V cache, and no chunk bound exists."""
    cfg, params = smoke[1], smoke[3]
    eng = InferenceEngine(cfg, params, device="cpu", **KW)
    assert eng._positional == [False] * cfg.num_layers
    assert not eng._int8_kv
    assert (eng._global_len, eng._ring) == (None, None)


def test_snapshot_moves_the_state_whole(smoke):
    """A 30-token prefix: ``state`` and the conv tail ship whole, the bytes
    are the JAX engine's (no length slice), a restore into another slot
    and a second hop give the same rows bit for bit."""
    jcfg, cfg, jparams, params = smoke
    eng = InferenceEngine(cfg, params, device="cpu", **KW)
    jeng = JaxEngine(jcfg, jparams, **KW)
    for e, cls in ((eng, Request), (jeng, JaxRequest)):
        e.run(_trace(cls, cfg.vocab_size, seed=7, lens=(30, 9, 5), new=1))
    src, jsrc = eng.snapshot_slot(0, 30), jeng.snapshot_slot(0, 30)
    assert (src.bytes_partial, src.bytes_full) == (jsrc.bytes_partial,
                                                   jsrc.bytes_full)
    assert src.bytes_partial == src.bytes_full
    for leaf in src.leaves:
        assert leaf["state"].shape == (8, 16, 16) \
            and leaf["conv"].shape == (3, 160)
    eng.restore_slot(src, 2)
    for a, b in zip(src.leaves, eng.snapshot_slot(2, 30).leaves):
        assert all(torch.equal(a[k], b[k]) for k in a)
    eng.restore_slot(eng.snapshot_slot(2, 30), 1)
    for a, b in zip(src.leaves, eng.snapshot_slot(1, 30).leaves):
        assert all(torch.equal(a[k], b[k]) for k in a)


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


def test_paging_moves_the_state_and_serves_like_more_slots(smoke):
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


def test_mid_prefill_migration_carries_the_state(smoke):
    """The router's migration round by hand: mid-prefill continuations
    leave with their snapshots after one chunk, the thief restores them
    and resumes the recurrence from the carried state and conv tail;
    outputs match an unmigrated engine."""
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


def test_ssm_stages_are_capturable(smoke):
    """Prefill (a padded group row; buckets of 16 and 64, one and two SSD
    chunks), chunk (first chunks, continuations, a padded row) and decode
    (inactive rows) of the mamba2 engine: two calls of each run the same
    aten ops on the same shapes, none of them a host sync, a boolean-mask
    index or a copy to the host."""
    cfg, params = smoke[1], smoke[3]
    eng = InferenceEngine(cfg, params, batch_slots=4, max_len=MAX_LEN,
                          prefill_buckets=(16, 64), device="cpu")
    rng = np.random.default_rng(8)
    toks = lambda *s: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
    calls = [([1, 2, 0, 1], [0, 16, 8, 0], [0, 16, 8, MAX_LEN],
              [16, 8, 5, 0]),
             ([3, 0, 2, 1], [24, 0, 32, 8], [24, 0, 32, 8], [16, 2, 9, 7])]
    chunk = []
    for slots, start, wpos, lengths in calls:
        arrays, _ = attn_mod.chunk_writes(slots, start, wpos, lengths, 16,
                                          eng._global_len, 4)
        chunk.append(dict(arrays, tokens=toks(4, 16), last_idx=np.maximum(
            np.asarray(lengths, np.int32) - 1, 0)))
    prefill = lambda S: [
        {"tokens": toks(4, S), "lengths": np.array([S, 3, 9, 1], np.int32),
         "rows": np.array([2, 0, 3, 1])},
        {"tokens": toks(4, S), "lengths": np.array([5, S - 4, 7, 1],
                                                   np.int32),
         "rows": np.array([1, 3, 0, -1])}]
    cases = [
        (eng._build_decode(), [
            {"tokens": toks(4, 1), "pos": np.array([3, 9, 0, 39], np.int32),
             "active": np.array([True, True, False, False])},
            {"tokens": toks(4, 1), "pos": np.array([39, 1, 20, 7], np.int32),
             "active": np.array([False, True, True, True])}]),
        (eng._build_prefill(16, 4), prefill(16)),
        (eng._build_prefill(64, 4), prefill(64)),
        (eng._build_chunk(16, 4), chunk)]
    for stage, inputs in cases:
        _record(stage, inputs[0])                   # the warm-up
        first, second = (_record(stage, x) for x in inputs)
        assert first.ops and not first.bad and not second.bad, \
            (first.bad, second.bad)
        assert first.ops == second.ops


# ---- the launcher and the card's block check -------------------------------

@pytest.mark.parametrize("extra,expect", [
    ((), "served 4 requests"),
    (("--prefill-chunk", "8", "--verify-chunked"),
     "verify-chunked OK: 4 requests"),
    (("--prefill-chunk", "8", "--prefix-cache", "8", "--verify-prefix"),
     "verify-prefix OK"),
    (("--precision", "w8a8", "--verify-quant"), "(0 sites int8, 0 fp")],
    ids=["plain", "chunked", "prefix", "w8a8"])
def test_serve_launcher_mamba2_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-130m", "--smoke", "--device", "cpu", "--requests", "4",
         "--new-tokens", "3", *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_block_check_holds_and_sees_the_planted_faults(chip_smoke,
                                                       monkeypatch, capsys):
    """The card's check of the first ssm layers, run on the host with both
    sides on the plain versions, at d_model 256, the published SSM dims
    and 2 layers: the bf16 side within its bound of the f32 side, each
    planted fault past it."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = dataclasses.replace(get_config("mamba2-130m"), num_layers=2,
                              d_model=256, vocab_size=4096)
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    chip_smoke.draw_ssm(params, seed=3)
    chip_smoke.check_ssm_block("check-block", cfg, params, layers=2,
                               lens=(300, 257, 40, 1), steps=4, chunk=256)
    line = capsys.readouterr().out
    got = float(line.split("layers add ")[1].split()[0])
    faults = [float(line.split(f"{name} ")[1].split()[0].rstrip(";,"))
              for name in chip_smoke.SSM_FAULTS.values()]
    assert got <= chip_smoke.SSM_BLOCK_TOL < min(faults), (got, faults)

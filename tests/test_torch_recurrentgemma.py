"""recurrentgemma-9b serving in the port against the JAX package, on the CPU.

Reduced recurrentgemma-9b (``reduce_for_smoke`` at 5 layers: recurrent,
recurrent, local, then the (recurrent, recurrent) tail; d_model 64,
lru_width 64 in 8 gate blocks, d_conv 4, 4 heads over 1 kv head, window 8,
GeGLU, the embedding multiplier, tied embeddings; f32, and bf16 where
named) with the JAX package's initial weights carried across by
``repro_torch.convert``:

- the RG-LRU's pieces against ``repro/models/rglru.py`` within 2e-3 (bf16
  2e-2): the sequence form with and without ``valid`` and the state it
  returns, the chunk step (a first chunk over a stale row, a continuation,
  a padded group row that writes nothing), the decode step with
  ``active``, the causal conv with its carry and ``tail_at_lengths``, and
  the gate's tanh GELU pinned;
- parameters and caches carry across and back bit for bit;
- the whole model's full, prefill, chunk and decode hidden states and
  caches; the engine's greedy tokens against the JAX engine's (>= 0.95);
  the build step's sites as the JAX package's, and a w8a8 + int8-KV
  chunked engine against its monolithic twin;
- within the port: chunked == monolithic (the JAX package's
  ``rglru`` and ``hybrid-rec-rec-local`` configs and the 5-layer cut),
  prefix hit == cold, snapshot -> restore bit for bit with the recurrent
  state moved whole (max_len below and above the window), host paging
  and mid-prefill migration against unpaged and unmigrated engines, and
  the stages through the CPU capture proxy of ``test_torch_graphs.py``;
- the engine's per-layer flags and ``cache_extents`` over recurrent
  layers, the refusals that still stand, the launcher, and the card
  check of one full-width unit (``chip_smoke.check_recurrent_block``) on
  the host at a small width with its planted faults.
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
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core.metrics import token_agreement
from repro.models import common as jax_common
from repro.models import model as jax_model
from repro.models import quantize as jax_quantize
from repro.models import rglru as jax_rglru
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import RECURRENT, get_config, reduce_for_smoke
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as common_mod
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request
from test_torch_graphs import _record

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48))
LENS = (40, 5, 9, 30, 3, 12)          # the JAX package's stateful trace
B, S, MAX_LEN = 3, 20, 48
ROW_LENS = np.array([20, 13, 1])      # right-padded rows


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


def _configs(dtype="float32", num_layers=5):
    kw = dict(num_layers=num_layers, param_dtype=dtype,
              activation_dtype=dtype)
    return (dataclasses.replace(jax_reduce(jax_get_config(
                "recurrentgemma-9b")), **kw),
            dataclasses.replace(reduce_for_smoke(get_config(
                "recurrentgemma-9b")), **kw))


def _carry(jcfg, cfg, jparams):
    return jcfg, cfg, jparams, convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = _configs()
    return _carry(jcfg, cfg, jax_model.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))


# the leaves the reference keeps f32 in a bf16 model
F32_LEAVES = ("ba", "bx", "a_param")


@pytest.fixture(scope="module")
def smoke_bf16(smoke):
    """The bf16 model of the same key: the JAX init draws in f32 and casts
    every leaf but ``F32_LEAVES``, so the f32 weights cast are its bf16
    weights (held in ``test_bf16_params_keep_the_f32_leaves``)."""
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in F32_LEAVES
        else a.astype(jnp.bfloat16), smoke[2])
    return _carry(*_configs("bfloat16"), jparams)


@pytest.fixture(scope="module")
def build(smoke):
    """The port's w8a8 build step of the 5-layer cut, int8 KV."""
    cfg, params = smoke[1], smoke[3]
    calib = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return quantize_mod.build_quantized_params(
        _int8_kv(cfg), params, calib_tokens=torch.from_numpy(calib))


def _pair(request, dtype):
    return request.getfixturevalue("smoke" if dtype == "float32"
                                   else "smoke_bf16")


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


# the JAX functions compiled whole (op by op, the scan alone compiles
# hundreds of small programs)
_jit = lambda fn, *static: jax.jit(fn, static_argnames=static)
jax_rglru_forward = _jit(jax_rglru.rglru_forward, "cfg", "return_state")
jax_rglru_chunk_step = _jit(jax_rglru.rglru_chunk_step, "cfg")
jax_rglru_decode_step = _jit(jax_rglru.rglru_decode_step, "cfg")
jax_forward = _jit(jax_model.forward, "cfg", "mode")
jax_chunk_prefill_step = _jit(jax_model.chunk_prefill_step, "cfg")
jax_decode_step = _jit(jax_model.decode_step, "cfg")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, dtype="float32", err=""):
    np.testing.assert_allclose(_np(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=err)


# ---- the RG-LRU's pieces against repro/models/rglru.py ----------------------

def _layer0(smoke):
    """Layer 0's RG-LRU on both sides (a recurrent layer of the scan)."""
    jcfg, cfg, jparams, params = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["scan"][0]["rec"])
    return jcfg, cfg, jp, params.layers[0].rec


def _x(cfg, shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,))
    return x.astype(np.float32)


def _jax_x(x, cfg):
    return jnp.asarray(x, jnp.dtype(cfg.activation_dtype))


def _torch_x(x, cfg):
    return torch.from_numpy(x).to(common_mod.dtype_of(cfg.activation_dtype))


def _state(jcfg, cfg, batch, seed):
    """A recurrent layer's state of ``batch`` rows with seeded values, on
    both sides."""
    rng = np.random.default_rng(seed)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32), a.dtype),
        jax_rglru.init_rglru_cache(jcfg, batch))
    return jc, {k: convert._to_torch(np.asarray(v)) for k, v in jc.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "valid"])
def test_rglru_forward_and_its_state_match_jax(request, dtype, ragged):
    """The sequence form over rows of 20, 13 and 1 real tokens (or all
    20), and the exit state it writes: ``h`` after each row's last real
    token, the conv tail ending there."""
    jcfg, cfg, jp, p = _layer0(_pair(request, dtype))
    x = _x(cfg, (B, S), seed=1)
    valid = (np.arange(S)[None, :] < ROW_LENS[:, None]) if ragged else None
    yj, cj = jax_rglru_forward(
        jp, _jax_x(x, jcfg), jcfg, return_state=True,
        valid=None if valid is None else jnp.asarray(valid))
    cache = rglru_mod.init_rglru_cache(cfg, B, "cpu")
    with torch.inference_mode():
        y = rglru_mod.rglru_forward(
            p, _torch_x(x, cfg),
            valid=None if valid is None else torch.from_numpy(valid),
            cache=cache, rows=torch.arange(B))
    keep = valid if ragged else np.ones((B, S), bool)
    _close(_np(y)[keep], np.asarray(yj, np.float32)[keep], dtype)
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].dtype == common_mod.dtype_of(dtype)
    for name in ("h", "conv"):
        _close(cache[name], cj[name], dtype, name)


def test_rglru_chunk_step_matches_jax(smoke):
    """Two chunk calls of 4 group rows, C 8, from a state of seeded values
    (stale rows): first chunks of slots 0 and 2 (which must ignore what
    the rows held), a continuation of slot 1, and a padded group row
    (lengths 0, repeating slot 0) that writes nothing; then continuations
    of slots 0 and 2 and a first chunk of slot 3. Outputs at the real
    tokens, the whole state after each call, and rows no call names bit
    for bit as before."""
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
        yj, jc = jax_rglru_chunk_step(
            jp, jnp.asarray(x), jc, jcfg,
            tuple(jnp.asarray(a) for a in arrays))
        with torch.inference_mode():
            y = rglru_mod.rglru_chunk_step(
                p, torch.from_numpy(x), cache, *(torch.from_numpy(a) for a
                                                 in (arrays[0], arrays[1],
                                                     arrays[3])))
        real = np.arange(C)[None, :] < np.asarray(lengths)[:, None]
        _close(_np(y)[real], np.asarray(yj)[real])
        for name in ("h", "conv"):
            _close(cache[name], jc[name], err=name)
    assert all(torch.equal(cache[k][4], before[k][4]) for k in cache)


def test_rglru_decode_step_matches_jax_with_inactive_rows(smoke):
    """Five steps from a seeded state, row 1 inactive on odd steps and row
    2 never active: active rows as the JAX step's, inactive rows' ``h``
    and conv tail bit for bit as they were."""
    jcfg, cfg, jp, p = _layer0(smoke)
    jc, cache = _state(jcfg, cfg, 3, seed=3)
    for step in range(5):
        x = _x(cfg, (3, 1), seed=20 + step)
        active = np.array([True, step % 2 == 0, False])
        before = {k: t.clone() for k, t in cache.items()}
        yj, jc = jax_rglru_decode_step(
            jp, jnp.asarray(x), jc, jcfg, active=jnp.asarray(active))
        with torch.inference_mode():
            y = rglru_mod.rglru_decode_step(p, torch.from_numpy(x), cache,
                                            active=torch.from_numpy(active))
        _close(_np(y)[active], np.asarray(yj)[active])
        for name in ("h", "conv"):
            _close(cache[name], jc[name], err=name)
            for r in np.flatnonzero(~active):
                assert torch.equal(cache[name][r], before[name][r])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_tail_at_lengths_match_jax(dtype):
    """The conv over a carried tail (taps summed in the reference's order)
    and the tail ending at each row's length, with and without a carry."""
    rng = np.random.default_rng(4)
    jdt, tdt = jnp.dtype(dtype), common_mod.dtype_of(dtype)
    x, carry = (rng.standard_normal(s).astype(np.float32)
                for s in ((3, 10, 16), (3, 3, 16)))
    w, b = (rng.standard_normal(s).astype(np.float32) for s in ((4, 16),
                                                                (16,)))
    out_j, full_j = jax_common.causal_conv_with_carry(
        *(jnp.asarray(a, jdt) for a in (x, w, b, carry)))
    out, full = common_mod.causal_conv_with_carry(
        *(torch.from_numpy(a).to(tdt) for a in (x, w, b, carry)))
    _close(out, out_j, dtype)
    assert np.array_equal(_np(full), np.asarray(full_j, np.float32))
    lengths = np.array([10, 2, 0], np.int32)
    for prepend in (None, carry):
        want = jax_common.tail_at_lengths(
            jnp.asarray(x), jnp.asarray(lengths), 3,
            prepend=None if prepend is None else jnp.asarray(prepend))
        got = common_mod.tail_at_lengths(
            torch.from_numpy(x), torch.from_numpy(lengths), 3,
            prepend=None if prepend is None else torch.from_numpy(prepend))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_gate_gelu_is_the_tanh_form(smoke):
    """``jax.nn.gelu`` defaults to the tanh approximation: the gate branch
    matches it within 1e-5 in f32, and the exact GELU would not."""
    _, cfg, jp, p = _layer0(smoke)
    x = _x(cfg, (2, 16), seed=5)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x) @ jp["proj_gate"]))
    with torch.inference_mode():
        got = rglru_mod._gate_branch(p, torch.from_numpy(x))
        exact = F.gelu(torch.from_numpy(x) @ p.proj_gate)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(exact.numpy() - want).max() > 1e-4


def test_linear_scan_is_the_recurrence():
    """The doubling scan against the recurrence stepped one token at a
    time, f32, at lengths on and off a power of two."""
    rng = np.random.default_rng(6)
    for n in (1, 7, 16, 33):
        a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, n, 5))
                             .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, n, 5))
                             .astype(np.float32))
        a_cum, h = rglru_mod.linear_scan(a, b)
        want_h, want_a = torch.zeros(2, 5), torch.ones(2, 5)
        for t in range(n):
            want_h = a[:, t] * want_h + b[:, t]
            want_a = want_a * a[:, t]
            torch.testing.assert_close(h[:, t], want_h, rtol=1e-5,
                                       atol=1e-6)
            torch.testing.assert_close(a_cum[:, t], want_a, rtol=1e-5,
                                       atol=1e-6)


# ---- weights, caches and the build step -----------------------------------

def test_config_and_support():
    assert dataclasses.asdict(jax_get_config("recurrentgemma-9b")) \
        == dataclasses.asdict(get_config("recurrentgemma-9b"))
    for n in (5, 3):
        jc, c = _configs(num_layers=n)
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
    full = get_config("recurrentgemma-9b")
    model_mod.check_supported(full)
    assert full.layer_kinds() == (RECURRENT, RECURRENT, "local") * 12 \
        + (RECURRENT, RECURRENT)


@pytest.mark.parametrize("what,names", [
    ("ssm", ("SSM blocks", "block kinds other than global, local and "
             "recurrent")),
    ("moe", ("mixture of experts",))])
def test_the_other_refusals_still_stand(what, names):
    """The features ``names`` lists as the refusals they once hit are
    served since their slices, beside recurrent blocks: an SSM block since
    mamba2-130m's (a pattern of ssm and recurrent blocks passes) and
    mixture-of-experts since dbrx-132b's (recurrent blocks whose MLP half
    is a MoE pass)."""
    cfg = _configs()[1]
    if what == "ssm":
        cfg = dataclasses.replace(cfg, block_pattern=("ssm", RECURRENT),
                                  ssm=SSMConfig())
    else:
        cfg = dataclasses.replace(cfg, moe=MoEConfig(num_experts=4, top_k=2,
                                                     d_expert=32))
    model_mod.check_supported(cfg)


def test_params_and_caches_carry_across_and_back(smoke):
    jcfg, cfg, jparams, params = smoke
    assert [l.kind for l in params.layers] == list(cfg.layer_kinds())
    rec = params.layers[0].rec
    assert {n for n, _ in rec.named_parameters()} == {
        "proj_x", "proj_gate", "conv_w", "conv_b", "wa", "wx", "ba", "bx",
        "a_param", "proj_out"}
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
        assert sorted(port[0]) == ["conv", "h"] and "k" in port[2]
        assert port[0]["h"].shape == (2, 64) \
            and port[0]["conv"].shape == (2, 3, 64)
        got, ref = _leaves(convert.caches_to_jax(port, cfg)), _leaves(jc)
        assert [p for p, _ in got] == [p for p, _ in ref]
        assert all(np.array_equal(g, np.asarray(w))
                   for (_, g), (_, w) in zip(got, ref))


def test_bf16_params_keep_the_f32_leaves(smoke_bf16):
    """In a bf16 model ``ba``, ``bx`` and ``a_param`` stay f32, as the
    reference's (the port's seeded init too); the round trip stays bit for
    bit."""
    jcfg, cfg, jparams, params = smoke_bf16
    want = jax.eval_shape(lambda: jax_model.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert [(p, a.dtype) for p, a in _leaves(jparams)] \
        == [(p, a.dtype) for p, a in _leaves(want)]
    for model in (params, model_mod.init_params(cfg, seed=0, device="cpu")):
        rec = model.layers[0].rec
        assert {n for n, t in rec.named_parameters()
                if t.dtype == torch.float32} == set(F32_LEAVES)
    back = _leaves(convert.params_to_jax(params, cfg))
    want = _leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                jparams))
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(back, want))


def test_build_step_takes_the_sites_of_jax(smoke, build):
    """No RG-LRU projection is a site (the reference's ``QUANT_SITES``):
    the port's sites are the JAX package's ``_collect_sites``, its
    attention and MLP weights of each unit position and of the tail, and
    the build decides each of them."""
    jcfg, cfg, jparams, params = smoke
    want = jax_quantize._collect_sites(jparams)
    got = quantize_mod._collect_sites(params, cfg)
    assert {k: v[:4] for k, v in got.items()} == want
    assert not any(".rec." in n for n in got)
    assert {n.split(".")[0] for n in got} == {"scan0", "scan1", "scan2",
                                              "tail0", "tail1"}
    assert set(build.schemes) == set(want)
    assert build.quantized_sites + build.fallback_sites == len(want)


# ---- the whole model against the JAX model ----------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return tokens, np.arange(S)[None, :] < ROW_LENS[:, None]


def _assert_caches(got, jcaches, cfg, dtype="float32"):
    """Recurrent state whole; the rings up to what the prompts wrote."""
    want = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                   "cpu")
    for g, w, kind in zip(got, want, cfg.layer_kinds()):
        for name in g:
            _close(g[name], _np(w[name]), dtype, f"{kind} {name}")


def _jax_prefill(jparams, jcfg, tokens, valid):
    return jax_forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jcfg, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "prefill"])
def test_model_full_and_prefill_match_jax(request, dtype, mode):
    jcfg, cfg, jparams, params = _pair(request, dtype)
    tokens, valid = _prompts(cfg.vocab_size)
    if mode == "full":
        hj = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})[0]
        with torch.inference_mode():
            h, _ = model_mod.forward(params, cfg, {
                "tokens": torch.from_numpy(tokens)}, mode="full",
                caches=None)
        _close(h, hj, dtype)
        return
    hj, cj = _jax_prefill(jparams, jcfg, tokens, valid)
    with torch.inference_mode():
        h, caches = model_mod.forward(
            params, cfg, {"tokens": torch.from_numpy(tokens)},
            mode="prefill", caches=model_mod.init_caches(cfg, B, MAX_LEN,
                                                         "cpu"),
            kv_valid=torch.from_numpy(valid))
    _close(_np(h)[valid], np.asarray(hj, np.float32)[valid], dtype)
    _assert_caches(caches, cj, cfg, dtype)


def test_model_decode_matches_jax_with_inactive_row(smoke):
    """Decode steps from a JAX prefill carried across, row 2 inactive on
    odd steps: hidden states as the JAX model's, the inactive row's state
    bit for bit as it was, and every cache at the end."""
    jcfg, cfg, jparams, params = smoke
    tokens, valid = _prompts(cfg.vocab_size)
    _, jcaches = _jax_prefill(jparams, jcfg, tokens, valid)
    caches = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                     "cpu")
    rng = np.random.default_rng(1)
    pos = ROW_LENS.astype(np.int32)
    for step in range(5):
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
        _close(_np(h)[active], np.asarray(hj)[active])
        if not active[2]:
            for c, old in zip(caches, before):
                assert all(torch.equal(t[2], old[k]) for k, t in c.items())
        pos = pos + active
    _assert_caches(caches, jcaches, cfg)


def _chunk_calls(lengths, C):
    """The engine's chunk calls for prompts of ``lengths`` at chunk C, all
    rows in every call until each is done; padded to a power of two with
    repeats of the first slot at write_pos max_len and no tokens."""
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
        yield slots, start, wpos, lens


@pytest.mark.parametrize("C", [8, 16])
def test_chunk_calls_match_jax_chunk_prefill(smoke, C):
    """Prompts of 37, 21 and 9 tokens prefilled C at a time against the
    JAX package's ``chunk_prefill_step`` from the same caches (3 padded to
    4 rows while all run): the real tokens' hidden states and every cache
    after every call."""
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 21, 9)]
    jcaches = jax_model.init_caches(jcfg, 3, MAX_LEN)
    caches = model_mod.init_caches(cfg, 3, MAX_LEN, "cpu")
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


# ---- the engine -------------------------------------------------------------

def test_engine_agrees_with_the_jax_engine(smoke):
    """The same trace (prompts up to 5 windows) through both engines."""
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


def _arch_cfg(name):
    """The JAX package's ``rglru`` and ``hybrid-rec-rec-local`` smoke
    configs (``tests/test_serving_runtime.py:265-285``) and the 5-layer
    cut with its tail."""
    cfg = reduce_for_smoke(get_config("recurrentgemma-9b"))
    if name == "rglru":
        return dataclasses.replace(cfg, block_pattern=(RECURRENT,))
    if name == "hybrid-rec-rec-local":
        return cfg
    return _configs()[1]


@pytest.mark.parametrize("arch", ["rglru", "hybrid-rec-rec-local",
                                  "5-layer"])
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


def test_jax_rglru_config_is_the_ports():
    from repro.configs.base import RECURRENT as JAX_RECURRENT
    jcfg = dataclasses.replace(jax_reduce(jax_get_config(
        "recurrentgemma-9b")), block_pattern=(JAX_RECURRENT,))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(_arch_cfg("rglru"))


def test_int8_kv_chunked_engine_serves_like_its_monolithic_twin(smoke,
                                                                build):
    """w8a8 + int8 KV with chunk 8: every request served, greedy agreement
    with the monolithic int8 engine >= 0.95 (an int8 chunk attends the
    dequantized ring; the recurrent state is exact in both)."""
    cfg, params = _int8_kv(smoke[1]), smoke[3]
    kw = dict(KW, precision="w8a8", quantized_params=build)
    mono = InferenceEngine(cfg, params, device="cpu", **kw)
    eng = InferenceEngine(cfg, params, prefill_chunk=8, device="cpu", **kw)
    assert eng._int8_kv
    want = mono.run(_trace(Request, cfg.vocab_size))
    got = eng.run(_trace(Request, cfg.vocab_size))
    assert all(r.done and len(r.output) == 4 for r in got)
    assert eng.telemetry.continuations > 0
    assert token_agreement([(a.output, b.output)
                            for a, b in zip(got, want)]) >= 0.95


# ---- the engine's per-layer flags over recurrent layers ---------------------

@pytest.mark.parametrize("max_len", [6, 64])
def test_engine_flags_over_recurrent_layers(smoke, max_len):
    """A recurrent layer is never positional, whatever max_len is against
    the window (the reference's ``_cache_seq_axes``: -1 for ``h`` and
    ``conv``); the ring is, only below its window. The int8-KV flag reads
    an attention layer's cache (layer 0 is recurrent)."""
    cfg, params = smoke[1], smoke[3]
    kw = dict(KW, max_len=max_len, prefill_buckets=(4,))
    eng = InferenceEngine(cfg, params, device="cpu", **kw)
    ring = cfg.window_size > max_len
    assert eng._positional == [kind == "local" and ring
                               for kind in cfg.layer_kinds()]
    assert not eng._int8_kv
    assert InferenceEngine(_int8_kv(cfg), params, device="cpu",
                           **kw)._int8_kv


def test_cache_extents_skip_recurrent_layers(smoke):
    """The chunk call's bounds come from the attention layers alone: a
    model with no global layer has no max_len bound, and one with no
    attention layer at all has neither; the slot count comes from any
    layer's state."""
    cfg = smoke[1]
    caches = model_mod.init_caches(cfg, 3, 40, "cpu")
    assert "k" not in caches[0]
    assert model_mod.cache_extents(cfg, caches) == (None, cfg.window_size)
    rec = _arch_cfg("rglru")
    assert model_mod.cache_extents(
        rec, model_mod.init_caches(rec, 3, 40, "cpu")) == (None, None)


# ---- movable state ----------------------------------------------------------

@pytest.mark.parametrize("max_len", [6, 64])
def test_snapshot_moves_recurrent_state_whole(smoke, max_len):
    """A 4-token prefix (max_len 6, below the window of 8: the ring is
    positional) or a 30-token one (max_len 64: every state moves whole):
    ``h`` and the conv tail ship whole, the bytes are the JAX engine's, a
    restore into another slot and a second hop give the same rows."""
    jcfg, cfg, jparams, params = smoke
    n, lens = (4, (4,)) if max_len == 6 else (30, (30, 9, 5))
    buckets = (4,) if max_len == 6 else KW["prefill_buckets"]
    kw = dict(KW, max_len=max_len, prefill_buckets=buckets)
    eng = InferenceEngine(cfg, params, device="cpu", **kw)
    jeng = JaxEngine(jcfg, jparams, **kw)
    for e, cls in ((eng, Request), (jeng, JaxRequest)):
        e.run(_trace(cls, cfg.vocab_size, seed=7, lens=lens, new=1))
    src, jsrc = eng.snapshot_slot(0, n), jeng.snapshot_slot(0, n)
    assert (src.bytes_partial, src.bytes_full) == (jsrc.bytes_partial,
                                                   jsrc.bytes_full)
    for leaf, kind in zip(src.leaves, cfg.layer_kinds()):
        if kind == RECURRENT:
            assert leaf["h"].shape == (64,) and leaf["conv"].shape == (3, 64)
        else:
            assert leaf["k"].shape[0] == (n if max_len == 6
                                          else cfg.window_size)
    eng.restore_slot(src, 2)
    for a, b in zip(src.leaves, eng.snapshot_slot(2, n).leaves):
        assert all(torch.equal(a[k], b[k]) for k in a)
    eng.restore_slot(eng.snapshot_slot(2, n), 1)
    for a, b in zip(src.leaves, eng.snapshot_slot(1, n).leaves):
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


def _run_checked(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work:
        eng.step_once()
        eng.states.check_partition()
    return [r.output for r in reqs]


def test_paging_moves_recurrent_state_and_serves_like_more_slots(smoke):
    """A 2-slot chunked engine with host paging serves 6 sessions
    token-identical to a 6-slot engine, every page-out (its ``h`` and conv
    tail with the rings) faulted back in."""
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


def test_mid_prefill_migration_carries_the_recurrent_state(smoke):
    """The router's migration round by hand: mid-prefill continuations
    leave with their snapshots after one chunk, the thief restores them
    and resumes the recurrence from the carried ``h`` and conv tail;
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


# ---- the capture proxy ------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_recurrent_stages_are_capturable(smoke, int8):
    """Prefill (a padded group row), chunk (a first chunk, continuations
    past the window, a padded row) and decode (inactive rows) of the
    recurrentgemma engine: two calls of each run the same aten ops on the
    same shapes, none of them a host sync, a boolean-mask index or a copy
    to the host."""
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
            slots, start, wpos, lengths, 16, eng._global_len, 4,
            ring=eng._ring)
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


# ---- the launcher and the card's unit check ---------------------------------

@pytest.mark.parametrize("extra,expect", [
    ((), "served 4 requests"),
    (("--prefill-chunk", "8", "--verify-chunked"),
     "verify-chunked OK: 4 requests"),
    (("--prefill-chunk", "8", "--prefix-cache", "8", "--verify-prefix"),
     "verify-prefix OK"),
    (("--precision", "w8a8", "--verify-quant"), "verify-quant OK")],
    ids=["plain", "chunked", "prefix", "w8a8"])
def test_serve_launcher_recurrentgemma_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "recurrentgemma-9b", "--smoke", "--device", "cpu", "--requests",
         "4", "--new-tokens", "3", *extra],
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
    """The card's check of one (recurrent, recurrent, local) unit, run on
    the host with both sides on the plain versions, at d_model and
    lru_width 1024 and a vocabulary of 65536: the zeroed ``h`` shows less
    at smaller widths, and the embedded tokens' scale (the multiplier over
    sqrt(vocab)) sets how much the unit adds against its input. The bf16
    side within its bound of the f32 side, the reversed conv taps and the
    zeroed ``h`` past it."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = chip_smoke.reduce_recurrentgemma("bfloat16")
    cfg = dataclasses.replace(cfg, num_layers=3, d_model=1024,
                              vocab_size=65536,
                              recurrent=dataclasses.replace(
                                  cfg.recurrent, lru_width=1024))
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    chip_smoke.check_recurrent_block("check-block", cfg, params,
                                     lens=(128, 100, 33, 1), steps=4)
    line = capsys.readouterr().out
    got, taps, h = (float(line.split(key)[1].split()[0].rstrip(";,"))
                    for key in ("adds ", "reversed ", "steps "))
    assert got <= chip_smoke.RECURRENT_BLOCK_TOL < min(taps, h)

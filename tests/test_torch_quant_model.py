"""The port's w8a8 build step, model and engine with an int8 KV cache,
against the JAX package's, on the CPU.

The JAX weights are carried across with ``repro_torch.convert``; the
calibration tokens are made with numpy and passed to both build steps.
Tolerances: the build step's decisions and quantized leaves and the int8
cache contents must agree bit for bit (integer paths); hidden states use
the JAX package's 2e-3 for f32; engine tokens are held with
``token_agreement`` >= 0.95 (the int8-KV guardrail). On the CPU the
port's wrappers run their kernels' plain versions.
"""
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core.metrics import token_agreement
from repro.models import model as jax_model
from repro.models import quantize as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_int8
from repro_torch.kernels.w8a8.ops import w8a8_matmul
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving.engine import InferenceEngine, Request

TOL = 2e-3
B, S, MAX_LEN = 3, 16, 32
LENS = np.array([16, 9, 1])            # right-padded prefill rows
ENGINE_KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32))


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


# ---- the build step ---------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    calib = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, cfg, jparams, params, calib


_BUILT = {}


def _builds(smoke, **kw):
    """Both packages' build step on the same weights and calibration
    tokens (each distinct call made once per module)."""
    key = repr(sorted(kw.items()))
    if key not in _BUILT:
        jcfg, cfg, jparams, params, calib = smoke
        jb = jax_quantize.build_quantized_params(
            jcfg, jparams, calib_tokens=jnp.asarray(calib), **kw)
        tb = quantize_mod.build_quantized_params(
            cfg, params, calib_tokens=torch.from_numpy(calib), **kw)
        _BUILT[key] = jb, tb
    return _BUILT[key]


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("kw", [dict(budget=0.0), dict(budget=1.0),
                                dict(skip=("attn", "mlp"))],
                         ids=["budget0_fallbacks", "all_int8", "siteless"])
def test_build_quantized_params_matches_jax(smoke, kw):
    cfg = smoke[1]
    jb, tb = _builds(smoke, **kw)
    assert tb.schemes == jb.schemes           # same site names, decisions
    assert (tb.quantized_sites, tb.fallback_sites) == \
        (jb.quantized_sites, jb.fallback_sites)
    assert tb.result.metric_delta == jb.result.metric_delta
    assert (tb.result.passed, tb.result.iterations) == \
        (jb.result.passed, jb.result.iterations)
    for d, e in zip(tb.result.decisions, jb.result.decisions):
        assert d.error == pytest.approx(e.error, rel=1e-5)
    if kw.get("budget") == 0.0:
        assert tb.fallback_sites > 0
    if "skip" in kw:
        assert not tb.schemes and tb.result.passed
    # every leaf (q8 and scale bit for bit, fp weights unchanged)
    want = _leaves(jax.tree.map(np.asarray, jb.params))
    got = _leaves(convert.params_to_jax(tb.params, cfg))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), path


def test_quantized_params_carry_across_and_share_fp_tensors(smoke):
    jcfg, cfg, jparams, params, calib = smoke
    jb, tb = _builds(smoke, budget=0.0)
    carried = convert.params_from_jax(jax.tree.map(np.asarray, jb.params),
                                      cfg, "cpu")
    a, b = carried.state_dict(), tb.params.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    n_q = sum(k.endswith(".q8") for k in a)
    assert n_q == tb.quantized_sites * cfg.num_layers
    # the original model is untouched and shares its fp tensors
    assert all(isinstance(getattr(l.mlp, "w_up"), torch.nn.Parameter)
               for l in params.layers)
    assert tb.params.embed.data_ptr() == params.embed.data_ptr()


# ---- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def quant_models(smoke):
    """JAX w8a8 params (every site int8) with an int8 KV config, and the
    port's model carried across from them."""
    jcfg, cfg, jparams, params, calib = smoke
    jb, _ = _builds(smoke, budget=1.0)
    jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jb.params),
                                      cfg, "cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jb.params, tparams, tokens


def _assert_caches_equal(caches, jcaches, cfg, upto):
    """int8 values and fp16 scales bit for bit at the positions each row
    has written (``upto`` (B,) exclusive)."""
    back = convert.caches_to_jax(caches, cfg)
    written = np.arange(MAX_LEN)[None, :] < np.asarray(upto)[:, None]
    for (path, got), (_, want) in zip(_leaves(back), _leaves(jcaches)):
        want = np.asarray(want)
        assert got.dtype == want.dtype, path
        assert np.array_equal(got[:, written], want[:, written]), path


@pytest.mark.parametrize("impl", ["chunked_jnp", "flash_pallas"])
def test_w8a8_int8kv_model_matches_jax(quant_models, impl):
    """Prefill then three decode steps at per-row positions: hidden states
    within 2e-3 on real rows, the int8 cache bit for bit."""
    jcfg, cfg, jq_params, tparams, tokens = quant_models
    jc = dataclasses.replace(jcfg, attention_impl=impl)
    valid = np.arange(S)[None, :] < LENS[:, None]
    hj, cj, _ = jax_model.forward(
        jq_params, jc, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jc, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))
    caches = model_mod.init_caches(cfg, B, MAX_LEN, "cpu")
    assert caches[0]["k"].dtype == torch.int8
    assert caches[0]["k_scale"].dtype == torch.float16
    with torch.inference_mode():
        h, caches = model_mod.forward(
            tparams, cfg, {"tokens": torch.from_numpy(tokens)},
            mode="prefill", caches=caches, kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(h.numpy()[valid], np.asarray(hj)[valid],
                               rtol=TOL, atol=TOL)
    _assert_caches_equal(caches, cj, cfg, LENS)
    pos = LENS.astype(np.int32)
    rng = np.random.default_rng(1)
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        hj, cj = jax_model.decode_step(jq_params, jc, jnp.asarray(nxt), cj,
                                       jnp.asarray(pos))
        with torch.inference_mode():
            h, caches = model_mod.decode_step(
                tparams, cfg, torch.from_numpy(nxt), caches,
                torch.from_numpy(pos))
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=TOL,
                                   atol=TOL)
        pos = pos + 1
        _assert_caches_equal(caches, cj, cfg, pos)


def test_full_mode_equals_prefill_hidden(smoke):
    """mode 'full' (the calibration forward) is prefill without a cache."""
    cfg, params = smoke[1], smoke[3]
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    with torch.inference_mode():
        full, none = model_mod.forward(params, cfg, {"tokens": tokens},
                                       mode="full", caches=None)
        pre, _ = model_mod.forward(
            params, cfg, {"tokens": tokens}, mode="prefill",
            caches=model_mod.init_caches(cfg, 2, 8, "cpu"))
    assert none is None and torch.equal(full, pre)


def test_local_int8_kv_still_unsupported():
    from repro_torch.configs.base import ATTN_LOCAL
    cfg = _int8_kv(dataclasses.replace(
        reduce_for_smoke(get_config("deepseek-7b")),
        block_pattern=(ATTN_LOCAL,)))
    with pytest.raises(NotImplementedError, match="int8 KV cache on local"):
        model_mod.check_supported(cfg)


# ---- the engine ----------------------------------------------------------------

def _requests(cls, n=6, seed=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 30, n)
    new = rng.integers(2, 9, n)
    return [cls(i, rng.integers(0, 256, int(L)).astype(np.int32),
                max_new_tokens=int(m))
            for i, (L, m) in enumerate(zip(lens, new))]


def test_w8a8_int8kv_engine_agrees_with_jax(smoke):
    """Both engines build their quantized weights from the same weights
    and calibration tokens (falling back sites, budget 0) and serve the
    same requests over an int8 KV cache."""
    jcfg, cfg, jparams, params, calib = smoke
    jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
    jb, tb = _builds(smoke, budget=0.0)
    jeng = JaxEngine(jcfg, jparams, precision="w8a8", quantized_params=jb,
                     **ENGINE_KW)
    jreqs = jeng.run(_requests(JaxRequest))
    counts = (w8a8_matmul.launches, decode_attn.launches,
              decode_attn_int8.launches)
    eng = InferenceEngine(cfg, params, precision="w8a8", quantized_params=tb,
                          device="cpu", **ENGINE_KW)
    reqs = eng.run(_requests(Request))
    agreement = token_agreement([(r.output, j.output)
                                 for r, j in zip(reqs, jreqs)])
    print(f"w8a8 + int8-KV greedy-token agreement with the JAX engine: "
          f"{agreement:.4f}")
    assert agreement >= 0.95
    assert eng.run_params is tb.params and eng.quant is tb
    assert eng.caches[0]["k"].dtype == torch.int8
    for r, j in zip(reqs, jreqs):
        assert r.done and len(r.output) == len(j.output) == j.max_new_tokens
    # stages keyed by precision, as the JAX engine's
    assert sorted(eng.executor.cached_keys()) == sorted(
        k for k in jeng.executor.cached_keys() if k[0] in ("prefill",
                                                           "decode"))
    # the plain versions ran: no kernel launch on the CPU
    assert (w8a8_matmul.launches, decode_attn.launches,
            decode_attn_int8.launches) == counts == (0, 0, 0)


def test_engine_rejects_bad_precision_and_misplaced_quantized_params(smoke):
    cfg, params = smoke[1], smoke[3]
    with pytest.raises(ValueError, match="precision"):
        InferenceEngine(cfg, params, precision="int4", device="cpu",
                        **ENGINE_KW)
    with pytest.raises(ValueError, match="params live on cpu"):
        InferenceEngine(cfg, params, precision="w8a8", device="cuda",
                        **ENGINE_KW)

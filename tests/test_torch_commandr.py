"""command-r-plus-104b serving in the port against the JAX package, on the
CPU.

command-r-plus-104b reduced with ``dataclasses.replace`` on both sides to
keep its grouping, which ``reduce_for_smoke`` drops (4 heads over 4): 2
global layers of d_model 64, 12 query heads over 1 kv head of 16 (G 12),
LayerNorm with a scale and a bias, SwiGLU, the tied embedding, RoPE at
theta 75000. The JAX package's weights carry across by
``repro_torch.convert``, every norm's scale and bias drawn nonzero first
(init leaves them at zero, where a port that dropped one would agree):

- the config equals the reference's field for field, full, reduced and
  cut; the full width and the 16-layer cut ``chip_smoke.py`` serves;
- mode 'full' and prefill hidden states (the JAX model under
  ``chunked_jnp`` and ``flash_pallas`` in interpret mode) and 4 decode
  steps agree within 2e-3 in f32 and by a relative 2e-2 in bf16;
- the engine chunked (8, 16) gives the monolithic engine's tokens;
- the w8a8 build's sites are the JAX package's ``_collect_sites``;
- both launchers' ``--full-config`` refusals name the chip_smoke phase
  that serves a cut; ``--smoke`` serves on the CPU;
- the card's layers check (``chip_smoke.check_cmdr_layers``) holds on the
  host at a small width, each planted fault past its bound.
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
from repro.models import quantize as jax_quantize
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "command-r-plus-104b"
TOL = 2e-3                     # f32, elementwise
REL_TOL = 2e-2                 # bf16, ||got - want|| / ||want||
B, S, MAX_LEN = 3, 20, 48
LENS = np.array([20, 13, 1])          # right-padded rows
KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48))
# what reduce_for_smoke drops and this slice must keep: G 12
KEEP = dict(num_heads=12, num_kv_heads=1)


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _configs(dtype="float32"):
    kw = dict(KEEP, param_dtype=dtype, activation_dtype=dtype)
    jcfg = dataclasses.replace(jax_reduce(jax_get_config(ARCH)), **kw)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert cfg.num_heads // cfg.num_kv_heads == 12
    assert cfg.norm_type == "layernorm"
    return jcfg, cfg


def _drawn(jparams):
    """Every norm's scale and bias drawn from N(0, 0.3^2) (numpy, seed 5),
    in the leaf's dtype."""
    rng = np.random.default_rng(5)

    def draw(path, x):
        if jax.tree_util.keystr(path).endswith(("['scale']", "['bias']")):
            return jnp.asarray(0.3 * rng.standard_normal(x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, jparams)


def _smoke(dtype):
    jcfg, cfg = _configs(dtype)
    jparams = _drawn(jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def smokes():
    return {dtype: _smoke(dtype) for dtype in ("float32", "bfloat16")}


jax_decode_step = jax.jit(jax_model.decode_step, static_argnames="cfg")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return tokens, np.arange(S)[None, :] < LENS[:, None]


def _trace(vocab, seed=5, lens=(40, 5, 9, 30, 3, 12), new=4):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=new) for i, n in enumerate(lens)]


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, dtype, err=""):
    """Elementwise within 2e-3 in f32; by relative error 2e-2 in bf16."""
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=err)
        return
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    assert rel <= REL_TOL, (err, rel)


# ---- the config -------------------------------------------------------------

def test_config_equals_the_reference_field_for_field():
    assert dataclasses.asdict(jax_get_config(ARCH)) \
        == dataclasses.asdict(get_config(ARCH))
    assert dataclasses.asdict(jax_reduce(jax_get_config(ARCH))) \
        == dataclasses.asdict(reduce_for_smoke(get_config(ARCH)))
    for dtype in ("float32", "bfloat16"):
        _configs(dtype)
    full = get_config(ARCH)
    model_mod.check_supported(full)
    assert (full.num_heads // full.num_kv_heads, full.head_dim,
            full.norm_type, full.tie_embeddings, full.rope_theta) \
        == (12, 128, "layernorm", True, 75_000.0)
    # the reference's block: sequential, no post-norms, no softcaps, no
    # embedding multiplier, no biases but the norms'
    assert not (full.post_attn_norm or full.attn_logit_softcap
                or full.final_logit_softcap or full.embedding_multiplier
                or full.qkv_bias or full.o_bias or full.mlp_bias)


def test_full_width_and_the_cut():
    """208 GB at 64 layers; the 16-layer cut ``chip_smoke.py`` serves is
    28.31 B parameters (56.6 GB in bf16), each layer 1.573 B, the tied
    embedding 3.146 B; a layer's norms are LayerNorms with a bias."""
    cut = dataclasses.replace(get_config(ARCH),
                              num_layers=serve_mod.CARD_CUTS[ARCH][1])
    meta = model_mod.Model(cut, None, "meta")
    n = sum(t.numel() for t in meta.parameters())
    assert cut.num_layers == 16
    assert round(n / 1e9, 2) == 28.31 and round(2 * n / 1e9, 1) == 56.6
    layer = dict(meta.layers[0].named_parameters())
    assert sum(t.numel() for t in layer.values()) == 1_572_913_152
    assert {"pre_norm.bias", "pre_mlp_norm.bias"} <= set(layer)
    assert not any(k.startswith("attn.b") for k in layer)
    assert not hasattr(meta, "lm_head") and meta.embed.numel() == 3_145_728_000


def test_params_carry_across_and_back(smokes):
    jcfg, cfg, jparams, params = smokes["float32"]
    assert params.layers[0].pre_norm.bias.abs().sum() > 0
    back = jax.tree_util.tree_flatten_with_path(
        convert.params_to_jax(params, cfg))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    assert [p for p, _ in back] == [p for p, _ in want]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(back, want))


# ---- the model against the JAX model -----------------------------------------

@pytest.mark.parametrize("impl", ["chunked_jnp", "flash_pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_and_prefill_match_jax(smokes, dtype, impl):
    """Modes 'full' and 'prefill' over 3 right-padded rows: the real
    tokens' hidden states, and in f32 the logits and the K/V caches."""
    jcfg, cfg, jparams, params = smokes[dtype]
    jc = dataclasses.replace(jcfg, attention_impl=impl)
    tokens, valid = _prompts(cfg.vocab_size)
    batch_j = {"tokens": jnp.asarray(tokens)}
    batch = {"tokens": torch.from_numpy(tokens)}
    fj = jax_model.forward(jparams, jc, batch_j, mode="full")[0]
    hj, cj = jax_model.forward(
        jparams, jc, batch_j, mode="prefill",
        caches=jax_model.init_caches(jc, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]
    with torch.inference_mode():
        f, _ = model_mod.forward(params, cfg, batch, mode="full",
                                 caches=None)
        h, caches = model_mod.forward(
            params, cfg, batch, mode="prefill",
            caches=model_mod.init_caches(cfg, B, MAX_LEN, "cpu"),
            kv_valid=torch.from_numpy(valid))
    _close(f, fj, dtype, "full")
    _close(_f32(h)[valid], _f32(hj)[valid], dtype, "prefill")
    if dtype == "float32":
        want = convert.caches_from_jax(jax.tree.map(np.asarray, cj), cfg,
                                       "cpu")
        m = torch.from_numpy(np.arange(MAX_LEN)[None, :] < LENS[:, None])
        for g, w in zip(caches, want):
            for name in g:
                _close(g[name][m], w[name][m], dtype, name)
        lj = jax_model.greedy_next(jparams, jcfg, hj[jnp.arange(B),
                                                     LENS - 1])
        lt = model_mod.greedy_next(params, cfg, h[torch.arange(B),
                                                  torch.from_numpy(LENS - 1)])
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax(smokes, dtype):
    """4 decode steps after the same prefill, a row inactive on odd steps:
    the active rows' hidden states."""
    jcfg, cfg, jparams, params = smokes[dtype]
    tokens, valid = _prompts(cfg.vocab_size)
    _, jcaches = jax_model.forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jcfg, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]
    with torch.inference_mode():
        _, caches = model_mod.forward(
            params, cfg, {"tokens": torch.from_numpy(tokens)},
            mode="prefill",
            caches=model_mod.init_caches(cfg, B, MAX_LEN, "cpu"),
            kv_valid=torch.from_numpy(valid))
    rng = np.random.default_rng(1)
    pos = LENS.astype(np.int32)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        active = np.array([True, True, step % 2 == 0])
        hj, jcaches = jax_decode_step(
            jparams, jcfg, jnp.asarray(tok), jcaches, jnp.asarray(pos),
            active=jnp.asarray(active))
        with torch.inference_mode():
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(tok), caches,
                torch.from_numpy(pos), active=active)
        _close(_f32(h)[active], _f32(hj)[active], dtype, f"step {step}")
        pos = pos + active


# ---- the engine, the build step and the launchers ----------------------------

@pytest.fixture(scope="module")
def mono(smokes):
    cfg, params = smokes["float32"][1], smokes["float32"][3]
    return [r.output for r in InferenceEngine(
        cfg, params, device="cpu", **KW).run(_trace(cfg.vocab_size))]


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_engine_matches_monolithic(smokes, mono, chunk):
    cfg, params = smokes["float32"][1], smokes["float32"][3]
    eng = InferenceEngine(cfg, params, prefill_chunk=chunk, device="cpu",
                          **KW)
    got = eng.run(_trace(cfg.vocab_size))
    assert [r.output for r in got] == mono
    assert eng.telemetry.continuations > 0
    assert all(r.done and len(r.output) == 4 for r in got)


def test_build_sites_are_the_references(smokes):
    """The 7 dense projections of a layer, named as the JAX package's
    ``_collect_sites`` names them, each int8 at budget 1.0 (the launcher's
    w8a8 leg serves such a build)."""
    jcfg, cfg, jparams, params = smokes["float32"]
    got = quantize_mod._collect_sites(params, cfg)
    want = jax_quantize._collect_sites(jparams)
    assert sorted(got) == sorted(want) == [
        f"scan0.{w}" for w in ("attn.wk", "attn.wo", "attn.wq", "attn.wv",
                               "mlp.w_down", "mlp.w_gate", "mlp.w_up")]
    qp = quantize_mod.build_quantized_params(cfg, params, budget=1.0)
    assert (qp.quantized_sites, qp.fallback_sites) == (7, 0)


@pytest.mark.parametrize("arch,want", [
    (ARCH, r"207\.6 GB in bfloat16, past the card's 80\.0 GB "
           r"\(chip_smoke\.py's serve-cmdr phase serves "
           r"command-r-plus-104b's first 16 of 64 layers"),
    ("kimi-k2-1t-a32b", r"2772\.4 GB in bfloat16, past the card's 80\.0 GB "
                        r"\(chip_smoke\.py's serve-kimi phase serves "
                        r"kimi-k2-1t-a32b's first 1 of 61 layers")],
    ids=["command-r-plus", "kimi-k2"])
def test_full_config_is_refused_before_allocating(monkeypatch, arch, want):
    """The weights alone pass the card: ``SystemExit`` names their bytes
    and the chip_smoke phase that serves a cut of the arch, before any
    weight or kernel exists."""
    def no(*a, **k):
        raise AssertionError("allocated before refusing")
    monkeypatch.setattr(model_mod, "init_params", no)
    monkeypatch.setattr(serve_mod._build, "build_all", no)
    with pytest.raises(SystemExit, match=want):
        serve_mod.main(["--arch", arch, "--full-config", "--device", "cpu"])


@pytest.mark.parametrize("extra,expect", [
    ((), "served 4 requests"),
    (("--precision", "w8a8"), "7 sites int8"),
    (("--prefill-chunk", "8", "--verify-chunked"),
     "verify-chunked OK: 4 requests")], ids=["plain", "w8a8", "chunked"])
def test_serve_launcher_cmdr_on_cpu(extra, expect, capsys):
    serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "4", "--new-tokens", "3", *extra])
    assert expect in capsys.readouterr().out


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
    """``check_cmdr_layers`` on the host, the block on the plain versions:
    2 bf16 layers of d_model 256, 24 heads over 2 kv heads of 64 (G 12),
    LayerNorm scales and biases drawn, prompts of 1, 33, 90 and 130
    tokens: the worst token within its bound, each planted fault (the
    bias dropped, heads grouped h mod K, RoPE at theta 10000) past it."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = chip_smoke.reduce_cmdr("bfloat16")
    assert cfg.num_heads // cfg.num_kv_heads == 12
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    chip_smoke.draw_norms(params, seed=2, leaves=chip_smoke.CMDR_LEAVES)
    chip_smoke.check_cmdr_layers("check-layers", cfg, params,
                                 lens=(1, 33, 90, 130))
    line = capsys.readouterr().out
    got = float(line.split("worst token ")[1].split()[0])
    faults = [float(line.split(f"{name} ")[1].split()[0].rstrip(";,"))
              for name in chip_smoke.CMDR_FAULTS.values()]
    assert got <= chip_smoke.CMDR_LAYERS_TOL < min(faults), (got, faults)

"""gemma-2b serving in the port against the JAX package, on the CPU.

gemma-2b reduced with ``dataclasses.replace`` on both sides to keep what
``reduce_for_smoke`` would drop: head_dim 256, 8 query heads padded to 16
over one kv head (MQA, G 16), so ``wq`` is (d, 16, 256) and ``wo`` (16, 256,
d) with the padded heads' ``wo`` rows zero; 3 layers of d_model 64, GeGLU,
the embedding multiplier, tied embeddings, f32. The JAX package's initial
weights carry across by ``repro_torch.convert``:

- the config equals the reference's field for field, full and reduced;
- the parameters (padded leaves included) and caches carry across and
  back bit for bit, and the w8a8 build step quantizes ``wq`` as (d, Hp*hd)
  and ``wo`` as (Hp*hd, d), the JAX package's sites and leaves;
- prefill hidden states and logits (the JAX model under ``chunked_jnp``
  and under ``flash_pallas`` in interpret mode), decode and chunk calls
  agree within 2e-3 (f32 math on both sides; the port's attention goes
  through its kernels' plain versions);
- the port's engine agrees with the JAX engine on greedy tokens (>= 0.95),
  fp and w8a8 + int8 KV;
- the padded model equals the same model with its padded heads cut away
  within 2e-3, and differs from it past that once ``wo[H:]`` is not zero;
- the launcher serves ``--arch gemma-2b --smoke``, plain and chunked.
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
from repro.models import model as jax_model
from repro.models import quantize as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.sharding import vocab as jax_vocab
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.quantization import is_quantized_dense
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.sharding import vocab as vocab_mod

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-3
B, S, MAX_LEN = 3, 20, 48
LENS = np.array([20, 13, 1])          # right-padded rows
KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48))
# what reduce_for_smoke drops and this slice must keep: hd 256, 8 heads
# padded to 16 over one kv head
KEEP = dict(num_layers=3, num_heads=8, num_padded_heads=16, num_kv_heads=1,
            head_dim=256)


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _padded(cfg):
    """The reduced config still holds what this slice is about."""
    assert cfg.padded_heads > cfg.num_heads and cfg.head_dim == 256
    assert cfg.padded_heads // cfg.num_kv_heads == 16
    return cfg


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


def _configs():
    jcfg = dataclasses.replace(jax_reduce(jax_get_config("gemma-2b")), **KEEP)
    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma-2b")),
                              **KEEP)
    return jcfg, cfg


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = _configs()
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, _padded(cfg), jparams, params


def _prompts(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return tokens, np.arange(S)[None, :] < LENS[:, None]


def _trace(cls, vocab, seed=5, lens=(40, 5, 9, 30, 3, 12), new=4):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=new) for i, n in enumerate(lens)]


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _port_prefill(cfg, params, tokens, valid):
    with torch.inference_mode():
        return model_mod.forward(
            params, cfg, {"tokens": torch.from_numpy(tokens)},
            mode="prefill", caches=model_mod.init_caches(cfg, B, MAX_LEN,
                                                         "cpu"),
            kv_valid=torch.from_numpy(valid))


def _assert_caches(got, jcaches, cfg, done):
    """Each layer's K/V rows up to ``done[row]`` within 2e-3 (int8 values
    within one step, on at most 0.1% of them)."""
    want = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                   "cpu")
    m = torch.from_numpy(np.arange(MAX_LEN)[None, :]
                         < np.asarray(done)[:, None])
    for g, w in zip(got, want):
        for name in g:
            if g[name].dtype == torch.int8:
                # quantized on each side from K/V within 2e-3: a value on a
                # rounding edge may land one step apart
                diff = (g[name][m].int() - w[name][m].int()).abs()
                assert diff.max() <= 1 and diff.float().mean() < 1e-3, \
                    (name, diff.max().item(), diff.float().mean().item())
            else:
                np.testing.assert_allclose(g[name][m].numpy(),
                                           w[name][m].numpy(), rtol=TOL,
                                           atol=TOL)


# ---- the config, the weights and the build step -------------------------------

def test_config_equals_the_reference_field_for_field():
    assert dataclasses.asdict(jax_get_config("gemma-2b")) \
        == dataclasses.asdict(get_config("gemma-2b"))
    assert dataclasses.asdict(jax_reduce(jax_get_config("gemma-2b"))) \
        == dataclasses.asdict(reduce_for_smoke(get_config("gemma-2b")))
    jcfg, cfg = _configs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(_padded(cfg))
    full = _padded(get_config("gemma-2b"))
    model_mod.check_supported(full)
    assert (full.num_heads, full.padded_heads, full.num_kv_heads) \
        == (8, 16, 1)


def test_params_and_caches_carry_across_and_back(smoke):
    jcfg, cfg, jparams, params = smoke
    _padded(cfg)
    d, hd, H, Hp = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.padded_heads
    for layer in params.layers:
        assert layer.attn.wq.shape == (d, Hp, hd)
        assert layer.attn.wo.shape == (Hp, hd, d)
        assert not layer.attn.wo[H:].any() and layer.attn.wo[:H].any()
        assert layer.attn.wq[:, H:].any()       # padded heads do attend
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
        assert port[0]["k"].shape == (2, 32, 1, 256)
        got, ref = _leaves(convert.caches_to_jax(port, cfg)), _leaves(jc)
        assert all(np.array_equal(g, np.asarray(w))
                   for (_, g), (_, w) in zip(got, ref))


def test_seeded_init_pads_as_the_reference():
    """The port's own seeded weights: 16 heads in ``wq`` and ``wo``, the
    padded heads' output rows zero."""
    cfg = _padded(_configs()[1])
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    for layer in params.layers:
        assert layer.attn.wq.shape[1] == layer.attn.wo.shape[0] == 16
        assert not layer.attn.wo[8:].any() and layer.attn.wo[:8].all()


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_build_step_quantizes_padded_sites_as_jax(smoke, budget):
    """The w8a8 build step takes ``wq`` as (d, Hp*hd) and ``wo`` as
    (Hp*hd, d), as the JAX package's ``_collect_sites`` does: the same
    decisions and int8 leaves."""
    jcfg, cfg, jparams, params = smoke
    _padded(cfg)
    calib = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jb = jax_quantize.build_quantized_params(
        jcfg, jparams, calib_tokens=jnp.asarray(calib), budget=budget)
    tb = quantize_mod.build_quantized_params(
        cfg, params, calib_tokens=torch.from_numpy(calib), budget=budget)
    assert tb.schemes == jb.schemes
    assert tb.result.metric_delta == jb.result.metric_delta
    width = cfg.padded_heads * cfg.head_dim
    attn = tb.params.layers[0].attn
    for wname, shape in (("wq", (cfg.d_model, width)),
                         ("wo", (width, cfg.d_model))):
        w = getattr(attn, wname)
        if is_quantized_dense(w):
            assert tuple(w.q8.shape) == shape, wname
    got = _leaves(convert.params_to_jax(tb.params, cfg))
    want = _leaves(jax.tree.map(np.asarray, jb.params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), path


# ---- prefill, decode and chunks against the JAX model ----------------------------

@pytest.mark.parametrize("impl", ["chunked_jnp", "flash_pallas"])
def test_prefill_hidden_and_logits_match_jax(smoke, impl):
    jcfg, cfg, jparams, params = smoke
    _padded(cfg)
    tokens, valid = _prompts(cfg.vocab_size)
    jc = dataclasses.replace(jcfg, attention_impl=impl)
    hj, cj = jax_model.forward(
        jparams, jc, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jc, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]
    h, caches = _port_prefill(cfg, params, tokens, valid)
    np.testing.assert_allclose(h.numpy()[valid], np.asarray(hj)[valid],
                               rtol=TOL, atol=TOL)
    lj = jax_vocab.lm_head_logits(hj, jax_model.head_table(jparams, jcfg),
                                  jcfg)
    lt = vocab_mod.lm_head_logits(h, model_mod.head_table(params, cfg), cfg)
    V = cfg.vocab_size
    np.testing.assert_allclose(lt.numpy()[valid][:, :V],
                               np.asarray(lj)[valid][:, :V], rtol=TOL,
                               atol=TOL)
    _assert_caches(caches, cj, cfg, LENS)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_decode_matches_jax_with_inactive_row(smoke, int8):
    """Decode steps from a JAX prefill carried across, a row inactive on
    odd steps: hidden states as the JAX model's, the inactive row's cache
    bit for bit as it was, and the caches at the end."""
    jcfg, cfg, jparams, params = smoke
    _padded(cfg)
    if int8:
        jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
    tokens, valid = _prompts(cfg.vocab_size)
    _, jcaches = jax_model.forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jcfg, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]
    caches = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                     "cpu")
    rng = np.random.default_rng(1)
    pos = LENS.astype(np.int32)
    for step in range(5):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        active = np.array([True, True, step % 2 == 0])
        before = [{k: t[2].clone() for k, t in c.items()} for c in caches]
        hj, jcaches = jax_model.decode_step(
            jparams, jcfg, jnp.asarray(tok), jcaches, jnp.asarray(pos),
            active=jnp.asarray(active))
        with torch.inference_mode():
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(tok), caches,
                torch.from_numpy(pos), active=active)
        np.testing.assert_allclose(h.numpy()[active], np.asarray(hj)[active],
                                   rtol=TOL, atol=TOL)
        if not active[2]:
            for c, old in zip(caches, before):
                assert all(torch.equal(t[2], old[k]) for k, t in c.items())
        pos = pos + active
    _assert_caches(caches, jcaches, cfg, pos)


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
        yield slots, start, wpos, lens, list(done)


@pytest.mark.parametrize("C", [8, 16])
def test_chunk_calls_match_jax_chunk_prefill(smoke, C):
    """Prompts of 37, 21 and 9 tokens prefilled C at a time against the
    JAX package's ``chunk_prefill_step`` from the same caches: the real
    tokens' hidden states and the written prefixes after every call."""
    jcfg, cfg, jparams, params = smoke
    _padded(cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 21, 9)]
    jcaches = jax_model.init_caches(jcfg, 3, MAX_LEN)
    caches = model_mod.init_caches(cfg, 3, MAX_LEN, "cpu")
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
        _assert_caches(caches, jcaches, cfg, done)


# ---- the engine ------------------------------------------------------------

@pytest.mark.parametrize("precision", ["fp32", "w8a8"])
def test_engine_agrees_with_the_jax_engine(smoke, precision):
    """The same trace through both engines, fp and w8a8 + int8 KV (each
    building its quantized weights from the same weights and calibration
    tokens)."""
    jcfg, cfg, jparams, params = smoke
    _padded(cfg)
    if precision == "w8a8":
        jcfg, cfg = _int8_kv(jcfg), _int8_kv(cfg)
        calib = np.random.default_rng(9).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)
        kw_j = dict(KW, precision="w8a8",
                    quantized_params=jax_quantize.build_quantized_params(
                        jcfg, jparams, calib_tokens=jnp.asarray(calib)))
        kw_t = dict(KW, precision="w8a8",
                    quantized_params=quantize_mod.build_quantized_params(
                        cfg, params, calib_tokens=torch.from_numpy(calib)))
    else:
        kw_j = kw_t = KW
    jreqs = JaxEngine(jcfg, jparams, **kw_j).run(
        _trace(JaxRequest, cfg.vocab_size))
    reqs = InferenceEngine(cfg, params, device="cpu", **kw_t).run(
        _trace(Request, cfg.vocab_size))
    agreement = token_agreement([(r.output, j.output)
                                 for r, j in zip(reqs, jreqs)])
    print(f"{precision} greedy-token agreement with the JAX engine: "
          f"{agreement:.4f}")
    assert agreement >= 0.95
    assert all(r.done and len(r.output) == 4 for r in reqs)


# ---- the padded heads --------------------------------------------------------

def _cut(cfg, params):
    """The same model with its padded heads cut away: ``wq[:, :H]``,
    ``wo[:H]``, ``num_padded_heads=None``."""
    H = cfg.num_heads
    cut_cfg = dataclasses.replace(cfg, num_padded_heads=None)
    state = params.state_dict()
    for name in list(state):
        if name.endswith("attn.wq"):
            state[name] = state[name][:, :H]
        elif name.endswith("attn.wo"):
            state[name] = state[name][:H]
    cut = model_mod.init_params(cut_cfg, device="cpu")
    cut.load_state_dict(state)
    return cut_cfg, cut


def _outputs(cfg, params, tokens, valid):
    h, caches = _port_prefill(cfg, params, tokens, valid)
    nxt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 1))
    with torch.inference_mode():
        hd, _ = model_mod.decode_step(params, cfg, torch.from_numpy(
            nxt.astype(np.int32)), caches, torch.from_numpy(
            LENS.astype(np.int32)))
    return h.numpy()[valid], hd.numpy()


def test_padded_model_equals_its_unpadded_cut(smoke):
    cfg, params = smoke[1], smoke[3]
    _padded(cfg)
    cut_cfg, cut = _cut(cfg, params)
    assert cut.layers[0].attn.wq.shape[1] == cut_cfg.padded_heads == 8
    tokens, valid = _prompts(cfg.vocab_size)
    for got, want in zip(_outputs(cfg, params, tokens, valid),
                         _outputs(cut_cfg, cut, tokens, valid)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_padded_heads_rest_on_their_zero_output_rows(smoke):
    """With ``wo[H:]`` not zero the padded model leaves the cut's
    tolerance: the zero rows are what the equality above rests on."""
    cfg, params = smoke[1], smoke[3]
    _padded(cfg)
    cut_cfg, cut = _cut(cfg, params)
    live = convert.params_from_jax(convert.params_to_jax(params, cfg), cfg,
                                   "cpu")
    gen = torch.Generator().manual_seed(4)
    for layer in live.layers:
        wo = layer.attn.wo
        wo.data[cfg.num_heads:] = torch.randn(
            wo[cfg.num_heads:].shape, generator=gen) / cfg.d_model ** 0.5
    tokens, valid = _prompts(cfg.vocab_size)
    for got, want in zip(_outputs(cfg, live, tokens, valid),
                         _outputs(cut_cfg, cut, tokens, valid)):
        assert np.abs(got - want).max() > TOL + TOL * np.abs(want).max()


# ---- the launcher ---------------------------------------------------------------

@pytest.mark.parametrize("extra,expect", [
    ((), "served 4 requests"),
    (("--prefill-chunk", "8", "--verify-chunked"),
     "verify-chunked OK: 4 requests")], ids=["plain", "chunked"])
def test_serve_launcher_gemma2b_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma-2b", "--smoke", "--device", "cpu", "--requests", "4",
         "--new-tokens", "3", *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout

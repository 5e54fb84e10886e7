"""qwen2-vl-7b in the port against the JAX package, on the CPU.

Two cuts of the config, both f32, on the JAX package's initial weights
carried across by ``repro_torch.convert`` with every q/k/v bias and norm
scale drawn nonzero (at init they are zeros, where a port that dropped
them would still agree):

- ``padded``: what ``reduce_for_smoke`` drops kept with
  ``dataclasses.replace``: 6 query heads padded to 8 over 2 kv heads (G 4,
  the padding inside kv group 1, as heads 28-31 sit in group 3 at full
  width), head_dim 16, M-RoPE sections (4, 2, 2);
- ``smoke``: ``reduce_for_smoke(get_config("qwen2-vl-7b"))`` (4 heads over
  4 kv heads, no padding).

Held within 2e-3, on tokens and on patch embeddings (``embeds``), at
distinct (t, h, w) positions (where M-RoPE differs from RoPE) and at the
default ones: ``apply_mrope``; ``forward`` in modes full and prefill
against the JAX model under ``chunked_jnp`` and under ``flash_pallas`` in
interpret mode; decode steps with an inactive row; chunk calls against
``chunk_prefill_step``; prefill + decode against full. The engine's greedy
tokens agree with the JAX engine's (>= 0.95), in f32, in bf16 and in
w8a8 + int8 KV; the w8a8 build step decides and quantizes site for site
as the reference's; parameters (padded ``wq``/``wo``/``bq`` and the
untied ``lm_head``) and caches carry across and back bit for bit; the
padded heads rest on their zero ``wo`` rows; the serving stages pass the
capture proxy of ``test_torch_graphs.py``; the launcher serves ``--arch
qwen2-vl-7b``.
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
from repro.models import common as jax_common
from repro.models import model as jax_model
from repro.models import quantize as jax_quantize
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.quantization import is_quantized_dense
from repro_torch.models import common
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request
from test_torch_graphs import _chunk_inputs, _record

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 2e-3
B, S, MAX_LEN = 3, 20, 48
LENS = np.array([20, 13, 1])          # right-padded rows
KW = dict(batch_slots=3, max_len=32, prefill_buckets=(8, 16))
# what reduce_for_smoke drops and the padded cut keeps: 6 query heads
# padded to 8 over 2 kv heads (G 4), head_dim 16 (sections (4, 2, 2))
PAD = dict(num_heads=6, num_padded_heads=8, num_kv_heads=2, head_dim=16)
CUTS = ["padded", "smoke"]


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


def _configs(cut, dtype="float32"):
    jcfg = jax_reduce(jax_get_config("qwen2-vl-7b"))
    cfg = reduce_for_smoke(get_config("qwen2-vl-7b"))
    kw = dict(PAD) if cut == "padded" else {}
    kw.update(param_dtype=dtype, activation_dtype=dtype)
    return tuple(dataclasses.replace(c, **kw) for c in (jcfg, cfg))


def _draw(jparams, seed=0):
    """Every bias and norm scale of the JAX weights drawn N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(f"'{n}'" in name for n in ("bq", "bk", "bv", "scale")):
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.5,
                               leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, jparams)


def _smoke(cut, dtype="float32"):
    jcfg, cfg = _configs(cut, dtype)
    jparams = _draw(jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def cuts():
    return {cut: _smoke(cut) for cut in CUTS}


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return tokens, embeds, np.arange(S)[None, :] < LENS[:, None]


def _distinct_positions(batch, length):
    """(3,B,S) (t, h, w) ids that differ stream from stream, row from row.
    At theta 1e6 the later frequencies, which the h and w sections hold,
    turn by 1e-3 to 6e-6 rad a position, so the h and w ids lie thousands
    apart: every section then rotates visibly, and M-RoPE replaced by
    RoPE, or two sections swapped, leaves the tolerance."""
    i = np.arange(length)
    pos = np.stack([i, 3000 + 611 * i, 60000 + 4999 * i])[:, None, :]
    row = np.arange(batch)[None, :, None] * np.array([1, 97, 1013])[:, None,
                                                                   None]
    return (pos + row).astype(np.int32)


def _batch(kind, tokens, embeds, positions):
    out = ({"tokens": tokens} if kind == "tokens" else {"embeds": embeds})
    if positions is not None:
        out["positions"] = positions
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


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
                diff = (g[name][m].int() - w[name][m].int()).abs()
                assert diff.max() <= 1 and diff.float().mean() < 1e-3, \
                    (name, diff.max().item(), diff.float().mean().item())
            else:
                np.testing.assert_allclose(g[name][m].numpy(),
                                           w[name][m].numpy(), rtol=TOL,
                                           atol=TOL)


# ---- the config, M-RoPE and the weights -------------------------------------

def test_config_cuts_equal_the_reference_and_keep_the_padding():
    for cut in CUTS:
        jcfg, cfg = _configs(cut)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        model_mod.check_supported(cfg)
        assert cfg.rope_mode == "mrope" and cfg.qkv_bias
        assert sum(cfg.mrope_sections) == cfg.head_dim // 2
        assert len(set(cfg.mrope_sections)) > 1     # a swap is visible
    cfg = _configs("padded")[1]
    assert (cfg.num_heads, cfg.padded_heads, cfg.num_kv_heads) == (6, 8, 2)
    full = get_config("qwen2-vl-7b")
    assert (full.num_heads, full.padded_heads, full.num_kv_heads,
            full.head_dim, full.mrope_sections) == (28, 32, 4, 128,
                                                    (16, 24, 24))


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16),
                                         ((16, 24, 24), 128)])
@pytest.mark.parametrize("streams", ["distinct", "equal"])
def test_apply_mrope_matches_jax(sections, hd, streams):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 3, hd)).astype(np.float32)
    pos = _distinct_positions(2, 20)
    if streams == "equal":
        pos = np.broadcast_to(pos[:1], pos.shape)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(
        np.ascontiguousarray(pos)), 1e6, sections)
    want = jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                  sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    plain = common.apply_rope(torch.from_numpy(x),
                              torch.from_numpy(np.array(pos[0])), 1e6)
    if streams == "equal":
        assert torch.equal(got, plain)
    else:
        assert (got - plain).abs().max() > 0.1
    with pytest.raises(AssertionError):
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(
            np.ascontiguousarray(pos)), 1e6, sections[:2] + (1,))


@pytest.mark.parametrize("cut", CUTS)
def test_params_and_caches_carry_across_and_back(cuts, cut):
    """Padded ``wq``/``wo``/``bq``, the biases and the untied ``lm_head``
    to the port and back bit for bit; the caches too, fp and int8."""
    jcfg, cfg, jparams, params = cuts[cut]
    d, hd, H, Hp = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.padded_heads
    for layer in params.layers:
        assert layer.attn.wq.shape == (d, Hp, hd)
        assert layer.attn.bq.shape == (Hp, hd) and layer.attn.bq.any()
        assert layer.attn.bk.any() and layer.attn.bv.any()
        assert not layer.attn.wo[H:].any() and layer.attn.wo[:H].any()
    assert params.lm_head.shape == params.embed.shape
    assert not torch.equal(params.lm_head, params.embed)
    back = _leaves(convert.params_to_jax(params, cfg))
    want = _leaves(jax.tree.map(np.asarray, jparams))
    assert [p for p, _ in back] == [p for p, _ in want]
    assert all(g.dtype == w.dtype and np.array_equal(g, w)
               for (_, g), (_, w) in zip(back, want))
    for c in (jcfg, _int8_kv(jcfg)):
        rng = np.random.default_rng(0)
        jc = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 50).astype(a.dtype),
            jax_model.init_caches(c, 2, 32))
        port = convert.caches_from_jax(jax.tree.map(np.asarray, jc), cfg,
                                       "cpu")
        got, ref = _leaves(convert.caches_to_jax(port, cfg)), _leaves(jc)
        assert all(np.array_equal(g, np.asarray(w))
                   for (_, g), (_, w) in zip(got, ref))


def test_seeded_init_pads_as_the_reference():
    """The port's own seeded weights at the padded cut: 8 heads in ``wq``,
    ``bq`` and ``wo``, the padded heads' output rows zero, biases zero."""
    cfg = _configs("padded")[1]
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    for layer in params.layers:
        a = layer.attn
        assert a.wq.shape[1] == a.bq.shape[0] == a.wo.shape[0] == 8
        assert not a.wo[6:].any() and a.wo[:6].all()
        assert not (a.bq.any() or a.bk.any() or a.bv.any())


# ---- full, prefill, decode and chunks against the JAX model -----------------

def _jax_full(jcfg, jparams, batch, impl, mode, valid):
    jc = dataclasses.replace(jcfg, attention_impl=impl)
    if mode == "full":
        return jax_model.forward(jparams, jc, batch, mode="full",
                                 kv_valid=jnp.asarray(valid))[:2]
    return jax_model.forward(jparams, jc, batch, mode="prefill",
                             caches=jax_model.init_caches(jc, B, MAX_LEN),
                             kv_valid=jnp.asarray(valid))[:2]


def _port_full(cfg, params, batch, mode, valid):
    with torch.inference_mode():
        caches = None if mode == "full" else \
            model_mod.init_caches(cfg, B, MAX_LEN, "cpu")
        return model_mod.forward(params, cfg, batch, mode=mode,
                                 caches=caches,
                                 kv_valid=torch.from_numpy(valid))


@pytest.mark.parametrize("impl", ["chunked_jnp", "flash_pallas"])
@pytest.mark.parametrize("positions", ["distinct", "default"])
@pytest.mark.parametrize("kind", ["tokens", "embeds"])
@pytest.mark.parametrize("cut", CUTS)
def test_full_and_prefill_match_jax(cuts, cut, kind, positions, impl):
    """Modes full and prefill on the same batch: hidden states of the real
    tokens, and the prefill's caches."""
    jcfg, cfg, jparams, params = cuts[cut]
    tokens, embeds, valid = _prompts(cfg)
    pos = _distinct_positions(B, S) if positions == "distinct" else None
    batch = _batch(kind, tokens, embeds, pos)
    for mode in ("full", "prefill"):
        hj, cj = _jax_full(jcfg, jparams, _jnp(batch), impl, mode, valid)
        h, caches = _port_full(cfg, params, _torch(batch), mode, valid)
        np.testing.assert_allclose(h.numpy()[valid], np.asarray(hj)[valid],
                                   rtol=TOL, atol=TOL)
        if mode == "prefill":
            _assert_caches(caches, cj, cfg, LENS)


@pytest.mark.parametrize("cut", CUTS)
def test_distinct_positions_are_not_plain_rope(cuts, cut):
    """The distinct (t, h, w) positions move the hidden states past the
    tolerance, from those of their t stream alone: the cases above could
    tell M-RoPE from plain RoPE."""
    jcfg, cfg, jparams, params = cuts[cut]
    tokens, embeds, valid = _prompts(cfg)
    pos = _distinct_positions(B, S)
    t_only = np.ascontiguousarray(np.broadcast_to(pos[:1], pos.shape))
    h, _ = _port_full(cfg, params, _torch(_batch("tokens", tokens, embeds,
                                                 pos)), "full", valid)
    h_t, _ = _port_full(cfg, params, _torch(_batch("tokens", tokens, embeds,
                                                   t_only)), "full", valid)
    assert (h - h_t).abs()[torch.from_numpy(valid)].max() > 10 * TOL


@pytest.mark.parametrize("kind", ["tokens", "embeds"])
@pytest.mark.parametrize("cut", CUTS)
def test_decode_matches_jax_with_inactive_row(cuts, cut, kind):
    """Decode steps (tokens (B,1) or embeds (B,1,d)) from a JAX prefill
    at distinct positions carried across, a row inactive on odd steps:
    hidden states as the JAX model's, the inactive row's cache bit for bit
    as it was, the caches at the end; the int8-KV cache too on tokens."""
    jcfg, cfg, jparams, params = cuts[cut]
    tokens, embeds, valid = _prompts(cfg)
    pre = _batch("tokens", tokens, embeds, _distinct_positions(B, S))
    for int8 in ((False, True) if kind == "tokens" else (False,)):
        jc, c = (_int8_kv(jcfg), _int8_kv(cfg)) if int8 else (jcfg, cfg)
        _, jcaches = jax_model.forward(
            jparams, jc, _jnp(pre), mode="prefill",
            caches=jax_model.init_caches(jc, B, MAX_LEN),
            kv_valid=jnp.asarray(valid))[:2]
        caches = convert.caches_from_jax(jax.tree.map(np.asarray, jcaches),
                                         c, "cpu")
        rng = np.random.default_rng(1)
        pos = LENS.astype(np.int32)
        for step in range(3):
            x = (rng.integers(0, c.vocab_size, (B, 1)).astype(np.int32)
                 if kind == "tokens" else
                 rng.standard_normal((B, 1, c.d_model)).astype(np.float32))
            active = np.array([True, True, step % 2 == 0])
            before = [{k: t[2].clone() for k, t in cc.items()}
                      for cc in caches]
            hj, jcaches = jax_model.decode_step(
                jparams, jc, jnp.asarray(x), jcaches, jnp.asarray(pos),
                active=jnp.asarray(active))
            with torch.inference_mode():
                h, caches = model_mod.decode_step(
                    params, c, torch.from_numpy(x), caches,
                    torch.from_numpy(pos), active=active)
            np.testing.assert_allclose(h.numpy()[active],
                                       np.asarray(hj)[active], rtol=TOL,
                                       atol=TOL)
            if not active[2]:
                for cc, old in zip(caches, before):
                    assert all(torch.equal(t[2], old[k])
                               for k, t in cc.items())
            pos = pos + active
        _assert_caches(caches, jcaches, c, pos)


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


@pytest.mark.parametrize("cut", CUTS)
def test_chunk_calls_match_jax_chunk_prefill(cuts, cut):
    """Prompts of 37, 21 and 9 tokens prefilled 8 at a time against the
    JAX package's ``chunk_prefill_step`` from the same caches: the real
    tokens' hidden states and the written prefixes after every call."""
    jcfg, cfg, jparams, params = cuts[cut]
    C = 8
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


@pytest.mark.parametrize("kind", ["tokens", "embeds"])
@pytest.mark.parametrize("cut", CUTS)
def test_prefill_then_decode_equals_full(cuts, cut, kind):
    """A prefill of the first 12 inputs at default positions, then the
    other 8 one decode step at a time (each broadcasting its one position
    to the three streams), give the hidden states of mode full over all
    20 at default positions."""
    cfg, params = cuts[cut][1], cuts[cut][3]
    tokens, embeds, _ = _prompts(cfg)
    x = tokens if kind == "tokens" else embeds
    full, _ = _port_full(cfg, params, _torch(_batch(kind, tokens, embeds,
                                                    None)),
                         "full", np.ones((B, S), bool))
    P = 12
    with torch.inference_mode():
        h, caches = model_mod.prefill(
            params, cfg, _torch(_batch(kind, x[:, :P], x[:, :P], None)),
            MAX_LEN)
        got = [h]
        for i in range(P, S):
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(np.ascontiguousarray(
                    x[:, i:i + 1])), caches,
                torch.full((B,), i, dtype=torch.int32))
            got.append(h)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               full[:, P - 1:].numpy(), rtol=TOL, atol=TOL)


# ---- the engine and the build step ------------------------------------------

def _trace(cls, vocab, seed=5, lens=(14, 5, 9, 16, 3, 12), new=4):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=new) for i, n in enumerate(lens)]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "w8a8"])
@pytest.mark.parametrize("cut", CUTS)
def test_engine_agrees_with_the_jax_engine(cuts, cut, precision):
    """The same token trace through both engines (default positions): f32,
    bf16 (the same cut in bf16, its own JAX weights carried across) and
    w8a8 + int8 KV (each building its quantized weights from the same
    weights and calibration tokens)."""
    jcfg, cfg, jparams, params = (_smoke(cut, "bfloat16")
                                  if precision == "bf16" else cuts[cut])
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
    print(f"{cut} {precision} greedy-token agreement with the JAX engine: "
          f"{agreement:.4f}")
    assert agreement >= 0.95
    assert all(r.done and len(r.output) == 4 for r in reqs)


@pytest.mark.parametrize("budget", [0.0, 1.0])
def test_build_step_quantizes_sites_as_jax(cuts, budget):
    """The w8a8 build step over qwen2-vl's sites (biased q/k/v, ``wq`` as
    (d, Hp*hd) and ``wo`` as (Hp*hd, d)): the same decisions and int8
    leaves as the JAX package's, the biases left in f32."""
    jcfg, cfg, jparams, params = cuts["padded"]
    calib = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jb = jax_quantize.build_quantized_params(
        jcfg, jparams, calib_tokens=jnp.asarray(calib), budget=budget)
    tb = quantize_mod.build_quantized_params(
        cfg, params, calib_tokens=torch.from_numpy(calib), budget=budget)
    assert tb.schemes == jb.schemes
    assert tb.result.metric_delta == jb.result.metric_delta
    # the scanned unit's sites, attn.{wq,wk,wv,wo} and mlp.{w_gate,w_up,
    # w_down}, each stacked over the layers
    assert tb.quantized_sites + tb.fallback_sites == 7
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


# ---- the padded heads -------------------------------------------------------

def _outputs(cfg, params):
    tokens, embeds, valid = _prompts(cfg)
    batch = _torch(_batch("tokens", tokens, embeds,
                          _distinct_positions(B, S)))
    h, caches = _port_full(cfg, params, batch, "prefill", valid)
    nxt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 1))
    with torch.inference_mode():
        hd, _ = model_mod.decode_step(params, cfg, torch.from_numpy(
            nxt.astype(np.int32)), caches, torch.from_numpy(
            LENS.astype(np.int32)))
    return h.numpy()[valid], hd.numpy()


def test_padded_heads_rest_on_their_zero_output_rows(cuts):
    """Queries of the padded heads do attend (``bq`` drawn on them too),
    and their outputs are discarded: the padded model equals one whose
    padded heads' ``wq`` and ``bq`` are scaled x8, within 2e-3; with
    ``wo[H:]`` not zero it leaves that tolerance."""
    cfg, params = cuts["padded"][1], cuts["padded"][3]
    H = cfg.num_heads
    copy = lambda: convert.params_from_jax(
        convert.params_to_jax(params, cfg), cfg, "cpu")
    loud, live = copy(), copy()
    gen = torch.Generator().manual_seed(4)
    for a, b in zip(loud.layers, live.layers):
        a.attn.wq.data[:, H:] *= 8
        a.attn.bq.data[H:] *= 8
        assert a.attn.bq[H:].abs().max() > 1
        wo = b.attn.wo
        wo.data[H:] = torch.randn(wo[H:].shape, generator=gen) \
            / cfg.d_model ** 0.5
    base = _outputs(cfg, params)
    for got, want in zip(_outputs(cfg, loud), base):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for got, want in zip(_outputs(cfg, live), base):
        assert np.abs(got - want).max() > TOL + TOL * np.abs(want).max()


# ---- the serving stages and the launcher ------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_stages_are_capturable(cuts, int8):
    """The engine's decode, prefill and chunk stages of the padded cut pass
    the capture proxy of ``test_torch_graphs.py``: no op that syncs or
    takes a shape from data, the same ops on two calls."""
    cfg, params = cuts["padded"][1], cuts["padded"][3]
    if int8:
        cfg = _int8_kv(cfg)
    eng = InferenceEngine(cfg, params, batch_slots=4, max_len=40,
                          prefill_buckets=(8, 16), device="cpu")
    rng = np.random.default_rng(8)
    toks = lambda *s: rng.integers(0, cfg.vocab_size, s).astype(np.int32)
    calls = [([1, 2, 0, 1], [0, 16, 8, 0], [0, 16, 8, 40], [8, 8, 5, 0]),
             ([3, 0, 2, 1], [24, 0, 32, 8], [24, 0, 32, 8], [8, 2, 8, 7])]
    chunk = [_chunk_inputs(eng, c, seed=i, bucket=8)
             for i, c in enumerate(calls)]
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
        (eng._build_chunk(8, 4), [c[0] for c in chunk],
         chunk[0][1] if int8 else None)]
    for stage, inputs, variant in cases:
        _record(stage, inputs[0], variant)          # the warm-up
        first, second = (_record(stage, x, variant) for x in inputs)
        assert first.ops and not first.bad and not second.bad, \
            (first.bad, second.bad)
        assert first.ops == second.ops


@pytest.mark.parametrize("extra,expect", [
    ((), "served 4 requests"),
    (("--prefill-chunk", "8", "--verify-chunked"),
     "verify-chunked OK: 4 requests")], ids=["plain", "chunked"])
def test_serve_launcher_qwen2vl_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-vl-7b", "--smoke", "--device", "cpu", "--requests", "4",
         "--new-tokens", "3", *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout

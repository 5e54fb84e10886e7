"""The port's XLM-R encoder (xlmr-paper) against the JAX package, on the CPU.

Reduced configs: ``reduce_for_smoke`` (2 layers, d 64, 4 heads of 16, f32)
and two at the flash kernel's head_dim 64 (d 256, 4 heads of 64), in f32
(held to the JAX forward) and in bf16 (held to itself across buckets and
stage forms, and in the kernel cases of ``test_torch_kernels.py``: the
reference's bf16 forward rounds its attention logits to bf16, which the
port's does not).
Weights are the JAX ``init_params`` tree with every bias and norm
parameter drawn nonzero from a numpy seed (they are zeros at init, where a
port that forgot them would still agree), carried across with
``convert.params_from_jax``. Tolerances: 2e-3 in f32, 2e-2 in bf16.

- ``forward(mode="full", kv_valid=...)`` (non-causal by ``family``) on
  right-padded rows, and the mean-pooled embeddings against the example's
  pooling over the JAX forward; the norms, the plain biased MLP (fp and
  w8a8 sites) and the biased projections against their JAX functions;
  convert round-trips bit for bit.
- The bucketing functions and ``xlmr_sentences`` against the JAX ones.
- Bucket invariance: a sentence's embedding in buckets 32, 64 and 128
  agrees, and does not without ``kv_valid``.
- The encode stage's static form passes the capture proxy of
  ``test_torch_graphs.py``, and the executor's graphed path (capture
  stubbed) returns what the eager one does.
- The launcher's ``--arch xlmr-paper`` serves every sentence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core import bucketing as jax_bucketing
from repro.core.quantization import quantize_weight_int8 as jax_quantize
from repro.data.synthetic import xlmr_sentences as jax_sentences
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro.models import model as jax_model
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import SSMConfig
from repro_torch.configs.xlmr_paper import SEQ_BUCKETS
from repro_torch.core import bucketing
from repro_torch.core.quantization import (QuantDense, quantize_weight_int8,
                                           set_quantized)
from repro_torch.data.synthetic import xlmr_sentences
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models.common import make_norm
from repro_torch.models.mlp import MLP, apply_mlp
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.encoder import EncoderServer, encode_pooled
from test_torch_graphs import _record, _StubGraph

TOL = {"f32": 2e-3, "f32_hd64": 2e-3, "bf16_hd64": 2e-2}
# the leaves init_params leaves at zero: biases and norm parameters
DRAWN = ("bq", "bk", "bv", "bo", "b_up", "b_down", "bias", "scale")


def _cfgs(kind: str):
    jcfg, cfg = (jax_reduce(jax_get_config("xlmr-paper")),
                 reduce_for_smoke(get_config("xlmr-paper")))
    if kind != "f32":
        kw = dict(d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                  d_ff=512)
        if kind == "bf16_hd64":
            kw.update(param_dtype="bfloat16", activation_dtype="bfloat16")
        jcfg, cfg = (dataclasses.replace(c, **kw) for c in (jcfg, cfg))
    return jcfg, cfg


def _draw(tree, rng):
    """Overwrite every bias and norm leaf of a numpy tree with seeded
    values, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw(v, rng)
        elif isinstance(v, tuple):
            for t in v:
                _draw(t, rng)
        elif k in DRAWN:
            tree[k] = (0.5 * rng.standard_normal(v.shape)).astype(v.dtype)


def _setup(kind: str, seed: int = 0):
    jcfg, cfg = _cfgs(kind)
    tree = jax.tree.map(np.asarray,
                        jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    tree = {k: (tuple(dict(u) for u in v) if isinstance(v, tuple) else v)
            for k, v in tree.items()}
    _draw(tree, np.random.default_rng(seed))
    params = convert.params_from_jax(tree, cfg, "cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), params, tree


@pytest.fixture(scope="module", params=["f32", "f32_hd64"])
def setup(request):
    """The configs held to the JAX forward."""
    return (request.param,) + _setup(request.param)


@pytest.fixture(scope="module", params=["f32", "bf16_hd64"])
def typed_setup(request):
    """The f32 config and the bf16 one at the kernel's head_dim."""
    return (request.param,) + _setup(request.param)


def _batch(cfg, lens, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (len(lens), S)).astype(np.int32)
    valid = np.arange(S)[None, :] < np.asarray(lens)[:, None]
    return toks, valid


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _port_forward(params, cfg, toks, valid):
    with torch.inference_mode():
        x, _ = model_mod.forward(
            params, cfg, {"tokens": torch.from_numpy(toks)}, mode="full",
            caches=None,
            kv_valid=None if valid is None else torch.from_numpy(valid))
    return x.float().numpy()


def test_forward_matches_jax_on_real_rows(setup):
    """Right-padded rows of lengths 32, 17, 1 and 0 (an empty row) in a
    32 bucket: every real position's hidden state."""
    kind, jcfg, cfg, jparams, params, _ = setup
    toks, valid = _batch(cfg, [32, 17, 1, 0], 32)
    want, _, _ = jax_model.forward(jparams, jcfg, {"tokens": toks},
                                   mode="full", kv_valid=jnp.asarray(valid))
    got = _port_forward(params, cfg, toks, valid)
    assert np.isfinite(got).all()
    _close(got[valid], np.asarray(want, np.float32)[valid], TOL[kind])


def _example_pooling(jparams, jcfg, toks, valid):
    """``examples/serve_lm_bucketed.py``'s pooling over the JAX forward,
    given the mask as ``kv_valid``."""
    mask = jnp.asarray(valid)
    x, _, _ = jax_model.forward(jparams, jcfg, {"tokens": toks},
                                mode="full", kv_valid=mask)
    denom = jnp.maximum(mask.sum(-1, keepdims=True), 1)
    return (x * mask[..., None]).sum(1) / denom


def test_pooled_embeddings_match_the_example_pooling(setup):
    kind, jcfg, cfg, jparams, params, _ = setup
    toks, valid = _batch(cfg, [64, 40, 3, 0], 64, seed=2)
    want = _example_pooling(jparams, jcfg, toks, valid)
    with torch.inference_mode():
        got = encode_pooled(params, cfg, torch.from_numpy(toks),
                            torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (4, cfg.d_model)
    assert not got[3].any()                      # the empty row gives 0
    _close(got.numpy(), want, TOL[kind])


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norm_by_type_matches_jax(norm_type):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("xlmr-paper")),
                              norm_type=norm_type)
    rng = np.random.default_rng(3)
    norm = make_norm(cfg, torch.float32, "cpu")
    jp = {k: rng.standard_normal(cfg.d_model).astype(np.float32)
          for k, _ in norm.named_parameters()}
    norm.load_state_dict({k: torch.from_numpy(v) for k, v in jp.items()})
    assert set(jp) == ({"scale", "bias"} if norm_type == "layernorm"
                       else {"scale"})
    x = (3.0 * rng.standard_normal((2, 5, cfg.d_model)) + 1.0) \
        .astype(np.float32)
    want = jax_common.apply_norm({k: jnp.asarray(v) for k, v in jp.items()},
                                 jnp.asarray(x), norm_type, cfg.norm_eps)
    _close(norm(torch.from_numpy(x), cfg.norm_eps).numpy(), want, 2e-3)


@pytest.mark.parametrize("site", ["fp", "w8a8"])
def test_plain_biased_mlp_matches_jax(site):
    """act(x @ w_up + b_up) @ w_down + b_down; at a w8a8 site each bias is
    added after the quantized product."""
    jcfg, cfg = _cfgs("f32")
    rng = np.random.default_rng(4)
    jp = jax.tree.map(np.asarray, jax_mlp.init_mlp(jcfg,
                                                   jax.random.PRNGKey(5)))
    _draw(jp, rng)
    assert set(jp) == {"w_up", "w_down", "b_up", "b_down"}
    p = MLP(cfg, torch.Generator(), "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    if site == "w8a8":
        for w in ("w_up", "w_down"):
            q8, scale = quantize_weight_int8(getattr(p, w))
            set_quantized(p, w, QuantDense(q8, scale))
            jq8, jscale = jax_quantize(jp[w])
            assert np.array_equal(np.asarray(jq8), q8.numpy())
            jp[w] = {"q8": jq8, "scale": jscale}
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    got = apply_mlp(p, torch.from_numpy(x), cfg)
    _close(got.numpy(), jax_mlp.apply_mlp(jp, jnp.asarray(x), jcfg), 2e-3)


def test_biased_projections_match_jax():
    """``_project_qkv`` (biases after the product, before RoPE) and
    ``_out_proj`` with ``bo`` (a config with ``o_bias``) against the
    reference's."""
    jcfg, cfg = (dataclasses.replace(c, o_bias=True) for c in _cfgs("f32"))
    rng = np.random.default_rng(6)
    jp = jax.tree.map(np.asarray,
                      jax_attn.init_attention(jcfg, jax.random.PRNGKey(7)))
    _draw(jp, rng)
    assert {"bq", "bk", "bv", "bo"} <= set(jp)
    p = attn_mod.Attention(cfg, torch.Generator(), "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S), (B, S))
    want = jax_attn._project_qkv(jp, jnp.asarray(x), jcfg,
                                 jnp.asarray(positions))
    got = attn_mod._project_qkv(p, torch.from_numpy(x), cfg,
                                torch.from_numpy(positions.copy()))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 2e-3)
    o = rng.standard_normal((B, S, cfg.num_heads, cfg.head_dim)) \
        .astype(np.float32)
    _close(attn_mod._out_proj(p, torch.from_numpy(o)).numpy(),
           jax_attn._out_proj(jp, jnp.asarray(o)), 2e-3)


def test_convert_round_trips_bit_for_bit(typed_setup):
    kind, jcfg, cfg, _, params, tree = typed_setup
    back = convert.params_to_jax(params, cfg)
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(tree)
    for (path, got), want in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree.leaves(tree)):
        assert np.array_equal(got, np.asarray(want, np.float32)), path
    assert not hasattr(params.layers[0].mlp, "w_gate")
    assert params.layers[0].attn.bq.abs().sum() > 0


def test_full_config_builds_at_full_width():
    """check_supported passes, and the model holds 558.4 M parameters
    (the reference's 558.3 M plus the vocabulary padded to 250112 rows),
    tied embeddings, every layer's biases and LayerNorms."""
    cfg = get_config("xlmr-paper")
    model_mod.check_supported(cfg)
    m = model_mod.Model(cfg, torch.Generator(), "meta")
    n = sum(p.numel() for p in m.parameters())
    assert n == 558_401_536
    assert m.embed.shape == (250_112, 1024) and not hasattr(m, "lm_head")
    assert set(dict(m.layers[0].named_parameters())) == {
        "pre_norm.scale", "pre_norm.bias", "attn.wq", "attn.wk", "attn.wv",
        "attn.wo", "attn.bq", "attn.bk", "attn.bv", "pre_mlp_norm.scale",
        "pre_mlp_norm.bias", "mlp.w_up", "mlp.w_down", "mlp.b_up",
        "mlp.b_down"}


# features the port once refused and now serves: each case still names
# the refusal it used to hit, and now passes ``check_supported``
ACCEPTED = ("SSM blocks", "block kinds other than global",
            "mixture of experts")


@pytest.mark.parametrize("feature,kw", [
    ("mixture of experts", "moe"), ("SSM blocks", "ssm"),
    ("block kinds other than global", {"block_pattern": ("ssm",),
                                       "ssm": SSMConfig()}),
    ("embedding inputs", {"input_kind": "video"}),
    ("embedding inputs", {"input_kind": "embeds"})])
def test_other_features_still_refused(feature, kw):
    """Inputs pass as tokens or as stub ``embeddings`` (whisper's encoder
    frames, qwen2-vl's patches); any other input kind is refused. SSM
    blocks (an ``ssm`` sub-config, an ``ssm`` block pattern) are served
    since mamba2-130m's slice and MoE (a ``moe`` sub-config) since
    dbrx-132b's, and pass."""
    if isinstance(kw, str):          # a config that has the feature
        arch = {"moe": "dbrx-132b", "ssm": "mamba2-130m"}[kw]
        cfg = dataclasses.replace(reduce_for_smoke(get_config("xlmr-paper")),
                                  **{kw: getattr(jax_get_config(arch), kw)})
    else:
        cfg = dataclasses.replace(reduce_for_smoke(get_config("xlmr-paper")),
                                  **kw)
    if feature in ACCEPTED:
        model_mod.check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match=feature):
        model_mod.check_supported(cfg)


def test_qwen2_vl_7b_passes_check_supported():
    """M-RoPE and embedding inputs in a decoder-only model, at full width
    and in smoke."""
    for cfg in (get_config("qwen2-vl-7b"),
                reduce_for_smoke(get_config("qwen2-vl-7b"))):
        assert cfg.rope_mode == "mrope" and cfg.input_kind == "embeddings"
        assert cfg.encdec is None
        model_mod.check_supported(cfg)


def test_whisper_medium_passes_check_supported():
    """The enc-dec config, at full width and in smoke: its decoder takes
    tokens and its encoder frame embeddings."""
    for cfg in (get_config("whisper-medium"),
                reduce_for_smoke(get_config("whisper-medium"))):
        assert cfg.encdec is not None and cfg.input_kind == "embeddings"
        model_mod.check_supported(cfg)


# ---- bucketing --------------------------------------------------------------

def test_bucketing_functions_match_jax():
    lengths = list(range(1, 600, 7))
    for buckets in (SEQ_BUCKETS, (8, 16, 32, 64)):
        assert [bucketing.pick_bucket(n, buckets) for n in lengths] \
            == [jax_bucketing.pick_bucket(n, buckets) for n in lengths]
        assert bucketing.wasted_compute_fraction(lengths, buckets) \
            == jax_bucketing.wasted_compute_fraction(lengths, buckets)
    for n in (50, 3):
        sents = xlmr_sentences(250_002, n, seed=5, min_len=4, max_len=512)
        want = jax_sentences(250_002, n, seed=5, min_len=4, max_len=512)
        assert len(sents) == len(want) and all(
            np.array_equal(a, b) and a.dtype == b.dtype
            for a, b in zip(sents, want))
        lens = [len(s) for s in sents]
        assert bucketing.length_sorted_batches(lens, 8) \
            == jax_bucketing.length_sorted_batches(lens, 8)
    seqs = sents + [np.arange(40, dtype=np.int32), np.zeros(0, np.int32)]
    for got, want in zip(bucketing.pad_ragged_to_bucket(seqs, 32),
                         jax_bucketing.pad_ragged_to_bucket(seqs, 32)):
        assert np.array_equal(got, want) and got.dtype == want.dtype
    toks = np.arange(30, dtype=np.int32).reshape(3, 10)
    for bucket in (16, 8):                         # pads, and truncates
        for got, want in zip(bucketing.pad_to_bucket(toks, bucket, 7),
                             jax_bucketing.pad_to_bucket(toks, bucket, 7)):
            assert np.array_equal(got, want) and got.dtype == want.dtype


def test_bucketed_executable_matches_jax():
    """One build per bucket reached, and the callable gets the reference's
    padded tokens and mask, as torch tensors on the named device."""
    calls = {"jax": [], "torch": []}

    def build(side):
        def build_fn(bucket):
            return lambda t, m: calls[side].append((bucket, np.asarray(t),
                                                    np.asarray(m), t))
        return build_fn

    jexe = jax_bucketing.BucketedExecutable(build("jax"), buckets=(8, 16))
    exe = bucketing.BucketedExecutable(build("torch"), buckets=(8, 16),
                                       device="cpu")
    rng = np.random.default_rng(8)
    for lens in ((3, 5), (9, 1, 16), (20,), (2,)):
        seqs = [rng.integers(0, 99, n).astype(np.int32) for n in lens]
        jexe(seqs)
        exe(seqs)
    assert exe.compile_count == jexe.compile_count == 2
    for (b, t, m, raw), (jb, jt, jm, _) in zip(calls["torch"], calls["jax"]):
        assert b == jb and np.array_equal(t, jt) and np.array_equal(m, jm)
        assert isinstance(raw, torch.Tensor) and raw.dtype == torch.int32


# ---- bucket invariance ------------------------------------------------------

def _pooled_in(params, cfg, sent, bucket, masked=True):
    toks, mask = bucketing.pad_ragged_to_bucket([sent, sent[:3]], bucket)
    with torch.inference_mode():
        if masked:
            return encode_pooled(params, cfg, torch.from_numpy(toks),
                                 torch.from_numpy(mask))[0].numpy()
        x, _ = model_mod.forward(params, cfg, {"tokens":
                                               torch.from_numpy(toks)},
                                 mode="full", caches=None)
        m = torch.from_numpy(mask).float()[..., None]
        return ((x.float() * m).sum(1) / m.sum(1))[0].numpy()


def test_pooled_embedding_does_not_depend_on_the_bucket(typed_setup):
    """A 20-token sentence pooled in buckets 32, 64 and 128 agrees within
    the tolerance; without ``kv_valid`` (the pads attended) it does not."""
    kind, _, cfg, _, params, _ = typed_setup
    sent = np.random.default_rng(9).integers(0, cfg.vocab_size, 20) \
        .astype(np.int32)
    ref = _pooled_in(params, cfg, sent, 32)
    for bucket in (64, 128):
        _close(_pooled_in(params, cfg, sent, bucket), ref, TOL[kind],
               f"bucket {bucket}")
    tol = TOL[kind]
    unmasked = [_pooled_in(params, cfg, sent, b, masked=False)
                for b in (32, 64)]
    err = np.abs(unmasked[1] - unmasked[0])
    assert (err > tol + tol * np.abs(unmasked[0])).any(), err.max()


# ---- the stage --------------------------------------------------------------

def _stage_inputs(cfg, bucket, B, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, bucket + 1, B)
    lens[0] = bucket
    toks, valid = _batch(cfg, lens, bucket, seed)
    return {"tokens": toks, "mask": valid}


@pytest.mark.parametrize("kind", ["f32", "bf16_hd64"])
def test_encode_stage_is_capturable(kind):
    _, cfg, _, params, _ = _setup(kind)
    stage = EncoderServer(cfg, params, batch_size=4).stage(32)
    inputs = [_stage_inputs(cfg, 32, 4, s) for s in (10, 11)]
    _record(stage, inputs[0])                   # the executor's warm-up
    first, second = (_record(stage, x) for x in inputs)
    assert first.ops and not first.bad and not second.bad, \
        (first.bad, second.bad)
    assert first.ops == second.ops


def test_graphed_encode_equals_eager(monkeypatch):
    """The executor's graphed path (the capture stubbed by a replay that
    recomputes the body) against an eager server's outputs, bucket by
    bucket; one build and one capture per bucket, the rest replays."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))

    def stub(body, pool):
        out = body()
        return _StubGraph(body, out), out

    monkeypatch.setattr(executor_mod, "capture", stub)
    _, cfg, _, params, _ = _setup("f32")
    graphed = EncoderServer(cfg, params, batch_size=4, buckets=(16, 32, 64))
    graphed.executor.graphs = True
    eager = EncoderServer(cfg, params, batch_size=4, buckets=(16, 32, 64))
    sents = xlmr_sentences(cfg.vocab_size, 22, seed=1, min_len=1, max_len=64)
    batches = bucketing.length_sorted_batches([len(s) for s in sents], 4)
    for _ in range(2):
        got = graphed.serve(sents, batches)
        want = eager.serve(sents, batches)
        assert np.array_equal(got.embeds, want.embeds)
    ex = graphed.executor
    assert graphed.exe.compile_count == len(set(got.buckets)) \
        == ex.compiles_for("encode") == ex.captures["encode"]
    assert ex.replays["encode"] == 2 * len(batches) - ex.captures["encode"]
    assert sorted(ex.cached_keys()) == [("encode", b)
                                        for b in sorted(set(got.buckets))]
    assert not eager.executor.captures and not eager.executor.replays
    assert flash_attn.launches == flash_attn.noncausal_launches == 0


def test_encoder_server_refuses_bad_batches():
    _, cfg, _, params, _ = _setup("f32")
    srv = EncoderServer(cfg, params, batch_size=2)
    with pytest.raises(ValueError, match="1..2"):
        srv.encode([np.ones(3, np.int32)] * 3)
    with pytest.raises(ValueError, match="not an encoder"):
        EncoderServer(reduce_for_smoke(get_config("deepseek-7b")), params)


def test_launcher_serves_every_sentence():
    n0 = flash_attn.noncausal_launches
    srv, run = serve_launcher.main(["--arch", "xlmr-paper", "--device",
                                    "cpu", "--requests", "13", "--slots",
                                    "4"])
    assert srv.exe.compile_count == len(set(run.buckets))
    assert sorted(i for b in run.batches for i in b) == list(range(13))
    assert run.embeds.shape == (13, 64) and np.isfinite(run.embeds).all()
    assert (np.abs(run.embeds).sum(1) > 0).all()
    assert flash_attn.noncausal_launches == n0 == 0

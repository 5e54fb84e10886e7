"""The port's whisper-medium (encoder-decoder) against the JAX package, on
the CPU.

Reduced configs: ``reduce_for_smoke`` (2 encoder + 2 decoder layers, d 64,
4 heads of 16, vocab 256, f32) and two at the kernels' head_dim 64 (d 256,
4 heads of 64), in f32 and in bf16; 3 rows of 20 frames. Weights are the
JAX ``init_params`` tree with every bias and norm parameter drawn nonzero
from a numpy seed (they are zeros at init, where a port that dropped them
would still agree), carried across with ``convert.params_from_jax``.
Tolerances are the reference's: 2e-3 in f32, 2e-2 in bf16, on hidden
states.

The reference's ``forward`` runs the decoder's layers as ``global``
blocks: it hands ``_run_stack`` the kinds of ``cfg.scan_plan()``, not the
``decoder`` kind its ``init_params`` builds them with, so its blocks skip
cross-attention and its decoder never reads the encoder (ROADMAP C). The
port runs the ``decoder`` blocks the reference builds, and is held here to
``jax_forward``: the reference's own ``_run_stack``, ``encode``,
``build_cross_kv`` and ``decoder`` blocks, in its ``forward``'s order,
with the decoder kind. ``test_reference_forward_skips_cross_attention``
pins the gap: the JAX ``forward`` equals the port with its cross-attention
dropped.

- ``encode`` (ragged ``enc_valid``), ``build_cross_kv`` layer by layer,
  ``forward(mode="full")``, and ``prefill`` then 8 ``decode_step``s at
  per-row positions (hidden states each step, self and cross caches
  after, with and without ragged frames: the reference's decode attends
  every frame, ``enc_valid`` or not), greedy tokens (agreement >= 0.95).
- Within the port, prefill + decode equals ``forward(mode="full")`` at
  every position (2e-4, ``tests/test_arch_smoke.py``'s bound).
- Four planted faults each fail a comparison with the reference: RoPE on
  the cross query, a causal encoder, cross-attention dropped, decode
  cross-attention cut to the first half of the frames.
- convert round-trips parameters and caches bit for bit.
- Both serving stages pass the capture proxy of ``test_torch_graphs.py``,
  and a second prefill writes the cross K/V into the same buffers; the
  graphed server (capture stubbed) serves two batches as an eager one.
- ``InferenceEngine`` refuses an enc-dec config; the launcher transcribes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import model as jax_model
from repro.models.common import apply_norm as jax_apply_norm
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.whisper_medium import ENC_FRAMES
from repro_torch.core.metrics import token_agreement
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk_mod
from repro_torch.models import model as model_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.encdec import EncDecServer, stub_batch
from repro_torch.serving.engine import InferenceEngine
from test_torch_graphs import _record, _StubGraph

TOL = {"f32": 2e-3, "f32_hd64": 2e-3, "bf16_hd64": 2e-2}
# the leaves init_params leaves at zero: biases and norm parameters
DRAWN = ("bq", "bk", "bv", "b_up", "b_down", "bias", "scale")
B, T, S, MAX_LEN = 3, 20, 8, 32
ENC_LENS = [20, 13, 7]           # a ragged enc_valid: the real frames
PROMPT_LENS = [8, 5, 3]


@pytest.fixture(autouse=True)
def _restore_launch_counters(monkeypatch):
    """The kernel wrappers' launch counters are module-global: pin each,
    so that no later test in the process sees what a test here moved."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _cfgs(kind: str):
    jcfg, cfg = (jax_reduce(jax_get_config("whisper-medium")),
                 reduce_for_smoke(get_config("whisper-medium")))
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
    return dict(kind=kind, jcfg=jcfg, cfg=cfg, tree=tree, params=params,
                jparams=jax.tree.map(jnp.asarray, tree))


_setup_once = functools.cache(_setup)


@pytest.fixture(scope="module", params=["f32", "f32_hd64", "bf16_hd64"])
def setup(request):
    return _setup_once(request.param)


@pytest.fixture(scope="module")
def f32():
    return _setup("f32")


def _inputs(cfg, seed=1):
    """Frames (B,T,d) N(0,1) x 0.1, the ragged frame mask, prompts (B,S)
    right-padded to ``PROMPT_LENS`` and their mask, 8 next tokens a row."""
    rng = np.random.default_rng(seed)
    enc = (0.1 * rng.standard_normal((B, T, cfg.d_model))).astype(np.float32)
    enc_valid = np.arange(T)[None, :] < np.asarray(ENC_LENS)[:, None]
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    valid = np.arange(S)[None, :] < np.asarray(PROMPT_LENS)[:, None]
    nxt = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    return enc, enc_valid, toks, valid, nxt


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def _rel(got, want) -> float:
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hold(got, want, kind: str, what=""):
    """The port's result against the reference's: elementwise within
    2e-3 in f32; in bf16 the relative error ||got - want|| / ||want||
    within 2e-2, since the reference's bf16 attention rounds its logits to
    bf16 and the kernels keep them in f32 (ROADMAP C, "Logit dtype"): a
    few elements of a bf16 hidden state differ by 2-4 ulps there."""
    if kind.startswith("bf16"):
        assert _rel(got, want) <= TOL[kind], (what, _rel(got, want))
    else:
        _close(got, want, TOL[kind], what)




def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---- the reference, with its decoder blocks --------------------------------

@functools.partial(jax.jit, static_argnames=("jcfg", "mode"))
def jax_forward(jp, jcfg, batch, *, mode, caches=None, pos=None,
                kv_valid=None):
    """``repro.models.model.forward`` for an enc-dec config, its steps and
    functions as they are there, but with the decoder layers run as the
    ``decoder`` blocks ``init_params`` builds (the reference passes
    ``cfg.scan_plan()``'s ``global``). Returns (hidden, caches); jitted,
    as the reference's serving stages are."""
    unit, _, tail = jcfg.scan_plan()
    x = jax_model._embed_inputs(jp, jcfg, batch)
    if "enc_embeds" in batch:
        cross_kv = jax_model.build_cross_kv(
            jp, jcfg, jax_model.encode(jp, jcfg, batch["enc_embeds"],
                                       batch.get("enc_valid")))
    else:
        cross_kv = caches["cross"]
    positions = None if mode == "decode" else \
        jax_model._default_positions(jcfg, x.shape[0], x.shape[1])
    x, new, _ = jax_model._run_stack(
        jp["scan"], jp["tail"], x, jcfg, ("decoder",) * len(unit),
        ("decoder",) * len(tail), mode=mode, positions=positions,
        caches=caches, pos=pos, kv_valid=kv_valid, cross_kv=cross_kv,
        cross_valid=batch.get("enc_valid"), causal=True)
    x = jax_apply_norm(jp["final_norm"], x, jcfg.norm_type, jcfg.norm_eps)
    if new is not None:
        new["cross"] = cross_kv
    return x, new


def _jbatch(enc, enc_valid, toks):
    b = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}
    if enc_valid is not None:
        b["enc_valid"] = jnp.asarray(enc_valid)
    return b


def _tbatch(enc, enc_valid, toks):
    b = {"tokens": torch.from_numpy(toks), "enc_embeds": torch.from_numpy(enc)}
    if enc_valid is not None:
        b["enc_valid"] = torch.from_numpy(enc_valid)
    return b


def jax_serve(s, enc, enc_valid, toks, valid, nxt):
    """The reference's prefill then 8 decode steps of ``nxt`` at per-row
    positions: (hidden states (9, B, d), caches after)."""
    jp, jcfg = s["jparams"], s["jcfg"]
    caches = jax_model.init_caches(jcfg, B, MAX_LEN)
    x, caches = jax_forward(jp, jcfg, _jbatch(enc, enc_valid, toks),
                            mode="prefill", caches=caches,
                            kv_valid=jnp.asarray(valid))
    hs = [np.asarray(x[np.arange(B), np.asarray(PROMPT_LENS) - 1],
                     np.float32)]
    pos = np.asarray(PROMPT_LENS, np.int32)
    for i in range(nxt.shape[1]):
        x, caches = jax_forward(jp, jcfg, {"tokens": jnp.asarray(
            nxt[:, i:i + 1])}, mode="decode", caches=caches,
            pos=jnp.asarray(pos + i))
        hs.append(np.asarray(x[:, -1], np.float32))
    return np.stack(hs), caches


def port_serve(s, enc, enc_valid, toks, valid, nxt):
    """The port's prefill then 8 decode steps, as ``jax_serve``."""
    params, cfg = s["params"], s["cfg"]
    with torch.inference_mode():
        caches = model_mod.init_caches(cfg, B, MAX_LEN, "cpu", enc_len=T)
        x, caches = model_mod.forward(
            params, cfg, _tbatch(enc, enc_valid, toks), mode="prefill",
            caches=caches, kv_valid=torch.from_numpy(valid))
        hs = [_np(x[np.arange(B), np.asarray(PROMPT_LENS) - 1])]
        pos = np.asarray(PROMPT_LENS, np.int32)
        for i in range(nxt.shape[1]):
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(nxt[:, i:i + 1].copy()),
                caches, torch.from_numpy(pos + i))
            hs.append(_np(h))
    return np.stack(hs), caches


@functools.cache
def _served(kind: str):
    """Both sides' prefill + 8 decode steps, with and without ragged
    frames."""
    s = _setup_once(kind)
    enc, enc_valid, toks, valid, nxt = _inputs(s["cfg"])
    out = {}
    for frames in ("ragged", "all"):
        ev = enc_valid if frames == "ragged" else None
        out[frames] = (jax_serve(s, enc, ev, toks, valid, nxt),
                       port_serve(s, enc, ev, toks, valid, nxt))
    return out


@pytest.fixture(scope="module")
def served(setup):
    return _served(setup["kind"])


# ---- the model against the reference ---------------------------------------

def test_config_equals_the_reference():
    """The port's copy of the config, at full width and reduced, field for
    field (``ENC_FRAMES`` is a serving constant beside it)."""
    assert dataclasses.asdict(get_config("whisper-medium")) \
        == dataclasses.asdict(jax_get_config("whisper-medium"))
    assert dataclasses.asdict(reduce_for_smoke(get_config("whisper-medium"))) \
        == dataclasses.asdict(jax_reduce(jax_get_config("whisper-medium")))
    assert ENC_FRAMES == 1500


def test_full_config_builds_at_full_width():
    """check_supported passes, and the full-width model holds exactly the
    reference's leaves at their shapes: the 24 decoder layers with
    ``xattn`` and ``xattn_norm``, the 24 encoder layers and
    ``enc_final_norm``; 758.6 M parameters (the vocabulary padded to
    51968 rows)."""
    cfg = get_config("whisper-medium")
    model_mod.check_supported(cfg)
    m = model_mod.Model(cfg, torch.Generator(), "meta")
    shapes = jax.eval_shape(lambda: jax_model.init_params(
        jax_get_config("whisper-medium"), jax.random.PRNGKey(0)))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        flat[jax.tree_util.keystr(path)] = leaf.shape
    n = sum(p.numel() for p in m.parameters())
    assert n == sum(int(np.prod(s)) for s in flat.values())
    assert n == 758_575_104
    assert len(m.layers) == len(m.enc_layers) == 24
    assert m.embed.shape == (51_968, 1024) and not hasattr(m, "lm_head")
    assert {n for n, _ in m.layers[0].named_parameters()} >= {
        "xattn.wq", "xattn.bq", "xattn.bk", "xattn.bv", "xattn_norm.scale",
        "xattn_norm.bias"}
    assert not hasattr(m.layers[0], "post_norm")
    assert not hasattr(m.enc_layers[0], "xattn")


def test_encode_matches_jax_with_ragged_frames(setup):
    enc, enc_valid, *_ = _inputs(setup["cfg"])
    want = jax_model.encode(setup["jparams"], setup["jcfg"], jnp.asarray(enc),
                            jnp.asarray(enc_valid))
    with torch.inference_mode():
        got = model_mod.encode(setup["params"], setup["cfg"],
                               torch.from_numpy(enc),
                               torch.from_numpy(enc_valid))
    assert got.shape == (B, T, setup["cfg"].d_model)
    _hold(_np(got), want, setup["kind"])


def test_build_cross_kv_matches_jax_layer_by_layer(setup):
    jp, jcfg = setup["jparams"], setup["jcfg"]
    enc, enc_valid, *_ = _inputs(setup["cfg"])
    hidden = jax_model.encode(jp, jcfg, jnp.asarray(enc),
                              jnp.asarray(enc_valid))
    want = jax.tree.map(np.asarray,
                        jax_model.build_cross_kv(jp, jcfg, hidden))
    with torch.inference_mode():
        got = model_mod.build_cross_kv(
            setup["params"], setup["cfg"],
            torch.from_numpy(np.array(hidden, np.float32)).to(
                setup["params"].embed.dtype))
    assert len(got) == setup["cfg"].num_layers
    for l, (k, v) in enumerate(got):
        _hold(_np(k), want["scan"][0]["k"][l], setup["kind"], f"k {l}")
        _hold(_np(v), want["scan"][0]["v"][l], setup["kind"], f"v {l}")


@pytest.mark.parametrize("frames", ["ragged", "all"])
def test_forward_full_matches_jax(setup, frames):
    enc, enc_valid, toks, *_ = _inputs(setup["cfg"])
    ev = enc_valid if frames == "ragged" else None
    want, _ = jax_forward(setup["jparams"], setup["jcfg"],
                          _jbatch(enc, ev, toks), mode="full")
    with torch.inference_mode():
        got, caches = model_mod.forward(setup["params"], setup["cfg"],
                                        _tbatch(enc, ev, toks), mode="full",
                                        caches=None)
    assert caches is None
    _hold(_np(got), want, setup["kind"])


@pytest.mark.parametrize("frames", ["ragged", "all"])
def test_prefill_and_decode_steps_match_jax(setup, served, frames):
    """Each row's hidden state after its prompt and after each of 8 decode
    steps at its own position; then the self and cross caches. With
    ragged frames the prefill masks the padded frames and the decode
    attends them, on both sides."""
    (want, jcaches), (got, caches) = served[frames]
    for i in range(want.shape[0]):
        _hold(got[i], want[i], setup["kind"], f"step {i}")
    back = convert.caches_to_jax(caches, setup["cfg"])
    assert set(back) == {"scan", "tail", "cross"}
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(jcaches)):
        _hold(g, w, setup["kind"], jax.tree_util.keystr(path))


def test_greedy_tokens_agree_with_jax(f32):
    """8 greedy steps from the prefill's token, each side feeding back its
    own: agreement >= 0.95."""
    jp, jcfg, params, cfg = (f32[k] for k in ("jparams", "jcfg", "params",
                                              "cfg"))
    enc, enc_valid, toks, valid, _ = _inputs(cfg)
    last = np.asarray(PROMPT_LENS) - 1
    caches = jax_model.init_caches(jcfg, B, MAX_LEN)
    x, caches = jax_forward(jp, jcfg, _jbatch(enc, None, toks),
                            mode="prefill", caches=caches,
                            kv_valid=jnp.asarray(valid))
    want = [np.asarray(jax_model.greedy_next(jp, jcfg, x[np.arange(B),
                                                         last]))]
    for i in range(8):
        x, caches = jax_forward(jp, jcfg, {"tokens": jnp.asarray(
            want[-1][:, None])}, mode="decode", caches=caches,
            pos=jnp.asarray(np.asarray(PROMPT_LENS, np.int32) + i))
        want.append(np.asarray(jax_model.greedy_next(jp, jcfg, x[:, -1])))
    srv = EncDecServer(cfg, params, batch_size=B, enc_frames=T,
                       prompt_len=S, max_len=MAX_LEN)
    got = srv.transcribe(enc, [t[:n] for t, n in zip(toks, PROMPT_LENS)],
                         9).tokens
    want = np.stack(want, 1)
    agreement = token_agreement(list(zip(got.tolist(), want.tolist())))
    assert agreement >= 0.95, (agreement, got, want)


@pytest.mark.parametrize("kind", ["f32", "f32_hd64"])
def test_prefill_decode_equals_full_in_the_port(kind):
    """``tests/test_arch_smoke.py``'s check inside the port: a prefill of
    8 tokens then 4 decode steps give ``forward(mode="full")``'s hidden
    state at every position (2e-4)."""
    s = _setup(kind)
    params, cfg = s["params"], s["cfg"]
    rng = np.random.default_rng(2)
    enc = (0.1 * rng.standard_normal((B, 16, cfg.d_model))).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    with torch.inference_mode():
        full, _ = model_mod.forward(params, cfg,
                                    _tbatch(enc, None, toks), mode="full",
                                    caches=None)
        h, caches = model_mod.prefill(params, cfg,
                                      _tbatch(enc, None, toks[:, :8]),
                                      max_len=MAX_LEN)
        _close(_np(h), _np(full[:, 7]), 2e-4, "prefill")
        for t in range(8, 12):
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(toks[:, t:t + 1].copy()),
                caches, t)
            _close(_np(h), _np(full[:, t]), 2e-4, f"position {t}")


# ---- planted faults ------------------------------------------------------

def _plant(monkeypatch, fault: str) -> None:
    """Break the port in one way: RoPE on the cross query (at the positions
    the layer's self-attention uses: 0..S-1 at prefill, ``pos`` at
    decode), a causal encoder, cross-attention dropped, or decode's
    cross-attention cut to the first half of the frames."""
    cross, apply = attn_mod.cross_attention, blk_mod.apply_block
    if fault == "cross query rotated":
        project, where = attn_mod._project_q, {}

        def recording(*a, **kw):
            pos = kw.get("pos")
            where["p"] = kw["positions"] if kw.get("positions") is not None \
                else (None if pos is None else pos[:, None])
            return apply(*a, **kw)

        def rotated(p, x, cfg, positions):
            return project(p, x, cfg, where["p"] if positions is None
                           else positions)

        monkeypatch.setattr(blk_mod, "apply_block", recording)
        monkeypatch.setattr(attn_mod, "_project_q", rotated)
    elif fault == "causal encoder":
        monkeypatch.setattr(blk_mod, "apply_block", lambda *a, **kw: apply(
            *a, **{**kw, "causal": True}))
    elif fault == "cross-attention dropped":
        monkeypatch.setattr(attn_mod, "cross_attention",
                            lambda p, x, *a, **kw: torch.zeros_like(x))
    elif fault == "decode cross cut to half the frames":
        def cut(p, x, ck, cv, cfg, *, mode, kv_valid=None):
            if mode == "decode":
                n = ck.shape[1] // 2
                ck, cv = ck[:, :n].contiguous(), cv[:, :n].contiguous()
            return cross(p, x, ck, cv, cfg, mode=mode, kv_valid=kv_valid)

        monkeypatch.setattr(attn_mod, "cross_attention", cut)
    else:
        raise ValueError(fault)


FAULTS = ["cross query rotated", "causal encoder", "cross-attention dropped",
          "decode cross cut to half the frames"]


@pytest.mark.parametrize("kind", ["f32", "f32_hd64"])
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_comparison(monkeypatch, kind, fault):
    """With the fault planted, the port's hidden states (the prefill's and
    every decode step's, all frames real) leave the reference's by more
    than 5x the f32 tolerance; unplanted they hold (the test above). (In
    bf16 the comparison's relative measure dilutes a fault that acts on
    the prefill alone: RoPE at the prompt's positions moves it 0.006.)"""
    s = _setup_once(kind)
    (want, _), _ = _served(kind)["all"]
    _plant(monkeypatch, fault)
    got, _ = port_serve(s, *(None if i == 1 else a for i, a in
                             enumerate(_inputs(s["cfg"]))))
    if fault == "decode cross cut to half the frames":
        got, want = got[1:], want[1:]          # the decode steps
    past = _err(got, want)
    assert past > 5 * TOL[kind], (fault, past)


def test_causal_encoder_fails_encode(monkeypatch, f32):
    enc, enc_valid, *_ = _inputs(f32["cfg"])
    want = jax_model.encode(f32["jparams"], f32["jcfg"], jnp.asarray(enc),
                            jnp.asarray(enc_valid))
    _plant(monkeypatch, "causal encoder")
    got = model_mod.encode(f32["params"], f32["cfg"], torch.from_numpy(enc),
                           torch.from_numpy(enc_valid))
    assert _err(_np(got), want) > 5 * TOL["f32"]


def test_reference_forward_skips_cross_attention(monkeypatch, f32):
    """The JAX ``forward`` runs the decoder's layers as ``global`` blocks:
    it equals the port with its cross-attention dropped, and differs from
    the port's (and ``jax_forward``'s) decoder."""
    enc, _, toks, *_ = _inputs(f32["cfg"])
    want, _, _ = jax_model.forward(f32["jparams"], f32["jcfg"],
                                   _jbatch(enc, None, toks), mode="full")
    with torch.inference_mode():
        real, _ = model_mod.forward(f32["params"], f32["cfg"],
                                    _tbatch(enc, None, toks), mode="full",
                                    caches=None)
        _plant(monkeypatch, "cross-attention dropped")
        dropped, _ = model_mod.forward(f32["params"], f32["cfg"],
                                       _tbatch(enc, None, toks),
                                       mode="full", caches=None)
    _close(_np(dropped), want, TOL["f32"])
    assert _err(_np(real), want) > 5 * TOL["f32"]


# ---- convert, caches, modes ------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16_hd64"])
def test_convert_round_trips_bit_for_bit(kind):
    s = _setup(kind)
    back = convert.params_to_jax(s["params"], s["cfg"])
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(s["tree"])
    for (path, got), want in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree.leaves(s["tree"])):
        assert np.array_equal(got, np.asarray(want, np.float32)), path
    assert s["params"].layers[1].xattn.bk.abs().sum() > 0
    assert s["params"].enc_layers[1].attn.bq.abs().sum() > 0
    assert s["params"].enc_final_norm.bias.abs().sum() > 0


def test_caches_round_trip_bit_for_bit(setup, served):
    (_, jcaches), _ = served["ragged"]
    np_caches = jax.tree.map(lambda a: np.asarray(a, np.float32), jcaches)
    caches = convert.caches_from_jax(np_caches, setup["cfg"], "cpu")
    assert set(caches[0]) == {"k", "v", "cross_k", "cross_v"}
    back = convert.caches_to_jax(caches, setup["cfg"])
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(np_caches)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(np_caches)):
        assert np.array_equal(g, w)


def test_caches_need_the_frames_and_keep_their_extents(f32):
    cfg = f32["cfg"]
    with pytest.raises(ValueError, match="enc_len"):
        model_mod.init_caches(cfg, B, MAX_LEN, "cpu")
    caches = model_mod.init_caches(cfg, B, MAX_LEN, "cpu", enc_len=T)
    assert caches[0]["cross_k"].shape == (B, T, cfg.num_kv_heads,
                                          cfg.head_dim)
    assert model_mod.cache_extents(cfg, caches) == (MAX_LEN, None)
    enc, _, toks, valid, _ = _inputs(cfg)
    with pytest.raises(ValueError, match="frames"):
        model_mod.forward(f32["params"], cfg,
                          _tbatch(enc[:, :T - 1].copy(), None, toks),
                          mode="prefill", caches=caches)


def test_decoder_layers_refuse_chunks_and_need_frames(f32):
    cfg, params = f32["cfg"], f32["params"]
    caches = model_mod.init_caches(cfg, B, MAX_LEN, "cpu", enc_len=T)
    toks = np.zeros((B, 4), np.int32)
    with pytest.raises(ValueError, match="decoder"):
        model_mod.chunk_prefill_step(params, cfg, torch.from_numpy(toks),
                                     caches, [0, 1, 2], [0] * 3, [0] * 3,
                                     [4] * 3)
    with pytest.raises(ValueError, match="enc_embeds"):
        model_mod.forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                          mode="full", caches=None)


# ---- serving ---------------------------------------------------------------

def _stage_inputs(srv, seed):
    rng = np.random.default_rng(seed)
    P, cfg = srv.prompt_len, srv.cfg
    lens = rng.integers(1, P + 1, srv.batch_size)
    pre = {"enc_embeds": (0.1 * rng.standard_normal(
               (srv.batch_size, srv.enc_frames, cfg.d_model))).astype(
               np.float32),
           "tokens": rng.integers(0, cfg.vocab_size,
                                  (srv.batch_size, P)).astype(np.int32),
           "kv_valid": np.arange(P)[None, :] < lens[:, None]}
    dec = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (srv.batch_size, 1)).astype(np.int32),
           "pos": (lens + rng.integers(0, 8, srv.batch_size)).astype(
               np.int32)}
    return pre, dec


@pytest.mark.parametrize("kind", ["f32", "bf16_hd64"])
def test_stages_are_capturable_and_keep_their_buffers(kind):
    """Each stage, warmed up once as the executor warms it, issues the
    same aten ops on two inputs and none that syncs or reads a value; a
    second prefill writes its cross K/V into the same buffers."""
    s = _setup(kind)
    srv = EncDecServer(s["cfg"], s["params"], batch_size=B, enc_frames=T,
                       prompt_len=S, max_len=MAX_LEN)
    ptrs = [(c["cross_k"].data_ptr(), c["cross_v"].data_ptr())
            for c in srv.caches]
    (pre0, dec0), (pre1, dec1) = (_stage_inputs(srv, n) for n in (3, 4))
    for stage, inputs in ((srv.prefill_stage(), (pre0, pre1)),
                          (srv.decode_stage(), (dec0, dec1))):
        _record(stage, inputs[0])                 # the executor's warm-up
        first, second = (_record(stage, x) for x in inputs)
        assert first.ops and not first.bad and not second.bad, \
            (first.bad, second.bad)
        assert first.ops == second.ops
    assert [(c["cross_k"].data_ptr(), c["cross_v"].data_ptr())
            for c in srv.caches] == ptrs
    hidden = model_mod.encode(s["params"], s["cfg"],
                              torch.from_numpy(pre1["enc_embeds"]))
    k, v = model_mod.build_cross_kv(s["params"], s["cfg"], hidden)[1]
    assert torch.equal(srv.caches[1]["cross_k"], k)
    assert torch.equal(srv.caches[1]["cross_v"], v)


def test_graphed_server_serves_two_batches_as_an_eager_one(monkeypatch,
                                                           f32):
    """The executor's graphed path (the capture stubbed by a replay that
    recomputes the body) over two different batches: the second batch's
    tokens equal an eager server's; one capture per stage, replays after."""
    def stub(body, pool):
        out = body()
        return _StubGraph(body, out), out

    monkeypatch.setattr(executor_mod, "capture", stub)
    cfg, params = f32["cfg"], f32["params"]
    kw = dict(batch_size=B, enc_frames=T, max_len=MAX_LEN)
    graphed = EncDecServer(cfg, params, **kw)
    graphed.executor.graphs = True
    first = graphed.transcribe(*stub_batch(cfg, B, seed=0, frames=T), 6)
    second = graphed.transcribe(*stub_batch(cfg, B, seed=1, frames=T), 6)
    want = EncDecServer(cfg, params, **kw).transcribe(
        *stub_batch(cfg, B, seed=1, frames=T), 6)
    assert np.array_equal(second.tokens, want.tokens)
    assert not np.array_equal(first.tokens, second.tokens)
    ex = graphed.executor
    assert ex.captures == {"encdec_prefill": 1, "encdec_decode": 1}
    assert ex.replays == {"encdec_prefill": 1, "encdec_decode": 2 * 5 - 1}
    assert sorted(ex.cached_keys()) == [("encdec_decode", B),
                                        ("encdec_prefill", B)]
    assert len(second.step_s) == 5 and second.prefill_s > 0
    assert flash_attn.launches == decode_attn.launches == 0


def test_server_refuses_bad_batches(f32):
    cfg, params = f32["cfg"], f32["params"]
    srv = EncDecServer(cfg, params, batch_size=2, enc_frames=T,
                       max_len=MAX_LEN)
    enc, prompts = stub_batch(cfg, 2, seed=0, frames=T)
    with pytest.raises(ValueError, match="rows"):
        srv.transcribe(enc[:1], prompts[:1], 2)
    with pytest.raises(ValueError, match="fit"):
        srv.transcribe(enc, prompts, MAX_LEN)
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        EncDecServer(reduce_for_smoke(get_config("deepseek-7b")), params)


@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_engine_refuses_an_encoder_decoder_config(f32, prefill_chunk):
    with pytest.raises(ValueError, match="'decoder'"):
        InferenceEngine(f32["cfg"], f32["params"], device="cpu",
                        prefill_chunk=prefill_chunk)


def test_launcher_transcribes_on_the_cpu():
    srv, run = serve_launcher.main(["--arch", "whisper-medium", "--device",
                                    "cpu", "--slots", "2", "--new-tokens",
                                    "3"])
    assert srv.enc_frames == ENC_FRAMES
    assert run.tokens.shape == (2, 3) and len(run.step_s) == 2
    assert ((run.tokens >= 0) & (run.tokens < srv.cfg.vocab_size)).all()
    assert not srv.executor.graphs and not srv.executor.replays

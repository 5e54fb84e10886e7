"""The port's training loss and its gradients against the JAX package's, on
the CPU.

For each arch of the reference's ``ASSIGNED_ARCHS``, at ``reduce_for_smoke``
(f32), the port's seeded weights with every all-zero leaf (biases, norm
scales, ``A_log``, ...) drawn nonzero, carried across to the reference
with ``repro_torch.convert``; batches as ``tests/test_arch_smoke.py::_batch``
builds them (``enc_embeds`` for whisper, ``embeds`` for qwen2-vl), drawn
with numpy. The port's ``loss_fn`` (mode 'train': the dense attention in
plain torch, the MoE aux carried through the blocks) must give the
reference's loss, xent, z and aux within 1e-5, and autograd's gradients,
mapped back with ``convert.state_to_jax``, ``jax.grad``'s within 2e-3
relative / 1e-5 absolute (the reference's f32 tolerance). The reference's
own ``forward`` runs whisper's decoder layers as ``global`` blocks and
never reads the encoder (ROADMAP C); whisper is held, as
``tests/test_torch_whisper.py`` holds it, to the reference's pieces run
as its ``decoder`` blocks. Also: remat on against off, and the flash
wrapper's plain version staying differentiable on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import model as jax_model
from repro.models.common import apply_norm as jax_apply_norm
from repro.sharding import vocab as jax_vocab
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.sharding import vocab as vocab_mod

B, S, ENC_T = 2, 16, 24
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5


def draw_zero_leaves(model, seed: int):
    """Every all-zero parameter (biases, norm scales, ``A_log``,
    ``dt_bias``, ...) drawn N(0, 0.1) in place: zeros would hide a port
    that drops them."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    return model


def make_batch(cfg, seed: int, batch: int = B, seq: int = S):
    """``test_arch_smoke._batch``'s inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encdec is not None:
        out["enc_embeds"] = (rng.standard_normal((batch, ENC_T, cfg.d_model))
                             * 0.1).astype(np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq),
                                     dtype=np.int32)
    elif cfg.input_kind == "embeddings":
        out["embeds"] = (rng.standard_normal((batch, seq, cfg.d_model))
                         * 0.1).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq),
                                     dtype=np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq),
                                 dtype=np.int32)
    return out


def jax_loss(jp, jcfg, batch):
    """The reference's ``loss_fn``; for an enc-dec config its pieces with
    the decoder layers run as the ``decoder`` blocks ``init_params``
    builds."""
    if jcfg.encdec is None:
        return jax_model.loss_fn(jp, jcfg, batch)
    unit, _, tail = jcfg.scan_plan()
    x = jax_model._embed_inputs(jp, jcfg, batch)
    cross_kv = jax_model.build_cross_kv(
        jp, jcfg, jax_model.encode(jp, jcfg, batch["enc_embeds"],
                                   batch.get("enc_valid")))
    x, _, aux = jax_model._run_stack(
        jp["scan"], jp["tail"], x, jcfg, ("decoder",) * len(unit),
        ("decoder",) * len(tail), mode="full",
        positions=jax_model._default_positions(jcfg, x.shape[0], x.shape[1]),
        cross_kv=cross_kv, cross_valid=batch.get("enc_valid"), causal=True)
    x = jax_apply_norm(jp["final_norm"], x, jcfg.norm_type, jcfg.norm_eps)
    loss, z = jax_vocab.lm_head_loss(x, jax_model.head_table(jp, jcfg),
                                     batch["labels"], jcfg,
                                     batch.get("loss_mask"))
    return loss + 1e-4 * z + 1e-2 * aux, {"xent": loss, "z": z, "aux": aux}


def setup_arch(arch: str, seed: int = 0):
    """(jcfg, cfg, the JAX parameter tree (numpy), the port's model with
    gradients on): the port's seed-``seed`` weights, zero leaves drawn,
    carried across with ``convert.params_to_jax``."""
    jcfg = jax_reduce(jax_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    model = draw_zero_leaves(model_mod.init_params(cfg, seed, "cpu"), seed)
    return jcfg, cfg, convert.params_to_jax(model, cfg), \
        model.requires_grad_(True)


def jax_loss_and_grads(jp, jcfg, batch):
    """((total, parts), grads) of ``jax_loss``, jitted."""
    f = jax.jit(jax.value_and_grad(lambda p, b: jax_loss(p, jcfg, b),
                                   has_aux=True))
    return f(jax.tree.map(jnp.asarray, jp),
             {k: jnp.asarray(v) for k, v in batch.items()})


def port_loss_and_grads(model, cfg, batch, remat=False):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, parts = model_mod.loss_fn(model, cfg, tb, remat=remat)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, grads)}
    return loss.item(), {k: v.item() for k, v in parts.items()}, grads


def _paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, cfg, jp, model = setup_arch(arch)
    batch = make_batch(cfg, seed=1)
    (jl, jparts), jg = jax_loss_and_grads(jp, jcfg, batch)
    loss, parts, grads = port_loss_and_grads(model, cfg, batch)
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_TOL, atol=LOSS_TOL)
    for k in ("xent", "z", "aux"):
        np.testing.assert_allclose(parts[k], float(jparts[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=k)
    if cfg.moe is not None:
        assert parts["aux"] > 0
    want, got = _paths(jg), _paths(convert.state_to_jax(grads, cfg))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path)
    # every weight matrix of the port gets a gradient (none left out of
    # autograd, as the flash kernel's launch would leave wq, wk and wv)
    for name, g in grads.items():
        if name.endswith(("attn.wq", "attn.wk", "attn.wv")):
            assert g.abs().max() > 0, name


def test_loss_and_grads_at_mamba2_published_widths():
    """mamba2-130m at its published widths (d_model 768, the SSD's 24
    heads of 64, d_state 128, chunk 256) cut to 2 layers and a 512-token
    vocabulary, over 128 tokens: the gradients the full-width training
    runs on are the reference's."""
    kw = dict(num_layers=2, vocab_size=512, param_dtype="float32",
              activation_dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("mamba2-130m"), **kw)
    cfg = dataclasses.replace(get_config("mamba2-130m"), **kw)
    model = draw_zero_leaves(model_mod.init_params(cfg, 0, "cpu"), 0)
    jp = convert.params_to_jax(model, cfg)
    batch = make_batch(cfg, seed=1, batch=2, seq=128)
    (jl, _), jg = jax_loss_and_grads(jp, jcfg, batch)
    loss, _, grads = port_loss_and_grads(model.requires_grad_(True), cfg,
                                         batch)
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_TOL)
    want, got = _paths(jg), _paths(convert.state_to_jax(grads, cfg))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=path)


@pytest.mark.parametrize("arch", ["deepseek-7b", "dbrx-132b", "mamba2-130m",
                                  "recurrentgemma-9b", "whisper-medium"])
def test_remat_matches_no_remat(arch):
    """``tests/test_system.py::test_remat_matches_no_remat`` on the port,
    one arch per block kind: the same loss, gradients within 1e-3 / 1e-5."""
    _, cfg, _, model = setup_arch(arch)
    batch = make_batch(cfg, seed=4, batch=4)
    l1, _, g1 = port_loss_and_grads(model, cfg, batch, remat=False)
    l2, _, g2 = port_loss_and_grads(model, cfg, batch, remat=True)
    assert abs(l1 - l2) < 1e-5
    for name in g1:
        np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_training_forward_takes_no_kernel(monkeypatch):
    """Mode 'train' never calls the flash or decode wrappers: its attention
    is the dense path in plain torch, chosen by ``loss_fn``."""
    from repro_torch.models import attention as attn_mod

    def refused(*a, **k):
        raise AssertionError("a kernel wrapper was called in mode 'train'")

    for name in ("flash_attn", "decode_attn", "decode_attn_int8"):
        monkeypatch.setattr(attn_mod, name, refused)
    for arch in ("gemma2-27b", "whisper-medium", "qwen2-vl-7b"):
        _, cfg, _, model = setup_arch(arch)
        loss, _, grads = port_loss_and_grads(model, cfg,
                                             make_batch(cfg, seed=2))
        assert np.isfinite(loss)


def test_flash_plain_version_stays_differentiable():
    """On the CPU ``flash_attn`` runs its plain version, which autograd
    differentiates, as before the CUDA kernel's grad guard."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True)
               for s in ((2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)))
    lens = torch.tensor([8, 5], dtype=torch.int32)
    out = flash_attn(q, k, v, lens)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, lens))
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert all(g.abs().max() > 0 for g in (gq, gk, gv))
    assert flash_attn.launches == 0


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_head_loss_matches_reference(cap, masked):
    """A vocabulary of 300 padded to 512 (the padded columns at -1e30), a
    final softcap and a loss mask: (loss, z) as the reference's."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma2-27b")),
                              vocab_size=300, final_logit_softcap=cap)
    jcfg = dataclasses.replace(jax_reduce(jax_get_config("gemma2-27b")),
                               vocab_size=300, final_logit_softcap=cap)
    rng = np.random.default_rng(6)
    Vp = vocab_mod.padded_vocab(cfg)
    assert Vp == 512
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 3).astype(np.float32)
    table = rng.standard_normal((Vp, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, 300, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    got = vocab_mod.lm_head_loss(
        torch.from_numpy(x), torch.from_numpy(table), torch.from_numpy(labels),
        cfg, None if mask is None else torch.from_numpy(mask))
    want = jax_vocab.lm_head_loss(jnp.asarray(x), jnp.asarray(table),
                                  jnp.asarray(labels), jcfg,
                                  None if mask is None else jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=LOSS_TOL)


@pytest.mark.parametrize("arch,kind,causal", [
    ("deepseek-7b", "global", True), ("gemma2-27b", "local", True),
    ("gemma2-27b", "global", False), ("qwen2-vl-7b", "global", True)])
def test_dense_attention_is_the_kernels_function(monkeypatch, arch, kind,
                                                 causal):
    """The training attention computes what the serving path's flash
    wrapper (its plain version here) computes at every real query of
    right-padded rows, the pads masked by ``kv_valid`` (a pad query whose
    window holds no real key gives 0 there and the mean of the values
    here, the reference's dense path's ``NEG_INF`` row: neither is read);
    and its query blocks (``PREFILL_Q_CHUNK``, cut to 4 here so that 16
    queries take the blocked path) change nothing."""
    cfg = reduce_for_smoke(get_config(arch))
    model = draw_zero_leaves(model_mod.init_params(cfg, 0, "cpu"), 0)
    p = model.layers[0].attn
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 16, cfg.d_model))
                         .astype(np.float32))
    valid = torch.arange(16)[None, :] < torch.tensor([16, 11, 5])[:, None]
    pos = model_mod._default_positions(cfg, 3, 16, "cpu")
    with torch.no_grad():
        want, _ = attn_mod.full_attention(p, x, cfg, pos, valid, kind=kind,
                                          causal=causal)
        got = attn_mod.dense_attention(p, x, cfg, pos, valid, kind=kind,
                                       causal=causal)
        monkeypatch.setattr(attn_mod, "PREFILL_Q_CHUNK", 4)
        blocked = attn_mod.dense_attention(p, x, cfg, pos, valid, kind=kind,
                                           causal=causal)
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(blocked, got, rtol=1e-6, atol=1e-6)


def test_dense_cross_attention_is_the_kernels_function():
    """Whisper's cross-attention in plain torch against the serving path's
    (the flash wrapper's plain version), frames past ``kv_valid``
    masked."""
    cfg = reduce_for_smoke(get_config("whisper-medium"))
    model = draw_zero_leaves(model_mod.init_params(cfg, 0, "cpu"), 0)
    p = model.layers[0].xattn
    rng = np.random.default_rng(9)
    x, enc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((2, 6, cfg.d_model), (2, 24, cfg.d_model)))
    valid = torch.arange(24)[None, :] < torch.tensor([24, 13])[:, None]
    with torch.no_grad():
        k, v = attn_mod.cross_kv(p, enc, cfg)
        want = attn_mod.cross_attention(p, x, k, v, cfg, mode="full",
                                        kv_valid=valid)
        got = attn_mod.dense_cross_attention(p, x, k, v, cfg, kv_valid=valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

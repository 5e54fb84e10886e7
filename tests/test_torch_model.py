"""The port's deepseek-7b model against the JAX package's, on the CPU.

Reduced deepseek-7b (``reduce_for_smoke``: 2 layers, d_model 64, f32) with
the JAX package's initial weights carried across by
``repro_torch.convert``. Prefill and decode hidden states must agree within
2e-3 (f32 math on both sides; the port's attention goes through its
kernels' plain versions), and greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import model as jax_model
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import model as model_mod

TOL = 2e-3
B, S, MAX_LEN = 3, 16, 32
LENS = np.array([16, 9, 1])           # right-padded rows


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    valid = np.arange(S)[None, :] < LENS[:, None]
    return jcfg, cfg, jparams, params, tokens, valid


def _jax_prefill(jcfg, jparams, tokens, valid, impl):
    jc = dataclasses.replace(jcfg, attention_impl=impl)
    return jax_model.forward(
        jparams, jc, {"tokens": jnp.asarray(tokens)}, mode="prefill",
        caches=jax_model.init_caches(jc, B, MAX_LEN),
        kv_valid=jnp.asarray(valid))[:2]


def _port_prefill(cfg, params, tokens, valid):
    return model_mod.forward(
        params, cfg, {"tokens": torch.from_numpy(tokens)}, mode="prefill",
        caches=model_mod.init_caches(cfg, B, MAX_LEN, "cpu"),
        kv_valid=torch.from_numpy(valid))


def test_configs_agree(setup):
    jcfg, cfg = setup[:2]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(jax_get_config("deepseek-7b")) \
        == dataclasses.asdict(get_config("deepseek-7b"))


def test_params_carry_across_bit_identical(setup):
    jcfg, cfg, jparams, params = setup[:4]
    w = np.asarray(jparams["scan"][0]["attn"]["wq"])      # (layers, d, H, hd)
    for layer in range(cfg.num_layers):
        assert np.array_equal(params.layers[layer].attn.wq.numpy(), w[layer])
    assert np.array_equal(params.lm_head.numpy(),
                          np.asarray(jparams["lm_head"]))
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_jax


@pytest.mark.parametrize("impl", ["chunked_jnp", "flash_pallas"])
def test_prefill_hidden_matches_jax(setup, impl):
    jcfg, cfg, jparams, params, tokens, valid = setup
    hj, cj = _jax_prefill(jcfg, jparams, tokens, valid, impl)
    with torch.inference_mode():
        h, caches = _port_prefill(cfg, params, tokens, valid)
    assert h.shape == (B, S, cfg.d_model) and h.dtype == torch.float32
    # padded positions are discarded by the engine: compare real ones only
    np.testing.assert_allclose(h.numpy()[valid], np.asarray(hj)[valid],
                               rtol=TOL, atol=TOL)
    back = convert.caches_to_jax(caches, cfg)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(cj)):
        np.testing.assert_allclose(got[:, :, :S][:, valid],
                                   np.asarray(want)[:, :, :S][:, valid],
                                   rtol=TOL, atol=TOL)


def test_decode_hidden_matches_jax_with_inactive_row(setup):
    """Decode after a JAX prefill carried across by caches_from_jax, per-row
    positions, and an inactive row whose cache must stay bit-unchanged."""
    jcfg, cfg, jparams, params, tokens, valid = setup
    _, cj = _jax_prefill(jcfg, jparams, tokens, valid, "chunked_jnp")
    pos = LENS.astype(np.int32)                     # next write position
    active = np.array([True, False, True])
    nxt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 1)) \
        .astype(np.int32)
    hj, cj2 = jax_model.decode_step(jparams, jcfg, jnp.asarray(nxt), cj,
                                    jnp.asarray(pos),
                                    active=jnp.asarray(active))
    caches = convert.caches_from_jax(jax.tree.map(np.asarray, cj), cfg,
                                     "cpu")
    before = [{k: t.clone() for k, t in c.items()} for c in caches]
    with torch.inference_mode():
        h, caches = model_mod.decode_step(params, cfg, torch.from_numpy(nxt),
                                          caches, torch.from_numpy(pos),
                                          active=active)
    np.testing.assert_allclose(h.numpy()[active], np.asarray(hj)[active],
                               rtol=TOL, atol=TOL)
    for layer, old in zip(caches, before):
        for name in ("k", "v"):
            assert torch.equal(layer[name][1], old[name][1])     # inactive
    back = convert.caches_to_jax(caches, cfg)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(cj2)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    # the greedy head on the same hidden states picks the same tokens
    got_tok = model_mod.greedy_next(params, cfg, torch.from_numpy(
        np.array(hj)))
    assert got_tok.dtype == torch.int32
    assert got_tok.tolist() == np.asarray(
        jax_model.greedy_next(jparams, jcfg, hj)).tolist()


def test_scalar_pos_decode_equals_per_row_pos(setup):
    jcfg, cfg, jparams, params, tokens, valid = setup
    with torch.inference_mode():
        _, caches = _port_prefill(cfg, params, tokens, valid)
        nxt = torch.zeros(B, 1, dtype=torch.int32)
        c1 = [{k: t.clone() for k, t in c.items()} for c in caches]
        h_scalar, _ = model_mod.decode_step(params, cfg, nxt, caches, 12)
        h_rows, _ = model_mod.decode_step(params, cfg, nxt, c1,
                                          torch.full((B,), 12,
                                                     dtype=torch.int32))
    assert torch.equal(h_scalar, h_rows)


def test_greedy_masks_padded_vocab_and_breaks_ties_low(setup):
    cfg, params = setup[1], setup[3]
    from repro_torch.sharding import vocab
    Vp = vocab.padded_vocab(cfg)
    table = torch.zeros(Vp, cfg.d_model)
    table[cfg.vocab_size:] = 1.0        # padded rows would win if unmasked
    table[[7, 5], 0] = 0.5              # a tie between ids 5 and 7
    x = torch.zeros(2, cfg.d_model)
    x[:, 0] = 1.0
    logits = vocab.lm_head_logits(x[:, None], table, cfg)[:, 0]
    assert torch.isinf(logits[:, cfg.vocab_size:]).all()
    assert vocab.sharded_greedy(x, table, cfg).tolist() == [5, 5]


def test_prefill_helper_returns_last_hidden(setup):
    cfg, params, tokens = setup[1], setup[3], setup[4]
    with torch.inference_mode():
        last, caches = model_mod.prefill(params, cfg,
                                         {"tokens": torch.from_numpy(tokens)},
                                         max_len=MAX_LEN)
        full, _ = _port_prefill(cfg, params, tokens,
                                np.ones((B, S), bool))
    assert torch.equal(last, full[:, -1])
    assert len(caches) == cfg.num_layers
    assert caches[0]["k"].shape == (B, MAX_LEN, cfg.num_kv_heads,
                                    cfg.head_dim)


def test_unsupported_config_raises():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("deepseek-7b")),
                              attn_logit_softcap=50.0)
    with pytest.raises(NotImplementedError, match="softcap"):
        model_mod.init_params(cfg, device="cpu")

"""kimi-k2-1t-a32b serving in the port against the JAX package, on the CPU.

``reduce_for_smoke(get_config("kimi-k2-1t-a32b"))`` on both sides (2
global layers of d_model 64, 4 heads over 4 kv heads of 16, 4 experts
top-2 of d_expert 32, the expert weights padded to 512, capacity factor
1.25), the JAX package's weights carried across by ``repro_torch.convert``
(``test_torch_moe.py`` holds the MoE block's pieces; this file the arch):

- the full width and the 1-layer cut ``chip_smoke.py`` serves;
- a prefill (the drops of its call included) and 4 decode steps against
  the JAX model, hidden states within 2e-3;
- the w8a8 build's sites are the reference's ``_collect_sites`` (the
  attention projections alone) and no MoE leaf is quantized;
- ``--arch kimi-k2-1t-a32b --smoke`` serves on the CPU, plain and w8a8;
- the card's layers check (``chip_smoke.check_moe_layers``, one layer) on
  the host at a small width over 384 experts padded to 512: no padded
  expert receives an entry, and each planted fault lands past the bound.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import quantize as jax_quantize
from repro_torch.configs import get_config
from repro_torch.core.quantization import QuantDense
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving import executor as executor_mod
from test_torch_moe import (_assert_caches, _close, _np, _prefill, _prompts,
                            _smoke, jax_decode_step)

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "kimi-k2-1t-a32b"
B = 3


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


@pytest.fixture(scope="module")
def smoke():
    """The reduced config at its own capacity factor, 1.25."""
    out = _smoke(ARCH, factor=get_config(ARCH).moe.capacity_factor)
    assert out[1].moe.padded_experts == 512 > out[1].moe.num_experts
    return out


def test_full_width_and_the_cut():
    """2772 GB at 61 layers (every layer's 512 experts, padded ones
    included, as the reference allocates them); the 1-layer cut
    ``chip_smoke.py`` serves is 25.03 B parameters (50.1 GB in bf16): 45.1
    GB of experts, the 163840-row embedding and head."""
    full = get_config(ARCH)
    model_mod.check_supported(full)
    cut = dataclasses.replace(full, num_layers=serve_mod.CARD_CUTS[ARCH][1])
    meta = model_mod.Model(cut, None, "meta")
    n = sum(t.numel() for t in meta.parameters())
    assert cut.num_layers == 1
    assert round(n / 1e9, 2) == 25.03 and round(2 * n / 1e9, 1) == 50.1
    experts = sum(getattr(meta.layers[0].moe, w).numel()
                  for w in ("wg", "wu", "wd"))
    assert round(2 * experts / 1e9, 1) == 45.1
    assert meta.layers[0].moe.wg.shape == (512, 7168, 2048)
    assert meta.layers[0].moe.router.shape == (7168, 384)
    assert (full.num_heads // full.num_kv_heads, full.head_dim) == (8, 128)


def test_prefill_and_decode_match_jax(smoke):
    """A prefill of 3 right-padded rows at capacity factor 1.25 (every
    token of the call routes, pads included, so the drops match), then 4
    decode steps with row 2 inactive on odd steps: hidden states at the
    real tokens and every cache."""
    jcfg, cfg, jparams, params = smoke
    tokens, valid = _prompts(cfg.vocab_size)
    hj, jcaches, h, caches = _prefill(smoke, tokens, valid)
    _close(_np(h)[valid], np.asarray(hj)[valid], err="prefill")
    _assert_caches(caches, jcaches, cfg)
    rng = np.random.default_rng(1)
    pos = valid.sum(-1).astype(np.int32)
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
        _close(_np(h)[active], np.asarray(hj)[active], err=f"step {step}")
        pos = pos + active
    _assert_caches(caches, jcaches, cfg)


def test_build_quantizes_the_attention_sites_alone(smoke):
    jcfg, cfg, jparams, params = smoke
    got = quantize_mod._collect_sites(params, cfg)
    assert sorted(got) == sorted(jax_quantize._collect_sites(jparams)) == [
        f"scan0.attn.{w}" for w in ("wk", "wo", "wq", "wv")]
    qp = quantize_mod.build_quantized_params(cfg, params, budget=1.0)
    assert (qp.quantized_sites, qp.fallback_sites) == (4, 0)
    for layer in qp.params.layers:
        assert not any(isinstance(m, QuantDense)
                       for m in layer.moe.modules())


@pytest.mark.parametrize("extra,expect", [
    ((), "served 4 requests"),
    (("--precision", "w8a8"), "4 sites int8")], ids=["plain", "w8a8"])
def test_serve_launcher_kimi_on_cpu(extra, expect, capsys):
    serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "4", "--new-tokens", "3", *extra])
    assert expect in capsys.readouterr().out


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_layers_check_holds_and_sees_the_planted_faults(chip_smoke,
                                                        monkeypatch, capsys):
    """``check_moe_layers`` on the host, both sides on the plain versions:
    1 bf16 layer of d_model 256 (16 heads over 2 kv heads of 64) over
    kimi-k2's 384 experts top-8 padded to 512 (d_expert 64), prompts of
    1, 33, 90 and 130 tokens: the worst token within its bound, entries
    dropped, none to a padded expert, fewer at 4x the capacity, each
    planted fault past the bound."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = dataclasses.replace(
        chip_smoke.reduce_kimi("bfloat16"), num_layers=1,
        moe=dataclasses.replace(get_config(ARCH).moe, d_expert=64))
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    chip_smoke.check_moe_layers("check-layers", cfg, params, layers=1,
                                lens=(1, 33, 90, 130))
    line = capsys.readouterr().out
    got = float(line.split("worst token ")[1].split()[0])
    dropped = float(line.split("dropped ")[1].split()[0].rstrip("%;,"))
    padded = int(line.split(" to a padded expert")[0].split()[-1])
    faults = [float(line.split(f"{name} ")[1].split()[0].rstrip(";,"))
              for name in chip_smoke.MOE_FAULTS.values()]
    assert got <= chip_smoke.MOE_LAYERS_TOL < min(faults), (got, faults)
    assert dropped > 0 and padded == 0

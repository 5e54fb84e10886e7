"""The port's w8a8 build step bounded in memory, on the CPU.

- ``sliced_argmax`` (the calibration argmax over slices of the vocabulary,
  never an f32 copy of the whole table) equals ``torch.argmax`` of the
  whole f32 product, ties to the first index included;
- a build with ``release_fp=True`` (each int8 site's fp weights moved to
  the host once quantized, a fall-back site moved back) decides, measures
  and quantizes exactly as the default build, and its engine serves the
  same tokens, on reduced deepseek-7b and gemma2-27b;
- after the release no int8 site's fp tensor is reachable from the
  quantized model, and a fall-back site's is the caller's own;
- both engines refuse a model with a leaf off their device (a ``meta``
  tensor stands in for the host here, where the host is the device);
- the launcher serves ``--arch gemma2-27b --precision w8a8
  --verify-quant`` to its OK line;
- ``chip_smoke.py``'s layers check, run here on the plain versions at the
  reduced gemma2-27b and gemma-2b cuts (rings that wrap), holds a
  releasing build's w8a8 + int8-KV step within its tolerance and sees
  both planted faults.

On the CPU "the host" and the device are one, so the release is seen in
storage, not in device: a released leaf is a copy in storage of its own,
and the storage it left is freed.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.quantization import QuantDense
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request

ROOT = os.path.join(os.path.dirname(__file__), "..")
KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32),
          device="cpu")
LENS = (20, 5, 9, 30, 3, 12)


@pytest.fixture(autouse=True)
def _pin_launch_counters(monkeypatch):
    """The kernels' launch counters are module-global: pin each, so that
    nothing this file does can leak into another test's counts."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


def _cfg(arch):
    """Reduced deepseek-7b (2 layers) and gemma2-27b at 4 layers (local,
    global, local, global), both with an int8 KV cache."""
    cfg = reduce_for_smoke(get_config(arch))
    if arch == "gemma2-27b":
        cfg = dataclasses.replace(cfg, num_layers=4)
    return _int8_kv(cfg)


def _trace(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=4) for i, n in enumerate(LENS)]


def _site_params(params, cfg, name):
    _, _, mod, wname, layers = quantize_mod._collect_sites(params, cfg)[name]
    return [getattr(getattr(params.layers[l], mod), wname) for l in layers]


# ---- the sliced argmax ------------------------------------------------------

@pytest.mark.parametrize("slice_rows", [1, 7, 64, 300, 1000],
                         ids=lambda n: f"slice{n}")
def test_sliced_argmax_equals_the_whole_table_argmax(monkeypatch,
                                                     slice_rows):
    """Random bf16 tables of 300 rows, 290 of them the vocabulary (7 and
    64 leave a remainder), against ``torch.argmax`` of the whole f32
    product."""
    monkeypatch.setattr(quantize_mod, "ARGMAX_SLICE_ROWS", slice_rows)
    gen = torch.Generator().manual_seed(slice_rows)
    h = torch.randn(3, 5, 32, generator=gen).to(torch.bfloat16)
    table = torch.randn(300, 32, generator=gen).to(torch.bfloat16)
    want = torch.argmax((h.float() @ table.float().t())[..., :290], dim=-1)
    got = quantize_mod.sliced_argmax(h, table, 290)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("slice_rows", [1, 3, 5, 16],
                         ids=lambda n: f"slice{n}")
def test_sliced_argmax_keeps_the_first_index_on_a_tie(monkeypatch,
                                                      slice_rows):
    """Integer-valued inputs (every product and sum exact), with the
    maximal row planted at 2, 9 and 13: each query takes row 2, as
    ``torch.argmax`` does, whichever slices the copies fall in. A NaN
    logit wins, as there."""
    monkeypatch.setattr(quantize_mod, "ARGMAX_SLICE_ROWS", slice_rows)
    gen = torch.Generator().manual_seed(1)
    h = torch.randint(1, 4, (4, 8), generator=gen).float()
    table = torch.randint(-3, 2, (16, 8), generator=gen).float()
    table[[2, 9, 13]] = 5.0
    want = torch.argmax(h @ table.t(), dim=-1)
    assert (want == 2).all()
    assert torch.equal(quantize_mod.sliced_argmax(h, table, 16),
                       want)
    table[11, 0] = float("nan")
    want = torch.argmax(h @ table.t(), dim=-1)
    assert (want == 11).all()
    assert torch.equal(quantize_mod.sliced_argmax(h, table, 16),
                       want)


# ---- releasing the fp weights -----------------------------------------------

@pytest.mark.parametrize("budget", [-1.0, 0.0, 1.0],
                         ids=["budget-1", "budget0", "budget1"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-27b"])
def test_release_build_equals_the_default_build(arch, budget):
    """The same weights built twice: decisions, errors, ``metric_delta``
    and every leaf of the quantized model equal, and the two engines'
    tokens identical. Budget -1 falls back ``max_iters`` sites (gemma2's
    reduced random weights disagree with no site int8, so 0.0 falls back
    none there), budget 0 falls back deepseek-7b's worst sites, budget 1
    none."""
    cfg = _cfg(arch)
    keep_params = model_mod.init_params(cfg, seed=0, device="cpu")
    free_params = model_mod.init_params(cfg, seed=0, device="cpu")
    keep = quantize_mod.build_quantized_params(cfg, keep_params,
                                               budget=budget)
    free = quantize_mod.build_quantized_params(cfg, free_params,
                                               budget=budget,
                                               release_fp=True)
    assert free.schemes == keep.schemes
    assert (free.quantized_sites, free.fallback_sites) == \
        (keep.quantized_sites, keep.fallback_sites)
    assert free.result.metric_delta == keep.result.metric_delta
    assert free.result.decisions == keep.result.decisions
    if budget < 0 or (budget == 0 and arch == "deepseek-7b"):
        assert keep.fallback_sites > 0
    else:
        assert keep.fallback_sites == 0
    a, b = keep.params.state_dict(), free.params.state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)
    outs = [[r.output for r in InferenceEngine(
        cfg, p, precision="w8a8", quantized_params=q, **KW).run(
            _trace(cfg.vocab_size))]
        for p, q in ((keep_params, keep), (free_params, free))]
    assert outs[0] == outs[1] and all(len(o) == 4 for o in outs[0])


@pytest.mark.parametrize("release", [False, True], ids=["keep", "release"])
def test_release_frees_the_int8_sites_fp_storage(release):
    """Reduced deepseek-7b at budget 0 (int8 and fall-back sites). After a
    releasing build each int8 site's fp weight is a copy of its values in
    storage of its own (on the host), the storage it left is freed, and
    the quantized model holds a ``QuantDense`` there and no Parameter; a
    fall-back site's fp weight is the caller's Parameter storage, on the
    device, read by the quantized model. The default build moves
    nothing."""
    cfg = _cfg("deepseek-7b")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    sites = quantize_mod._collect_sites(params, cfg)
    before = {n: [(StorageWeakRef(p.untyped_storage()), p.data_ptr(),
                   p.detach().clone())
                  for p in _site_params(params, cfg, n)] for n in sites}
    q = quantize_mod.build_quantized_params(cfg, params, budget=0.0,
                                            release_fp=release)
    assert q.quantized_sites and q.fallback_sites
    run_ptrs = {t.untyped_storage().data_ptr() for t in
                list(q.params.parameters()) + list(q.params.buffers())}
    for name, scheme in q.schemes.items():
        _, _, mod, wname, layers = sites[name]
        for layer, p, (ref, ptr, value) in zip(
                layers, _site_params(params, cfg, name), before[name]):
            held = getattr(getattr(q.params.layers[layer], mod), wname)
            assert torch.equal(p.detach(), value)
            if scheme == "int8":
                assert isinstance(held, QuantDense)
                assert p.untyped_storage().data_ptr() not in run_ptrs
                assert ref.expired() == release
                assert (p.data_ptr() != ptr) == release
                assert p.device.type == "cpu"
            else:
                assert isinstance(held, torch.nn.Parameter)
                assert held.device == p.device
                assert held.data_ptr() == p.data_ptr()
                assert torch.equal(held.detach(), value)


# ---- the engines' device check ----------------------------------------------

def _to_meta(module, name):
    """Stand a ``meta`` tensor (a leaf off the device) in for one leaf."""
    t = getattr(module, name)
    meta = torch.empty(t.shape, dtype=t.dtype, device="meta")
    if name in module._parameters:
        module._parameters[name] = torch.nn.Parameter(meta,
                                                      requires_grad=False)
    else:
        module._buffers[name] = meta


def test_fp_engine_refuses_a_leaf_off_its_device():
    cfg = _cfg("gemma2-27b")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    _to_meta(params.layers[2].mlp, "w_down")
    with pytest.raises(ValueError, match=r"fp params: layers\.2\.mlp\.w_down "
                       r"lives on meta, the engine serves on cpu"):
        InferenceEngine(cfg, params, **KW)


def test_w8a8_engine_refuses_a_leaf_off_its_device():
    """A ``QuantDense`` buffer off the device, and a fall-back site's fp
    weight; the fp model's own leaves are not what a w8a8 engine reads."""
    cfg = _cfg("deepseek-7b")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    q = quantize_mod.build_quantized_params(cfg, params, budget=0.0)
    int8 = next(n for n, s in q.schemes.items() if s == "int8")
    fp = next(n for n, s in q.schemes.items() if s != "int8")
    _, _, mod, wname, layers = quantize_mod._collect_sites(params, cfg)[int8]
    leaf = getattr(getattr(q.params.layers[layers[-1]], mod), wname)
    saved = leaf.scale
    _to_meta(leaf, "scale")
    with pytest.raises(ValueError, match=rf"quantized params: layers\."
                       rf"{layers[-1]}\.{mod}\.{wname}\.scale lives on meta"):
        InferenceEngine(cfg, params, precision="w8a8", quantized_params=q,
                        **KW)
    leaf.scale = saved
    _, _, mod, wname, layers = quantize_mod._collect_sites(params, cfg)[fp]
    _to_meta(getattr(q.params.layers[layers[0]], mod), wname)
    with pytest.raises(ValueError, match=rf"layers\.{layers[0]}\.{mod}\."
                       rf"{wname} lives on meta"):
        InferenceEngine(cfg, params, precision="w8a8", quantized_params=q,
                        **KW)
    # the caller's model with a leaf off the device does not stop a w8a8
    # engine that never reads it
    _to_meta(params.layers[0].attn, "wq")
    InferenceEngine(cfg, params, precision="w8a8",
                    quantized_params=quantize_mod.build_quantized_params(
                        cfg, model_mod.init_params(cfg, seed=0,
                                                   device="cpu"),
                        budget=1.0), **KW)


# ---- the launcher -----------------------------------------------------------

def test_serve_launcher_gemma2_w8a8_verify_quant_on_cpu():
    """The fp reference serves first, then the releasing build, then the
    w8a8 engine; the agreement guardrail holds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-27b", "--precision", "w8a8", "--verify-quant", "--device",
         "cpu", "--requests", "8", "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "sites int8 (their fp weights moved to the host)" in out.stdout
    assert "served 8 requests" in out.stdout
    assert "verify-quant OK: 8 requests" in out.stdout


# ---- chip_smoke.py's layers check on the plain versions ---------------------

@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cut,lens,max_len", [
    ("reduce_gemma2", (100, 80, 20, 1), 128),
    ("reduce_gemma_2b", (64, 30, 7, 1), 96)], ids=["gemma2", "gemma2b"])
def test_layers_check_holds_w8a8_and_sees_the_planted_faults(
        chip_smoke, monkeypatch, capsys, cut, lens, max_len):
    """The bf16 reference step is taken before a releasing build, as
    check-gemma2-layers does; gemma2's prompts pass its 64-slot rings."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = getattr(chip_smoke, cut)("bfloat16")
    params = model_mod.init_params(cfg, seed=0, device="cpu")
    ref = chip_smoke.layers_reference(cfg, params, lens, max_len)
    qcfg = _int8_kv(cfg)
    q = quantize_mod.build_quantized_params(qcfg, params, release_fp=True)
    assert q.quantized_sites
    chip_smoke.check_w8a8_layers("check-layers", ref, qcfg, q.params)
    line = capsys.readouterr().out
    got, no_attn, neg_v = (float(line.split(key)[1].split()[0].rstrip(";,"))
                           for key in ("error over that ", "zeroed ",
                                       "negated "))
    tol = chip_smoke.W8A8_LAYERS_TOL
    assert got <= tol < min(no_attn, neg_v)

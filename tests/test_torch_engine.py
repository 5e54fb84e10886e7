"""The port's serving engine and launcher against the JAX package's, on the
CPU: the same weights (carried across by ``repro_torch.convert``), the same
seeded requests, greedy decoding on both sides."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core.metrics import token_agreement
from repro.models import model as jax_model
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import model as model_mod
from repro_torch.serving.engine import InferenceEngine, Request

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENGINE_KW = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32))


def _requests(cls, n=6, seed=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 30, n)
    new = rng.integers(2, 9, n)
    return [cls(i, rng.integers(0, 256, int(L)).astype(np.int32),
                max_new_tokens=int(m))
            for i, (L, m) in enumerate(zip(lens, new))]


@pytest.fixture(scope="module")
def served():
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    jeng = JaxEngine(jcfg, jparams, **ENGINE_KW)
    jreqs = jeng.run(_requests(JaxRequest))
    eng = InferenceEngine(cfg, params, device="cpu", **ENGINE_KW)
    reqs = eng.run(_requests(Request))
    return jeng, jreqs, eng, reqs


def test_engine_greedy_tokens_agree_with_jax(served):
    jeng, jreqs, eng, reqs = served
    agreement = token_agreement([(r.output, j.output)
                                 for r, j in zip(reqs, jreqs)])
    print(f"greedy-token agreement with the JAX engine: {agreement:.4f}")
    assert agreement >= 0.95
    for r, j in zip(reqs, jreqs):
        assert r.done and len(r.output) == len(j.output) == j.max_new_tokens


def test_engine_telemetry_matches_jax(served):
    jeng, _, eng, _ = served
    for name in ("served", "prefills", "prefill_batches", "steps",
                 "total_tokens"):
        assert getattr(eng.telemetry, name) == getattr(jeng.telemetry, name),\
            name
    # one stage per (bucket, padded group size, precision) plus the decode
    # step per precision, keyed as the JAX engine keys its compiles
    for stage in ("prefill", "decode"):
        assert sorted(eng.executor.cached_keys(stage)) == sorted(
            jeng.executor.cached_keys(stage))


def test_engine_slots_partition_and_release(served):
    _, _, eng, _ = served
    eng.states.check_partition()
    assert sorted(eng.free) == [0, 1, 2] and not eng.active
    assert not eng.has_work and eng.inflight == 0


def test_engine_sheds_past_max_queue():
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    eng = InferenceEngine(cfg, model_mod.init_params(cfg, device="cpu"),
                          max_queue=2, device="cpu", **ENGINE_KW)
    tickets = [eng.submit(r) for r in _requests(Request, n=4)]
    assert [t.shed for t in tickets] == [False, False, True, True]
    assert eng.telemetry.shed == 2


def test_engine_rejects_params_on_another_device():
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    params = model_mod.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="params live on cpu"):
        InferenceEngine(cfg, params, device="cuda", **ENGINE_KW)


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--new-tokens", "3"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served 4 requests" in out.stdout


def test_serve_launcher_w8a8_verify_quant_on_cpu():
    """The §V build step and the w8a8 plain path, then the replay on an
    unquantized engine: agreement at or above the 0.90 guardrail."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--precision", "w8a8", "--verify-quant", "--requests", "16",
         "--new-tokens", "8"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "served 16 requests" in out.stdout
    assert "verify-quant OK" in out.stdout


def test_serve_launcher_verify_quant_needs_w8a8():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--verify-quant", "--requests", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "--verify-quant needs --precision w8a8" in out.stderr

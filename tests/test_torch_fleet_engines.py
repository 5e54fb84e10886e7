"""The port's real engines behind the port's router, on the CPU at smoke
size, against the JAX package's fleet and against one engine: routing
(count and feedback) lands each request where the reference's router
lands it, stealing and the fault drain move the same tickets and lose
none, a mixed-precision fleet pins class-0 traffic to fp32, the fleet
prefix tier stays consistent with every replica's cache, DLRM replicas
over one slab give the JAX engine's logits, the performance model is
fitted from the engine's replayed calls, and the launcher has every flag
of the reference's and runs each fleet check on the CPU."""
import ast
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import dlrm_paper as jax_dlrm_cfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core.metrics import token_agreement
from repro.data import synthetic as jax_synth
from repro.launch import serve as jax_serve
from repro.models import dlrm as jax_dlrm
from repro.models import model as jax_model
from repro.serving.dlrm_engine import DLRMEngine as JaxDLRMEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import make_replicas as jax_make_replicas
from repro.serving.router import ReplicaRouter as JaxRouter
from repro_torch import convert
from repro_torch.configs import dlrm_paper, get_config, reduce_for_smoke
from repro_torch.launch import serve
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.serving import dlrm_engine
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import InferenceEngine, Request, make_replicas
from repro_torch.serving.perf_model import PerfModel
from repro_torch.serving.router import ReplicaRouter

ROOT = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(batch_slots=2, max_len=64, prefill_buckets=(8, 16, 32))
LOGIT_TOL = 2e-3


@pytest.fixture(autouse=True)
def _restore_launch_counters(monkeypatch):
    """Pin every kernel wrapper's module-global launch counter, so the
    test leaves them as it found them."""
    for fn, name in executor_mod.COUNTERS:
        monkeypatch.setattr(fn, name, getattr(fn, name))


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    return jcfg, cfg, jparams, params


def _requests(cls, n=8, seed=5, vocab=256):
    """Seeded prompts with mixed classes (every third is class 0)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 30, n)
    new = rng.integers(2, 6, n)
    return [cls(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                max_new_tokens=int(m), priority=int(i % 3 != 0))
            for i, (L, m) in enumerate(zip(lens, new))]


def _landing(router, reqs):
    """Submit every request; returns the replica each landed on."""
    out = []
    for r in reqs:
        before = list(router.routed)
        router.submit(r)
        out.append(next(i for i, (a, b) in enumerate(zip(before,
                                                         router.routed))
                        if a != b))
    return out


def _one_engine(cfg, params, **kw):
    reqs = _requests(Request)
    InferenceEngine(cfg, params, device="cpu", **dict(ENGINE_KW, **kw)) \
        .run(reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("route", ["count", "feedback"])
def test_routing_lands_like_the_jax_fleet(lm, route):
    """Two replicas each side, the same requests: each lands on the
    replica the reference's router picks (feedback: the EWMAs seeded with
    the same step times before any request); the port fleet's tokens are
    one port engine's, and agree with the JAX fleet's."""
    jcfg, cfg, jparams, params = lm
    fleet = ReplicaRouter(make_replicas(cfg, params, 2, device="cpu",
                                        **ENGINE_KW), route=route)
    jfleet = JaxRouter(jax_make_replicas(jcfg, jparams, 2, **ENGINE_KW),
                       route=route)
    if route == "feedback":
        for f in (fleet, jfleet):
            f.record_dispatch(0, 0.01)
            f.record_dispatch(1, 0.03)
    reqs, jreqs = _requests(Request), _requests(JaxRequest)
    landed = _landing(fleet, reqs)
    assert landed == _landing(jfleet, jreqs)
    assert fleet.routed == jfleet.routed and min(fleet.routed) > 0
    fleet.run_until_drained()
    jfleet.run_until_drained()
    assert all(r.done for r in reqs)
    assert [r.output for r in reqs] == _one_engine(cfg, params)
    assert token_agreement([(r.output, j.output)
                            for r, j in zip(reqs, jreqs)]) >= 0.95
    assert fleet.fleet_telemetry().served == jfleet.fleet_telemetry().served


def test_steal_and_drain_like_the_jax_fleet(lm):
    """Every request hot-spotted onto replica 0, stealing on, replica 0
    drained after two rounds (the reference's ``--verify-steal`` loop on
    the JAX fleet): the same steals and re-homes per replica, none lost,
    and the port's tokens are one engine's."""
    jcfg, cfg, jparams, params = lm
    fleet = ReplicaRouter(make_replicas(cfg, params, 2, device="cpu",
                                        **ENGINE_KW), steal=True)
    jfleet = JaxRouter(jax_make_replicas(jcfg, jparams, 2, **ENGINE_KW),
                       steal=True)
    reqs, jreqs = _requests(Request), _requests(JaxRequest)
    tel = serve.drive_steal(fleet, reqs)
    jtel = jax_serve._verify_steal(jfleet, jreqs,
                                   types.SimpleNamespace(steal=True))
    assert fleet.steals_per_replica == jfleet.steals_per_replica
    assert fleet.rehomed == jfleet.rehomed and fleet.dead == jfleet.dead
    assert (tel.steals, tel.drained, tel.served) \
        == (jtel.steals, jtel.drained, jtel.served)
    assert tel.steals > 0 and tel.drained > 0
    assert all(r.done for r in reqs)
    assert [r.output for r in reqs] == _one_engine(cfg, params)
    dead = fleet.replicas[0]
    assert not dead.has_work and dead.inflight == 0
    dead.states.check_partition()


def test_mixed_fleet_pins_class0_and_rehomes_on_drain(lm):
    """fp32 + two w8a8 replicas from one quantized build: class-0 lands
    on fp32 and decodes one fp32 engine's tokens; draining the fp32
    replica mid-run re-homes its class-0 load to int8, one
    ``precision_rehomed`` each, with nothing lost."""
    _, cfg, _, params = lm
    reps = make_replicas(cfg, params, 3, precisions=["fp32", "w8a8", "w8a8"],
                         device="cpu", **ENGINE_KW)
    assert reps[1].quant is reps[2].quant is not None
    assert reps[1].run_params is reps[2].run_params
    assert all(r.params is params for r in reps)
    fleet = ReplicaRouter(reps)
    reqs = _requests(Request)
    landed = _landing(fleet, reqs)
    assert all(landed[i] == 0 for i, r in enumerate(reqs) if r.priority == 0)
    fleet.run_until_drained()
    want = _one_engine(cfg, params)
    for r, w in zip(reqs, want):
        if r.priority == 0:
            assert r.output == w
    assert fleet.fleet_telemetry().precision_rehomed == 0

    fleet = ReplicaRouter(make_replicas(cfg, params, 2,
                                        precisions=["fp32", "w8a8"],
                                        device="cpu", **ENGINE_KW))
    reqs = _requests(Request)
    _landing(fleet, reqs)
    fleet.replicas[0].step_once()
    held = [t for t in fleet.replicas[0].scheduler._pending] \
        + list(fleet.replicas[0].active.values())
    class0 = sum(t.priority == 0 for t in held)
    fleet.drain_replica(0)
    fleet.run_until_drained()
    tel = fleet.fleet_telemetry()
    assert class0 > 0 and tel.precision_rehomed == class0
    assert all(r.done for r in reqs) and tel.served == len(reqs)


def _hot_prompts(n, chunk, seed=11, vocab=256):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 3 * chunk).astype(np.int32)
    return [Request(i, np.concatenate([prefix, rng.integers(
        0, vocab, int(rng.integers(4, 12))).astype(np.int32)]),
        max_new_tokens=3) for i in range(n)]


def test_fleet_prefix_tier_on_real_engines(lm):
    """A hot-system-prompt trace over two replicas with the shared tier
    (local caches of two entries, so evictions reach the host tier):
    after every submit and step the index names exactly what each
    replica's cache holds; remote hits happen; a holder drained mid-run
    leaves its prefixes in the host tier; every output is a cold
    engine's."""
    _, cfg, _, params = lm
    kw = dict(ENGINE_KW, prefill_chunk=8, prefix_cache=2)
    fleet = ReplicaRouter(make_replicas(cfg, params, 2, device="cpu", **kw),
                          fleet_prefix=True, prefix_host_entries=8,
                          perf_model=PerfModel.for_params(params))
    idx = fleet.prefix_index

    def consistent():
        # a drained replica is out of the fleet: the engine's drain, as
        # the reference's, leaves its local cache in place, and the index
        # must name it for nothing (ROADMAP C)
        idx.check_consistent([set() if fleet.dead[i]
                              else set(dict(r.export_prefix_cache()))
                              for i, r in enumerate(fleet.replicas)])

    reqs = _hot_prompts(8, 8)
    fleet.submit(reqs[0])
    fleet.run_until_drained()
    consistent()
    holder = idx.holders(fleet.replicas[0].prefix_keys(reqs[1])[0])
    assert holder
    for r in reqs[1:5]:
        fleet.submit(r)
        consistent()
    fleet.replicas[0].step_once()
    fleet.replicas[1].step_once()
    consistent()
    fleet.drain_replica(holder[0])
    consistent()
    assert len(idx.host) > 0
    for r in reqs[5:]:
        fleet.submit(r)
        consistent()
    fleet.run_until_drained()
    consistent()
    tel = fleet.fleet_telemetry()
    assert tel.prefix_remote_hits > 0 and tel.prefix_hits > 0
    assert all(r.done for r in reqs)
    cold = _hot_prompts(8, 8)
    InferenceEngine(cfg, params, device="cpu", **dict(
        kw, prefix_cache=None)).run(cold)
    assert [r.output for r in reqs] == [r.output for r in cold]


def test_dlrm_replicas_match_the_jax_engine():
    """Two DLRM replicas over one int8 slab, every batch hot-spotted on
    replica 0, stealing on and replica 0 drained after its first step:
    every batch is served once, and its logits are the JAX engine's
    within 2e-3."""
    jc = jax_dlrm_cfg.reduce_for_smoke(jax_dlrm_cfg.PAPER_COMPLEX)
    tc = dlrm_paper.reduce_for_smoke(dlrm_paper.PAPER_COMPLEX)
    asn = jax_dlrm.make_assignment(jc, 1)
    jp = jax_dlrm.init_dlrm(jc, asn, jax.random.PRNGKey(7), quantize=True)
    tp = convert.dlrm_params_from_jax(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    batches = [next(jax_synth.dlrm_batches(jc, 8, seed=s))
               for s in range(10)]
    want, _ = JaxDLRMEngine(jc, asn, jp).serve(batches, pipelined=True)
    got = {}
    reps = dlrm_engine.make_replicas(
        tc, dlrm_mod.make_assignment(tc, 1), tp, 2, device="cpu",
        on_result=lambda b, v: got.setdefault(id(b), []).append(v))
    assert reps[0].params is reps[1].params
    fleet = ReplicaRouter(reps, steal=True)
    for b in batches:
        reps[0].submit(b)
    rounds = 0
    while fleet.has_work:
        fleet.maybe_steal()
        for i, rep in enumerate(fleet.replicas):
            if not fleet.dead[i] and rep.has_work:
                rep.step_once()
        rounds += 1
        if rounds == 1:
            fleet.drain_replica(0)
    tel = fleet.fleet_telemetry()
    assert tel.steals > 0 and tel.drained > 0 and tel.served == len(batches)
    for b, w in zip(batches, want):
        assert len(got[id(b)]) == 1
        np.testing.assert_allclose(got[id(b)][0].numpy(), np.asarray(w),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert reps[1].free_slots == reps[1].step_group and reps[1].inflight == 0


def test_perf_model_is_fitted_from_replayed_calls_only(lm):
    """``warm_call_s`` holds every call of a stage key but its first, and
    ``observe_stages`` feeds exactly those to the model; an engine with
    ``prefill_chunk='auto'`` takes the fitted knee on its ladder and
    serves chunk 16's tokens."""
    _, cfg, _, params = lm
    eng = InferenceEngine(cfg, params, device="cpu", prefill_chunk=32,
                          **ENGINE_KW)
    for k in range(3):
        eng.run(_requests(Request, n=4, seed=k))
    ex = eng.executor
    calls = ex.telemetry.stage_calls
    firsts = {k[:2] for k in ex._called}
    assert sum(len(v) for v in ex.warm_call_s.values()) \
        == sum(calls.values()) - len(ex._called)
    assert set(ex.warm_call_s) <= firsts
    pm = eng.observe_stages(PerfModel.for_params(params))
    assert sum(len(v) for v in pm._samples.values()) \
        == sum(len(v) for v in ex.warm_call_s.values())
    assert all(p == "fp32" for (_, _, _, p) in pm._samples)
    assert {("decode", ENGINE_KW["batch_slots"], 1)} \
        == {(s, b, n) for (s, b, n, _) in pm._samples if s == "decode"}
    auto = InferenceEngine(cfg, params, device="cpu", prefill_chunk="auto",
                           perf_model=pm, **ENGINE_KW)
    assert auto.prefill_chunk == pm.suggest_prefill_chunk(auto.buckets)
    assert auto.prefill_chunk in auto.buckets
    reqs = _requests(Request)
    auto.run(reqs)
    assert [r.output for r in reqs] == _one_engine(cfg, params,
                                                   prefill_chunk=16)


def _flags(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and str(a.value).startswith("--")}
    return out


def test_launcher_has_every_flag_of_the_reference():
    """Every ``add_argument`` flag of the JAX launcher is the port's; the
    port adds only ``--device``."""
    ref = _flags(ROOT / "src" / "repro" / "launch" / "serve.py")
    port = _flags(ROOT / "src" / "repro_torch" / "launch" / "serve.py")
    assert ref <= port and port - ref == {"--device"}


@pytest.mark.parametrize("argv,ok", [
    ("--replicas 2 --steal --verify-steal", "verify-steal OK"),
    ("--replicas 2 --replica-precisions fp32,w8a8 --verify-quant "
     "--policy priority", "verify-quant OK: mixed fleet"),
    ("--replicas 2 --prefill-chunk 16 --prefix-cache 16 "
     "--verify-fleet-prefix --requests 6", "verify-fleet-prefix OK"),
    ("--prefill-chunk auto --verify-autotune", "verify-autotune OK"),
    ("--elastic-smoke", "elastic-smoke OK"),
    ("--arch dlrm --replicas 2 --steal --requests 6",
     "fleet served 6 batches"),
], ids=["steal", "quant-fleet", "fleet-prefix", "autotune", "elastic",
        "dlrm-fleet"])
def test_launcher_fleet_checks_on_cpu(argv, ok, capsys):
    serve.main(argv.split() + ["--device", "cpu", "--max-len", "64",
                               "--new-tokens", "3"])
    assert ok in capsys.readouterr().out


@pytest.mark.parametrize("argv,msg", [
    ("--replicas 2 --verify-steal", "--verify-steal needs --steal"),
    ("--verify-steal", "--verify-steal needs --replicas >= 2 --steal"),
    ("--replica-precisions fp32,w8a8", "--replica-precisions needs"),
    ("--replicas 2 --verify-quant", "needs a mixed"),
    ("--prefill-chunk 16 --verify-autotune", "needs --prefill-chunk auto"),
    ("--replicas 2 --prefill-chunk auto --verify-autotune",
     "single-engine only"),
    ("--verify-fleet-prefix --prefill-chunk 16 --prefix-cache 4",
     "needs --replicas >= 2"),
])
def test_launcher_refuses_what_the_reference_refuses(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        serve.main(argv.split() + ["--device", "cpu", "--requests", "2",
                                   "--new-tokens", "2"])

"""The port's fleet layer decides like the JAX package's on the same
inputs: the router (count and feedback routing, stealing, the fault
drain, the mixed-precision pin, the fleet prefix tier), the performance
model, the failure detector, the elastic controller and the fleet
simulator. Every check here runs on the simulator's virtual clock with
fixed numpy seeds, so each is deterministic; the real engines behind a
router are in ``test_torch_fleet_engines.py``."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core import backend as jax_backend
from repro.models import model as jax_model
from repro.runtime import fault_tolerance as jax_ft
from repro.serving import controller as jax_ctl
from repro.serving import fleet_sim as jax_fs
from repro.serving import perf_model as jax_pm
from repro.serving import state as jax_state
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import backend
from repro_torch.core.transfer import TransferStats
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.serving import controller as ctl
from repro_torch.serving import fleet_sim as fs
from repro_torch.serving import perf_model as pm
from repro_torch.serving import state

PAIRS = {"port": (fs, ctl, ft), "jax": (jax_fs, jax_ctl, jax_ft)}


def _summary(sim):
    s = sim.fleet_summary()
    s.pop("qps", None)
    return s


def _drive(mod, seed, *, route="count", precisions=None, fail=None,
           ticks=120, prefix=False):
    """Seeded arrivals (some pinned to replica 0, the hot key; some tagged
    with a shared prefix) and ticks on a 3-replica sim; replica ``fail``
    is drained at tick 40. Returns everything the fleet decided."""
    sim = mod.FleetSim(replicas=3, service_s=[0.01, 0.02, 0.015],
                       slots=[1, 2, 1], route=route, precisions=precisions,
                       dt=0.005, seed=seed, max_queue=24,
                       fleet_prefix=prefix, prefix_cache=2 if prefix else 0,
                       prefix_host_entries=3 if prefix else 0)
    rng = np.random.default_rng(seed)
    log = []
    for k in range(ticks):
        for _ in range(int(rng.integers(0, 3))):
            pin = 0 if rng.random() < 0.3 else None
            tag = int(rng.integers(0, 5)) if prefix else None
            before = list(sim.router.routed)
            t = sim.submit(size=int(rng.integers(1, 64)),
                           priority=int(rng.integers(0, 3)), pin=pin,
                           prefix=tag)
            landed = [i for i, (a, b) in enumerate(zip(before,
                                                       sim.router.routed))
                      if a != b]
            log.append(("submit", t.payload, t.tid, t.shed, t.priority,
                        landed))
        log.append(("tick", sorted(t.payload for t in sim.tick())))
        if fail is not None and k == 40:
            log.append(("fail", sim.fail(fail)))
        if prefix:
            sim.router.prefix_index.check_consistent(
                [set(dict(r.export_prefix_cache())) for r in sim.replicas])
            log.append(("holders", sorted(
                (k, tuple(v)) for k, v in
                sim.router.prefix_index._holders.items()),
                list(sim.router.prefix_index.host)))
    sim.drain()
    sim.assert_conserved()
    r = sim.router
    return (log, _summary(sim), list(r.routed), list(r.steals_per_replica),
            list(r.rehomed), list(r.dead), sim.served_per_replica(),
            list(r.ewma_s))


@pytest.mark.parametrize("route", ["count", "feedback"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sim_routes_and_steals_like_the_reference(route, seed):
    """The same arrivals land on the same replicas, the same tickets are
    stolen, and the fleet's summary is the same, under count routing and
    under feedback routing (EWMAs seeded from the replicas' service
    times)."""
    port = _drive(fs, seed, route=route)
    assert port == _drive(jax_fs, seed, route=route)
    assert sum(port[3]) > 0                  # the hot key was stolen from


@pytest.mark.parametrize("route", ["count", "feedback"])
@pytest.mark.parametrize("seed", [0, 3])
def test_sim_drain_rehomes_like_the_reference(route, seed):
    """A replica drained mid-run re-homes the same tickets to the same
    survivors, and none is lost (``assert_conserved`` in ``_drive``)."""
    port = _drive(fs, seed, route=route, fail=1)
    assert port == _drive(jax_fs, seed, route=route, fail=1)
    rehomed, dead = port[4], port[5]
    assert dead == [False, True, False] and sum(rehomed) > 0


@pytest.mark.parametrize("seed", [0, 2])
def test_mixed_precision_pin_like_the_reference(seed):
    """fp32 + two w8a8 replicas: every unpinned class-0 arrival lands on
    the fp32 replica while it lives; draining it re-homes its class-0 load
    to int8 with one ``precision_rehomed`` count each, as the reference
    counts them."""
    precisions = ["fp32", "w8a8", "w8a8"]
    port = _drive(fs, seed, precisions=precisions, fail=0)
    assert port == _drive(jax_fs, seed, precisions=precisions, fail=0)
    log, summary = port[0], port[1]
    fail_at = next(i for i, e in enumerate(log) if e[0] == "fail")
    for e in log[:fail_at]:
        if e[0] == "submit" and not e[3] and e[4] == 0 and e[5]:
            assert e[5] == [0], e        # routed (not pinned) class-0
    assert summary["precision_rehomed"] > 0


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_fleet_prefix_index_stays_consistent_like_the_reference(seed):
    """Prefix-tagged arrivals through the shared tier (accept, evict to
    the host tier, steer, ship) and a holder drained mid-run: the index
    agrees with every replica's cache after every tick
    (``check_consistent`` in ``_drive``), and holds the same holders and
    host entries as the reference's."""
    port = _drive(fs, seed, prefix=True, fail=2)
    assert port == _drive(jax_fs, seed, prefix=True, fail=2)
    summary = port[1]
    assert summary["prefix_remote_hits"] > 0 and summary["prefix_hits"] > 0


def test_fleet_prefix_index_unit_moves():
    """The directory and the host tier move by move, port against
    reference: add, discard (twice), purge, the bounded host LRU and
    ``check_consistent``'s refusals."""
    out = []
    for mod in (state, jax_state):
        idx = mod.FleetPrefixIndex(host_capacity=2)
        idx.add("a", 0), idx.add("a", 1), idx.add("a", 0), idx.add("b", 1)
        idx.discard("a", 0), idx.discard("a", 0), idx.discard("zz", 3)
        for k in "xyz":
            idx.host_insert(k, k.upper())
        got = [idx.holders("a"), idx.holders("b"), list(idx.host),
               idx.host_get("y"), idx.host_get("x"), idx.host_evicted]
        idx.check_consistent([set(), {"a", "b"}])
        with pytest.raises(AssertionError):
            idx.check_consistent([{"a"}, {"a", "b"}])
        idx.purge_replica(1)
        idx.check_consistent([set(), set()])
        out.append(got)
    assert out[0] == out[1] == [[1], [1], ["y", "z"], "Y", None, 1]


# ---- performance model ---------------------------------------------------

def _observations(seed):
    rng = np.random.default_rng(seed)
    obs = []
    for stage, prec in (("chunk_prefill", "fp32"), ("prefill", "fp32"),
                        ("decode", "fp32"), ("chunk_prefill", "w8a8")):
        for bucket in (16, 32, 64, 128):
            for batch in (1, 2):
                for _ in range(3):
                    t = (1e-3 + bucket * batch * 2e-6
                         * (0.6 if prec == "w8a8" else 1.0)) \
                        * float(rng.uniform(0.9, 1.1))
                    obs.append((stage, bucket, batch, prec, t))
    return obs


def _fit(mod, spec, seed, pinned=False):
    model = mod.PerfModel(6.9e9, spec=spec)
    for stage, bucket, batch, prec, t in _observations(seed):
        if stage == "prefill" and bucket > 32:
            continue                     # one stage fitted from 2 cells
        model.observe(stage, bucket=bucket, batch=batch, precision=prec,
                      seconds=t)
    if pinned:
        model.set_dispatch_cost("decode", 2e-3, 1e-5, precision="w8a8")
    stats = TransferStats()
    stats.num_transfers_batched, stats.bytes_partial = 4, 4e6
    stats.bytes_full = 9e6
    ladder = (8, 16, 32, 64, 128)
    return {
        "terms": model.fitted_terms(),
        "knee": model.suggest_prefill_chunk(ladder),
        "knee_w8a8": model.suggest_prefill_chunk(ladder, precision="w8a8"),
        "cold_knee": model.suggest_prefill_chunk(
            ladder, stage="unmeasured"),
        "buckets": model.suggest_buckets([3, 9, 17, 40, 41, 77, 300],
                                         max_len=256),
        "ratio": model.service_ratio(128, 16),
        "scale": model.precision_scale("w8a8"),
        "fit_scale": model.fit_precision_scale("w8a8"),
        "step": model.predict_step_s("chunk_prefill", bucket=200, batch=2,
                                     chunk=64),
        "overhead": model.cell_overhead("decode", bucket=64, batch=2),
        "cross": model.fit_dispatch_cost("prefill", precision="w8a8"),
        "transfer": model.transfer_s(h2d_bytes=1e6, d2h_bytes=3e6),
        "snap": model.snapshot_transfer_terms(stats),
        "floor": model.flop_floor_s(100, "w8a8"),
    }


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_perf_model_fits_like_the_reference(seed, pinned):
    """On identical observations and an identical spec the port's model
    gives the reference's fitted lines, knees, ladders, priors, precision
    scales and transfer terms."""
    ref_spec = jax_backend.TPU_V5E
    spec = backend.BackendSpec(**dataclasses.asdict(ref_spec))
    assert _fit(pm, spec, seed, pinned) == _fit(jax_pm, ref_spec, seed,
                                                pinned)


def test_h100_spec_is_the_default_and_the_cards_own():
    """The port's one spec is the H100's datasheet envelope (the rates
    chip_smoke.py prices bounds with) and the default everywhere; no TPU
    spec is in the port."""
    h = backend.H100
    assert backend.DEFAULT_BACKEND is h
    assert (h.hbm_bw, h.peak_flops_bf16, h.peak_flops_int8) \
        == (3.35e12, 989e12, 1979e12)
    assert pm.PerfModel().spec is h
    assert h.precision_scale("w8a8") == pytest.approx(989 / 1979)
    assert h.precision_scale("fp32") == 1.0
    assert not any(isinstance(v, backend.BackendSpec) and v is not h
                   for v in vars(backend).values())


def test_for_params_counts_the_weights_like_the_reference():
    """The torch model's weights, converted from the JAX tree, size the
    model as the reference's leaves do."""
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     "cpu")
    assert pm.PerfModel.for_params(params).flops_per_token \
        == jax_pm.PerfModel.for_params(jparams).flops_per_token


# ---- failure detector and elastic controller -----------------------------

def test_heartbeat_monitor_like_the_reference():
    out = []
    for mod in (ft, jax_ft):
        clock = [0.0]
        mon = mod.HeartbeatMonitor(3, timeout_s=1.0, clock=lambda: clock[0])
        log = []
        for t, op, h in [(0.5, "beat", 0), (0.9, "beat", 1),
                         (1.0, "poll", None), (1.2, "poll", None),
                         (1.3, "add", 3), (2.2, "poll", None),
                         (2.5, "remove", 2), (2.6, "rejoin", 0),
                         (3.7, "poll", None)]:
            clock[0] = t
            if op == "poll":
                log.append((mon.unhealthy(), mon.newly_failed(),
                            mon.healthy_count()))
            else:
                getattr(mon, {"beat": "beat", "add": "add_host",
                              "remove": "remove_host",
                              "rejoin": "rejoin"}[op])(h)
        with pytest.raises(mod.DeadHostBeat):
            mon.beat(1)
        out.append(log)
    assert out[0] == out[1]


def _controller(mod_fs, mod_ctl, mod_ft, sim, **kw):
    """``tests/fleet_sim.py::make_controller`` over either package."""
    mon = mod_ft.HeartbeatMonitor(num_hosts=len(sim.replicas),
                                  timeout_s=0.05, clock=lambda: sim.now)
    cfg = dict(min_replicas=1, max_replicas=3, cooldown_s=0.2,
               down_hold_s=0.5)
    cfg.update(kw)
    return mod_ctl.FleetController(
        sim.router, sim.replica_factory(service_s=0.01), mon,
        mod_ctl.ControllerConfig(**cfg))


def _last_fp32_run(which, seed):
    """The reference's ``test_scale_down_never_burns_last_fp32`` scenario:
    one fp32 and two w8a8 replicas under light multi-tenant traffic."""
    mod_fs, mod_ctl, mod_ft = PAIRS[which]
    sim = mod_fs.FleetSim(replicas=3, precisions=["fp32", "w8a8", "w8a8"],
                          service_s=0.01, slots=1, dt=0.005, seed=seed,
                          max_queue=16)
    c = _controller(mod_fs, mod_ctl, mod_ft, sim)
    m = mod_fs.run_elastic(sim, c, mod_fs.multi_tenant_trace(
        120, base_gap_s=0.05, seed=seed))
    return sim, c, m


def _decisions(c):
    return [(d.now, d.action, d.replica, d.live, d.reason)
            for d in c.decisions]


@pytest.mark.parametrize("seed", [0, 1, 2, 82, 187, 7015])
def test_controller_decides_like_the_reference(seed):
    """The same decision log and outcome as the frozen reference
    controller, at seeds where the reference keeps its last fp32 replica
    (0, 1, 2) and at three where it drains it (82, 187, and 7015, the
    failing example the reference's property test replays first; ROADMAP
    C)."""
    sim, c, m = _last_fp32_run("port", seed)
    jsim, jc, jm = _last_fp32_run("jax", seed)
    assert _decisions(c) == _decisions(jc)
    assert m == jm and c.summary() == jc.summary()
    assert m["lost"] == 0


@pytest.mark.xfail(strict=True, reason="ROADMAP C, 'An unsteady JAX "
                   "test': the copied controller, like the reference's, "
                   "scales down the last fp32 replica of a mixed fleet "
                   "at seed 82")
def test_scale_down_never_burns_last_fp32_at_seed_82():
    """The reference's invariant, held on the port at a seed where both
    controllers break it: deterministic, so the known defect stays
    visible until the reference is fixed."""
    _hold_last_fp32(82)


@pytest.mark.xfail(strict=True, reason="ROADMAP C, 'An unsteady JAX "
                   "test': at seed 7015, the failing example the "
                   "reference's property test replays first, the copied "
                   "controller, like the reference's, scales down the last "
                   "fp32 replica of a mixed fleet")
def test_scale_down_never_burns_last_fp32_at_seed_7015():
    """The same invariant at the seed the reference's saved example
    holds."""
    _hold_last_fp32(7015)


def _hold_last_fp32(seed):
    sim, c, m = _last_fp32_run("port", seed)
    assert c.scale_downs >= 1
    assert len(sim.router.fp32_alive) >= 1
    assert all(d.replica != 0 for d in c.decisions if d.action == "down")


@pytest.mark.parametrize("seed", [0, 4])
def test_controller_under_a_crowd_with_a_kill_like_the_reference(seed):
    """A flash crowd with replica 0 frozen mid-crowd (detected by the
    heartbeat monitor, replaced and drained): the same decisions, fleet
    ticks and outcome as the reference; nothing lost."""
    out = []
    for which in ("port", "jax"):
        mod_fs, mod_ctl, mod_ft = PAIRS[which]
        sim = mod_fs.FleetSim(replicas=2, service_s=0.01, slots=1,
                              dt=0.005, seed=seed, max_queue=16)
        c = _controller(mod_fs, mod_ctl, mod_ft, sim, max_replicas=5)
        arr = mod_fs.flash_crowd_trace(150, base_gap_s=0.006, crowd_x=5.0,
                                       seed=seed, slo_ms=500.0)
        m = mod_fs.run_elastic(sim, c, arr, kills=[(arr[75].t, 0)])
        out.append((_decisions(c), m, c.report()))
    assert out[0] == out[1]
    assert out[0][1]["lost"] == 0
    assert any(d[1] == "up" for d in out[0][0])


def test_elastic_vs_fixed_gives_the_reference_numbers():
    """The elastic-versus-fixed comparison (the launcher's
    ``--elastic-smoke``) gives the reference's numbers field for field."""
    r = fs.elastic_vs_fixed(kill_at_frac=0.33)
    jr = jax_fs.elastic_vs_fixed(kill_at_frac=0.33)
    assert [dataclasses.astuple(a) for a in r.pop("arrivals")] \
        == [dataclasses.astuple(a) for a in jr.pop("arrivals")]
    c, jc = r.pop("controller"), jr.pop("controller")
    assert _decisions(c) == _decisions(jc)
    assert r == jr
    assert r["zero_lost"] and r["shed_improved"] and r["capacity_improved"]


@pytest.mark.parametrize("trace", ["diurnal_trace", "flash_crowd_trace",
                                   "hot_burst_trace", "multi_tenant_trace"])
def test_trace_generators_like_the_reference(trace):
    a = getattr(fs, trace)(300, seed=3)
    b = getattr(jax_fs, trace)(300, seed=3)
    assert [dataclasses.astuple(x) for x in a] \
        == [dataclasses.astuple(x) for x in b]


def test_fixed_fleet_like_the_reference():
    out = []
    for mod in (fs, jax_fs):
        sim = mod.FleetSim(replicas=3, service_s=0.01, slots=1, dt=0.005,
                           seed=2, max_queue=16)
        arr = mod.hot_burst_trace(400, seed=2)
        out.append(mod.run_fixed(sim, arr))
    assert out[0] == out[1] and out[0]["lost"] == 0


def test_no_module_global_counter_moves():
    """The fleet layer runs no kernel: a simulated fleet leaves every
    kernel launch counter where it was."""
    from repro_torch.serving import executor as executor_mod
    before = executor_mod._counts()
    _drive(fs, 0, prefix=True, fail=1, ticks=30)
    assert executor_mod._counts() == before

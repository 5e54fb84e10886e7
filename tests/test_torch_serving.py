"""The port's copies of the JAX package's jax-free serving modules
(scheduler, telemetry, slot-state manager), of the quantization workflow
and token agreement, and of the DLRM slice's jax-free parts (config,
partitioner, click-log batches, transfer bookkeeping, pipeline helpers)
and of the fleet layer's jax-free modules (backend spec, failure
detector, fleet prefix index, router, performance model, controller,
fleet simulator, and the engines' replica hooks) stay copies: the same
code, and the same decisions on the same seeded operation sequences."""
import ast
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import dlrm_paper as jax_dlrm_cfg
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core import backend as jax_backend
from repro.core import bucketing as jax_bucketing
from repro.core import metrics as jax_metrics
from repro.core import partitioner as jax_part
from repro.core import pipeline as jax_pipe
from repro.core import quantization as jax_quant
from repro.core import transfer as jax_transfer
from repro.data import synthetic as jax_synth
from repro.runtime import fault_tolerance as jax_ft
from repro.serving import controller as jax_ctl
from repro.serving import dlrm_engine as jax_dlrm_engine
from repro.serving import engine as jax_engine
from repro.serving import fleet_sim as jax_fs
from repro.serving import perf_model as jax_pm
from repro.serving import router as jax_router
from repro.serving import scheduler as jax_sched
from repro.serving import state as jax_state
from repro.serving import telemetry as jax_tel
from repro_torch.configs import dlrm_paper as dlrm_cfg
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import backend
from repro_torch.core import bucketing
from repro_torch.core import metrics
from repro_torch.core import partitioner as part
from repro_torch.core import pipeline as pipe
from repro_torch.core import quantization as quant
from repro_torch.core import transfer
from repro_torch.data import synthetic as synth
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.serving import controller as ctl
from repro_torch.serving import dlrm_engine
from repro_torch.serving import engine
from repro_torch.serving import fleet_sim as fs
from repro_torch.serving import perf_model as pm
from repro_torch.serving import router
from repro_torch.serving import scheduler as sched
from repro_torch.serving import state
from repro_torch.serving import telemetry as tel

COPIED = [
    (jax_tel, tel, "percentile"), (jax_tel, tel, "Telemetry"),
    (jax_sched, sched, "Ticket"), (jax_sched, sched, "FIFOPolicy"),
    (jax_sched, sched, "EDFPolicy"), (jax_sched, sched, "SizeTimePolicy"),
    (jax_sched, sched, "PriorityAgingPolicy"),
    (jax_sched, sched, "ServiceEstimator"), (jax_sched, sched, "Scheduler"),
    (jax_state, state, "SequenceStateManager"),
    (jax_state, state, "slot_kinds_for"),
    (jax_state, state, "require_chunkable"),
    (jax_state, state, "SequenceSnapshot"),
    (jax_quant, quant, "LayerQuantDecision"),
    (jax_quant, quant, "QuantWorkflowResult"),
    (jax_quant, quant, "quantization_workflow"),
    (jax_metrics, metrics, "token_agreement"),
    (jax_dlrm_cfg, dlrm_cfg, "DLRMConfig"),
    (jax_dlrm_cfg, dlrm_cfg, "_powerlaw_rows"),
    (jax_dlrm_cfg, dlrm_cfg, "reduce_for_smoke"),
    (jax_part, part, "TableAssignment"), (jax_part, part, "_greedy_assign"),
    (jax_part, part, "partition_tables"),
    (jax_synth, synth, "zipf_indices"), (jax_synth, synth, "dlrm_batches"),
    (jax_synth, synth, "xlmr_sentences"),
] + [(jax_bucketing, bucketing, name) for name in (
    "pick_bucket", "pad_to_bucket", "pad_ragged_to_bucket",
    "wasted_compute_fraction", "length_sorted_batches")] + [
    (jax_transfer, transfer, "TransferStats"),
    (jax_transfer, transfer, "SparseBatch"),
    (jax_transfer, transfer, "pack_sparse_inputs"),
    (jax_pipe, pipe, "PipelineStats"), (jax_pipe, pipe, "TwoStagePipeline"),
    (jax_pipe, pipe, "steady_state_speedup"),
    (jax_backend, backend, "BackendSpec"),
    (jax_ft, ft, "HostState"), (jax_ft, ft, "DeadHostBeat"),
    (jax_ft, ft, "HeartbeatMonitor"),
    (jax_state, state, "FleetPrefixIndex"),
    (jax_router, router, "ReplicaRouter"), (jax_router, router, "spread"),
    (jax_pm, pm, "_median"), (jax_pm, pm, "PerfModel"),
    (jax_ctl, ctl, "ControllerConfig"), (jax_ctl, ctl, "Decision"),
    (jax_ctl, ctl, "FleetController"),
] + [(jax_fs, fs, name) for name in (
    "SimSnapshot", "SimReplica", "FleetSim", "Arrival", "_poisson_times",
    "diurnal_trace", "flash_crowd_trace", "hot_burst_trace",
    "multi_tenant_trace", "run_elastic", "run_fixed", "elastic_vs_fixed")]
# the engines' replica hooks: methods and properties of the port's engines
# that keep the reference's code
COPIED_HOOKS = [(jax_engine.InferenceEngine, engine.InferenceEngine, name)
                for name in ("attach_prefix_index", "prefix_keys",
                             "prefix_snapshot", "prefix_accept",
                             "export_prefix_cache", "_prefix_store",
                             "_prefix_lookup", "free_slots",
                             "drain_tickets", "steal_eligible")] + [
    (jax_dlrm_engine.DLRMEngine, dlrm_engine.DLRMEngine, name)
    for name in ("inflight", "free_slots", "steal_eligible",
                 "drain_tickets", "submit")]
# nested functions written in torch in the copy (the workflow's default
# per-layer error; the performance model's weight count);
# test_quantization_workflow_decides_like_the_original and
# test_torch_fleet.py::test_for_params_counts_the_weights_like_the_reference
# hold their numbers to the original's
TORCH_REWRITTEN = {"default_err", "for_params"}
# the array type of an annotation in the original, and in the copy
ARRAY_TYPES = (("jax", "Array"), ("torch", "Tensor"))


def _code(obj) -> str:
    """The object's source as an AST dump without docstrings (comments
    are not in the AST), without the nested functions the copy rewrites
    in torch, with ``jax.Array`` read as ``torch.Tensor`` and an import
    from ``repro_torch`` read as one from ``repro``: the code, not its
    prose."""
    if isinstance(obj, property):
        obj = obj.fget
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    (jax_mod, jax_attr), (torch_mod, torch_attr) = ARRAY_TYPES
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[0] == "repro_torch":
            node.module = "repro" + node.module[len("repro_torch"):]
        if isinstance(node, ast.Attribute) and node.attr == jax_attr \
                and isinstance(node.value, ast.Name) \
                and node.value.id == jax_mod:
            node.attr, node.value.id = torch_attr, torch_mod
        body = getattr(node, "body", None)
        if isinstance(body, list):
            node.body = [n for n in body
                         if not (isinstance(n, ast.FunctionDef)
                                 and n.name in TORCH_REWRITTEN)]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("orig,copy,name", COPIED,
                         ids=[c[2] for c in COPIED])
def test_copy_has_the_original_code(orig, copy, name):
    assert _code(getattr(copy, name)) == _code(getattr(orig, name))


@pytest.mark.parametrize("orig,copy,name", COPIED_HOOKS,
                         ids=[f"{c[1].__name__}.{c[2]}" for c in COPIED_HOOKS])
def test_replica_hook_has_the_original_code(orig, copy, name):
    assert _code(copy.__dict__[name]) == _code(orig.__dict__[name])


def _drive_scheduler(mod, policy, seed):
    """Seeded submits / admits / completes at explicit clock values; returns
    everything the scheduler decided."""
    rng = np.random.default_rng(seed)
    s = mod.Scheduler(policy, max_queue=12, service_ms_est="auto",
                      service_ms_fallback=5.0, default_slo_ms=400.0)
    now, log, live = 0.0, [], []
    for _ in range(60):
        now += float(rng.uniform(0.0, 0.05))
        op = rng.integers(0, 3)
        if op == 0:
            t = s.submit(f"r{len(log)}", size=int(rng.integers(1, 200)),
                         priority=int(rng.integers(0, 3)), now=now)
            log.append(("submit", t.tid, t.shed))
        elif op == 1:
            got = s.admit(int(rng.integers(1, 4)), now=now)
            live += got
            log.append(("admit", [t.tid for t in got]))
        elif live:
            t = live.pop(int(rng.integers(0, len(live))))
            s.complete(t, now=now)
            log.append(("complete", t.tid))
    summary = s.telemetry.summary()
    summary.pop("qps")                       # wall-clock dependent
    return log, summary


@pytest.mark.parametrize("policy", ["fifo", "edf", "sizetime", "priority"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decides_like_the_original(policy, seed):
    assert _drive_scheduler(sched, policy, seed) \
        == _drive_scheduler(jax_sched, policy, seed)


def _drive_states(mod, seed, slots=4):
    """Seeded slot lifecycle (acquire / park / activate / release /
    page_out / evict_all) with the partition checked after every move."""
    rng = np.random.default_rng(seed)
    m = mod.SequenceStateManager(slots)
    parked, log = [], []
    for _ in range(80):
        op = rng.integers(0, 3)
        t = None
        if op == 0 and m.free_count:           # a fresh ticket
            t = object()
        elif op == 1 and parked:               # a chunked continuation
            t = parked.pop(0)
        elif op == 2 and m.active:
            slot = sorted(m.active)[int(rng.integers(0, len(m.active)))]
            (m.release(slot) if rng.integers(0, 2) else m.page_out(slot))
        if t is not None:
            slot = m.acquire(t)
            if rng.integers(0, 2):
                m.activate(t, slot, int(rng.integers(1, 50)))
            else:
                m.park(t, slot)
                parked.append(t)
        m.check_partition()
        log.append((sorted(m.free), sorted(m.active), m.inflight,
                    m.active_mask().tolist(), m.decode_positions(99).tolist(),
                    [m.steal_eligible(p) for p in parked]))
    log.append(len(m.evict_all()))
    m.check_partition()
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_state_manager_moves_like_the_original(seed):
    assert _drive_states(state, seed) == _drive_states(jax_state, seed)


def test_percentile_and_report_like_the_original():
    rng = np.random.default_rng(3)
    vals = sorted(rng.uniform(0, 100, 37).tolist())
    for p in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert tel.percentile(vals, p) == jax_tel.percentile(vals, p)
    a, b = tel.Telemetry(), jax_tel.Telemetry()
    for t in (a, b):
        t.wall_start = 0.0
        t.record_serving_window(2.0)
        for x in vals:
            t.record_latency(x, deadline_missed=x > 90)
            t.record_ttft(x / 4)
        t.record_compile("prefill")
        t.served, t.steps = 37, 12
    assert a.report() == b.report() and a.summary() == b.summary()


@pytest.mark.parametrize("budget", [0.0, 0.05, 1.0])
def test_quantization_workflow_decides_like_the_original(budget):
    """The default per-layer error (the part written in torch) and the
    fall-back loop: the same errors, order and decisions on the same
    weights and the same metric."""
    rng = np.random.default_rng(4)
    ws = {f"site{i}": rng.standard_normal((32, 48)).astype(np.float32)
          * rng.uniform(0.5, 2.0, 48).astype(np.float32) for i in range(5)}
    ws["site0"][3, 7] = 40.0                     # one badly scaled column

    def metric(schemes):
        return 0.02 * sum(s == "int8" for s in schemes.values())

    import jax.numpy as jnp
    got = quant.quantization_workflow(
        {n: torch.from_numpy(w) for n, w in ws.items()}, metric,
        budget=budget, max_iters=3)
    want = jax_quant.quantization_workflow(
        {n: jnp.asarray(w) for n, w in ws.items()}, metric, budget=budget,
        max_iters=3)
    assert [(d.name, d.scheme) for d in got.decisions] == \
        [(d.name, d.scheme) for d in want.decisions]
    for d, e in zip(got.decisions, want.decisions):
        assert d.error == pytest.approx(e.error, rel=1e-5)
    assert (got.passed, got.metric_delta, got.iterations) == \
        (want.passed, want.metric_delta, want.iterations)


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-27b", "gemma-2b",
                                  "recurrentgemma-9b", "xlmr-paper",
                                  "qwen2-vl-7b", "mamba2-130m",
                                  "dbrx-132b", "command-r-plus-104b",
                                  "kimi-k2-1t-a32b"])
def test_config_copy_equals_the_original(arch):
    """Each config the port registers is the JAX package's, field for
    field, at full width and through ``reduce_for_smoke``."""
    assert dataclasses.asdict(get_config(arch)) \
        == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(reduce_for_smoke(get_config(arch))) \
        == dataclasses.asdict(jax_reduce(jax_get_config(arch)))

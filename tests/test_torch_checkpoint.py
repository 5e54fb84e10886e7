"""The port's checkpoints, data pipeline and fault-tolerance copies, on the
CPU.

- ``CheckpointManager``: round trip, async save and retention, ``.tmp``
  directories not counted (as ``tests/test_checkpoint_ft.py``); the
  reference's manager reads a directory the port wrote (``all_steps``,
  ``latest_step``, ``restore``), and both write the same ``index.json``
  for the same leaves; a bf16 leaf raises, naming it.
- ``TrainSupervisor`` restarts from a checkpoint; ``StepDeadline``'s
  cases; the copies (``lm_token_batches``, the training side of
  ``runtime/fault_tolerance.py``, ``OptConfig``, ``select_for``,
  ``choose_microbatches``) hold the originals' code.
- ``PrefetchLoader`` hands out the generator's batches in order, raises
  the worker's exception and stops its worker on ``close``.
- The independence check walks the training modules.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro.data import synthetic as jax_synth
from repro.runtime import fault_tolerance as jax_ft
from repro.training import optimizer as jax_opt
from repro.training import train_step as jax_train_step
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data import synthetic as synth
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import (HostFailure, StepDeadline,
                                                 TrainSupervisor)
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step
from test_torch_independence import _modules
from test_torch_serving import _code


def _state(seed: int, scale: float = 1.0):
    g = torch.Generator().manual_seed(seed)
    return {"layers.0.attn.wq": torch.randn(8, 4, 2, generator=g) * scale,
            "layers.0.pre_norm.scale": torch.randn(8, generator=g) * scale,
            "embed": torch.randn(16, 8, generator=g) * scale,
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t = _state(0)
    mgr.save(10, t)
    back = mgr.restore(10, {k: torch.zeros_like(v) for k, v in t.items()})
    for k, v in t.items():
        assert torch.equal(back[k], v) and back[k].dtype == v.dtype, k


def test_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(0, scale=s), blocking=False)
    mgr.wait()
    mgr._gc()
    assert mgr.all_steps() == [3, 4]
    t = mgr.restore(4, _state(1))
    assert torch.equal(t["embed"], _state(0, scale=4)["embed"])


def test_save_snapshots_before_returning(tmp_path):
    """The leaves are copied to the host before ``save`` returns: a write
    to the tensors after it does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    t = _state(0)
    want = {k: v.clone() for k, v in t.items()}
    mgr.save(1, t, blocking=False)
    for v in t.values():
        v.add_(1)
    mgr.wait()
    back = mgr.restore(1, t)
    for k, v in want.items():
        assert torch.equal(back[k], v), k


def test_tmp_dirs_are_not_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    os.makedirs(tmp_path / "step_00000099.tmp")       # crashed mid-write
    mgr.save(5, _state(0))
    assert mgr.all_steps() == [5]
    assert mgr.latest_step() == 5


def test_reference_reads_the_ports_checkpoints(tmp_path):
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    mgr = CheckpointManager(str(ours), keep=2)
    for s in (3, 6, 9):
        mgr.save(s, _state(s))
    os.makedirs(ours / "step_00000012.tmp")
    ref = JaxManager(str(ours), keep=2)
    assert ref.all_steps() == mgr.all_steps() == [6, 9]
    assert ref.latest_step() == mgr.latest_step() == 9
    t = _state(9)
    back = ref.restore(9, {k: v.numpy() for k, v in t.items()})
    for k, v in t.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v.numpy())
    # the same leaves written by the reference: the same index.json
    JaxManager(str(theirs)).save(9, {k: v.numpy() for k, v in t.items()})
    index = [json.load(open(d / "step_00000009" / "index.json"))
             for d in (ours, theirs)]
    assert index[0] == index[1]
    assert set(index[0]) == {"step", "leaves"}
    assert list(index[0]["leaves"]) == sorted(t)


def test_bf16_leaf_raises_naming_it(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = dict(_state(0), **{"lm_head": torch.zeros(4, 4,
                                                  dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="lm_head"):
        mgr.save(1, t)
    assert mgr.all_steps() == []


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """Simulated host failure at a known step; training resumes from the
    last checkpoint and completes all steps exactly once post-restore."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": torch.zeros(4), "done": set()}
    failures = {17}

    def run_step(step):
        if step in failures:
            failures.discard(step)
            raise HostFailure(f"host 3 died at step {step}")
        state["params"] = state["params"] + 1.0
        state["done"].add(step)

    def save(step):
        mgr.save(step, {"params": state["params"]})

    def restore():
        s = mgr.latest_step() or 0
        if s:
            state["params"] = mgr.restore(
                s, {"params": state["params"]})["params"]
        return s

    sup = TrainSupervisor(run_step, save, restore, ckpt_every=5)
    assert sup.run(30) == 30
    assert sup.restarts == 1
    assert float(state["params"][0]) == 30      # 15 before, 15 after 15
    assert mgr.latest_step() == 30


@pytest.mark.parametrize("k,times,want", [
    # an even window's median is interpolated: 1.2 here, so 2.0 > 1.8
    (1.5, [1.0, 1.0, 1.0, 1.4, 1.4, 2.0], [False] * 5 + [True]),
    (3.0, [1.0] * 10 + [10.0], [False] * 10 + [True])])
def test_step_deadline(k, times, want):
    wd = StepDeadline(k=k)
    assert [wd.observe(t) for t in times] == want


COPIED = [(jax_synth, synth, "lm_token_batches")] + [
    (jax_ft, ft, name) for name in (
        "ElasticPlan", "plan_elastic_mesh", "TrainSupervisor", "HostFailure",
        "HedgePolicy", "simulate_hedged_latency", "StepDeadline")] + [
    (jax_opt, opt, "OptConfig"), (jax_opt, opt, "select_for"),
    (jax_train_step, train_step, "choose_microbatches")]


@pytest.mark.parametrize("orig,copy,name", COPIED,
                         ids=[c[2] for c in COPIED])
def test_copy_has_the_original_code(orig, copy, name):
    assert _code(getattr(copy, name)) == _code(getattr(orig, name))


def test_token_batches_equal_the_originals():
    ours = synth.lm_token_batches(50280, 4, 16, seed=17)
    theirs = jax_synth.lm_token_batches(50280, 4, 16, seed=17)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_stages_in_order_and_stops():
    want = synth.lm_token_batches(256, 2, 8, seed=3)
    loader = PrefetchLoader(synth.lm_token_batches(256, 2, 8, seed=3),
                            depth=2, device="cpu")
    for _ in range(5):
        got, w = next(loader), next(want)
        for k in ("tokens", "labels"):
            assert torch.is_tensor(got[k])
            np.testing.assert_array_equal(got[k].numpy(), w[k])
    loader.close()                       # the worker is blocked on a put
    assert not loader._thread.is_alive()


def test_prefetch_loader_raises_the_workers_error():
    def broken():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("no more data")

    loader = PrefetchLoader(broken(), device="cpu")
    assert torch.equal(next(loader)["x"], torch.zeros(2))
    with pytest.raises(RuntimeError, match="no more data"):
        next(loader)
    loader.close()


def test_module_list_covers_the_training_path():
    """The blocked-import check of ``tests/test_torch_independence.py``
    walks the training slice's modules too."""
    assert {"repro_torch.training.optimizer",
            "repro_torch.training.train_step", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.train"} <= set(_modules())

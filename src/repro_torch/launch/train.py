"""Training launcher of the port: ``python -m repro_torch.launch.train --arch
mamba2-130m --steps 200 --batch 8 --seq 128`` — the reference's loop
(``repro/launch/train.py``) on one device: f32 parameters and
activations, Adam, optional grad accumulation (``--accum``), checkpoints
every ``--ckpt-every`` steps written on a background thread, restart from
the latest one (``--resume``), a prefetching data pipeline and a step-time
watchdog. ``--smoke`` (the default) trains the reduced config,
``--full-config`` the published widths; ``--device cpu`` runs on the
host. Every flag of the reference's launcher is here, plus ``--device``
(default ``cuda``).

Its resume is the reference's: checkpoints hold the parameters only, so a
resumed run starts a fresh optimizer state; a run resumed from step s runs
step s again (the checkpoint of step s is taken after its update); the
data restarts from its seed. On a CUDA device each logged step also
prints its device time, between CUDA events around the step, and the
peak memory so far. There is no mesh: one device, no sharding rules.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.data.synthetic import lm_token_batches
from repro_torch.models import model as model_mod
from repro_torch.runtime.fault_tolerance import StepDeadline
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

DATA_SEED = 17


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


@dataclasses.dataclass
class Trainer:
    """What a run trains: the config, the model (gradients on), Adam's
    state, the checkpoint manager and the step to start from."""
    cfg: ModelConfig
    model: model_mod.Model
    opt_cfg: OptConfig
    opt_state: Dict
    mgr: CheckpointManager
    start: int


def setup(args: argparse.Namespace) -> Trainer:
    """The config (f32 parameters and activations), the seed-0 model, a
    fresh Adam state; with ``--resume``, the parameters of the latest
    checkpoint."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              activation_dtype="float32")
    opt_cfg = OptConfig(name="adam", lr=args.lr)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    model = model_mod.init_params(cfg, seed=0, device=args.device)
    model.requires_grad_(True)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start = mgr.latest_step()
        model.load_state_dict(mgr.restore(start, model.state_dict()))
        print(f"resumed from step {start}")
    opt_state = init_opt_state(dict(model.named_parameters()), opt_cfg)
    return Trainer(cfg, model, opt_cfg, opt_state, mgr, start)


def train(tr: Trainer, args: argparse.Namespace) -> List[dict]:
    """Steps ``tr.start`` .. ``args.steps - 1``; returns one record a
    logged step: step, loss, grad_norm, wall_ms (the mean wall time a
    step so far) and, on a CUDA device, device_ms (the step's time
    between CUDA events) and peak_gib (the peak allocated so far)."""
    device = model_mod.model_device(tr.model)
    cuda = device.type == "cuda"
    step_fn = make_train_step(tr.cfg, tr.opt_cfg, accum_steps=args.accum,
                              remat=False)
    watchdog = StepDeadline()
    data = PrefetchLoader(lm_token_batches(tr.cfg.vocab_size, args.batch,
                                           args.seq, seed=DATA_SEED),
                          device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    records = []
    try:
        t0 = time.perf_counter()
        for step in range(tr.start, args.steps):
            ts = time.perf_counter()
            if cuda:
                begin.record()
            batch = next(data)
            tr.opt_state, metrics = step_fn(tr.model, tr.opt_state, batch)
            if cuda:
                end.record()
            if watchdog.observe(time.perf_counter() - ts):
                print(f"straggler warning at step {step}")
            if step % args.ckpt_every == 0 and step > tr.start:
                tr.mgr.save(step, tr.model.state_dict(), blocking=False)
            if step % args.log_every == 0:
                rec = {"step": step, "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "wall_ms": (time.perf_counter() - t0)
                       / (step - tr.start + 1) * 1e3}
                line = (f"step {step:5d} loss {rec['loss']:.4f} "
                        f"gnorm {rec['grad_norm']:.3f} "
                        f"({rec['wall_ms']:.0f} ms/step)")
                if cuda:
                    end.synchronize()
                    rec["device_ms"] = begin.elapsed_time(end)
                    rec["peak_gib"] = \
                        torch.cuda.max_memory_allocated(device) / 2**30
                    line += (f" device {rec['device_ms']:.3f} ms, peak "
                             f"{rec['peak_gib']:.2f} GiB")
                records.append(rec)
                print(line, flush=True)
        tr.mgr.wait()
    finally:
        data.close()
    if records:
        print(f"final loss {records[-1]['loss']:.4f} "
              f"(first {records[0]['loss']:.4f})")
    return records


def main(argv=None) -> List[dict]:
    args = _parser().parse_args(argv)
    return train(setup(args), args)


if __name__ == "__main__":
    main()

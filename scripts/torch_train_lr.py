#!/usr/bin/env python3
"""The trainer's loss against its learning rate: ``python3
scripts/torch_train_lr.py --arch mamba2-130m --lrs 3e-3 1e-3 3e-4``
from the repository root.

For each learning rate, a fresh seed-0 model (f32, as ``launch/train.py``
builds it) takes ``--steps`` Adam steps of ``make_train_step`` on the
launcher's data stream (``lm_token_batches``, seed 17); prints every
step's loss and gradient norm, then the first loss, the mean of the last
5 and their difference. With ``--own-steps N`` the model then takes N
more steps on the stream's next batch alone, and that batch's loss is
printed before them and after each (whether a step lowers the loss of the
batch it was taken on). ``--layers`` keeps the first layers of the arch
and ``--d-model`` narrows it (a cut the host can run); the default is
the published config at full width, which wants the card (``--device
cuda``, the default). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.launch.train import DATA_SEED  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.training.optimizer import OptConfig  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    init_train_state, make_train_step)


def run(cfg, lr: float, args) -> list:
    opt_cfg = OptConfig(name="adam", lr=lr)
    model, state = init_train_state(cfg, opt_cfg, 0, args.device)
    step = make_train_step(cfg, opt_cfg, accum_steps=args.accum,
                           remat=False)
    data = lm_token_batches(cfg.vocab_size, args.batch, args.seq,
                            seed=DATA_SEED)
    losses = []
    for i in range(args.steps):
        state, m = step(model, state, next(data))
        losses.append(float(m["loss"]))
        print(f"lr {lr:g} step {i:3d} loss {losses[-1]:.4f} gnorm "
              f"{float(m['grad_norm']):.3f}", flush=True)
    if args.own_steps:
        batch = {k: torch.from_numpy(v).to(args.device)
                 for k, v in next(data).items()}
        own = [_loss(model, cfg, batch)]
        for _ in range(args.own_steps):
            state, _ = step(model, state, batch)
            own.append(_loss(model, cfg, batch))
        print(f"lr {lr:g} own batch: " + " -> ".join(f"{l:.4f}" for l in own)
              + f" (fell {own[0] - own[1]:.4f} in one step)", flush=True)
    return losses


def _loss(model, cfg, batch) -> float:
    with torch.no_grad():
        return model_mod.loss_fn(model, cfg, batch)[0].item()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--lrs", type=float, nargs="+", default=[3e-3])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--own-steps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(args.arch), param_dtype="float32",
                              activation_dtype="float32")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model)
    where = torch.cuda.get_device_name(0) if args.device == "cuda" \
        else "the host"
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {args.batch} x {args.seq} tokens a "
          f"step, on {where}", flush=True)
    rows = []
    for lr in args.lrs:
        t0 = time.perf_counter()
        losses = run(cfg, lr, args)
        tail = float(np.mean(losses[-5:]))
        rows.append((lr, losses[0], tail))
        print(f"lr {lr:g}: first {losses[0]:.4f}, mean of the last 5 "
              f"{tail:.4f}, fell {losses[0] - tail:.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    for lr, first, tail in rows:
        print(f"summary lr {lr:g}: {first:.4f} -> {tail:.4f} "
              f"(fell {first - tail:.4f})")


if __name__ == "__main__":
    main()

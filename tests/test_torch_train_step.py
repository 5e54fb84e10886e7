"""The port's optimizers, training step and launcher against the JAX
package's, on the CPU.

- ``apply_updates``: Adam (weight decay on, the global-norm clip biting)
  and Adafactor (``min_dim_factored`` 8: factored and unfactored leaves)
  over 3 steps on the same trees as the reference's, within 1e-6.
- ``make_train_step``: accumulation over 2 microbatches against 1
  (``tests/test_system.py::test_grad_accum_equivalence``), and 3 steps
  against the reference's jitted step from the same weights and batches,
  qwen2-vl's M-RoPE positions (3,B,S) split on axis 1 included.
- Training reduces the loss (``tests/test_system.py``'s gemma-2b case).
- ``launch/train.py``: 6 steps with checkpoints, then a resume from the
  latest one in place of its parameters; the flag set is the reference
  launcher's plus ``--device``.
"""
import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.training import optimizer as jax_opt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data.synthetic import lm_token_batches
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as model_mod
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_TOL = 1e-6
SHAPES = {"w": (16, 12), "b": (12,), "t": (3, 9, 10), "s": (4, 200)}


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("cfg", [
    opt.OptConfig(name="adam", lr=1e-2, weight_decay=0.01),
    opt.OptConfig(name="adafactor", lr=1e-2, min_dim_factored=8)],
    ids=["adam", "adafactor"])
def test_apply_updates_matches_reference(cfg):
    rng = np.random.default_rng(0)
    jcfg = jax_opt.OptConfig(**dataclasses.asdict(cfg))
    start = _tree(rng)
    params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    state = opt.init_opt_state(params, cfg)
    jstate = jax_opt.init_opt_state(jparams, jcfg)
    for step in range(3):
        grads = _tree(rng, scale=2.0 if step else 0.01)  # clipped, then not
        m = opt.apply_updates(params, {k: torch.from_numpy(v)
                                       for k, v in grads.items()}, state, cfg)
        jparams, jstate, jm = jax_opt.apply_updates(
            jparams, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            jcfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=OPT_TOL)
        for k in SHAPES:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), rtol=OPT_TOL,
                                       atol=OPT_TOL, err_msg=f"{k} {step}")
    assert int(state["step"]) == 3
    if cfg.name == "adafactor":      # both kinds of second moment were used
        assert {k for k, v in state["v"].items() if "vr" in v} == {"w", "t"}


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               activation_dtype="float32")


def _model(cfg, seed=0):
    return model_mod.init_params(cfg, seed, "cpu").requires_grad_(True)


def _state(model, opt_cfg):
    return opt.init_opt_state(dict(model.named_parameters()), opt_cfg)


def test_grad_accum_equivalence():
    """accum=2 over batch 8 == accum=1 over batch 8 (same data)."""
    cfg = _f32(reduce_for_smoke(get_config("mamba2-130m")))
    opt_cfg = opt.OptConfig(name="adam", lr=1e-3)
    batch = next(lm_token_batches(cfg.vocab_size, 8, 16, seed=2))
    out = []
    for accum in (1, 2):
        model = _model(cfg)
        step = make_train_step(cfg, opt_cfg, accum_steps=accum, remat=False)
        _, m = step(model, _state(model, opt_cfg), batch)
        out.append((float(m["loss"]), model.state_dict()))
    assert abs(out[0][0] - out[1][0]) < 2e-5
    for k, v in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k].numpy(), v.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def _mrope_positions(B: int, S: int) -> np.ndarray:
    """(t, h, w) streams that differ from each other and from 0..S-1."""
    t = np.arange(S)
    return np.stack([np.broadcast_to(t // 4, (B, S)),
                     np.broadcast_to(t % 4 + 3, (B, S)),
                     np.broadcast_to((t * 7) % 5 + 1, (B, S))]).astype(np.int32)


def _step_batch(cfg, rng, B: int, S: int):
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
    if cfg.input_kind == "embeddings":
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                       * 0.1).astype(np.float32)
        b["positions"] = _mrope_positions(B, S)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return b


# loss of each step; the parameters after the 3rd within 1e-4: a tenth of
# one Adam step (lr 1e-3), room for the elements whose f32 gradient is
# rounding noise on either side
STEP_LOSS_TOL, STEP_PARAM_TOL = 1e-5, 1e-4


@pytest.mark.parametrize("arch,accum", [("qwen2-vl-7b", 2), ("dbrx-132b", 1),
                                        ("mamba2-130m", 2)])
def test_train_step_matches_reference(arch, accum):
    cfg = _f32(reduce_for_smoke(get_config(arch)))
    jcfg = _f32(jax_reduce(jax_get_config(arch)))
    opt_cfg = opt.OptConfig(name="adam", lr=1e-3)
    model = _model(cfg)
    jparams = jax.tree.map(jnp.asarray, convert.params_to_jax(model, cfg))
    jopt_cfg = jax_opt.OptConfig(**dataclasses.asdict(opt_cfg))
    jstate = jax_opt.init_opt_state(jparams, jopt_cfg)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt_cfg, accum_steps=accum,
                                        remat=False))
    step = make_train_step(cfg, opt_cfg, accum_steps=accum, remat=False)
    state = _state(model, opt_cfg)
    rng = np.random.default_rng(7)
    for _ in range(3):
        batch = _step_batch(cfg, rng, 4, 8)
        state, m = step(model, state, batch)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        assert m.keys() == jm.keys()
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=STEP_LOSS_TOL,
                                       atol=STEP_LOSS_TOL, err_msg=k)
    got = jax.tree_util.tree_flatten_with_path(
        convert.params_to_jax(model, cfg))[0]
    for (path, g), w in zip(got, jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=STEP_PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_training_reduces_loss():
    cfg = _f32(reduce_for_smoke(get_config("gemma-2b")))
    model = _model(cfg)
    opt_cfg = opt.OptConfig(name="adam", lr=3e-3)
    state = _state(model, opt_cfg)
    step = make_train_step(cfg, opt_cfg, accum_steps=1, remat=False)
    data = lm_token_batches(cfg.vocab_size, 8, 32, seed=5)
    losses = []
    for _ in range(40):
        state, m = step(model, state, next(data))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "6", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    recs = train_launcher.main(argv)
    assert [r["step"] for r in recs] == list(range(6))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 4]                 # keep=2
    # the resumed model holds the saved leaves bit for bit
    tr = train_launcher.setup(train_launcher._parser().parse_args(
        argv + ["--resume"]))
    assert tr.start == 4
    saved = mgr.restore(4, tr.model.state_dict())
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert "resumed from step 4" in capsys.readouterr().out
    # the reference's resume: step 4 runs again, then 5
    recs = train_launcher.train(tr, train_launcher._parser().parse_args(
        argv + ["--resume"]))
    assert [r["step"] for r in recs] == [4, 5]
    assert all(np.isfinite(r["loss"]) for r in recs)


def _reference_flags():
    """(flag, default) of every ``add_argument`` in the reference's
    launcher."""
    tree = ast.parse(open(os.path.join(ROOT, "src", "repro", "launch",
                                       "train.py")).read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = ast.literal_eval(kw["default"]) \
                if "default" in kw else None
    return out


def test_launcher_flags_are_the_reference_plus_device():
    ref = _reference_flags()
    ap = train_launcher._parser()
    ours = {a.option_strings[0]: a for a in ap._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert set(ours) == set(ref) | {"--device"}
    assert ours["--device"].default == "cuda"
    defaults = vars(ap.parse_args([]))
    for flag, default in ref.items():
        if default is not None and flag != "--ckpt-dir":   # under TMPDIR
            assert defaults[flag.lstrip("-").replace("-", "_")] == default, \
                flag

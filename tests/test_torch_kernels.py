"""The port's attention kernels against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels themselves are held against those on the card by chip_smoke.py).
Inputs are made once with numpy and fed to both packages; the JAX side is
its Pallas kernel in interpret mode and its ref.py oracle. Tolerances are
the JAX package's own: 2e-3 for f32, 2e-2 for bf16
(kernels/flash_attn/ops.py, kernels/decode_attn/ops.py).
"""
import ctypes
import dataclasses
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.kernels.decode_attn.decode import flash_decode
from repro.kernels.decode_attn.ref import decode_attn_ref as jax_decode_ref
from repro.kernels.flash_attn.ops import flash_attn as jax_flash_attn
from repro.kernels.flash_attn.ref import flash_attention_ref as jax_flash_ref
from repro.models import attention as jax_attn
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.sls import ops as sls_ops
from repro_torch.kernels.w8a8 import ops as w8a8_ops
from repro_torch.kernels.decode_attn.ops import decode_attn, decode_attn_int8
from repro_torch.kernels.decode_attn.ref import (decode_attn_int8_ref,
                                                 decode_attn_ref)
from repro_torch.kernels.flash_attn.ops import flash_attn
from repro_torch.kernels.flash_attn.ref import flash_attention_ref
from repro_torch.kernels.w8a8.ops import w8a8_matmul
from repro_torch.kernels.w8a8.ref import w8a8_ref
from repro_torch.models import attention as attn


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounds
    f32 -> bf16 to nearest-even on both sides, so the bits agree)."""
    j = jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(a)
    return j, (t.to(torch.bfloat16) if dtype == "bf16" else t)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the nine cases of repro/kernels/flash_attn/ops.py:
# (B, S, H, K, hd, dtype, lens_frac, kwargs)
FLASH_CASES = {
    "mha_64": (2, 64, 4, 4, 32, "f32", None, {}),
    "gqa_128": (2, 128, 8, 2, 64, "f32", None, {}),
    "mqa_256": (1, 256, 8, 1, 64, "f32", None, {}),
    "local_128": (2, 128, 4, 4, 32, "f32", None, {"window": 32}),
    "softcap": (2, 64, 4, 2, 32, "f32", None, {"softcap": 30.0}),
    "padded_lens": (2, 64, 4, 4, 32, "f32", 0.6, {}),
    "noncausal": (2, 64, 4, 4, 32, "f32", None, {"causal": False}),
    "odd_seq_96": (1, 96, 4, 4, 32, "f32", None, {}),
    "bf16": (2, 128, 8, 2, 64, "bf16", None, {}),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_plain_matches_jax(name):
    B, S, H, K, hd, dtype, lens_frac, kw = FLASH_CASES[name]
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.standard_normal((B, S, H, hd), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, K, hd), np.float32), dtype)
    lj = lt = None
    if lens_frac is not None:
        n = max(int(S * lens_frac), 1)
        lj, lt = jnp.full((B,), n, jnp.int32), torch.full((B,), n,
                                                          dtype=torch.int32)
    tol = 2e-2 if dtype == "bf16" else 2e-3
    got = flash_attn(qt, kt, vt, lt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, jax_flash_attn(qj, kj, vj, lj, bq=32, bk=32, interpret=True,
                               **kw), tol)
    _close(got, jax_flash_ref(qj, kj, vj, lj, **kw), tol)


# the cases of repro/kernels/decode_attn/ops.py: (B, H, K, hd, S, pos_frac,
# softcap)
DECODE_CASES = [
    (2, 8, 8, 64, 256, 0.5, 0.0),      # MHA
    (2, 8, 2, 64, 256, 0.9, 0.0),      # GQA
    (1, 8, 1, 128, 512, 0.3, 0.0),     # MQA
    (4, 4, 4, 32, 64, 0.0, 0.0),       # pos=0 edge
    (2, 8, 4, 64, 256, 0.7, 50.0),     # softcap
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "B{}_H{}_K{}_hd{}_S{}_p{}_cap{}".format(*c))
def test_decode_plain_matches_jax(case):
    B, H, K, hd, S, frac, cap = case
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.standard_normal((B, H, hd), np.float32), "f32")
    kj, kt = _pair(rng.standard_normal((B, S, K, hd), np.float32), "f32")
    vj, vt = _pair(rng.standard_normal((B, S, K, hd), np.float32), "f32")
    pos = int(S * frac)
    got = decode_attn(qt, kt, vt, pos, softcap=cap)   # scalar pos broadcasts
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    _close(got, flash_decode(qj, kj, vj, jnp.int32(pos), bs=64,
                             softcap=cap), 2e-3)
    _close(got, jax_decode_ref(qj, kj, vj, jnp.int32(pos), softcap=cap),
           2e-3)


def test_decode_per_row_pos_matches_jax_decode_attention():
    """Per-row positions and an inactive row, in a one-layer setup: the
    port's decode_attention (through the decode kernel's plain version)
    against the JAX model's jnp decode_attention on the same weights."""
    jcfg = jax_reduce(jax_get_config("deepseek-7b"))
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    B, S = 3, 32
    rng = np.random.default_rng(2)
    jp = jax_attn.init_attention(jcfg, jax.random.PRNGKey(3))
    p = attn.Attention(cfg, torch.Generator(), "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    ck = rng.standard_normal((B, S, cfg.num_kv_heads, cfg.head_dim),
                             np.float32)
    cv = rng.standard_normal(ck.shape, np.float32)
    pos = np.array([17, 0, 31], np.int32)
    active = np.array([True, True, False])
    yj, cj = jax_attn.decode_attention(
        jp, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.asarray(pos), jcfg, "global", active=jnp.asarray(active))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    y, cache = attn.decode_attention(p, torch.from_numpy(x), cache,
                                     torch.from_numpy(pos), cfg,
                                     rows=torch.tensor([0, 1]))
    _close(y, yj, 2e-3)
    for name, c0 in (("k", ck), ("v", cv)):
        _close(cache[name], cj[name], 2e-3)
        assert np.array_equal(cache[name][2].numpy(), c0[2])   # inactive


def test_wrappers_on_cpu_run_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 16, 4, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 16, 2, 32), np.float32))
    lens = torch.tensor([16, 5], dtype=torch.int32)
    f0, d0 = flash_attn.launches, decode_attn.launches
    assert torch.equal(flash_attn(q, k, k, lens),
                       flash_attention_ref(q, k, k, lens))
    pos = torch.tensor([15, 3], dtype=torch.int32)
    assert torch.equal(decode_attn(q[:, 0], k, k, pos),
                       decode_attn_ref(q[:, 0], k, k, pos))
    assert (flash_attn.launches, decode_attn.launches) == (f0, d0) == (0, 0)
    kq = torch.from_numpy(rng.integers(-127, 128, (2, 16, 2, 32),
                                       dtype=np.int8))
    sc = torch.from_numpy(rng.uniform(0.001, 0.02, (2, 16, 2))
                          .astype(np.float16))
    i0, w0 = decode_attn_int8.launches, w8a8_matmul.launches
    assert torch.equal(decode_attn_int8(q[:, 0], kq, sc, kq, sc, pos),
                       decode_attn_int8_ref(q[:, 0], kq, sc, kq, sc, pos))
    xs = torch.from_numpy(rng.uniform(0.001, 0.05, 16).astype(np.float32))
    xq, wq = kq[0, :, 0], kq[1, 0].t()                    # (16,32), (32,2)
    assert torch.equal(w8a8_matmul(xq, wq, xs, xs[:2]),
                       w8a8_ref(xq, wq, xs, xs[:2]))
    assert (decode_attn_int8.launches, w8a8_matmul.launches) == (i0, w0) \
        == (0, 0)


# the entry points whose wrapper module declares them under another name
# than ARGTYPES
OTHER_ARGTYPES = {"decode_attn_int8_fwd": "ARGTYPES_INT8",
                  "sls_fp_fwd": "ARGTYPES_FP", "sls_int8_fwd": "ARGTYPES_Q",
                  "sls_int4_fwd": "ARGTYPES_Q"}


@pytest.mark.parametrize("ops,entry,source", [
    (flash_ops, "flash_attn_fwd", "flash.cu"),
    (decode_ops, "decode_attn_fwd", "decode.cu"),
    (decode_ops, "decode_attn_int8_fwd", "decode_int8.cu"),
    (w8a8_ops, "w8a8_matmul_fwd", "w8a8.cu"),
    (sls_ops, "sls_fp_fwd", "sls.cu"),
    (sls_ops, "sls_int8_fwd", "sls.cu"),
    (sls_ops, "sls_int4_fwd", "sls.cu"),
])
def test_ctypes_signature_matches_c_entry(ops, entry, source):
    """The wrapper declares one ctypes type per parameter of the C entry
    point, in order (a pointer cut to 32 bits or a shifted argument would
    only show on the card)."""
    src = (_build.CSRC_DIR / source).read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
    c_types = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
               "float": ctypes.c_float}
    declared = [c_types["".join(re.sub(r"\bconst\b|\w+$", "",
                                       p.strip()).split())]
                for p in params.split(",")]
    assert declared == getattr(ops, OTHER_ARGTYPES.get(entry, "ARGTYPES"))


def test_every_csrc_source_is_covered():
    """Every kernel source has a parse check above and builds on its own."""
    assert sorted(_build.sources()) == ["decode", "decode_int8", "flash",
                                        "sls", "w8a8"]


def test_lib_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """A library is named by a hash of its source, the shared headers and
    the flags, so an edit to ``hopper.cuh`` or ``decode_split.cuh`` (which
    are not sources) names a new library for every source and a stale one
    is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert [p.name for p in _build.headers()] == ["decode_split.cuh",
                                                  "hopper.cuh"]
    for header in _build.headers():
        assert header.stem not in _build.sources()
        before = {name: _build.lib_path(name) for name in _build.sources()}
        assert before == {name: _build.lib_path(name)
                          for name in _build.sources()}
        header.write_text(header.read_text() + "\n// edited\n")
        after = {name: _build.lib_path(name) for name in _build.sources()}
        assert all(after[name] != before[name] for name in before)
        assert len(set(after.values())) == len(after)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 16, 4, 32)
    k = torch.zeros(2, 16, 3, 32)                       # 4 heads, 3 kv heads
    with pytest.raises(ValueError):
        flash_attn(q, k, k)
    with pytest.raises(ValueError):                     # lens must be int32
        flash_attn(q, q, q, torch.tensor([16, 5]))
    with pytest.raises(ValueError):                     # pos must be (B,)
        decode_attn(q[:, 0], q, q, torch.zeros(3, dtype=torch.int32))

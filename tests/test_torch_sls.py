"""The port's SLS (embedding-bag) plain versions against the JAX package's,
on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels of ``csrc/sls.cu`` are held against those on the card by
chip_smoke.py). Inputs are made once with numpy and fed to both packages;
the JAX side is its ``ref.py`` oracle and its Pallas kernel in interpret
mode, on the cases of ``repro/kernels/sls/ops.py``. Tolerances are the
JAX package's: 1e-5 for fp32, 1e-4 for int8 and int4.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sls import ref as jax_ref
from repro.kernels.sls.sls import sls_int4_pallas, sls_int8_pallas, sls_pallas
from repro_torch.core.quantization import dequantize_rows, quantize_rows_int8
from repro_torch.kernels.sls import ops as sls_ops
from repro_torch.kernels.sls.ops import sls, sls_int4, sls_int8
from repro_torch.kernels.sls.ref import sls_int4_ref, sls_int8_ref, sls_ref

# the cases of repro/kernels/sls/ops.py: (R, D, NB, L)
FP_CASES = [(64, 16, 8, 4), (1000, 64, 32, 8), (4096, 128, 16, 64),
            (128, 256, 4, 1)]
INT8_CASES = [(64, 16, 8, 4), (1000, 64, 32, 8), (512, 128, 16, 32)]
INT4_CASES = [(64, 16, 8, 4), (1000, 64, 32, 8)]
TOL = {"fp": 1e-5, "int8": 1e-4, "int4": 1e-4}


def _bags(rng, R, NB, L):
    idx = rng.integers(0, R, (NB, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, NB).astype(np.int32)
    return idx, lens


def _table(rng, kind, R, D):
    """The table's arrays for ``kind``: (table,) or (q, scale, bias), with
    the JAX cases' value ranges."""
    if kind == "fp":
        return (rng.standard_normal((R, D)).astype(np.float32),)
    cols = D if kind == "int8" else D // 2       # int4 packs two nibbles
    q = rng.integers(0, 256, (R, cols)).astype(np.uint8)
    scale = (rng.uniform(0, 1, R) * 0.1 + 0.01).astype(np.float16)
    bias = (rng.standard_normal(R) * 0.1).astype(np.float16)
    return q, scale, bias


PORT = {"fp": sls, "int8": sls_int8, "int4": sls_int4}
PLAIN = {"fp": sls_ref, "int8": sls_int8_ref, "int4": sls_int4_ref}
JAX_REF = {"fp": jax_ref.sls_ref, "int8": jax_ref.sls_int8_ref,
           "int4": jax_ref.sls_int4_ref}
PALLAS = {"fp": sls_pallas, "int8": sls_int8_pallas, "int4": sls_int4_pallas}
CASES = ([("fp",) + c for c in FP_CASES] + [("int8",) + c for c in INT8_CASES]
         + [("int4",) + c for c in INT4_CASES])


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "{}_R{}_D{}_NB{}_L{}".format(*c))
def test_plain_matches_jax_ref_and_pallas(case):
    kind, R, D, NB, L = case
    rng = np.random.default_rng(R + D + NB + L)
    tables = _table(rng, kind, R, D)
    idx, lens = _bags(rng, R, NB, L)
    t_args = [torch.from_numpy(a) for a in (*tables, idx, lens)]
    j_args = [jnp.asarray(a) for a in (*tables, idx, lens)]
    got = PORT[kind](*t_args)
    assert got.dtype == torch.float32 and got.shape == (NB, D)
    assert torch.equal(got, PLAIN[kind](*t_args))
    _close(got, JAX_REF[kind](*j_args), TOL[kind])
    _close(got, PALLAS[kind](*j_args, interpret=True), TOL[kind])


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_empty_bags_pool_to_exact_zero(kind):
    rng = np.random.default_rng(5)
    tables = [torch.from_numpy(a) for a in _table(rng, kind, 64, 16)]
    idx = torch.from_numpy(rng.integers(0, 64, (6, 8)).astype(np.int32))
    lens = torch.tensor([0, 3, 0, 8, -2, 0], dtype=torch.int32)
    out = PORT[kind](*tables, idx, lens)
    for b in (0, 2, 4, 5):                 # length 0, and negative
        assert torch.equal(out[b], torch.zeros(16))
    assert not torch.equal(out[1], torch.zeros(16))


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_lookups_past_the_length_are_never_read(kind):
    """An entry past a bag's length may hold anything (here indices out of
    the table), and a length past L reads L lookups, as the kernels do."""
    rng = np.random.default_rng(6)
    tables = [torch.from_numpy(a) for a in _table(rng, kind, 64, 16)]
    idx = rng.integers(0, 64, (4, 8)).astype(np.int32)
    lens = np.array([2, 5, 0, 8], np.int32)
    junk = idx.copy()
    for b, n in enumerate(lens):
        junk[b, n:] = [-7, 10**6, 64, -1, 99, 1 << 30, -64, 65][:8 - n]
    want = PORT[kind](*tables, torch.from_numpy(idx), torch.from_numpy(lens))
    got = PORT[kind](*tables, torch.from_numpy(junk), torch.from_numpy(lens))
    assert torch.equal(got, want)
    over = PORT[kind](*tables, torch.from_numpy(idx),
                      torch.full((4,), 50, dtype=torch.int32))
    full = PORT[kind](*tables, torch.from_numpy(idx),
                      torch.full((4,), 8, dtype=torch.int32))
    assert torch.equal(over, full)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_an_index_outside_the_table_makes_its_bag_nan(kind):
    """A read index outside [0, R) pools to NaN, as the JAX oracle's
    ``jnp.take`` gives for rows past the table; the other bags are
    untouched and nothing outside the table is read."""
    rng = np.random.default_rng(9)
    tables = _table(rng, kind, 32, 8)
    idx = rng.integers(0, 32, (5, 4)).astype(np.int32)
    lens = np.array([4, 4, 2, 4, 1], np.int32)
    idx[0, 1], idx[2, 3], idx[3, 3], idx[4, 0] = 32, 10**9, -1, -5
    got = PORT[kind](*[torch.from_numpy(a) for a in (*tables, idx, lens)])
    nan_rows = [0, 3, 4]                     # row 2's bad index is unread
    assert torch.isnan(got[nan_rows]).all()
    assert torch.isfinite(got[[1, 2]]).all()
    past = idx.copy()
    past[3, 3] = past[4, 0] = 32             # the oracle wraps negatives
    want = JAX_REF[kind](*[jnp.asarray(a) for a in (*tables, past, lens)])
    _close(got[[0, 1, 3, 4]], np.asarray(want)[[0, 1, 3, 4]], TOL[kind])


def test_int8_plain_matches_dlrm_quant_path():
    """The int8 kernel's dequantization is the row-wise scheme of
    ``core.quantization``: pooled rows equal the pooled dequantized rows."""
    rng = np.random.default_rng(7)
    qt = quantize_rows_int8(torch.from_numpy(
        rng.standard_normal((128, 32)).astype(np.float32)))
    idx = torch.from_numpy(rng.integers(0, 128, (8, 4)).astype(np.int32))
    lens = torch.full((8,), 3, dtype=torch.int32)
    _close(sls_int8(qt["q8"], qt["scale"], qt["bias"], idx, lens),
           sls_ref(dequantize_rows(qt), idx, lens).numpy(), 1e-4)


def test_cpu_wrappers_count_no_launch():
    rng = np.random.default_rng(8)
    before = (sls.launches, sls_int8.launches, sls_int4.launches)
    for kind in ("fp", "int8", "int4"):
        tables = [torch.from_numpy(a) for a in _table(rng, kind, 32, 8)]
        idx, lens = (torch.from_numpy(a) for a in _bags(rng, 32, 4, 3))
        assert torch.equal(PORT[kind](*tables, idx, lens),
                           PLAIN[kind](*tables, idx, lens))
    assert (sls.launches, sls_int8.launches, sls_int4.launches) == before \
        == (0, 0, 0)


class _FakeCuda:
    """Stands in for a contiguous CUDA tensor: all that ``_launch`` reads."""
    device = torch.device("cuda", 0)

    def __init__(self, *shape):
        self.shape = torch.Size(shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


ENTRY = {"fp": "sls_fp_fwd", "int8": "sls_int8_fwd", "int4": "sls_int4_fwd"}


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_launch_counts_only_a_launched_kernel(kind, monkeypatch):
    """The count goes up where the kernel is launched and nowhere else:
    zero bags launch nothing and count nothing, a launch counts one."""
    wrapper, calls = PORT[kind], []
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(sls_ops, "_lib", lambda: SimpleNamespace(
        **{ENTRY[kind]: lambda *args: calls.append(args) or 0}))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device:
                        empty(shape, dtype=dtype))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=0))
    tables = [_FakeCuda(16, 8)] * (1 if kind == "fp" else 3)
    for NB, launched in ((0, 0), (3, 1)):
        out = sls_ops._launch(wrapper, ENTRY[kind], tables, _FakeCuda(NB, 4),
                              _FakeCuda(NB), 8)
        assert out.shape == (NB, 8)
        assert wrapper.launches == len(calls) == launched


def test_wrappers_reject_bad_inputs():
    table = torch.zeros(16, 8)
    q = torch.zeros(16, 8, dtype=torch.uint8)
    s = torch.ones(16, dtype=torch.float16)
    idx = torch.zeros(4, 3, dtype=torch.int32)
    lens = torch.ones(4, dtype=torch.int32)
    bad = [
        lambda: sls(table.half(), idx, lens),                   # fp16 table
        lambda: sls(table, idx.long(), lens),                   # int64 idx
        lambda: sls(table, idx, lens[:3]),                      # (NB,) lens
        lambda: sls(table, idx[0], lens),                       # 1-D idx
        lambda: sls(table[:, :0], idx, lens),                   # D = 0
        lambda: sls(table[:0], idx, lens),                      # R = 0
        lambda: sls_int8(q[:0], s[:0], s[:0], idx, lens),       # R = 0
        lambda: sls_int8(q.to(torch.int8), s, s, idx, lens),    # int8 table
        lambda: sls_int8(q, s.float(), s, idx, lens),           # f32 scale
        lambda: sls_int4(q, s[:8], s, idx, lens),               # scale (8,)
        lambda: sls(table, idx.to("meta"), lens.to("meta")),    # devices
        lambda: sls(table.to("meta"), idx.to("meta"),           # no kernel
                    lens.to("meta")),
        lambda: sls_int4(q.to("meta"), s.to("meta"), s.to("meta"),
                         idx.to("meta"), lens.to("meta")),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"bad input {i} was accepted")

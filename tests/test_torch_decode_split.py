"""The split plain versions behind the port's redesigned kernels, on the CPU.

Both flash-decode kernels now split S (``csrc/decode_split.cuh``): each block
takes one chunk of a row's keys and the chunks merge in the same launch, so
``decode_attn_split_ref`` computes per chunk and merges as they do. It is held
to the unsplit plain version (2e-3 f32, 2e-2 bf16, the JAX package's
tolerances) at chunk-edge positions, G 1-8, hd 16-128, with and without a
softcap, and to the JAX package's ``flash_decode`` Pallas kernel in interpret
mode on its own cases. ``chunk_plan``, which now knows the bytes of a K/V row,
must cover each row's keys exactly once and keep a block's shared memory
legal at every row width.

The SLS kernel (``csrc/sls.cu``) splits a bag over lane groups and adds the
groups' partial sums in group order; the plain versions with ``groups=``
compute that order and are held to the plain sums and to the JAX oracle
(1e-5 fp32, 1e-4 int8/int4), NaN and empty bags included. ``lane_plan`` must
pick loads the row and the table's address allow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.decode import flash_decode as jax_flash_decode
from repro.kernels.decode_attn.ref import decode_attn_ref as jax_decode_ref
from repro.kernels.sls import ref as jax_sls_ref
from repro_torch.kernels.decode_attn.ops import (CHUNK_MAX, CHUNK_MIN,
                                                 CHUNK_SMEM, SMEM_PAD,
                                                 chunk_plan, int8_chunk_plan)
from repro_torch.kernels.decode_attn.ref import (decode_attn_ref,
                                                 decode_attn_split_ref,
                                                 row_chunks)
from repro_torch.kernels.sls.ops import (MAX_COLUMNS, UNROLLS, bag_groups,
                                         lane_plan)
from repro_torch.kernels.sls.ref import sls_int4_ref, sls_int8_ref, sls_ref

H100_SMS = 132
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
CARD_SMEM = 227 * 1024       # a block's shared memory on the H100


def _qkv(rng, B, H, K, hd, S, dtype):
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dtype) for shape in ((B, H, hd), (B, S, K, hd),
                                        (B, S, K, hd)))
    return q, k, v


# (B, H, K, hd, S, per-row pos, softcap, dtype): pos on, before and after the
# 64-, 128- and 256-key chunk edges, 0, at and past S-1; G from 1 to 8, 12
# and 16; hd from 16 to 256
SPLIT_CASES = [
    (4, 32, 32, 128, 1024, [1023, 600, 31, 0], 0.0, torch.bfloat16),
    (4, 8, 8, 128, 600, [0, 62, 63, 64], 0.0, torch.bfloat16),
    (4, 8, 8, 64, 1024, [127, 128, 1023, 5000], 0.0, torch.float32),
    (2, 32, 8, 128, 700, [699, 191], 30.0, torch.bfloat16),
    (2, 2, 2, 16, 300, [255, 65], 0.0, torch.float32),
    (2, 4, 2, 32, 300, [255, 130], 0.0, torch.bfloat16),
    (2, 6, 2, 64, 300, [255, 195], 30.0, torch.float32),
    (2, 8, 2, 128, 300, [255, 4], 0.0, torch.bfloat16),
    (2, 10, 2, 16, 300, [256, 69], 0.0, torch.bfloat16),
    (2, 12, 2, 32, 300, [257, 134], 30.0, torch.float32),
    (2, 14, 2, 64, 300, [299, 199], 0.0, torch.bfloat16),
    (2, 16, 2, 128, 300, [511, 8], 50.0, torch.float32),
    # hd 256 at G 8, 12 and 16 (gemma-2b: 16 padded heads over one kv head)
    (2, 8, 1, 256, 300, [255, 64], 0.0, torch.bfloat16),
    (2, 24, 2, 256, 300, [127, 299], 30.0, torch.float32),
    (2, 16, 1, 256, 300, [63, 191], 0.0, torch.float32),
    (2, 16, 1, 256, 300, [299, 128], 0.0, torch.bfloat16),
]


@pytest.mark.parametrize(
    "case", SPLIT_CASES,
    ids=lambda c: "B{}_H{}_K{}_hd{}_S{}_{}".format(*c[:5],
                                                 str(c[7]).split(".")[-1]))
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_split_ref_matches_plain(case, chunk):
    B, H, K, hd, S, pos, cap, dt = case
    rng = np.random.default_rng(B * 1000 + H * 10 + hd)
    q, k, v = _qkv(rng, B, H, K, hd, S, dt)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    got = decode_attn_split_ref(q, k, v, pos_t, chunk, softcap=cap)
    want = decode_attn_ref(q, k, v, pos_t, softcap=cap)
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL[dt],
                               atol=TOL[dt])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_split_ref_row_without_keys_is_exactly_zero(dt):
    """A row whose pos is below 0 has no valid key: the kernels' max(l,
    1e-30) gives exactly 0, and so does the split plain version."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 3, 8, 2, 64, 200, dt)
    pos = torch.tensor([-1, 130, -5], dtype=torch.int32)
    for chunk in (64, 128):
        got = decode_attn_split_ref(q, k, v, pos, chunk)
        assert torch.equal(got[0], torch.zeros_like(got[0]))
        assert torch.equal(got[2], torch.zeros_like(got[2]))
        assert torch.equal(decode_attn_ref(q, k, v, pos)[0], got[0])
        assert torch.isfinite(got).all() and got[1].abs().sum() > 0


# the JAX package's flash_decode cases (repro/kernels/decode_attn/ops.py):
# (B, H, K, hd, S, pos_frac, softcap)
JAX_DECODE_CASES = [(2, 8, 8, 64, 256, 0.5, 0.0), (2, 8, 2, 64, 256, 0.9, 0.0),
                    (1, 8, 1, 128, 512, 0.3, 0.0), (4, 4, 4, 32, 64, 0.0, 0.0),
                    (2, 8, 4, 64, 256, 0.7, 50.0),
                    (2, 16, 1, 256, 256, 0.6, 0.0),     # hd 256, G 16
                    (1, 12, 1, 256, 256, 0.9, 30.0)]    # G 12


@pytest.mark.parametrize(
    "case", JAX_DECODE_CASES,
    ids=lambda c: "B{}_H{}_K{}_hd{}_S{}_p{}_cap{}".format(*c))
def test_split_ref_matches_jax_flash_decode(case):
    """The JAX kernel's scalar pos is the case of every row's pos equal; its
    Pallas kernel runs in interpret mode with 64-row blocks, as the JAX
    package's own cases run it."""
    B, H, K, hd, S, frac, cap = case
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, H, hd), (B, S, K, hd), (B, S, K, hd))]
    pos = int(S * frac)
    jargs = [jnp.asarray(a) for a in arrays]
    wants = [np.asarray(jax_flash_decode(*jargs, jnp.int32(pos), bs=64,
                                         softcap=cap, interpret=True)),
             np.asarray(jax_decode_ref(*jargs, jnp.int32(pos), softcap=cap))]
    t = [torch.from_numpy(a) for a in arrays]
    pos_t = torch.full((B,), pos, dtype=torch.int32)
    for chunk in (64, chunk_plan(B, K, S, H100_SMS, hd, 4, H // K)):
        got = decode_attn_split_ref(*t, pos_t, chunk, softcap=cap).numpy()
        for want in wants:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


# K/V row bytes: int8 (1 byte an element), bf16 (2) and f32 (4) at hd 16-128
ROW_BYTES = sorted({e * hd for e in (1, 2, 4) for hd in (16, 32, 64, 128)})
PLAN_SHAPES = [(4, 32, 1024), (1, 1, 64), (64, 32, 4096), (3, 2, 300),
               (8, 32, 32768), (1, 8, 1 << 20), (16, 8, 2048)]


@pytest.mark.parametrize("row_bytes", ROW_BYTES)
def test_chunk_plan_covers_each_row_once(row_bytes):
    # every (head_dim, element size) of these row bytes plans alike at G 1
    widths = [(hd, e) for e in (1, 2, 4) for hd in (16, 32, 64, 128)
              if hd * e == row_bytes]
    for B, K, S in PLAN_SHAPES:
        plans = {chunk_plan(B, K, S, H100_SMS, hd, e, 1) for hd, e in widths}
        assert len(plans) == 1
        chunk = plans.pop()
        assert CHUNK_MIN <= chunk <= CHUNK_MAX and chunk % CHUNK_MIN == 0
        # the K/V rows of a chunk, q and the 4 warps' states of 8 query
        # heads at hd 128 fit a block
        assert 2 * chunk * (row_bytes + SMEM_PAD) <= CHUNK_SMEM
        assert 2 * chunk * (row_bytes + SMEM_PAD) \
            + 4 * (8 * 128 + 4 * 8 * 130) <= CARD_SMEM
        for p in (0, chunk - 1, chunk, chunk + 1, S - 1, S + 3, S // 3):
            chunks = row_chunks(p, S, chunk)
            last = min(p, S - 1)
            assert chunks[0][0] == 0 and chunks[-1][1] == last + 1
            assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
            assert all(0 < b - a <= chunk for a, b in chunks)
            assert len(chunks) == last // chunk + 1 <= -(-S // chunk)


def test_chunk_plan_by_row_width():
    # the main decode shape: int8 keeps 64-key chunks, bf16 and f32 rows
    # (256 and 512 bytes at hd 128) take 128 (f32 stops there: 256 keys
    # would not fit the shared memory)
    assert chunk_plan(4, 32, 1024, H100_SMS, 128, 1, 1) == 64
    assert chunk_plan(4, 32, 1024, H100_SMS, 128, 2, 1) == 128
    assert chunk_plan(4, 32, 1024, H100_SMS, 128, 4, 1) == 128
    assert chunk_plan(64, 32, 4096, H100_SMS, 128, 4, 1) == 128
    assert chunk_plan(64, 32, 4096, H100_SMS, 128, 2, 1) == 256
    for B, K, S in PLAN_SHAPES:      # the int8 kernel's plan is unchanged
        assert int8_chunk_plan(B, K, S, H100_SMS, 128, 1) \
            == chunk_plan(B, K, S, H100_SMS, 128, 1, 1)
        assert chunk_plan(B, K, S, H100_SMS, 64, 1, 1) \
            == chunk_plan(B, K, S, H100_SMS, 16, 1, 1)


# ---- SLS ----------------------------------------------------------------

SLS_PLAIN = {"fp": sls_ref, "int8": sls_int8_ref, "int4": sls_int4_ref}
SLS_JAX = {"fp": jax_sls_ref.sls_ref, "int8": jax_sls_ref.sls_int8_ref,
           "int4": jax_sls_ref.sls_int4_ref}
SLS_TOL = {"fp": 1e-5, "int8": 1e-4, "int4": 1e-4}


def _sls_inputs(rng, kind, R, D, NB, L):
    if kind == "fp":
        tables = (rng.standard_normal((R, D)).astype(np.float32),)
    else:
        cols = D if kind == "int8" else D // 2
        tables = (rng.integers(0, 256, (R, cols)).astype(np.uint8),
                  (rng.uniform(0, 1, R) * 0.1 + 0.01).astype(np.float16),
                  (rng.standard_normal(R) * 0.1).astype(np.float16))
    idx = rng.integers(0, R, (NB, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, NB).astype(np.int32)
    lens[0] = 0                               # an empty bag
    idx[1, 0], lens[1] = R, max(lens[1], 1)   # a lookup past the table: NaN
    idx[2, L - 1], lens[2] = -1, L            # and one before it
    lens[3] = L + 5                           # a length past L
    idx[4, 1:] = R + 7                        # unread indices, past the table
    lens[4] = 1
    return tables, idx, lens


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
@pytest.mark.parametrize("groups", [2, 3, 5, 10, 32])
@pytest.mark.parametrize("L", [1, 7, 40, 300])
def test_sls_grouped_sum_matches_plain_and_jax(kind, groups, L):
    rng = np.random.default_rng(groups * 100 + L)
    tables, idx, lens = _sls_inputs(rng, kind, 500, 16, 24, L)
    t = [torch.from_numpy(a) for a in (*tables, idx, lens)]
    got = SLS_PLAIN[kind](*t, groups=groups).numpy()
    plain = SLS_PLAIN[kind](*t).numpy()
    # the oracle reads every entry (an unread one past the table would make
    # its bag NaN there) and wraps a negative index: give it row 0 for the
    # unread entries and a row past the table for the -1
    oracle_idx = idx.copy()
    oracle_idx[4, 1:] = 0
    oracle_idx[2, L - 1] = 500
    want = np.asarray(SLS_JAX[kind](*(jnp.asarray(a) for a in
                                      (*tables, oracle_idx, lens))))
    assert np.array_equal(got[0], np.zeros_like(got[0]))   # exactly 0
    assert np.isnan(got[1]).all() and np.isnan(got[2]).all()
    assert not np.isnan(got[4]).any()
    for other in (plain, want):
        np.testing.assert_allclose(got, other, rtol=SLS_TOL[kind],
                                   atol=SLS_TOL[kind])
    if L == 1:          # one lookup a bag: every grouping is the plain sum
        assert np.array_equal(got, plain, equal_nan=True)


# (row bytes, element bytes, columns a byte, bytes the table's start lies
# past a 16-byte boundary): fp32, int8 and int4 rows at several widths, most
# not a multiple of 16 bytes (an fp32 table starts on a 4-byte boundary)
LANE_CASES = ([(4 * d, 4, 0.25, sh) for d in (1, 3, 4, 50, 96, 200, 1024)
               for sh in (0, 4, 8)]
              + [(d, 1, 1.0, sh) for d in (1, 7, 16, 95, 96, 98, 100, 600)
                 for sh in (0, 1, 2, 4, 8)]
              + [(d // 2, 1, 2.0, sh) for d in (2, 18, 36, 96, 200)
                 for sh in (0, 1, 2, 4, 8)])


@pytest.mark.parametrize("row_bytes,elem,cpb,shift", LANE_CASES)
def test_lane_plan_loads_what_the_row_allows(row_bytes, elem, cpb, shift):
    address = 1024 + shift
    vec, groups, unroll = lane_plan(row_bytes, elem, address, cpb)
    assert vec in (16, 8, 4, 2, 1) and vec >= elem
    assert row_bytes % vec == 0 and address % vec == 0
    assert vec * cpb <= MAX_COLUMNS
    assert groups == bag_groups(row_bytes, vec)
    lanes = row_bytes // vec
    assert groups == (32 // lanes if lanes <= 32 else 1)
    assert groups * min(lanes, 32) <= 32 and unroll in UNROLLS
    # nothing wider would have done
    for wider in (16, 8, 4, 2):
        if wider > vec and wider * cpb <= MAX_COLUMNS:
            assert row_bytes % wider or address % wider


def test_lane_plan_at_the_dlrm_width():
    # D = 96 on 16-byte aligned tables: fp32 24 lanes a row, 8 rows in
    # flight; int8 5 groups of 6 lanes; int4 at 8 bytes, 5 groups of 6
    assert lane_plan(384, 4, 0, 0.25) == (16, 1, 8)
    assert lane_plan(96, 1, 0, 1.0) == (16, 5, 2)
    assert lane_plan(48, 1, 0, 2.0) == (8, 5, 2)

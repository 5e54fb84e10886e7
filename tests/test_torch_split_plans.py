"""The launch plans of the port's decode-step kernels and their split plain
versions, on the CPU.

The w8a8 decode-rows kernel cuts K into slices whose int32 partial sums are
added across a cluster (``csrc/w8a8.cu``); the int8-KV decode kernel cuts
each row's keys into chunks whose (acc, m, l) are merged by the last block
(``csrc/decode_int8.cu``). The wrapper-side plans that choose the cut
(``splitk_plan``, ``int8_chunk_plan``) and the geometry of the cut
(``k_slices``, ``row_chunks``) are held here to cover K and each row's
[0, pos] exactly once. The split plain versions (``w8a8_split_ref``,
``decode_attn_int8_split_ref``) compute the partials and the merge as the
kernels do: the w8a8 one must equal the unsplit plain version bit for bit
(integer sums), the decode one within 1e-6 in f32 (the merge reorders f32
sums). Both are held against the JAX package's Pallas kernels in interpret
mode and its oracles, at the JAX package's tolerances (bit for bit for
w8a8, 2e-3 for f32 decode).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attn_int8 as jax_decode_int8
from repro.kernels.decode_attn.ref import \
    decode_attn_int8_ref as jax_decode_int8_ref
from repro.kernels.w8a8.ops import w8a8 as jax_w8a8
from repro.kernels.w8a8.ref import w8a8_ref as jax_w8a8_ref
from repro_torch.kernels.decode_attn.ops import (INT8_CHUNK_MAX,
                                                 INT8_CHUNK_MIN,
                                                 int8_chunk_plan)
from repro_torch.kernels.decode_attn.ref import (decode_attn_int8_ref,
                                                 decode_attn_int8_split_ref,
                                                 row_chunks)
from repro_torch.kernels.w8a8.ops import SPLITK_MAX, splitk_plan
from repro_torch.kernels.w8a8.ref import k_slices, w8a8_ref, w8a8_split_ref

H100_SMS = 132
# (K, N) of deepseek-7b's seven projections (wq/wk/wv/wo; w_gate/w_up;
# w_down), of the reduced configs (d_model 64, d_ff 128; the head_dim-128
# check config: d_model 256, d_ff 512) and ragged ones (K % 16 == 0 is the
# split-K route's condition)
W8A8_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (64, 192),
               (64, 128), (128, 64), (256, 256), (256, 1024), (512, 256),
               (4112, 4104), (16, 1), (48, 3), (11024, 70), (2752, 4096)]


def _covers_once(ranges, lo, hi):
    """Contiguous, ordered, non-overlapping and exactly [lo, hi)."""
    assert ranges[0][0] == lo and ranges[-1][1] == hi
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("K,N", W8A8_SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 8, 1000])
def test_splitk_plan_slices_cover_k_once(K, N, sms):
    split = splitk_plan(N, K, sms)
    assert 1 <= split <= SPLITK_MAX
    for s in sorted({split, 1, 2, 3, 5, SPLITK_MAX}):
        slices = k_slices(K, s)
        assert len(slices) == s
        _covers_once(slices, 0, K)
        # 16-byte cuts (the bulk of a slice is 16-byte loads), and no slice
        # more than 16 bytes longer than another
        assert all(a % 16 == 0 and b % 16 == 0 for a, b in slices)
        lens = [b - a for a, b in slices]
        assert max(lens) - min(lens) <= 16


def test_splitk_plan_at_the_main_and_reduced_shapes():
    # one block of 4 warps per SM: ceil(N/64) weight tiles times the split
    assert splitk_plan(4096, 4096, H100_SMS) == 2
    assert splitk_plan(11008, 4096, H100_SMS) == 1
    assert splitk_plan(4096, 11008, H100_SMS) == 2
    for K, N in [(64, 192), (64, 128), (128, 64)]:      # reduced configs
        assert splitk_plan(N, K, H100_SMS) == 1
    assert splitk_plan(64, 1 << 20, H100_SMS) == SPLITK_MAX   # capped at 8
    for K, N in W8A8_SHAPES:
        split = splitk_plan(N, K, H100_SMS)
        assert -(-N // 64) * split <= max(H100_SMS, -(-N // 64))
        assert split == 1 or K // split >= 1024


ROW_CASES = [(1024, [1023, 600, 31, 0]), (1024, [63, 64, 65, 127]),
             (1024, [128, 255, 256, 1024]), (300, [0, 299, 5000, -1]),
             (64, [63, 0, 10, 1]), (4096, [4095, 2047, 2048, 1])]


@pytest.mark.parametrize("S,pos", ROW_CASES)
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_int8_row_chunks_cover_each_row_once(S, pos, chunk):
    for p in pos:
        last = min(p, S - 1)
        chunks = row_chunks(p, S, chunk)
        if last < 0:
            assert chunks == []
            continue
        _covers_once(chunks, 0, last + 1)
        # the kernel's blocks: chunk c starts at c*chunk, and a row reads
        # last // chunk + 1 of them (the others exit at once)
        assert [a for a, _ in chunks] == [c * chunk
                                          for c in range(len(chunks))]
        assert len(chunks) == last // chunk + 1 <= -(-S // chunk)
        assert all(0 < b - a <= chunk for a, b in chunks)


def test_int8_chunk_plan():
    # the main shape: 4 rows, 32 kv heads, S 1024 -> 64 keys a block
    assert int8_chunk_plan(4, 32, 1024, H100_SMS) == 64
    for B, K, S in [(4, 32, 1024), (1, 1, 64), (64, 32, 4096), (3, 2, 300),
                    (8, 32, 32768), (1, 8, 1 << 20)]:
        chunk = int8_chunk_plan(B, K, S, H100_SMS)
        assert INT8_CHUNK_MIN <= chunk <= INT8_CHUNK_MAX and chunk % 64 == 0
        # at most 16 blocks per SM unless the largest chunk is reached
        assert chunk == INT8_CHUNK_MAX \
            or B * K * -(-S // chunk) <= 16 * H100_SMS
    assert int8_chunk_plan(64, 32, 4096, H100_SMS) == 256


# ---- the split plain versions ---------------------------------------------

def _w8a8_inputs(M, K, N, row_scale, seed=0):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = np.asarray(rng.uniform(0.001, 0.05, M) if row_scale else 0.02,
                    np.float32)
    ws = rng.uniform(0.001, 0.02, N).astype(np.float32)
    return xq, wq, xs, ws


@pytest.mark.parametrize("M,K,N", [(1, 4096, 64), (4, 256, 100), (8, 272, 64),
                                   (16, 4112, 40), (13, 64, 192), (4, 128, 64),
                                   (2, 2752, 33)])
def test_w8a8_split_ref_bitwise_equals_plain(M, K, N):
    """Every split of K (the kernel's slices, ragged where K/16 does not
    divide) gives the unsplit plain version's bits."""
    t = [torch.from_numpy(a) for a in _w8a8_inputs(M, K, N, True)]
    want = w8a8_ref(*t)
    for split in range(1, SPLITK_MAX + 1):
        assert torch.equal(w8a8_split_ref(*t, split), want)


def test_w8a8_split_ref_exact_past_f32_integers():
    """int8 extremes at K = 11008, split 3: the slices' partial sums add up
    past 2^24 exactly."""
    K = 11008
    xq = torch.full((2, K), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    wq = torch.full((K, 3), 127, dtype=torch.int8)
    wq[K - 1, 1] = 1
    got = w8a8_split_ref(xq, wq, torch.ones(2), torch.ones(3), 3)
    assert torch.equal(got, (xq.long() @ wq.long()).float())


# the JAX package's w8a8 cases (repro/kernels/w8a8/ops.py) and decode-row
# shapes: (M, K, N, per-row x scale)
JAX_W8A8_CASES = [(128, 128, 128, False), (256, 512, 128, False),
                  (128, 256, 384, False), (512, 128, 256, False),
                  (96, 192, 320, False), (48, 160, 288, True),
                  (128, 128, 128, True), (4, 256, 128, True),
                  (16, 128, 256, True)]


@pytest.mark.parametrize("case", JAX_W8A8_CASES,
                         ids=lambda c: "{}x{}x{}_row{}".format(*c))
def test_w8a8_split_ref_bitwise_vs_jax(case):
    xq, wq, xs, ws = _w8a8_inputs(*case, seed=2)
    jargs = [jnp.asarray(a) for a in (xq, wq, xs, ws)]
    want = np.asarray(jax_w8a8_ref(*jargs))
    t = [torch.from_numpy(a) for a in (xq, wq, xs, ws)]
    split = splitk_plan(case[2], case[1], H100_SMS)
    for s in sorted({split, 3}):
        assert np.array_equal(w8a8_split_ref(*t, s).numpy(), want)
    if case[0] <= 16 or case == (48, 160, 288, True):
        # the Pallas kernel itself, in interpret mode, on the decode rows
        # and the JAX package's padded per-row case
        got = np.asarray(jax_w8a8(*jargs, interpret=True))
        assert np.array_equal(w8a8_split_ref(*t, 3).numpy(), got)


def _int8_cache(rng, shape):
    kq = rng.integers(-127, 128, shape).astype(np.int8)
    vq = rng.integers(-127, 128, shape).astype(np.int8)
    ks = (rng.uniform(0, 1, shape[:3]) * 0.02 + 0.001).astype(np.float16)
    vs = (rng.uniform(0, 1, shape[:3]) * 0.02 + 0.001).astype(np.float16)
    return kq, ks, vq, vs


# (B, H, K, hd, S, per-row pos, softcap): chunk boundaries at 64 / 128, pos
# 0, pos >= S-1, G from 1 to 8, hd from 16 to 128
DECODE_SPLIT_CASES = [
    (4, 32, 32, 128, 1024, [1023, 600, 31, 0], 0.0),
    (3, 8, 8, 64, 300, [63, 64, 299], 0.0),
    (2, 8, 2, 32, 256, [127, 128], 30.0),
    (2, 8, 1, 16, 200, [0, 5000], 0.0),
    (2, 6, 2, 128, 257, [256, 191], 50.0),
    (1, 5, 5, 64, 64, [63], 0.0),
    (3, 16, 2, 16, 130, [65, 129, 2], 0.0),
]


@pytest.mark.parametrize("case", DECODE_SPLIT_CASES,
                         ids=lambda c: "B{}_H{}_K{}_hd{}_S{}".format(*c[:5]))
def test_decode_int8_split_ref_matches_plain(case):
    B, H, K, hd, S, pos, cap = case
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    cache = [torch.from_numpy(a) for a in _int8_cache(rng, (B, S, K, hd))]
    pos_t = torch.tensor(pos, dtype=torch.int32)
    want = decode_attn_int8_ref(q, *cache, pos_t, softcap=cap)
    for chunk in (64, 128, 256):
        got = decode_attn_int8_split_ref(q, *cache, pos_t, chunk, softcap=cap)
        assert got.dtype == torch.float32 and got.shape == (B, H, hd)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


# the JAX package's int8 decode cases (repro/kernels/decode_attn/ops.py)
# plus a softcap case: (B, H, K, hd, S, pos_frac, softcap)
JAX_DECODE_INT8_CASES = [(2, 8, 8, 64, 256, 0.5, 0.0),
                         (2, 8, 2, 64, 256, 0.9, 0.0),
                         (1, 8, 1, 128, 512, 0.3, 0.0),
                         (2, 8, 4, 64, 256, 0.7, 50.0)]


@pytest.mark.parametrize(
    "case", JAX_DECODE_INT8_CASES,
    ids=lambda c: "B{}_H{}_K{}_hd{}_S{}_p{}_cap{}".format(*c))
def test_decode_int8_split_ref_matches_jax(case):
    B, H, K, hd, S, frac, cap = case
    rng = np.random.default_rng(6)
    qn = rng.standard_normal((B, H, hd)).astype(np.float32)
    cache = _int8_cache(rng, (B, S, K, hd))
    pos = int(S * frac)
    jargs = [jnp.asarray(a) for a in (qn, *cache)]
    want = [np.asarray(jax_decode_int8_ref(*jargs, jnp.int32(pos),
                                           softcap=cap))]
    if not cap:     # the TPU kernel's registered cases have no softcap
        want.append(np.asarray(jax_decode_int8(*jargs, jnp.int32(pos), bs=64,
                                               interpret=True)))
    t = [torch.from_numpy(a) for a in (qn, *cache)]
    pos_t = torch.full((B,), pos, dtype=torch.int32)
    for chunk in (64, int8_chunk_plan(B, K, S, H100_SMS)):
        got = decode_attn_int8_split_ref(*t, pos_t, chunk, softcap=cap).numpy()
        for w in want:
            np.testing.assert_allclose(got, w, rtol=2e-3, atol=2e-3)

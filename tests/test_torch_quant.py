"""The port's w8a8 and int8-KV path against the JAX package's, on the CPU.

The same numpy-made inputs go through both packages. Tolerances:
quantizers, the w8a8 GEMM and the build step's quantized leaves are
integer paths and must agree bit for bit; float attention and hidden
states use the JAX package's 2e-3 for f32 (``kernels/decode_attn/ops.py``);
engine tokens are held with ``token_agreement`` >= 0.95. On the CPU the
port's wrappers run their kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core import quantization as jq
from repro.kernels.decode_attn.ops import decode_attn_int8 as jax_decode_int8
from repro.kernels.decode_attn.ref import \
    decode_attn_int8_ref as jax_decode_int8_ref
from repro.kernels.w8a8.ops import w8a8 as jax_w8a8
from repro.kernels.w8a8.ref import w8a8_ref as jax_w8a8_ref
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models import quantize as jax_quantize
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import quantization as q
from repro_torch.kernels.decode_attn.ops import decode_attn_int8
from repro_torch.kernels.w8a8.ops import kernel_layout, w8a8_matmul
from repro_torch.kernels.w8a8.ref import w8a8_ref
from repro_torch.models import attention as attn
from repro_torch.models import model as model_mod
from repro_torch.models import quantize as quantize_mod

TOL = 2e-3
B, S, MAX_LEN = 3, 16, 32
LENS = np.array([16, 9, 1])            # right-padded prefill rows


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


# ---- quantizers ---------------------------------------------------------

def _with_ties(rng, shape):
    """Random values plus entries that sit exactly on .5 rounding ties:
    column/row absmax 127 gives a scale of exactly 1.0."""
    a = rng.standard_normal(shape).astype(np.float32)
    a[0, :4] = [127.0, 0.5, -2.5, 1.5]
    a[1:5, 0] = [2.5, -0.5, 3.5, -1.5]
    return a


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_and_activation_quantizers_bitwise(dtype):
    rng = np.random.default_rng(0)
    a = _with_ties(rng, (24, 40))
    a[:, 0] = np.where(np.arange(24) == 0, 127.0, a[:, 0])   # tie column
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ja, ta = jnp.asarray(a, jd), torch.from_numpy(a).to(td)
    for jfn, tfn in ((jq.quantize_weight_int8, q.quantize_weight_int8),
                     (jq.quantize_act_int8_rowwise,
                      q.quantize_act_int8_rowwise)):
        jv, js = jfn(ja)
        tv, ts = tfn(ta)
        assert tv.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert np.array_equal(ts.numpy(), np.asarray(js))
    # round half to even on both sides: the tie row/column
    tv, _ = q.quantize_act_int8_rowwise(torch.from_numpy(a[:1]))
    assert tv[0, :4].tolist() == [127, 0, -2, 2]
    tv, _ = q.quantize_weight_int8(torch.from_numpy(a[:5, :1]))
    assert tv[:, 0].tolist() == [127, 2, -0, 4, -2]


# ---- w8a8 GEMM ------------------------------------------------------------

# the cases of repro/kernels/w8a8/ops.py: (M, K, N, per-row x scale)
W8A8_CASES = [(128, 128, 128, False), (256, 512, 128, False),
              (128, 256, 384, False), (512, 128, 256, False),
              (96, 192, 320, False), (48, 160, 288, True),
              (128, 128, 128, True)]


def _w8a8_inputs(M, K, N, row_scale, seed=0):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = np.asarray(rng.uniform(0.001, 0.05, M) if row_scale else 0.02,
                    np.float32)
    ws = rng.uniform(0.001, 0.02, N).astype(np.float32)
    return xq, wq, xs, ws


@pytest.mark.parametrize("case", W8A8_CASES,
                         ids=lambda c: "{}x{}x{}_row{}".format(*c))
def test_w8a8_plain_bitwise_vs_jax(case):
    xq, wq, xs, ws = _w8a8_inputs(*case)
    want = np.asarray(jax_w8a8_ref(jnp.asarray(xq), jnp.asarray(wq),
                                   jnp.asarray(xs), jnp.asarray(ws)))
    t = [torch.from_numpy(a) for a in (xq, wq, xs, ws)]
    got = w8a8_matmul(*t)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # the kernel's column-major weight layout holds the same function
    assert torch.equal(w8a8_matmul(t[0], kernel_layout(t[1]), t[2], t[3]),
                       got)
    assert torch.equal(w8a8_ref(*t), got)


@pytest.mark.parametrize("case", [W8A8_CASES[4], W8A8_CASES[5]],
                         ids=["96x192x320_padded", "48x160x288_rowscale"])
def test_w8a8_plain_bitwise_vs_jax_kernel_interpret(case):
    xq, wq, xs, ws = _w8a8_inputs(*case, seed=1)
    want = np.asarray(jax_w8a8(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(xs), jnp.asarray(ws),
                               interpret=True))
    got = w8a8_matmul(*[torch.from_numpy(a) for a in (xq, wq, xs, ws)])
    assert np.array_equal(got.numpy(), want)


def test_w8a8_plain_exact_past_f32_integers():
    """K = 11008 of full-width int8 extremes: the sum (~1.8e8) is past
    2^24, where an f32 sum would round; the plain version stays exact."""
    K = 11008
    xq = torch.full((2, K), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    wq = torch.full((K, 3), 127, dtype=torch.int8)
    wq[K - 1, 1] = 1
    got = w8a8_matmul(xq, wq, torch.ones(2), torch.ones(3))
    want = (xq.long() @ wq.long()).float()
    assert torch.equal(got, want)
    assert got[0, 0].item() == float(127 * 127 * K)


def test_dense_w8a8_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    jv, js = jq.quantize_weight_int8(jnp.asarray(w))
    want = jq.dense_w8a8(jnp.asarray(x), {"q8": jv, "scale": js})
    leaf = q.QuantDense(*q.quantize_weight_int8(torch.from_numpy(w)))
    assert leaf.q8.shape == (24, 40) and leaf.q8.t().is_contiguous()
    got = q.dense_w8a8(torch.from_numpy(x), leaf)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---- int8-KV decode ---------------------------------------------------------

# the cases of repro/kernels/decode_attn/ops.py's int8 registration, plus a
# softcap case: (B, H, K, hd, S, pos_frac, softcap)
DECODE_INT8_CASES = [(2, 8, 8, 64, 256, 0.5, 0.0),
                     (2, 8, 2, 64, 256, 0.9, 0.0),
                     (1, 8, 1, 128, 512, 0.3, 0.0),
                     (2, 8, 4, 64, 256, 0.7, 50.0)]


def _int8_cache(rng, shape):
    kq = rng.integers(-127, 128, shape).astype(np.int8)
    vq = rng.integers(-127, 128, shape).astype(np.int8)
    ks = (rng.uniform(0, 1, shape[:3]) * 0.02 + 0.001).astype(np.float16)
    vs = (rng.uniform(0, 1, shape[:3]) * 0.02 + 0.001).astype(np.float16)
    return kq, ks, vq, vs


@pytest.mark.parametrize(
    "case", DECODE_INT8_CASES,
    ids=lambda c: "B{}_H{}_K{}_hd{}_S{}_p{}_cap{}".format(*c))
def test_decode_int8_plain_matches_jax(case):
    B_, H, K, hd, S_, frac, cap = case
    rng = np.random.default_rng(2)
    qn = rng.standard_normal((B_, H, hd)).astype(np.float32)
    cache = _int8_cache(rng, (B_, S_, K, hd))
    pos = int(S_ * frac)
    got = decode_attn_int8(torch.from_numpy(qn),
                           *[torch.from_numpy(a) for a in cache], pos,
                           softcap=cap)
    assert got.dtype == torch.float32 and got.shape == (B_, H, hd)
    jargs = [jnp.asarray(a) for a in (qn, *cache)]
    if not cap:     # the TPU kernel's registered cases have no softcap
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jax_decode_int8(*jargs, jnp.int32(pos),
                                                    bs=64, interpret=True)),
            rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_decode_int8_ref(*jargs, jnp.int32(pos),
                                                    softcap=cap)),
        rtol=TOL, atol=TOL)


def test_int8_decode_attention_per_row_pos_matches_jax():
    """Per-row positions and an inactive row over an int8 cache: the port's
    decode_attention (the int8 kernel's plain version) against the JAX
    model's jnp decode_attention, on real rows; the written cache entries
    bit for bit, the inactive row untouched."""
    jcfg = _int8_kv(jax_reduce(jax_get_config("deepseek-7b")))
    cfg = _int8_kv(reduce_for_smoke(get_config("deepseek-7b")))
    Bd, Sd = 3, 32
    rng = np.random.default_rng(4)
    jp = jax_attn.init_attention(jcfg, jax.random.PRNGKey(3))
    p = attn.Attention(cfg, torch.Generator(), "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    x = rng.standard_normal((Bd, 1, cfg.d_model)).astype(np.float32)
    names = ("k", "k_scale", "v", "v_scale")
    c0 = dict(zip(names, _int8_cache(
        rng, (Bd, Sd, cfg.num_kv_heads, cfg.head_dim))))
    pos = np.array([17, 0, 31], np.int32)
    active = np.array([True, True, False])
    yj, cj = jax_attn.decode_attention(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in c0.items()},
        jnp.asarray(pos), jcfg, "global", active=jnp.asarray(active))
    cache = {k: torch.from_numpy(v.copy()) for k, v in c0.items()}
    y, cache = attn.decode_attention(p, torch.from_numpy(x), cache,
                                     torch.from_numpy(pos), cfg,
                                     rows=torch.tensor([0, 1]),
                                     kind="global")
    np.testing.assert_allclose(y.numpy()[active], np.asarray(yj)[active],
                               rtol=TOL, atol=TOL)
    for name in names:
        assert np.array_equal(cache[name].numpy(), np.asarray(cj[name])), \
            name
        assert np.array_equal(cache[name][2].numpy(), c0[name][2])


def test_int8_wrappers_reject_bad_inputs_and_devices_without_kernels():
    xq = torch.zeros(4, 32, dtype=torch.int8)
    wq = torch.zeros(32, 8, dtype=torch.int8)
    ws = torch.ones(8)
    with pytest.raises(ValueError):                     # K mismatch
        w8a8_matmul(xq, wq[:16], 1.0, ws)
    with pytest.raises(ValueError):                     # not int8
        w8a8_matmul(xq.float(), wq, 1.0, ws)
    with pytest.raises(ValueError):                     # x_scale (3,)
        w8a8_matmul(xq, wq, torch.ones(3), ws)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        w8a8_matmul(xq.to("meta"), wq.to("meta"), 1.0, ws.to("meta"))
    qd = torch.zeros(2, 4, 16)
    kq = torch.zeros(2, 8, 2, 16, dtype=torch.int8)
    sc = torch.zeros(2, 8, 2, dtype=torch.float16)
    with pytest.raises(ValueError):                     # scales (B,S,K)
        decode_attn_int8(qd, kq, sc[:, :4], kq, sc, 3)
    with pytest.raises(ValueError):                     # fp cache
        decode_attn_int8(qd, kq.float(), sc, kq, sc, 3)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        decode_attn_int8(*[t.to("meta") for t in (qd, kq, sc, kq, sc)],
                         torch.zeros(2, dtype=torch.int32, device="meta"))

"""Mamba2 (SSD, state-space duality) mixer (``repro/models/ssm.py``).
[arXiv:2405.21060]

The sequence form runs the chunked SSD: quadratic within a chunk (the
decay matrix ``exp(segsum)`` between every pair of its positions), linear
across chunks (a Python loop over the chunk count, which the shape fixes,
in place of the reference's ``jax.lax.scan``); decode is one step of the
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = C_t h_t. Every
cast mirrors the reference's: the decay matrix is cast to the activation
type before its product, softplus and the state run in f32.

A layer's per-slot state is a dict of preallocated tensors updated in
place: ``state`` (B, heads, head_dim, d_state) f32, the SSD state after
the row's last token, and ``conv`` (B, d_conv-1, conv_dim), the last
d_conv-1 pre-conv inputs (the causal conv's left context). Neither grows
with the context. Every write keeps a fixed shape and reads no value on
the host, so the serving stages stay capturable as CUDA graphs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (causal_conv_with_carry, dtype_of,
                                       mk_param, tail_at_lengths,
                                       write_rows)

# the profiler spans around an SSM layer's mixer and around its scan
# (``chip_smoke.py`` reads their device time)
SSM_SPAN = "ssm"
SSD_SPAN = "ssd"

GATED_NORM_EPS = 1e-6   # the gated RMSNorm's eps (fixed, not cfg.norm_eps)

State = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    return s, d_in, s.num_heads(cfg.d_model), d_in + 2 * s.d_state


class SSM(nn.Module):
    """The reference's leaves: ``in_proj`` (d, 2 d_in + 2 n + heads),
    ``conv_w`` (d_conv, conv_dim), ``conv_b`` (conv_dim,), ``A_log``,
    ``D`` and ``dt_bias`` (heads,), kept f32 in a bf16 model as the
    reference keeps them, ``norm_scale`` (d_in,) and ``out_proj`` (d_in,
    d). Also holds the dims the mixer reads."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        f32 = torch.float32
        s, d_in, nh, conv_dim = _dims(cfg)
        d = cfg.d_model
        self.d_in, self.nh, self.hd, self.n = d_in, nh, s.head_dim, s.d_state
        self.chunk = s.chunk_size
        self.in_proj = mk_param((d, 2 * d_in + 2 * s.d_state + nh), dt,
                                device, gen)
        self.conv_w = mk_param((s.d_conv, conv_dim), dt, device, gen,
                               scale=0.5)
        self.conv_b = mk_param((conv_dim,), dt, device, init="zeros")
        self.A_log = mk_param((nh,), f32, device, init="zeros")
        self.D = mk_param((nh,), f32, device, init="ones")
        self.dt_bias = mk_param((nh,), f32, device, init="zeros")
        self.norm_scale = mk_param((d_in,), dt, device, init="zeros")
        self.out_proj = mk_param((d_in, d), dt, device, gen)


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> State:
    s, _, nh, conv_dim = _dims(cfg)
    return {"state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                                dtype=dtype_of(cfg.activation_dtype),
                                device=device)}


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L) lower-triangular cumulative sums:
    out[s, t] = sum_{t < u <= s} a[u] (as a difference of cumsums, the
    reference's rounding), -inf above the diagonal."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int):
    """The SSD scan. x (b,l,h,p), already times dt; dtA (b,l,h) the log
    decay; B, C (b,l,n), shared by the heads (one group). Returns y
    (b,l,h,p) and the final state (b,h,p,n) f32."""
    with torch.profiler.record_function(SSD_SPAN):
        b, l, h, p = x.shape
        n = B.shape[-1]
        assert l % chunk == 0, (l, chunk)
        c = l // chunk
        dt = x.dtype
        xr = x.reshape(b, c, chunk, h, p)
        ar = dtA.reshape(b, c, chunk, h).float()
        Br = B.reshape(b, c, chunk, n)
        Cr = C.reshape(b, c, chunk, n)

        a_cs = torch.cumsum(ar, dim=2)                          # (b,c,l,h)
        L = torch.exp(_segsum(ar.transpose(2, 3)))              # (b,c,h,l,s)
        # within each chunk: y[l] = sum_s (C_l . B_s) L[l,s] x_s
        CB = torch.einsum("bcln,bcsn->bcls", Cr, Br)
        y_diag = torch.matmul(CB[:, :, None] * L.to(dt),
                              xr.permute(0, 1, 3, 2, 4))        # (b,c,h,l,p)
        y_diag = y_diag.permute(0, 1, 3, 2, 4)
        # each chunk's end state from its own tokens
        decay = torch.exp(a_cs[:, :, -1:, :] - a_cs)            # (b,c,l,h)
        states = torch.einsum("bclhp,bcln->bchpn",
                              xr * decay.to(dt)[..., None], Br)
        # across chunks: the state entering each chunk
        chunk_decay = torch.exp(a_cs[:, :, -1, :])              # (b,c,h)
        carry = x.new_zeros((b, h, p, n), dtype=torch.float32)
        prev = []
        for i in range(c):
            prev.append(carry)
            carry = carry * chunk_decay[:, i, :, None, None] \
                + states[:, i].float()
        prev = torch.stack(prev, dim=1)                         # (b,c,h,p,n)
        state_decay = torch.exp(a_cs)                           # (b,c,l,h)
        y_off = torch.einsum("bcln,bchpn->bclhp", Cr, prev.to(dt)) \
            * state_decay.to(dt)[..., None]
        return (y_diag + y_off).reshape(b, l, h, p), carry


def _split_proj(p: SSM, zxbcdt: torch.Tensor):
    d_in, conv_dim = p.d_in, p.d_in + 2 * p.n
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _conv_out(p: SSM, xBC: torch.Tensor, dtype: torch.dtype):
    """The conv's output through SiLU (in f32, back in ``dtype``), split
    into x (..., heads, head_dim), B and C (..., n)."""
    xBC = F.silu(xBC.float()).to(dtype)
    d_in, n = p.d_in, p.n
    xs = xBC[..., :d_in].reshape(xBC.shape[:-1] + (p.nh, p.hd))
    return xs, xBC[..., d_in:d_in + n], xBC[..., d_in + n:]


def _dt(p: SSM, dtraw: torch.Tensor) -> torch.Tensor:
    return F.softplus(dtraw.float() + p.dt_bias)


def _mask_pads(dt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """dt = 0 at the tokens ``valid`` (B,S) leaves out: they neither decay
    nor feed the state."""
    return torch.where(valid[..., None], dt, 0.0)


def _gated_out(p: SSM, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y * SiLU(z), the gated RMSNorm (eps 1e-6, ``1 + norm_scale``) in
    f32, then ``out_proj``."""
    y = y * F.silu(z.float()).to(y.dtype)
    y = y.float()
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + GATED_NORM_EPS) * (1.0 + p.norm_scale.float())
    return y.to(p.out_proj.dtype) @ p.out_proj


def _with_D(p: SSM, y: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    return y + xs * p.D[:, None].to(xs.dtype)


def xBC_raw_tail(p: SSM, x: torch.Tensor) -> torch.Tensor:
    """The last d_conv-1 pre-conv inputs of x (B,S,d), recomputed from its
    last tokens (zeros before position 0), for decode to continue from."""
    need = p.conv_w.shape[0] - 1
    _, xBC, _ = _split_proj(p, x[:, -need:] @ p.in_proj)
    return F.pad(xBC, (0, 0, need - xBC.shape[1], 0))


def ssm_forward(p: SSM, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                cache: Optional[State] = None,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d). ``valid`` (B,S) marks the real tokens of a
    right-padded row: the others get dt = 0, so they neither decay nor
    feed the state. A bucket that is a multiple of the chunk size runs in
    chunks of it, any other as one chunk (the reference's choice). With
    ``cache``, batch row j's exit state (the state after its last real
    token, and the pre-conv inputs ending there, or ``xBC_raw_tail``
    without ``valid``) is written into cache row ``rows[j]``; a negative
    ``rows[j]`` marks a padded group row, which repeats row 0's write."""
    with torch.profiler.record_function(SSM_SPAN):
        B, S = x.shape[:2]
        z, xBC_pre, dtraw = _split_proj(p, x @ p.in_proj)
        K = p.conv_w.shape[0]
        xBC, _ = causal_conv_with_carry(
            xBC_pre, p.conv_w, p.conv_b,
            xBC_pre.new_zeros((B, K - 1, xBC_pre.shape[-1])))
        xs, Bm, Cm = _conv_out(p, xBC, xBC_pre.dtype)
        dt = _dt(p, dtraw)                                      # (B,S,nh)
        if valid is not None:
            dt = _mask_pads(dt, valid)
        A = -torch.exp(p.A_log)
        ch = min(p.chunk, S)
        ch = ch if S % ch == 0 else S
        y, final = ssd_chunked(xs * dt[..., None].to(xs.dtype), dt * A, Bm,
                               Cm, ch)
        out = _gated_out(p, _with_D(p, y, xs).reshape(B, S, p.d_in), z)
        if cache is not None:
            tail = xBC_raw_tail(p, x) if valid is None \
                else tail_at_lengths(xBC_pre, valid.sum(-1), K - 1)
            pad = rows < 0
            src = torch.where(pad, 0, torch.arange(B, device=x.device))
            dst = torch.where(pad, rows[0], rows)
            write_rows(cache, {"state": final, "conv": tail}, src, dst)
        return out


def ssm_chunk_step(p: SSM, x: torch.Tensor, cache: State,
                   slots: torch.Tensor, start: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """One prompt chunk per group row against the live state: x (P,C,d)
    for cache rows ``slots`` (P,) at offsets ``start`` (P,), of which the
    first ``lengths[j]`` tokens are real. The entering state and conv tail
    are read at ``slots`` (zeros on a request's first chunk: the row may
    hold a previous occupant's state); the chunk runs as one SSD chunk
    from zero state, and the entering state ``h0`` joins linearly (h_t
    picks up h0 exp(cumsum dtA), the exit state h0 exp(sum dtA)). Tokens
    past ``lengths[j]`` get dt = 0; a padded group row (lengths 0) repeats
    the first real row's write, so it writes nothing of its own (the
    reference scatters it out of bounds). Returns y (P,C,d)."""
    with torch.profiler.record_function(SSM_SPAN):
        P, C = x.shape[:2]
        rows = slots.long()
        first = (start == 0)
        h0 = torch.where(first[:, None, None, None], 0.0,
                         cache["state"][rows])                  # (P,nh,hd,n)
        carry = torch.where(first[:, None, None], 0.0,
                            cache["conv"][rows]).to(cache["conv"].dtype)
        z, xBC_pre, dtraw = _split_proj(p, x @ p.in_proj)
        xBC, _ = causal_conv_with_carry(xBC_pre, p.conv_w, p.conv_b, carry)
        xs, Bm, Cm = _conv_out(p, xBC, xBC_pre.dtype)
        dt = _dt(p, dtraw)
        dt = _mask_pads(dt, torch.arange(C, device=x.device)[None, :]
                        < lengths[:, None])
        dtA = dt * -torch.exp(p.A_log)                          # (P,C,nh)
        y, final = ssd_chunked(xs * dt[..., None].to(xs.dtype), dtA, Bm, Cm,
                               C)
        with torch.profiler.record_function(SSD_SPAN):
            acs = torch.cumsum(dtA, dim=1)                      # (P,C,nh)
            dt_ = Cm.dtype
            y = y + torch.einsum("bln,bhpn->blhp", Cm, h0.to(dt_)) \
                * torch.exp(acs).to(dt_)[..., None]
            final = final + h0 * torch.exp(acs[:, -1])[..., None, None]
        out = _gated_out(p, _with_D(p, y, xs).reshape(P, C, p.d_in), z)
        real = lengths > 0
        j = torch.arange(P, device=x.device)
        src = torch.where(real, j, real.int().argmax())
        K = p.conv_w.shape[0]
        write_rows(cache, {"state": final,
                           "conv": tail_at_lengths(xBC_pre, lengths, K - 1,
                                                   prepend=carry)},
                   src, rows[src])
        return out


def ssm_decode_step(p: SSM, x: torch.Tensor, cache: State,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B,1,d): one step of every row. A row ``active`` (B,) bool leaves
    out (a free or a mid-prefill slot riding the fixed-shape step) keeps
    its state and conv tail as they were. Returns y (B,1,d)."""
    with torch.profiler.record_function(SSM_SPAN):
        B = x.shape[0]
        z, xBC_new, dtraw = _split_proj(p, x @ p.in_proj)
        window = torch.cat([cache["conv"], xBC_new.to(cache["conv"].dtype)],
                           dim=1)                               # (B,K,conv)
        xBC = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
        xs, Bm, Cm = _conv_out(p, xBC, x.dtype)                 # (B,nh,hd)
        dt = _dt(p, dtraw[:, 0])                                # (B,nh)
        with torch.profiler.record_function(SSD_SPAN):
            dA = torch.exp(dt * -torch.exp(p.A_log))
            state = cache["state"] * dA[..., None, None] + torch.einsum(
                "bhp,bn->bhpn", (xs * dt[..., None].to(xs.dtype)).float(),
                Bm.float())
            y = torch.einsum("bhpn,bn->bhp", state.to(Cm.dtype), Cm)
        out = _gated_out(p, _with_D(p, y, xs).reshape(B, 1, p.d_in), z)
        new_state, new_conv = state, window[:, 1:]
        if active is not None:
            new_state = torch.where(active[:, None, None, None], new_state,
                                    cache["state"])
            new_conv = torch.where(active[:, None, None], new_conv,
                                   cache["conv"])
        cache["state"].copy_(new_state)
        cache["conv"].copy_(new_conv)
        return out

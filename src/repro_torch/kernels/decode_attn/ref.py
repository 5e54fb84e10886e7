"""Plain PyTorch versions of flash decode: the same functions as the CUDA
kernels in ``csrc/decode.cu`` (an fp cache) and ``csrc/decode_int8.cu`` (an
int8 cache), in f32 math, and the same computed per chunk and merged as the
kernels' split-S design does (``*_split_ref``). The wrappers run the plain
versions for CPU tensors; ``chip_smoke.py`` holds each kernel against them
on the card."""
from __future__ import annotations

import torch


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """q (B,H,hd); k,v (B,S,K,hd); pos (B,) int (row b attends keys
    [0, pos[b]]) -> (B,H,hd) f32."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * (hd ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(S, device=q.device)[None, :] \
        <= pos.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)   # no valid key -> 0
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, hd)


def decode_attn_int8_ref(q: torch.Tensor, kq: torch.Tensor,
                         k_scale: torch.Tensor, vq: torch.Tensor,
                         v_scale: torch.Tensor, pos: torch.Tensor,
                         softcap: float = 0.0) -> torch.Tensor:
    """The same over an int8 cache: kq, vq (B,S,K,hd) int8, k_scale,
    v_scale (B,S,K) fp16, dequantized in f32, then ``decode_attn_ref``
    (the kernel in ``csrc/decode_int8.cu``)."""
    k = kq.float() * k_scale.float()[..., None]
    v = vq.float() * v_scale.float()[..., None]
    return decode_attn_ref(q, k, v, pos, softcap=softcap)


def row_chunks(pos: int, S: int, chunk: int):
    """The key ranges [j0, j1) that the split-S kernels' blocks read for a
    row at ``pos``: keys [0, min(pos, S-1)] cut at multiples of ``chunk``;
    none for a row with no valid key."""
    last = min(int(pos), S - 1)
    return [(j0, min(j0 + chunk, last + 1))
            for j0 in range(0, last + 1, chunk)]


def decode_attn_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, chunk: int,
                          softcap: float = 0.0) -> torch.Tensor:
    """``decode_attn_ref`` computed as the split-S kernels
    (``csrc/decode_split.cuh``) do: per chunk of ``row_chunks`` a partial
    (acc, m, l) over its keys, then the merge m = max m_i,
    l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / max(l, 1e-30).
    A row of one chunk divides its own acc by max(l, 1e-30); a row with no
    valid key gives 0. f32 math."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    out = torch.zeros(B, K, G, hd, dtype=torch.float32, device=q.device)
    for b in range(B):
        qg = q[b].reshape(K, G, hd).float()
        parts = []
        for j0, j1 in row_chunks(pos[b], S, chunk):
            kc, vc = k[b, j0:j1].float(), v[b, j0:j1].float()
            s = torch.einsum("kgd,jkd->kgj", qg, kc) * (hd ** -0.5)
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((torch.einsum("kgj,jkd->kgd", p, vc), m, p.sum(-1)))
        if not parts:
            continue
        m = torch.stack([m_i for _, m_i, _ in parts]).amax(0)
        acc = sum(a_i * torch.exp(m_i - m)[..., None] for a_i, m_i, _ in parts)
        l = sum(l_i * torch.exp(m_i - m) for _, m_i, l_i in parts)
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, hd)


def decode_attn_int8_split_ref(q: torch.Tensor, kq: torch.Tensor,
                               k_scale: torch.Tensor, vq: torch.Tensor,
                               v_scale: torch.Tensor, pos: torch.Tensor,
                               chunk: int,
                               softcap: float = 0.0) -> torch.Tensor:
    """``decode_attn_int8_ref`` computed as the split-S kernel
    (``csrc/decode_int8.cu``) does: the cache dequantized in f32, then
    ``decode_attn_split_ref``."""
    k = kq.float() * k_scale.float()[..., None]
    v = vq.float() * v_scale.float()[..., None]
    return decode_attn_split_ref(q, k, v, pos, chunk, softcap=softcap)

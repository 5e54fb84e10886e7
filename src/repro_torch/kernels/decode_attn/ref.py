"""Plain PyTorch version of flash decode: the same function as the CUDA
kernel in ``csrc/decode.cu``, in f32 math. The wrapper runs it for CPU
tensors; ``chip_smoke.py`` holds the kernel against it on the card."""
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

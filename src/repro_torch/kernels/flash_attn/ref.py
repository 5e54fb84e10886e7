"""Plain PyTorch version of flash prefill attention: the same function as
the CUDA kernel in ``csrc/flash.cu``, in f32 math with the whole score
matrix materialized. The wrapper runs it for CPU tensors; ``chip_smoke.py``
holds the kernel against it on the card."""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lens: Optional[torch.Tensor] = None,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,hd); k,v (B,T,K,hd); lens (B,) valid key count (default T)
    -> (B,S,H,hd) in q.dtype. A row whose keys are all masked gives 0."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (hd ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    mask = mask.expand(B, S, T)
    if lens is not None:
        mask = mask & (kpos[None] < lens.to(q.device)[:, None, None])
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)   # fully-masked rows -> 0
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)

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
                        softcap: float = 0.0,
                        q_off: Optional[torch.Tensor] = None,
                        kv_rows: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q (B,S,H,hd); k,v (Bk,T,K,hd); lens (B,) valid key count (default
    T) -> (B,S,H,hd) in q.dtype. A row whose keys are all masked gives 0.

    ``q_off`` (B,): query i of row b sits at absolute position
    ``q_off[b] + i`` (default 0), which the causal mask and the window are
    measured from. ``kv_rows`` (B,): row b reads K/V row ``kv_rows[b]``
    (default b, and then Bk == B); a row outside [0, Bk) reads no key and
    gives 0, as in the kernel."""
    B, S, H, hd = q.shape
    if kv_rows is not None:
        rows = kv_rows.to(q.device).long()
        Bk, T = k.shape[:2]
        inside = (rows >= 0) & (rows < Bk)
        k, v = k[rows.clamp(0, Bk - 1)], v[rows.clamp(0, Bk - 1)]
        lens = torch.where(inside, T if lens is None else lens.to(q.device),
                           0)
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (hd ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[None, :, None]
    if q_off is not None:
        qpos = qpos + q_off.to(q.device).long()[:, None, None]
    kpos = torch.arange(T, device=q.device)[None, None, :]
    mask = torch.ones(B, S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    if lens is not None:
        mask &= kpos < lens.to(q.device)[:, None, None]
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)   # fully-masked rows -> 0
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)

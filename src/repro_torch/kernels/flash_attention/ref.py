"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref.attention_ref``, expression for
expression): causal GQA attention with float32 scores and softmax, masked
scores -1e30, the output cast to ``q.dtype``."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0.
    Causal masking is aligned top left: key j is visible to query i iff
    j <= i."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(d)
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)

"""Attention: GQA with a chunked online softmax and a KV cache (port of
``repro.models.attention``).

* ``flash_attention``: on CUDA tensors, the hand-written flash-attention
  kernels (``kernels/flash_attention``; the model's bf16 goes to the
  tensor-core one), whose probabilities keep float32 precision, under
  ``FlashAttentionFn`` for the gradient.  On CPU tensors, the mirror of
  the JAX package's jnp online softmax over KV chunks (its ``lax.scan`` a
  Python loop), with that path's bf16 rounding points: the scores are the
  bf16 product cast to float32, and the probabilities are cast to
  ``q.dtype`` before the P.V product; autograd differentiates it as JAX
  differentiates its jnp path.  On the card the model's attention
  therefore differs from the CPU mirror by bf16 rounding.
* GQA: KV heads are repeated to ``kv_eff`` at projection time,
  interleaved (``h_eff = h * reps + r``); queries are grouped per
  effective KV head.
* decode: single-token attention over a cache laid out
  (batch, kv_eff, max_seq, head_dim); a position mask handles partial fill.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, repeats: int) -> torch.Tensor:
    """(B, H_kv, S, D) -> (B, H_kv*repeats, S, D), interleaved so that head
    h_eff = h_orig*repeats + r."""
    if repeats == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, repeats, s, d).reshape(
        b, h * repeats, s, d)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, q_offset: int = 0,
                   kv_valid_len: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv_eff, Sk, D)."""
    b, hq, sq, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    qg = q.reshape(b, hk, g, sq, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float()
    scores = scores / math.sqrt(d)
    sk = k.shape[2]
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    if kv_valid_len is not None:
        kmask = torch.arange(sk, device=q.device) < kv_valid_len
        scores = torch.where(kmask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return out.reshape(b, hq, sq, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (memory O(Sq·chunk)).

    CUDA tensors go through the flash-attention kernel, whatever ``chunk``
    (``FlashAttentionFn``: the kernel forward, the mirror's gradient);
    CPU tensors through the mirror of the JAX package's jnp path."""
    if q.device.type == "cuda":
        return FlashAttentionFn.apply(q, k, v, causal, chunk)
    return _flash_attention_chunked(q, k, v, causal, chunk)


class FlashAttentionFn(torch.autograd.Function):
    """The flash-attention kernel's forward with the gradient of the plain
    chunked mirror (``_flash_attention_chunked``).

    * Forward: ``kernels/flash_attention`` (bf16 the wgmma kernel, float32
      the split-TF32 one); q, k and v are saved, nothing else.
    * Backward: the mirror re-run from the saved q, k, v under autograd,
      its gradient taken by ``torch.autograd.grad``.  The TPU kernel had
      no backward, so neither has this one; the backward is plain PyTorch.
      Its memory is the mirror's autograd graph of one call: the scores
      and probabilities of every KV chunk, O(Sq·Sk) for the call.

    The forward keeps the probabilities in float32 and rounds the output
    once; the mirror rounds its probabilities to ``q.dtype`` before the
    P.V product.  In bf16 the backward is therefore the gradient of the
    bf16-rounded mirror, not of the kernel's own forward: the two differ
    by that bf16 rounding (in float32 by the kernel's 1e-5 contract).
    A kernel that fails to build or launch raises ``KernelError``; there
    is no fallback to the mirror's forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        return flash_ops.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _flash_attention_chunked(*qkv, ctx.causal, ctx.chunk)
            dq, dk, dv = torch.autograd.grad(out, qkv, grad_out)
        return dq, dk, dv, None, None


def _flash_attention_chunked(q, k, v, causal, chunk):
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    if sk <= chunk or sk % chunk != 0:
        # short or non-tileable KV: the dense path
        return full_attention(q, k, v, causal)
    nchunks = sk // chunk
    qg = q.reshape(b, hk, g, sq, d)
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qpos = torch.arange(sq, device=q.device)[:, None]
    acc = torch.zeros((b, hk, g, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk]
        vb = v[:, :, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb).float() * scale
        if causal:
            kpos = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(b, hq, sq, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len) -> torch.Tensor:
    """q: (B, Hq, 1, D); caches (B, Hkv_eff, S_max, D); ``valid_len`` the
    filled cache length including this step, a scalar or (B,)."""
    b, hq, _, d = q.shape
    hk, smax = k_cache.shape[1], k_cache.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache).float()
    s = s / math.sqrt(d)
    vl = torch.as_tensor(valid_len, device=q.device)
    ar = torch.arange(smax, device=q.device)
    if vl.dim() == 0:
        mask = ar[None, None, None, :] < vl
    else:
        mask = (ar[None, :] < vl[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache)
    return out.reshape(b, hq, 1, d)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, position
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert (B, H, S_new, D) at ``position`` along the seq axis; new
    caches, the inputs untouched.  ``position`` is clamped so the update
    fits, as ``jax.lax.dynamic_update_slice`` clamps it."""
    s_new, smax = k_new.shape[2], k_cache.shape[2]
    pos = min(max(int(position), 0), smax - s_new)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[:, :, pos:pos + s_new] = k_new.to(k_cache.dtype)
    v_cache[:, :, pos:pos + s_new] = v_new.to(v_cache.dtype)
    return k_cache, v_cache

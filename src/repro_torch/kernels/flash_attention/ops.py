"""Flash-attention entry point (port of
``repro.kernels.flash_attention.ops.flash_attention``).

Dispatch is by the tensors' device, as in every wrapper of the port: CPU
tensors take the plain version (``ref.attention_ref``), CUDA tensors launch
a hand-written kernel (by dtype: bf16 the wgmma one, float32 the
split-TF32 one) or raise ``KernelError``.  The JAX package's
``use_pallas``/``interpret`` switches have no counterpart, and neither has
its tiling fallback (ragged ``Sq``/``Sk`` to the oracle): the kernel masks
ragged tiles itself, so every shape on the card goes through it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in ``q.dtype``."""
    return flash_attention_fwd_kernel(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal)

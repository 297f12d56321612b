"""Wrapper of the CUDA ``flash_attention_fwd`` kernel
(``csrc/flash_attention_fwd.cu``): causal GQA attention forward with an
online softmax, float32 inside.

The plain version (``ref.attention_ref``) serves tensors on the CPU;
tensors on the card launch the kernel, with no fallback between the two.
The wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on PyTorch's current stream, raises ``KernelError`` on a
failed build or launch, and counts its launches in
``flash_attention_fwd_kernel.launches``; no output rows, no launch.

Any ``Sq`` and ``Sk`` are taken: the kernel masks the ragged edges of its
tiles itself.  A head dim outside ``HEAD_DIMS`` or ``Hq % Hkv != 0``
raises ``ValueError``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows per CUDA block and keys per shared-memory tile.
BLOCK_Q = 64
BLOCK_K = 64

_P = ctypes.c_void_p
_I = ctypes.c_int


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported, want one of "
                         f"{HEAD_DIMS}")


def flash_attention_fwd_kernel(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True
                               ) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  Returns (B, Hq, Sq, D)
    in ``q.dtype``."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, want one of {list(DTYPES)}")
    check_tensor(q, "q", q.dtype, (b, hq, sq, d), dev)
    check_tensor(k, "k", q.dtype, (b, hk, sk, d), dev)
    check_tensor(v, "v", q.dtype, (b, hk, sk, d), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.entry("flash_attention_fwd",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, hq, hk, sq, sk, d, DTYPES[q.dtype], int(causal),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("flash_attention_fwd", err)
    flash_attention_fwd_kernel.launches += 1
    return out


flash_attention_fwd_kernel.launches = 0


"""Wrapper of the two CUDA flash-attention kernels: causal GQA attention
forward with an online softmax whose probabilities keep float32 precision.

* bf16 tensors launch ``csrc/flash_attention_fwd_wgmma.cu``: both
  products on Hopper's tensor cores (wgmma, TMA-fed K/V stages), P split
  into three bf16 terms for the P.V product.
* float32 tensors launch ``csrc/flash_attention_fwd.cu``: both products
  on Hopper's tensor cores in split TF32 (wgmma; each float32 operand
  split into hi + lo TF32 values, three TF32 products for each float32
  one), K and a transposed V split into hi and lo tiles by a producer
  warpgroup; within its 1e-5 contract.

The choice is by dtype alone, with no fallback from one kernel to the
other.  The plain version (``ref.attention_ref``) serves tensors on the
CPU; tensors on the card launch a kernel or raise.  The wrapper checks
device, dtype, shape, contiguity and (bf16: the TMA's) 16-byte alignment,
allocates the output, launches on PyTorch's current stream, raises
``KernelError`` on a failed build or launch, and counts every launch in
``flash_attention_fwd_kernel.launches`` and the wgmma kernel's alone in
``flash_attention_fwd_kernel.wgmma_launches``; no output rows, no launch.

Any ``Sq`` and ``Sk`` are taken: the kernels mask the ragged edges of their
tiles themselves.  ``HEAD_DIMS`` holds every head dim of the registered
configs (nemotron-4-340b's 192, its REDUCED config's 24); both kernels
take each of them (D = 24 in tiles padded to 32 columns, D = 192 with its
own ring depth and geometry; the ``.cu`` headers say how).  Any other
head dim, or ``Hq % Hkv != 0``, raises ``ValueError``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 24, 32, 64, 128, 192)
# the kernel each dtype launches
KERNEL_OF = {torch.float32: "flash_attention_fwd",
             torch.bfloat16: "flash_attention_fwd_wgmma"}

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
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with D in ``HEAD_DIMS``
    and Hq a multiple of Hkv; ``causal`` masks key j from query i for
    j > i (aligned top left), else every key takes part.  Returns
    (B, Hq, Sq, D) in ``q.dtype``: the plain version on CPU tensors, the
    bf16 or float32 kernel on card tensors."""
    check_shapes(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dev = q.device
    name = KERNEL_OF.get(q.dtype)
    if name is None:
        raise TypeError(f"q has dtype {q.dtype}, want one of "
                        f"{list(KERNEL_OF)}")
    check_tensor(q, "q", q.dtype, (b, hq, sq, d), dev)
    check_tensor(k, "k", q.dtype, (b, hk, sk, d), dev)
    check_tensor(v, "v", q.dtype, (b, hk, sk, d), dev)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    if name == "flash_attention_fwd_wgmma" and any(p % 16 for p in ptrs[:3]):
        raise ValueError("bf16 q, k and v must start at 16-byte aligned "
                         "addresses (the TMA copies them)")
    fn = build.entry(name, [_P] * 4 + [_I] * 7 + [_P])
    err = fn(*ptrs, b, hq, hk, sq, sk, d, int(causal), stream)
    build.check_launch(name, err)
    flash_attention_fwd_kernel.launches += 1
    if name == "flash_attention_fwd_wgmma":
        flash_attention_fwd_kernel.wgmma_launches += 1
    return out


flash_attention_fwd_kernel.launches = 0
flash_attention_fwd_kernel.wgmma_launches = 0

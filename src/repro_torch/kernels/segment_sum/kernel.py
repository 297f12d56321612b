"""Wrapper of the CUDA ``block_segment_sums`` kernel
(``csrc/block_segment_sums.cu``): within-block run totals over sorted keys.

The plain version (``ref.block_segment_sums_ref``) serves tensors on the
CPU; tensors on the card launch the kernel, with no fallback between the
two.  The wrapper checks device, dtype, shape and contiguity, allocates the
output, launches on PyTorch's current stream, raises ``KernelError`` on a
launch error, and counts its launches in
``block_segment_sums_kernel.launches``; no keys, no launch.

Callers pad to a multiple of ``block`` (1 ≤ block ≤ 1024, one warp a
block) and pass non-decreasing keys: the kernel sums each contiguous run
of equal keys, which for sorted keys is every equal key of the block, as
the left fold of the run's values in position order (the same bits on
float values at every block size).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor
from repro_torch.kernels.segment_sum.ref import block_segment_sums_ref

# The JAX package's block length.
DEFAULT_BLOCK = 512
MAX_BLOCK = 1024

_P = ctypes.c_void_p


def block_segment_sums_kernel(keys: torch.Tensor, vals: torch.Tensor, *,
                              block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-position within-block run totals, float32[m]."""
    m = keys.shape[0]
    if not 1 <= block <= MAX_BLOCK or m % block:
        raise ValueError(f"block {block} must lie in [1, {MAX_BLOCK}] and "
                         f"divide the length {m}: the caller pads")
    if keys.device.type == "cpu":
        return block_segment_sums_ref(keys, vals, block)
    dev = keys.device
    check_tensor(keys, "keys", torch.int32, (m,), dev)
    check_tensor(vals, "vals", torch.float32, (m,), dev)
    out = torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0:
        return out
    fn = build.entry("block_segment_sums",
                     [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P])
    err = fn(keys.data_ptr(), vals.data_ptr(), m, block, out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("block_segment_sums", err)
    block_segment_sums_kernel.launches += 1
    return out


block_segment_sums_kernel.launches = 0

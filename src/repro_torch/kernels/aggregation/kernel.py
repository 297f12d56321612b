"""Wrapper of the CUDA ``bin_rank`` kernel (``csrc/bin_rank.cu``).

The plain version (``ref.py``) serves tensors on the CPU; tensors on the
card launch the kernel, with no fallback between the two.  The wrapper
checks device, dtype, shape and contiguity, allocates the output, launches
on PyTorch's current stream, raises ``KernelError`` on a launch error, and
counts its launches in ``bin_rank_kernel.launches``.

Callers guarantee every ``cs`` lies in [0, rows of the table).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.aggregation.ref import bin_rank_ref

_P = ctypes.c_void_p


def bin_rank_kernel(
    keys_flat: torch.Tensor,  # (rows·width,) int32 — bin-key table
    cs: torch.Tensor,         # (R,) int32
    cd: torch.Tensor,         # (R,) int32
    *,
    width: int,
    empty: int,
) -> torch.Tensor:
    """Per-edge bin rank (ref.py contract), int32[R]."""
    if cs.device.type == "cpu":
        return bin_rank_ref(keys_flat, cs, cd, width=width, empty=empty)
    dev, R = cs.device, cs.shape[0]
    if width % 4 or keys_flat.shape[0] % width:
        raise ValueError(f"width {width} must be a multiple of 4 dividing the "
                         f"table length {keys_flat.shape[0]}")
    for t, what, shape in ((keys_flat, "keys_flat", keys_flat.shape),
                           (cs, "cs", (R,)), (cd, "cd", (R,))):
        if t.device != dev or t.dtype != torch.int32 or t.shape != shape \
                or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{what} must be a contiguous 1-D int32 tensor "
                             f"of shape {tuple(shape)} on {dev}")
    if keys_flat.data_ptr() % 16:
        raise ValueError("keys_flat must be 16-byte aligned")
    fn = build.load("bin_rank").bin_rank_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, _P, _P]
        fn.restype = ctypes.c_int
    out = torch.empty(R, dtype=torch.int32, device=dev)
    err = fn(keys_flat.data_ptr(), cs.data_ptr(), cd.data_ptr(), R, width,
             empty, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("bin_rank", err)
    bin_rank_kernel.launches += 1
    return out


bin_rank_kernel.launches = 0

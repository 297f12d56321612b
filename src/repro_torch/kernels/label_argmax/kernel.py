"""Wrapper of the CUDA ``label_argmax`` kernel (``csrc/label_argmax.cu``):
PLP weighted-label-mode scoring over pre-gathered (R, W) tiles.

The plain version (``ref.label_argmax_chunked``) serves tensors on the CPU;
tensors on the card launch the kernel, with no fallback between the two.
The wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on PyTorch's current stream, raises ``KernelError`` on a
launch error, and counts its launches in ``label_argmax_kernel.launches``;
no rows, no launch.

Widths: any W from 1 to ``MAX_WIDTH`` = 4096.  Up to 16 a lane scores a
row, up to 1024 a warp with a hash table in shared memory, above that the
fused kernels' block path, whose row staging (labels and weights, 8·W
bytes, plus the argmax scratch) must fit the 48 KB of static shared
memory a block gets: 4096 is the widest that does.  A wider
tile raises ``ValueError`` before any launch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, noise_scale
from repro_torch.kernels.label_argmax.ref import label_argmax_chunked

MAX_WIDTH = 4096

_P = ctypes.c_void_p


def label_argmax_kernel(
    nbr_lab: torch.Tensor,   # (R, W) int32, ``sentinel`` where padded
    nbr_w: torch.Tensor,     # (R, W) float32, 0 where padded
    cur_lab: torch.Tensor,   # (R,) int32
    rows: torch.Tensor,      # (R,) int32 noise keys (vertex ids)
    seed: int,               # uint32 tie-noise seed
    *,
    tie_eps: float,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_label[R] int32, best_score[R] f32, cur_score[R] f32)."""
    if nbr_lab.device.type == "cpu":
        return label_argmax_chunked(nbr_lab, nbr_w, cur_lab, rows, seed,
                                    tie_eps, sentinel)
    dev = nbr_lab.device
    R, W = nbr_lab.shape
    if not 1 <= W <= MAX_WIDTH:
        raise ValueError(f"tile width {W} is outside [1, {MAX_WIDTH}]: a "
                         f"wider row's staging does not fit a block's "
                         f"static shared memory")
    check_tensor(nbr_lab, "nbr_lab", torch.int32, (R, W), dev)
    check_tensor(nbr_w, "nbr_w", torch.float32, (R, W), dev)
    check_tensor(cur_lab, "cur_lab", torch.int32, (R,), dev)
    check_tensor(rows, "rows", torch.int32, (R,), dev)
    lab = torch.empty(R, dtype=torch.int32, device=dev)
    best = torch.empty(R, dtype=torch.float32, device=dev)
    cur = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return lab, best, cur
    fn = build.entry("label_argmax",
                     [_P, _P, _P, _P, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P,
                      _P, _P])
    err = fn(nbr_lab.data_ptr(), nbr_w.data_ptr(), cur_lab.data_ptr(),
             rows.data_ptr(), int(seed) & 0xFFFFFFFF,
             float(noise_scale(tie_eps)), sentinel, R, W, lab.data_ptr(),
             best.data_ptr(), cur.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("label_argmax", err)
    label_argmax_kernel.launches += 1
    return lab, best, cur


label_argmax_kernel.launches = 0

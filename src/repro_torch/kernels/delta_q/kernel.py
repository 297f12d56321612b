"""Wrapper of the CUDA ``delta_q`` kernel (``csrc/delta_q.cu``): the Louvain
Eq. 1 ΔQ argmax over pre-gathered (R, W) candidate tiles.

The plain version (``ref.delta_q_chunked``) serves tensors on the CPU;
tensors on the card launch the kernel, with no fallback between the two.
The wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on PyTorch's current stream, raises ``KernelError`` on a
launch error, and counts its launches in ``delta_q_kernel.launches``;
no rows, no launch.

Widths: any W from 1 to ``MAX_WIDTH`` = 2048.  Up to 16 a lane scores a
row, up to 1024 a warp with a hash table in shared memory, above that the
fused kernels' block path, whose row staging (candidates, weights,
volumes and sizes, 16·W bytes, plus the argmax scratch) must fit the 48 KB
of static shared memory a block gets: 2048 is the widest that does.  A wider
tile raises ``ValueError`` before any launch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor
from repro_torch.kernels.delta_q.ref import delta_q_chunked

MAX_WIDTH = 2048

_P = ctypes.c_void_p


def delta_q_kernel(
    cand_com: torch.Tensor,   # (R, W) int32 (sentinel where padded)
    nbr_w: torch.Tensor,      # (R, W) float32
    cur_com: torch.Tensor,    # (R,) int32
    deg_v: torch.Tensor,      # (R,) float32
    vol_cand: torch.Tensor,   # (R, W) float32
    vol_cur: torch.Tensor,    # (R,) float32
    size_cand: torch.Tensor,  # (R, W) int32
    size_cur: torch.Tensor,   # (R,) int32
    inv_vol: torch.Tensor,    # float32 0-dim tensor 1 / vol(V), same device
    *,
    sentinel: int,
    singleton_rule: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community[R] int32, best_gain[R] f32)."""
    if cand_com.device.type == "cpu":
        return delta_q_chunked(cand_com, nbr_w, cur_com, deg_v, vol_cand,
                               vol_cur, size_cand, size_cur, inv_vol,
                               sentinel, singleton_rule)
    dev = cand_com.device
    R, W = cand_com.shape
    if not 1 <= W <= MAX_WIDTH:
        raise ValueError(f"tile width {W} is outside [1, {MAX_WIDTH}]: a "
                         f"wider row's staging does not fit a block's "
                         f"static shared memory")
    for t, what, dtype in ((cand_com, "cand_com", torch.int32),
                           (nbr_w, "nbr_w", torch.float32),
                           (vol_cand, "vol_cand", torch.float32),
                           (size_cand, "size_cand", torch.int32)):
        check_tensor(t, what, dtype, (R, W), dev)
    for t, what, dtype in ((cur_com, "cur_com", torch.int32),
                           (deg_v, "deg_v", torch.float32),
                           (vol_cur, "vol_cur", torch.float32),
                           (size_cur, "size_cur", torch.int32)):
        check_tensor(t, what, dtype, (R,), dev)
    check_tensor(inv_vol, "inv_vol", torch.float32, (), dev)
    cand = torch.empty(R, dtype=torch.int32, device=dev)
    gain = torch.empty(R, dtype=torch.float32, device=dev)
    if R == 0:
        return cand, gain
    fn = build.entry("delta_q",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P,
                      _P])
    err = fn(cand_com.data_ptr(), nbr_w.data_ptr(), vol_cand.data_ptr(),
             size_cand.data_ptr(), cur_com.data_ptr(), deg_v.data_ptr(),
             vol_cur.data_ptr(), size_cur.data_ptr(), inv_vol.data_ptr(),
             int(bool(singleton_rule)), sentinel, R, W, cand.data_ptr(),
             gain.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("delta_q", err)
    delta_q_kernel.launches += 1
    return cand, gain


delta_q_kernel.launches = 0

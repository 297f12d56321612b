"""Public entry point of the delta_q family (port of
``repro.kernels.delta_q.ops``): the casts of the JAX package and its
``inv_vol = (1 / vol_total)`` in float32, then ``use_pallas=True`` goes
through the kernel wrapper (a CUDA launch for tensors on the card, the
plain version for tensors on the CPU) and ``use_pallas=False`` runs the
plain version on any device."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.delta_q.kernel import delta_q_kernel
from repro_torch.kernels.delta_q.ref import delta_q_chunked


def delta_q_argmax(
    cand_com: torch.Tensor,
    nbr_w: torch.Tensor,
    cur_com: torch.Tensor,
    deg_v: torch.Tensor,
    vol_cand: torch.Tensor,
    vol_cur: torch.Tensor,
    size_cand: torch.Tensor,
    size_cur: torch.Tensor,
    vol_total,
    *,
    sentinel: int,
    singleton_rule: bool = True,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community, best_gain) per row; gain is Eq. 1 / vol(V)."""
    def i32(t):
        return t.to(torch.int32).contiguous()

    def f32(t):
        return t.to(torch.float32).contiguous()

    vol_total = torch.as_tensor(vol_total, device=cand_com.device)
    inv_vol = (1.0 / vol_total).to(torch.float32)
    args = (i32(cand_com), f32(nbr_w), i32(cur_com), f32(deg_v),
            f32(vol_cand), f32(vol_cur), i32(size_cand), i32(size_cur),
            inv_vol)
    if use_pallas:
        return delta_q_kernel(*args, sentinel=sentinel,
                              singleton_rule=singleton_rule)
    return delta_q_chunked(*args, sentinel, singleton_rule)

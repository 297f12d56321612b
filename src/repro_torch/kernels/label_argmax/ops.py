"""Public entry point of the label_argmax family (port of
``repro.kernels.label_argmax.ops``): the casts of the JAX package, then
``use_pallas=True`` goes through the kernel wrapper (a CUDA launch for
tensors on the card, the plain version for tensors on the CPU) and
``use_pallas=False`` runs the plain version on any device."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.label_argmax.kernel import label_argmax_kernel
from repro_torch.kernels.label_argmax.ref import label_argmax_chunked


def label_argmax(
    nbr_lab: torch.Tensor,
    nbr_w: torch.Tensor,
    cur_lab: torch.Tensor,
    rows: torch.Tensor,
    seed: int,
    *,
    tie_eps: float,
    sentinel: int,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_label, best_score, cur_score) per row; see ref.py for the
    semantics."""
    nbr_lab = nbr_lab.to(torch.int32).contiguous()
    nbr_w = nbr_w.to(torch.float32).contiguous()
    cur_lab = cur_lab.to(torch.int32).contiguous()
    rows = rows.to(torch.int32).contiguous()
    if use_pallas:
        return label_argmax_kernel(nbr_lab, nbr_w, cur_lab, rows, seed,
                                   tie_eps=tie_eps, sentinel=sentinel)
    return label_argmax_chunked(nbr_lab, nbr_w, cur_lab, rows, seed, tie_eps,
                                sentinel)

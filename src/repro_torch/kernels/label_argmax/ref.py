"""Plain PyTorch PLP weighted-label-mode scoring (port of
``repro.kernels.label_argmax.ref``, expression for expression).

Per row r (one vertex, ELL-padded neighbor tile of width W):

  score(c)  = Σ_k w[r,k] · [lab[r,k] == c] + noise(row_id, c)
  best      = argmax over candidate labels present in the row (tie → min)
  cur_score = score(cur_lab[r]) if cur_lab present among neighbors else 0

The pairwise (R, W, W) equality tensor is materialized; callers bound R
(``local_move.ref`` loops over row chunks).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import tie_noise


def label_argmax_ref(
    nbr_lab: torch.Tensor,   # (R, W) int32, ``sentinel`` where padded
    nbr_w: torch.Tensor,     # (R, W) float32, 0 where padded
    cur_lab: torch.Tensor,   # (R,) int32
    rows: torch.Tensor,      # (R,) int32 vertex ids (noise key)
    seed,                    # uint32 value (int or 0-dim tensor)
    tie_eps: float,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    neg_inf = float("-inf")
    valid = nbr_lab != sentinel
    # pairwise label equality: eq[r, k, j] = lab[r,k] == lab[r,j]
    eq = nbr_lab[:, :, None] == nbr_lab[:, None, :]
    score = torch.sum(torch.where(eq, nbr_w[:, :, None], 0.0), dim=1)  # (R, W)
    noise = tie_noise(rows[:, None], nbr_lab, seed, tie_eps)
    eff = torch.where(valid, score + noise, neg_inf)

    best_score = torch.amax(eff, dim=1)
    is_best = (eff == best_score[:, None]) & valid
    best_lab = torch.amin(torch.where(is_best, nbr_lab, sentinel), dim=1)
    best_lab = torch.where(best_score > neg_inf, best_lab, -1).to(torch.int32)

    eqc = valid & (nbr_lab == cur_lab[:, None])
    cur_sum = torch.sum(torch.where(eqc, nbr_w, 0.0), dim=1)
    cur_present = torch.any(eqc, dim=1)
    cur_noise = tie_noise(rows, cur_lab, seed, tie_eps)
    cur_score = torch.where(cur_present, cur_sum + cur_noise, 0.0)
    return best_lab, best_score, cur_score

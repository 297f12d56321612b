"""Plain PyTorch Louvain Eq. 1 ΔQ scoring (port of
``repro.kernels.delta_q.ref``, expression for expression).

Per row r (one vertex v, ELL tile of width W; candidate j is the community
of neighbor j):

  S(c)        = Σ_k w[r,k] · [cand[r,k] == c]          (= cut_w(v, c))
  S_A         = S(cur_com[r])                          (= cut_w(v, A⁻))
  vol(B⁻)     = vol_cand[r,j] − [cand==A]·deg_v[r]
  vol(A⁻)     = vol_cur[r] − deg_v[r]
  gain(j)     = (S(cand_j) − S_A) − deg_v·((vol(B⁻) − vol(A⁻))·(1/vol_total))

Lu–Halappanavar rule: candidate suppressed when both communities are
singletons and cand > cur.  Argmax tie-break: smallest candidate id.  The
gain keeps exactly this association: eager PyTorch rounds every operation
separately, which the CUDA kernels match by building without FMA
contraction.

``delta_q_ref`` materializes an (R, W, W) pairwise tensor, so it takes a
bounded R; ``delta_q_chunked`` runs it over the row chunks of
``common.row_chunks`` and is what the wrapper and ``ops`` call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import row_chunks


def delta_q_ref(
    cand_com: torch.Tensor,   # (R, W) int32 (sentinel where padded)
    nbr_w: torch.Tensor,      # (R, W) float32
    cur_com: torch.Tensor,    # (R,) int32
    deg_v: torch.Tensor,      # (R,) float32
    vol_cand: torch.Tensor,   # (R, W) float32  volCom[cand]
    vol_cur: torch.Tensor,    # (R,) float32    volCom[cur]
    size_cand: torch.Tensor,  # (R, W) int32    |cand community|
    size_cur: torch.Tensor,   # (R,) int32
    inv_vol_total: torch.Tensor,  # f32 scalar (1 / vol(V))
    sentinel: int,
    singleton_rule: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    neg_inf = float("-inf")
    valid = cand_com != sentinel
    eq = cand_com[:, :, None] == cand_com[:, None, :]
    S = torch.sum(torch.where(eq, nbr_w[:, :, None], 0.0), dim=1)      # (R, W)
    eqA = valid & (cand_com == cur_com[:, None])
    S_A = torch.sum(torch.where(eqA, nbr_w, 0.0), dim=1)                # (R,)

    is_A = cand_com == cur_com[:, None]
    vol_B_minus = vol_cand - torch.where(is_A, deg_v[:, None], 0.0)
    vol_A_minus = (vol_cur - deg_v)[:, None]
    gain = (S - S_A[:, None]) - deg_v[:, None] * (
        (vol_B_minus - vol_A_minus) * inv_vol_total
    )

    if singleton_rule:
        both_single = (size_cur[:, None] == 1) & (size_cand == 1)
        gain = torch.where(both_single & (cand_com > cur_com[:, None]),
                           neg_inf, gain)

    eff = torch.where(valid & ~is_A, gain, neg_inf)
    best_gain = torch.amax(eff, dim=1)
    is_best = (eff == best_gain[:, None]) & valid
    best_cand = torch.amin(torch.where(is_best, cand_com, sentinel), dim=1)
    best_cand = torch.where(best_gain > neg_inf, best_cand, -1).to(torch.int32)
    return best_cand, best_gain


def delta_q_chunked(cand_com, nbr_w, cur_com, deg_v, vol_cand, vol_cur,
                    size_cand, size_cur, inv_vol_total, sentinel: int,
                    singleton_rule: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``delta_q_ref`` over bounded row chunks, concatenated."""
    outs = [delta_q_ref(cand_com[a:b], nbr_w[a:b], cur_com[a:b], deg_v[a:b],
                        vol_cand[a:b], vol_cur[a:b], size_cand[a:b],
                        size_cur[a:b], inv_vol_total, sentinel,
                        singleton_rule)
            for a, b in row_chunks(*cand_com.shape)]
    return tuple(torch.cat(o) for o in zip(*outs))

"""Move-evaluation primitives (port of ``repro.core.moves``).

Both PLP (Alg. 1 l.18) and Louvain local-moving (Alg. 2 l.13-16) reduce to:
"for every destination vertex, group incident edges by a per-edge candidate
key, sum weights per group, then argmax a per-group score" — the
sort+segment GroupBy pattern of ``graph.segment``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.common import tie_noise
from repro_torch.graph import segment as seg


def extend(t: torch.Tensor, fill) -> torch.Tensor:
    """``t`` with one sink slot holding ``fill`` appended: the (n+1)-entry
    "extended" tables every evaluator indexes with ids in [0, n]."""
    return torch.cat([t, torch.full((1,), fill, dtype=t.dtype, device=t.device)])


def plp_best_labels(src, dst, w, valid, labels, n: int, it, seed,
                    tie_eps: float):
    """(best_score[n], best_label[n], cur_score[n]) for the PLP move; a thin
    wrapper over ``plp_best_labels_tables`` on the sink-extended labels."""
    return plp_best_labels_tables(src, dst, w, valid, extend(labels, n), n, it,
                                  seed, tie_eps)


def plp_best_labels_tables(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    labels_ext: torch.Tensor,   # (n+1,) labels table, labels_ext[n] = n
    n: int,
    it: int,
    seed: int,
    tie_eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``plp_best_labels`` on the once-per-sweep EXTENDED label table (slot
    n is the sink).  Vertices with no valid incident edge get best_score =
    -inf, best_label = -1."""
    cand_valid = valid & (src != dst)
    dst_k = torch.where(cand_valid, dst, n)
    lab_k = torch.where(cand_valid, labels_ext[torch.clamp(src, 0, n)], n)
    w_v = torch.where(cand_valid, w, 0.0)

    (gk, gs, gvalid, _) = seg.groupby_sum((dst_k, lab_k), w_v, bound=n)
    gdst, glab = gk
    grp_ok = gvalid & (gdst < n) & (glab < n)

    noise = tie_noise(gdst, glab, (seed + it) & 0xFFFFFFFF, tie_eps)
    score = torch.where(grp_ok, gs + noise, float("-inf"))
    # groups are compacted in (dst, label) order and invalid ones carry the
    # sink id n, which the reductions below drop: seg_ids ascend, no sort
    seg_ids = torch.where(grp_ok, gdst, n)
    best_score, best_lab = seg.segment_argmax(
        score, glab, seg_ids, num_segments=n, valid=grp_ok,
        segments_sorted=True)
    cur_match = grp_ok & (glab == labels_ext[torch.clamp(gdst, 0, n)])
    cur_score = seg.segment_sum(torch.where(cur_match, score, 0.0), seg_ids,
                                n, ids_sorted=True)
    return best_score, best_lab, cur_score


def community_aux(com: torch.Tensor, deg: torch.Tensor, vmask: torch.Tensor,
                  n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vol_com[n], size_com[n]) — the per-sweep Louvain state, recomputed
    from scratch.  The volume sum is the deterministic sorted reduction of
    ``graph.segment.segment_sum``: it feeds every gain."""
    com_c = torch.clamp(com, 0, n - 1)
    vol_com = seg.segment_sum(deg, com_c, n)
    size_com = seg.segment_sum(vmask.to(torch.int32), com_c, n)
    return vol_com, size_com


def louvain_best_moves(src, dst, w, valid, com, deg, vol_com, size_com, vol_v,
                       n: int, singleton_rule: bool = True):
    """(best_gain[n], best_community[n]) for the Louvain local move (Eq. 1);
    a thin wrapper over ``louvain_best_moves_tables`` on sink-extended
    arrays."""
    return louvain_best_moves_tables(
        src, dst, w, valid, extend(com, n), extend(vol_com, 0),
        extend(size_com, 0), extend(deg, 0), vol_v, n,
        singleton_rule=singleton_rule)


def louvain_best_moves_tables(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    com_ext: torch.Tensor,    # (n+1,) community table, com_ext[n] = n
    vol_ext: torch.Tensor,    # (n+1,) community volumes, vol_ext[n] = 0
    size_ext: torch.Tensor,   # (n+1,) community sizes, size_ext[n] = 0
    deg_ext: torch.Tensor,    # (n+1,) weighted degrees, deg_ext[n] = 0
    vol_v: torch.Tensor,
    n: int,
    singleton_rule: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``louvain_best_moves`` on the once-per-sweep EXTENDED tables.  The
    gain is ``(gs − s_to_A) − deg·(vol(B⁻) − vol(A⁻))/vol(V)``, the JAX
    package's segment-path association (a division, where the ELL path
    multiplies by 1/vol(V))."""
    neg_inf = float("-inf")
    cand_valid = valid & (src != dst)
    dst_k = torch.where(cand_valid, dst, n)
    cand_k = torch.where(cand_valid, com_ext[torch.clamp(src, 0, n)], n)
    w_v = torch.where(cand_valid, w, 0.0)

    (gk, gs, gvalid, _) = seg.groupby_sum((dst_k, cand_k), w_v, bound=n)
    gdst, gcand = gk
    grp_ok = gvalid & (gdst < n) & (gcand < n)

    gdst_e = torch.clamp(gdst, 0, n)
    # ascending, with the dropped sink id n last (see plp_best_labels_tables)
    seg_ids = torch.where(grp_ok, gdst, n)
    A = com_ext[gdst_e]
    deg_d = deg_ext[gdst_e]
    s_to_A = seg.segment_sum(torch.where(grp_ok & (gcand == A), gs, 0.0),
                             seg_ids, n, ids_sorted=True)

    cand_e = torch.clamp(gcand, 0, n)
    A_e = torch.clamp(A, 0, n)
    vol_B_minus = vol_ext[cand_e] - torch.where(gcand == A, deg_d, 0.0)
    vol_A_minus = vol_ext[A_e] - deg_d
    gain = (gs - s_to_A[torch.clamp(gdst, 0, n - 1)]
            ) - deg_d * (vol_B_minus - vol_A_minus) / vol_v

    if singleton_rule:
        both_single = (size_ext[A_e] == 1) & (size_ext[cand_e] == 1)
        gain = torch.where(both_single & (gcand > A), neg_inf, gain)

    gain = torch.where(grp_ok & (gcand != A), gain, neg_inf)
    return seg.segment_argmax(gain, gcand, seg_ids, num_segments=n,
                              valid=grp_ok, segments_sorted=True)

"""Plain PyTorch versions of the fused local-move kernels (port of
``repro.kernels.local_move.ref``, expression for expression).

Per row r (one vertex, ELL tile of width W): gather the per-vertex tables at
the row/neighbor ids, then score the move — the PLP weighted label mode or
the Louvain Eq. 1 ΔQ argmax — and emit ``(proposal, propose)`` per row.

Tables are the (n+1)-entry "extended" arrays the sweep engine builds once per
sweep: slot ``sentinel`` (= n) is the padding sink.  Every table access goes
through ``_gather``, which masks sentinel ids to the sink VALUE instead of
reading the table — the CUDA kernels do the same, so a sentinel id never
touches memory.

The scoring materializes an (R, W, W) pairwise tensor: about 4 MB a row at
W = 1024.  The functions here therefore score ``PAIRWISE_ELEMS``-sized row
chunks one after another; rows are independent, so chunking changes no
value.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.delta_q.ref import delta_q_ref
from repro_torch.kernels.label_argmax.ref import label_argmax_ref

# Pairwise-tensor elements per row chunk (128 MB of float32 per temporary).
PAIRWISE_ELEMS = 1 << 25


def _chunks(R: int, W: int):
    step = max(1, PAIRWISE_ELEMS // (W * W))
    return [(i, min(R, i + step)) for i in range(0, R, step)] or [(0, 0)]


def _gather(tab: torch.Tensor, ids: torch.Tensor, sentinel: int, fill
            ) -> torch.Tensor:
    """Masked table gather: ids in [0, n]; sentinel ids take ``fill``
    without reading the table."""
    idx = torch.clamp(ids, 0, tab.shape[0] - 1)
    return torch.where(ids < sentinel, tab[idx], fill)


def local_move_plp_ref(
    rows: torch.Tensor,        # (R,) int32 vertex id per row (sentinel = pad)
    nbr: torch.Tensor,         # (R, W) int32 neighbor ids (sentinel = pad)
    w: torch.Tensor,           # (R, W) float32 edge weights (0 = pad)
    labels_ext: torch.Tensor,  # (n+1,) int32, labels_ext[n] = n
    seed,                      # uint32 tie-noise seed
    *,
    tie_eps: float,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_label[R], propose[R]) for the PLP move, gathers included."""
    n = sentinel
    outs = []
    for a, b in _chunks(rows.shape[0], nbr.shape[1]):
        r, nb = rows[a:b], nbr[a:b]
        nbr_lab = _gather(labels_ext, nb, n, n)
        cur_lab = _gather(labels_ext, r, n, n)
        rows_n = torch.where(r < n, r, n)
        best_lab, best_score, cur_score = label_argmax_ref(
            nbr_lab, w[a:b], cur_lab, rows_n, seed, tie_eps, sentinel)
        outs.append((best_lab, (best_lab >= 0) & (best_score > cur_score)))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def compose_louvain_tables(
    com_ext: torch.Tensor,   # (n+1,) int32 community per vertex, com_ext[n] = n
    vol_ext: torch.Tensor,   # (n+1,) float32 community volume, vol_ext[n] = 0
    size_ext: torch.Tensor,  # (n+1,) int32 community size, size_ext[n] = 0
    deg_ext: torch.Tensor,   # (n+1,) float32 weighted degree, deg_ext[n] = 0
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-VERTEX composed tables (com_v, volcom_v, sizecom_v, deg_v):
    ``volcom_v[v] = vol_ext[com_ext[v]]`` etc., one gather per sweep that
    turns every community-indexed Eq. 1 term into a vertex-indexed one."""
    idx = torch.clamp(com_ext, 0, sentinel)
    return com_ext, vol_ext[idx], size_ext[idx], deg_ext


def local_move_louvain_tables_ref(
    rows: torch.Tensor,       # (R,) int32 vertex id per row (sentinel = pad)
    nbr: torch.Tensor,        # (R, W) int32 neighbor ids (sentinel = pad)
    w: torch.Tensor,          # (R, W) float32 edge weights (0 = pad)
    com_v: torch.Tensor,      # (n+1,) int32 community per vertex, com_v[n] = n
    volcom_v: torch.Tensor,   # (n+1,) f32 vol of v's community, volcom_v[n] = 0
    sizecom_v: torch.Tensor,  # (n+1,) i32 size of v's community, sizecom_v[n]=0
    deg_v: torch.Tensor,      # (n+1,) f32 weighted degree, deg_v[n] = 0
    inv_vol: torch.Tensor,    # f32 scalar 1 / vol(V)
    *,
    sentinel: int,
    singleton_rule: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community[R], propose[R]) on vertex-composed tables (Eq. 1)."""
    n = sentinel
    outs = []
    for a, b in _chunks(rows.shape[0], nbr.shape[1]):
        r, nb = rows[a:b], nbr[a:b]
        best_cand, best_gain = delta_q_ref(
            _gather(com_v, nb, n, n), w[a:b], _gather(com_v, r, n, n),
            _gather(deg_v, r, n, 0.0),
            _gather(volcom_v, nb, n, 0.0),
            _gather(volcom_v, r, n, 0.0),
            _gather(sizecom_v, nb, n, 0),
            _gather(sizecom_v, r, n, 0),
            inv_vol,
            sentinel=sentinel,
            singleton_rule=singleton_rule,
        )
        outs.append((best_cand, (best_cand >= 0) & (best_gain > 0.0)))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

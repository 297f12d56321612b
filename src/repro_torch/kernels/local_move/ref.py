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

The streamed (windowed) layout: rows come in blocks of
``TableWindows.block_rows``, and block b reads each table only inside its
window ``[lo, lo + 2·slot)``, ``lo = win_blk[b]·slot``, of the table padded
by ``window_flat``.  The JAX package slices that window per block and
gathers at ``id − lo``, clipped into the window.  Here ``win_lo`` is the
window base of every row and the gather reads the padded table at
``lo + clip(id − lo, 0, 2·slot − 1)`` — the same entries, with no window
copied out per block — so the windowed and the resident results are
identical by construction, as in the JAX package.

The scoring materializes an (R, W, W) pairwise tensor: about 4 MB a row at
W = 1024.  The functions here therefore score the row chunks of
``common.row_chunks`` one after another; rows are independent, so chunking
changes no value.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import cdiv, row_chunks
from repro_torch.kernels.delta_q.ref import delta_q_ref
from repro_torch.kernels.label_argmax.ref import label_argmax_ref


def _gather(tab: torch.Tensor, ids: torch.Tensor, sentinel: int, fill,
            win_lo: Optional[torch.Tensor] = None, win_len: int = 0
            ) -> torch.Tensor:
    """Masked table gather: ids in [0, n]; sentinel ids take ``fill``
    without reading the table.  With ``win_lo`` (broadcastable to ``ids``)
    ``tab`` is the ``window_flat`` table and each id reads its row's
    window of ``win_len`` entries, rebased and clipped as the JAX package
    does; real ids inside the window read their own entry."""
    if win_lo is None:
        idx = torch.clamp(ids, 0, tab.shape[0] - 1)
    else:
        idx = win_lo + torch.clamp(ids - win_lo, 0, win_len - 1)
    return torch.where(ids < sentinel, tab[idx], fill)


def window_flat(tab: torch.Tensor, slot: int, n_slots: int, fill
                ) -> torch.Tensor:
    """The (n+1,) table padded with ``fill`` to (n_slots+1)·slot entries,
    so every window [k·slot, k·slot + 2·slot), k < n_slots, is in range.
    The padding is never read by a real id."""
    pad = (n_slots + 1) * slot - tab.shape[0]
    if pad <= 0:
        return tab
    return torch.cat([tab, torch.full((pad,), fill, dtype=tab.dtype,
                                      device=tab.device)])


def check_windows(windows, R: int) -> int:
    """The number of blocks, after checking that ``windows`` covers R rows."""
    nb = windows.win_blk.shape[0]
    if cdiv(R, windows.block_rows) != nb:
        raise ValueError(
            f"window metadata mismatch: {nb} blocks of "
            f"{windows.block_rows} rows vs {R} tile rows — windows must be "
            f"computed over the same bucket layout they score")
    return nb


def row_win_lo(windows, R: int) -> torch.Tensor:
    """int64[R]: the window base ``win_blk[b]·slot`` of each row's block."""
    check_windows(windows, R)
    lo = windows.win_blk.long() * windows.slot
    return lo.repeat_interleave(windows.block_rows)[:R]


def local_move_plp_ref(
    rows: torch.Tensor,        # (R,) int32 vertex id per row (sentinel = pad)
    nbr: torch.Tensor,         # (R, W) int32 neighbor ids (sentinel = pad)
    w: torch.Tensor,           # (R, W) float32 edge weights (0 = pad)
    labels_ext: torch.Tensor,  # (n+1,) int32, labels_ext[n] = n
    seed,                      # uint32 tie-noise seed
    *,
    tie_eps: float,
    sentinel: int,
    win_lo: Optional[torch.Tensor] = None,  # int64[R] window base per row
    win_len: int = 0,                        # 2·slot, with win_lo
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_label[R], propose[R]) for the PLP move, gathers included."""
    n = sentinel
    outs = []
    for a, b in row_chunks(rows.shape[0], nbr.shape[1]):
        r, nb = rows[a:b], nbr[a:b]
        lo = None if win_lo is None else win_lo[a:b]
        nbr_lab = _gather(labels_ext, nb, n, n,
                          None if lo is None else lo[:, None], win_len)
        cur_lab = _gather(labels_ext, r, n, n, lo, win_len)
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
    win_lo: Optional[torch.Tensor] = None,  # int64[R] window base per row
    win_len: int = 0,                        # 2·slot, with win_lo
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community[R], propose[R]) on vertex-composed tables (Eq. 1)."""
    n = sentinel
    outs = []
    for a, b in row_chunks(rows.shape[0], nbr.shape[1]):
        r, nb = rows[a:b], nbr[a:b]
        lo = None if win_lo is None else win_lo[a:b]
        lo_n = None if lo is None else lo[:, None]

        def at_nbr(tab, fill):
            return _gather(tab, nb, n, fill, lo_n, win_len)

        def at_row(tab, fill):
            return _gather(tab, r, n, fill, lo, win_len)

        best_cand, best_gain = delta_q_ref(
            at_nbr(com_v, n), w[a:b], at_row(com_v, n),
            at_row(deg_v, 0.0),
            at_nbr(volcom_v, 0.0),
            at_row(volcom_v, 0.0),
            at_nbr(sizecom_v, 0),
            at_row(sizecom_v, 0),
            inv_vol,
            sentinel=sentinel,
            singleton_rule=singleton_rule,
        )
        outs.append((best_cand, (best_cand >= 0) & (best_gain > 0.0)))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def local_move_plp_windowed_ref(
    rows: torch.Tensor,        # (R,) int32
    nbr: torch.Tensor,         # (R, W) int32
    w: torch.Tensor,           # (R, W) float32
    labels_ext: torch.Tensor,  # (n+1,) int32, labels_ext[n] = n
    seed,                      # uint32 tie-noise seed
    *,
    tie_eps: float,
    sentinel: int,
    windows,                   # graph.ell.TableWindows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The PLP move on the streamed layout: every block reads only its
    window of the table (the streamed kernel's plain version)."""
    return local_move_plp_ref(
        rows, nbr, w,
        window_flat(labels_ext, windows.slot, windows.n_slots, sentinel),
        seed, tie_eps=tie_eps, sentinel=sentinel,
        win_lo=row_win_lo(windows, rows.shape[0]), win_len=2 * windows.slot)


def local_move_louvain_windowed_ref(
    rows: torch.Tensor,       # (R,) int32
    nbr: torch.Tensor,        # (R, W) int32
    w: torch.Tensor,          # (R, W) float32
    com_v: torch.Tensor,      # (n+1,) composed per-vertex tables
    volcom_v: torch.Tensor,
    sizecom_v: torch.Tensor,
    deg_v: torch.Tensor,
    inv_vol: torch.Tensor,    # f32 scalar 1 / vol(V)
    *,
    sentinel: int,
    singleton_rule: bool,
    windows,                  # graph.ell.TableWindows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Louvain move on the streamed layout: every block reads only its
    window of each of the four tables (the streamed kernel's plain
    version)."""
    S, k = windows.slot, windows.n_slots
    return local_move_louvain_tables_ref(
        rows, nbr, w, window_flat(com_v, S, k, sentinel),
        window_flat(volcom_v, S, k, 0), window_flat(sizecom_v, S, k, 0),
        window_flat(deg_v, S, k, 0), inv_vol, sentinel=sentinel,
        singleton_rule=singleton_rule,
        win_lo=row_win_lo(windows, rows.shape[0]), win_len=2 * S)

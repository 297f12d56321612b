"""Graph construction: symmetrize + dedup undirected edge lists (port of
``repro.graph.builders``).

All work is host-side numpy, exactly the JAX package's, followed by ONE
upload of the finished arrays to the target device.  ``canonicalize_edges``
repairs (or rejects, per policy) duplicate and reverse-duplicate rows,
self-loops, NaN/negative weights and out-of-range ids BEFORE symmetrization
and returns a ``RepairReport``; clean input passes through untouched.
``from_numpy_edges_robust`` chains the two and validates the result (the
serving layer's per-request ingest).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.graph.structure import Graph, graph_from_arrays, resolve_device
from repro_torch.utils import telemetry
from repro_torch.utils.errors import InputValidationError


@dataclasses.dataclass(frozen=True)
class RepairReport:
    """What ``canonicalize_edges`` changed (all counts are input rows).

    ``clean`` is True iff the input needed no repair — in that case the
    canonicalizer returned the caller's arrays untouched (bit-identity of
    the clean path is structural, not asserted after the fact).
    """

    duplicates_coalesced: int = 0
    self_loops_dropped: int = 0
    nonfinite_weights: int = 0
    negative_weights: int = 0
    out_of_range_ids: int = 0
    actions: Tuple[str, ...] = ()

    @property
    def clean(self) -> bool:
        return not self.actions


def canonicalize_edges(
    u: np.ndarray,
    v: np.ndarray,
    w: Optional[np.ndarray] = None,
    *,
    n: Optional[int] = None,
    self_loops: str = "keep",
    bad_weights: str = "raise",
    bad_ids: str = "raise",
    coalesce: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, RepairReport]:
    """Repair a raw undirected edge list into canonical form.

    Policies:
      * ``self_loops``: "keep" or "drop"
      * ``bad_weights`` (NaN/Inf, or negative): "raise", "drop" (remove the
        row), or "zero" (clamp the weight to 0.0, keeping the row)
      * ``bad_ids`` (negative or >= n): "raise" or "drop"
      * ``coalesce``: merge duplicate AND reverse-duplicate rows ({u,v} as an
        unordered pair) by weight summation, keeping first-occurrence order
        of the surviving representative rows.

    Returns ``(u, v, w, n, report)``.  When nothing needs repair the input
    arrays are returned as-is (same objects), so the clean path feeds
    ``from_numpy_edges`` bit-identically to calling it directly.
    """
    if self_loops not in ("keep", "drop"):
        raise ValueError(f"self_loops={self_loops!r}, want 'keep' or 'drop'")
    if bad_weights not in ("raise", "drop", "zero"):
        raise ValueError(
            f"bad_weights={bad_weights!r}, want 'raise', 'drop' or 'zero'")
    if bad_ids not in ("raise", "drop"):
        raise ValueError(f"bad_ids={bad_ids!r}, want 'raise' or 'drop'")

    u0, v0, w_in = u, v, w
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if w is None:
        w = np.ones(u.shape[0], dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    if u.shape != v.shape or u.shape != w.shape:
        raise InputValidationError("u, v, w must have identical shapes")
    n = int(n if n is not None else
            (max(u.max(initial=-1), v.max(initial=-1)) + 1))

    actions: list = []

    id_bad = (u < 0) | (v < 0) | (u >= n) | (v >= n)
    n_id_bad = int(id_bad.sum())
    if n_id_bad:
        telemetry.bump("ingest.out_of_range_ids", n_id_bad)
        if bad_ids == "raise":
            raise InputValidationError(
                f"{n_id_bad} edge(s) with endpoint ids outside [0, {n})")
        actions.append(f"dropped {n_id_bad} out-of-range-id edge(s)")
        u, v, w = u[~id_bad], v[~id_bad], w[~id_bad]

    nonfinite = ~np.isfinite(w)
    negative = np.isfinite(w) & (w < 0)
    n_nonfinite, n_negative = int(nonfinite.sum()), int(negative.sum())
    if n_nonfinite or n_negative:
        telemetry.bump("ingest.bad_weights", n_nonfinite + n_negative)
        if bad_weights == "raise":
            raise InputValidationError(
                f"{n_nonfinite} non-finite and {n_negative} negative edge "
                "weight(s)")
        bad = nonfinite | negative
        if bad_weights == "drop":
            actions.append(f"dropped {int(bad.sum())} bad-weight edge(s)")
            u, v, w = u[~bad], v[~bad], w[~bad]
        else:
            actions.append(f"zeroed {int(bad.sum())} bad weight(s)")
            w = np.where(bad, 0.0, w)

    n_loops_dropped = 0
    if self_loops == "drop":
        loops = u == v
        n_loops_dropped = int(loops.sum())
        if n_loops_dropped:
            telemetry.bump("ingest.self_loops_dropped", n_loops_dropped)
            actions.append(f"dropped {n_loops_dropped} self-loop(s)")
            u, v, w = u[~loops], v[~loops], w[~loops]

    n_coalesced = 0
    if coalesce and u.size:
        # unordered-pair key: duplicates AND reverse-duplicates share it
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        key = lo * n + hi
        uniq, first, inv = np.unique(
            key, return_index=True, return_inverse=True)
        if uniq.size != key.size:
            n_coalesced = int(key.size - uniq.size)
            telemetry.bump("ingest.duplicates_coalesced", n_coalesced)
            actions.append(
                f"coalesced {n_coalesced} duplicate/reverse-duplicate row(s)")
            sums = np.zeros(uniq.size, dtype=np.float64)
            np.add.at(sums, inv, w)
            keep = np.sort(first)          # first-occurrence order
            u, v = u[keep], v[keep]
            w = sums[inv[keep]]   # each survivor's unique-key aggregate

    report = RepairReport(
        duplicates_coalesced=n_coalesced,
        self_loops_dropped=n_loops_dropped,
        nonfinite_weights=n_nonfinite,
        negative_weights=n_negative,
        out_of_range_ids=n_id_bad,
        actions=tuple(actions),
    )
    if report.clean:
        # nothing repaired: hand back the caller's arrays untouched so the
        # downstream build is bit-identical to the non-robust entry point
        return u0, v0, w_in, n, report
    return u, v, w, n, report


def from_numpy_edges(
    u: np.ndarray,
    v: np.ndarray,
    w: Optional[np.ndarray] = None,
    *,
    n: Optional[int] = None,
    m_max: Optional[int] = None,
    dedup: bool = True,
    sort_by: str = "src",
    validate: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Graph:
    """Build a Graph from an undirected host edge list, on ``device``
    (``"cuda"`` unless the caller names another; raises without a card).

    * symmetrizes: {u,v} -> (u,v) and (v,u)
    * input self-loops (u==v) are stored once with DOUBLED weight
    * optional dedup merges parallel edges by weight summation
    * ``validate`` runs ``validate_graph`` on the result
    """
    dev = resolve_device(device)
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    if w is None:
        w = np.ones(u.shape[0], dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    if u.shape != v.shape or u.shape != w.shape:
        raise ValueError("u, v, w must have identical shapes")
    n = int(n if n is not None else (max(u.max(initial=-1), v.max(initial=-1)) + 1))
    if u.size and (u.min() < 0 or v.min() < 0 or max(u.max(), v.max()) >= n):
        raise InputValidationError("vertex ids out of range")

    loops = u == v
    nl_u, nl_v, nl_w = u[~loops], v[~loops], w[~loops]
    lp_u, lp_w = u[loops], w[loops]

    src = np.concatenate([nl_u, nl_v, lp_u])
    dst = np.concatenate([nl_v, nl_u, lp_u])
    ww = np.concatenate([nl_w, nl_w, 2.0 * lp_w])

    presorted = False
    if dedup and src.size:
        key = src * n + dst
        order = np.argsort(key, kind="stable")
        key, src, dst, ww = key[order], src[order], dst[order], ww[order]
        starts = np.concatenate([[True], key[1:] != key[:-1]])
        rid = np.cumsum(starts) - 1
        # bincount adds in element order, as np.add.at does, and is faster
        sums = np.bincount(rid, weights=ww, minlength=int(rid[-1]) + 1)
        src, dst, ww = src[starts], dst[starts], sums
        # unique keys ascending: already in (src, dst) order
        presorted = True

    if not (presorted and sort_by == "src"):
        if sort_by == "dst":
            order = np.lexsort((src, dst))
        else:
            order = np.lexsort((dst, src))
        src, dst, ww = src[order], dst[order], ww[order]

    g = graph_from_arrays(
        torch.from_numpy(src.astype(np.int32)).to(dev),
        torch.from_numpy(dst.astype(np.int32)).to(dev),
        torch.from_numpy(ww.astype(np.float32)).to(dev),
        n_max=n,
        m_max=m_max,
        n_valid=n,
        sorted_by=sort_by,
    )
    if validate:
        validate_graph(g)
    return g


def from_numpy_edges_robust(
    u: np.ndarray,
    v: np.ndarray,
    w: Optional[np.ndarray] = None,
    *,
    n: Optional[int] = None,
    m_max: Optional[int] = None,
    sort_by: str = "src",
    self_loops: str = "keep",
    bad_weights: str = "raise",
    bad_ids: str = "raise",
    device: Union[str, torch.device, None] = None,
) -> Tuple[Graph, RepairReport]:
    """Canonicalize → build on ``device`` → validate.  Clean input gives a
    Graph bit-identical to ``from_numpy_edges(u, v, w, ...)``; repaired
    input is described by the returned ``RepairReport``."""
    u, v, w, n, report = canonicalize_edges(
        u, v, w, n=n, self_loops=self_loops, bad_weights=bad_weights,
        bad_ids=bad_ids)
    g = from_numpy_edges(u, v, w, n=n, m_max=m_max, sort_by=sort_by,
                         device=device)
    validate_graph(g)
    return g, report


def validate_graph(g: Graph, *, symmetry: bool = True) -> None:
    """Host-side invariant checks (raises ``InputValidationError``):

    * masks consistent with n_valid/m_valid
    * endpoint ids inside [0, n_valid) (negative ids included)
    * weights finite and non-negative
    * sort invariant holds
    * symmetry (vectorized): (u,v) valid <=> (v,u) valid with equal
      aggregate weight, loops exempt.  ``symmetry=False`` runs only the
      structural checks — builder intermediates (e.g. pre-symmetrized
      fixtures through ``graph_from_arrays``) are deliberately one-sided.
    """
    src, dst, w = g.to_numpy_edges()
    if int(g.edge_mask.sum()) != int(g.m_valid):
        raise InputValidationError("edge_mask count != m_valid")
    if src.size:
        if src.min() < 0 or dst.min() < 0:
            raise InputValidationError("negative edge endpoint ids")
        if src.max() >= int(g.n_valid) or dst.max() >= int(g.n_valid):
            raise InputValidationError(
                "valid edge endpoints out of vertex range")
    if not np.all(np.isfinite(w)):
        raise InputValidationError("non-finite edge weights")
    if w.size and w.min() < 0:
        raise InputValidationError("negative edge weights")
    if g.sorted_by == "src":
        key = src.astype(np.int64) * g.n_max + dst
        if np.any(np.diff(key) < 0):
            raise InputValidationError("not sorted by (src, dst)")
    elif g.sorted_by == "dst":
        key = dst.astype(np.int64) * g.n_max + src
        if np.any(np.diff(key) < 0):
            raise InputValidationError("not sorted by (dst, src)")
    if not symmetry:
        return
    nonloop = src != dst
    a = src[nonloop].astype(np.int64)
    b = dst[nonloop].astype(np.int64)
    ws = w[nonloop].astype(np.float64)
    n64 = np.int64(g.n_max)
    fwd = a * n64 + b
    # aggregate parallel-edge weights per directed key, then require the
    # transposed key set to exist with matching sums
    uniq, inv = np.unique(fwd, return_inverse=True)
    sums = np.zeros(uniq.size, dtype=np.float64)
    np.add.at(sums, inv, ws)
    ua, ub = uniq // n64, uniq % n64
    rev = ub * n64 + ua
    pos = np.searchsorted(uniq, rev)
    present = (pos < uniq.size) & (uniq[np.clip(pos, 0, uniq.size - 1)] == rev)
    if not np.all(present):
        k = int(np.argmin(present))
        raise InputValidationError(
            f"missing reverse edge for ({int(ua[k])},{int(ub[k])})")
    rsums = sums[pos]
    tol = 1e-5 * np.maximum(1.0, np.abs(sums))
    if np.any(np.abs(rsums - sums) > tol):
        k = int(np.argmax(np.abs(rsums - sums) > tol))
        raise InputValidationError(
            f"asymmetric weight on ({int(ua[k])},{int(ub[k])})")

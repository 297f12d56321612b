"""Edge partition of a graph over the ranks of a process group (port of
``repro.graph.partition``).

Directed edges are sorted by destination and the vertex range is split
into D contiguous chunks with about equal edge counts ("owner computes":
rank d owns the vertices in ``[bounds[d], bounds[d+1])`` and every edge
INTO them).  Each rank's edge slice is padded to one common length
``m_pad``.  Everything here is host numpy over ``Graph.to_numpy_edges()``;
``core.distributed`` moves one rank's row to the graph's device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.graph.structure import Graph


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """Host-side partition plan and padded rank-major arrays."""

    n_devices: int
    vertex_bounds: np.ndarray  # int64[D+1]
    src: np.ndarray  # int32[D, m_pad]   (sentinel n_max where invalid)
    dst: np.ndarray  # int32[D, m_pad]
    w: np.ndarray  # float32[D, m_pad] (0 where invalid)
    edge_mask: np.ndarray  # bool[D, m_pad]
    m_pad: int
    n_max: int


def partition_edges_by_dst(g: Graph, n_devices: int) -> EdgePartition:
    src, dst, w = g.to_numpy_edges()
    order = np.lexsort((src, dst))
    src, dst, w = src[order], dst[order], w[order]
    m = src.shape[0]
    n = int(g.n_valid)

    # balanced split points: rank i gets edges [i·m/D, (i+1)·m/D), snapped
    # outward to vertex boundaries so each vertex's in-edges live on one rank
    targets = (np.arange(1, n_devices) * m) // n_devices
    bounds = [0]
    cut_v = [0]
    for t in targets:
        vcut = dst[min(t, m - 1)] + 1 if m else 0
        vcut = max(vcut, cut_v[-1])
        e = int(np.searchsorted(dst, vcut, side="left"))
        bounds.append(e)
        cut_v.append(int(vcut))
    bounds.append(m)
    cut_v.append(n)
    vertex_bounds = np.asarray(cut_v, dtype=np.int64)

    counts = np.diff(np.asarray(bounds))
    m_pad = int(max(1, counts.max()))
    m_pad = int(np.ceil(m_pad / 8) * 8)   # the JAX package's alignment

    S = np.full((n_devices, m_pad), g.n_max, dtype=np.int32)
    D_ = np.full((n_devices, m_pad), g.n_max, dtype=np.int32)
    W = np.zeros((n_devices, m_pad), dtype=np.float32)
    M = np.zeros((n_devices, m_pad), dtype=bool)
    for d in range(n_devices):
        lo, hi = bounds[d], bounds[d + 1]
        c = hi - lo
        S[d, :c] = src[lo:hi]
        D_[d, :c] = dst[lo:hi]
        W[d, :c] = w[lo:hi]
        M[d, :c] = True
    return EdgePartition(
        n_devices=n_devices,
        vertex_bounds=vertex_bounds,
        src=S,
        dst=D_,
        w=W,
        edge_mask=M,
        m_pad=m_pad,
        n_max=g.n_max,
    )


def owner_of_vertices(p: EdgePartition) -> np.ndarray:
    """int32[n_max]: the owning rank of each vertex id under the contiguous
    dst-range ownership (``vertex_bounds``); ids past the last bound clamp
    onto the last rank."""
    own = np.searchsorted(p.vertex_bounds, np.arange(p.n_max), side="right") - 1
    return np.clip(own, 0, p.n_devices - 1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class HaloTable:
    """Per-rank ghost-vertex (halo) tables of one edge partition.

    Rank d owns ``[vertex_bounds[d], vertex_bounds[d+1])`` and every edge
    into it; the sources of those edges owned ELSEWHERE are d's ghosts —
    the boundary vertices whose labels d must receive each sweep.
    ``sum(ghost_counts)`` label words per refresh is the least label
    exchange a level needs.  ``ghost_ids`` is padded to one width
    (``n_max`` sentinel where ``ghost_mask`` is False).
    """

    n_devices: int
    owner_of: np.ndarray     # int32[n_max]
    ghost_counts: np.ndarray  # int64[D] — distinct non-owned srcs per rank
    ghost_ids: np.ndarray    # int32[D, g_pad] (sentinel n_max where invalid)
    ghost_mask: np.ndarray   # bool[D, g_pad]
    g_pad: int

    @property
    def total_ghosts(self) -> int:
        return int(self.ghost_counts.sum())


def build_halo(p: EdgePartition) -> HaloTable:
    """The ghost tables of an edge partition.  A one-rank partition has no
    ghosts; a rank whose slice is all padding has an empty ghost row."""
    owner = owner_of_vertices(p)
    ghosts = []
    for d in range(p.n_devices):
        s = p.src[d][p.edge_mask[d]]
        g = np.unique(s[owner[s] != d]) if s.size else np.zeros(0, np.int64)
        ghosts.append(g.astype(np.int32))
    counts = np.array([g.size for g in ghosts], dtype=np.int64)
    g_pad = max(1, int(counts.max()) if p.n_devices else 1)
    ids = np.full((p.n_devices, g_pad), p.n_max, dtype=np.int32)
    mask = np.zeros((p.n_devices, g_pad), dtype=bool)
    for d, g in enumerate(ghosts):
        ids[d, : g.size] = g
        mask[d, : g.size] = True
    return HaloTable(
        n_devices=p.n_devices,
        owner_of=owner,
        ghost_counts=counts,
        ghost_ids=ids,
        ghost_mask=mask,
        g_pad=g_pad,
    )


class PartitionQuality(NamedTuple):
    """Partition health, host-side numpy.

    ``imbalance``     max/mean per-rank edge count (1.0 = perfect);
    ``cut_fraction``  fraction of edges whose src is owned elsewhere — the
                      label-exchange edges of the distributed sweep;
    ``halo_factor``   ``sum_d(owned_d + ghosts_d) / n``: 1.0 means no vertex
                      state is ghosted anywhere;
    ``max_halo_fraction``  the worst rank's ghosts over its owned count;
    ``total_ghosts``  the sum of per-rank distinct ghosts — the per-level
                      halo-label payload in words.
    """

    imbalance: float
    cut_fraction: float
    halo_factor: float
    max_halo_fraction: float
    total_ghosts: int


def partition_quality(p: EdgePartition,
                      halo: HaloTable | None = None) -> PartitionQuality:
    """Edge balance, cut fraction and halo factor of a partition; a cut
    edge is one whose src is owned by another rank than its dst."""
    if halo is None:
        halo = build_halo(p)
    counts = p.edge_mask.sum(axis=1).astype(np.float64)
    imbalance = float(counts.max() / max(1.0, counts.mean()))
    cut = 0
    total = 0
    for d in range(p.n_devices):
        mask = p.edge_mask[d]
        s = p.src[d][mask]
        cut += int(np.sum(halo.owner_of[s] != d))
        total += int(mask.sum())
    owned = np.maximum(np.diff(p.vertex_bounds).astype(np.float64), 0.0)
    n_live = max(1.0, float(p.vertex_bounds[-1]))
    halo_factor = float((owned.sum() + halo.ghost_counts.sum()) / n_live)
    max_halo_fraction = float(
        (halo.ghost_counts / np.maximum(owned, 1.0)).max()) if p.n_devices else 0.0
    return PartitionQuality(
        imbalance=imbalance,
        cut_fraction=(cut / total if total else 0.0),
        halo_factor=halo_factor,
        max_halo_fraction=max_halo_fraction,
        total_ghosts=halo.total_ghosts,
    )

"""Louvain aggregation phase (paper Alg. 3 l.13-17, §III-B2) — port of
``repro.core.aggregation``.

  1. *Remap* community IDs to a contiguous [0, n_comm) range;
  2. *Rewrite* edge endpoints through the remap;
  3. *Merge* parallel edges with weight summation.

Intra-community edges collapse onto self-loops whose (single, doubled)
weight equals the directed intra weight.  Outputs keep static capacities
with masks.  Two coarsening paths, bit-for-bit identical:

* ``remap_and_coarsen_binned`` (``aggregation="binned"``, the default): a
  presence-bitmap remap and the sort-free binned merge of
  ``kernels/aggregation``, falling back to the one-sort path when a row
  overflows the bin width;
* ``remap_and_coarsen`` (``aggregation="sort"``): remap and merge fused into
  ONE sort over the combined (m edges + n vertices) entry list — the
  oracle.  ``remap_communities`` + ``coarsen_graph`` is the two-step
  reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.graph import segment as seg
from repro_torch.graph.structure import Graph
from repro_torch.kernels.aggregation.ops import binned_coarsen

AGGREGATION_METHODS = ("binned", "sort")


def remap_communities(com: torch.Tensor, vertex_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, int]:
    """Contiguize community ids, sort-free (presence bitmap + cumsum).
    Returns ``(new_com, n_comm)``: ``new_com[v] ∈ [0, n_comm)`` for valid v
    in ascending old-id order, the ``n_max`` sentinel for invalid v."""
    n = com.shape[0]
    table, n_comm = seg.contiguize_ids(com, vertex_mask, n)
    new_com = torch.where(vertex_mask, table[torch.clamp(com, 0, n - 1)], n)
    return new_com.to(torch.int32), int(n_comm)


def remap_and_coarsen(g: Graph, com: torch.Tensor
                      ) -> Tuple[torch.Tensor, int, Graph]:
    """Fused remap + coarsen: ONE sort per aggregation.

    The combined (m + n)-entry list carries one entry per edge keyed by its
    RAW (com[src], com[dst]) pair and one entry per vertex keyed by
    (com[v], -1), so within each source community the vertex entries sort
    first; runs of the first key enumerate communities in ascending raw-id
    order, and edge runs group the parallel edges.  Returns
    ``(new_com, n_comm, coarse_graph)``."""
    n, m = g.n_max, g.m_max
    dev = g.device
    vmask = g.vertex_mask()
    com_c = torch.clamp(com, 0, n - 1)
    emask = g.edge_mask

    flag = torch.cat([torch.where(emask, 0, 1), torch.where(vmask, 0, 1)])
    a = torch.cat([
        torch.where(emask, com_c[torch.clamp(g.src, 0, n - 1)], n),
        torch.where(vmask, com, n),
    ]).long()
    b = torch.cat([
        torch.where(emask, com_c[torch.clamp(g.dst, 0, n - 1)], n).long(),
        torch.full((n,), -1, dtype=torch.long, device=dev),  # vertices first
    ])
    wv = torch.cat([torch.where(emask, g.w, 0.0),
                    torch.zeros(n, dtype=g.w.dtype, device=dev)])
    payload = torch.cat([torch.full((m,), n, dtype=torch.long, device=dev),
                         torch.arange(n, device=dev)])
    skey, order = torch.sort(
        seg.composite_key((flag, a, b), n, first_size=2), stable=True)
    sflag, sa, sb, sw, spay = (flag[order], a[order], b[order], wv[order],
                               payload[order])
    svalid = sflag == 0
    is_vtx = sb == -1
    total = m + n

    # community enumeration: runs of (flag, a)
    a_starts = seg.run_starts(sflag * (n + 2) + sa)
    a_rid = seg.run_ids(a_starts)
    n_comm = int((a_starts & svalid).sum())

    vpos = torch.where(svalid & is_vtx, spay, n)
    new_com = torch.full((n + 1,), n, dtype=torch.long, device=dev)
    new_com[vpos] = a_rid
    new_com = torch.where(vmask, new_com[:n], n).to(torch.int32)
    # raw community id -> contiguous id (every vertex entry of one raw id
    # writes the same value)
    raw2new = torch.full((n + 1,), n, dtype=torch.long, device=dev)
    raw2new[torch.where(svalid & is_vtx, sa, n)] = a_rid

    # edge grouping: runs of (flag, a, b) restricted to valid edge entries
    starts_all = seg.run_starts(skey)
    rid = seg.run_ids(starts_all)
    sums = seg.segment_sum(torch.where(svalid & ~is_vtx, sw, 0.0), rid, total,
                           ids_sorted=True)
    e_starts = starts_all & svalid & ~is_vtx
    e_rid = torch.cumsum(e_starts.long(), 0) - 1
    n_groups = int(e_starts.sum())

    pos = torch.where(e_starts, e_rid, total)
    idx = torch.zeros(total + 1, dtype=torch.long, device=dev)
    idx[pos] = torch.arange(total, device=dev)
    idx = idx[:m]
    grp_ok = torch.arange(m, device=dev) < n_groups
    cg = Graph(
        src=torch.where(grp_ok, a_rid[idx], n).to(torch.int32),
        dst=torch.where(grp_ok, raw2new[torch.clamp(sb[idx], 0, n)], n
                        ).to(torch.int32),
        w=torch.where(grp_ok, sums[rid[idx]], 0.0),
        edge_mask=grp_ok,
        n_valid=n_comm,
        m_valid=n_groups,
        n_max=n, m_max=m, sorted_by="src")
    return new_com, n_comm, cg


def remap_and_coarsen_binned(g: Graph, com: torch.Tensor, *,
                             width: int | None = None, impl: str = "kernel"
                             ) -> Tuple[torch.Tensor, int, Graph]:
    """Sort-free remap + coarsen; bit-for-bit the ``remap_and_coarsen``
    oracle.  Returns ``(new_com, n_comm, coarse_graph)``."""
    new_com, n_comm = remap_communities(com, g.vertex_mask())
    cg = binned_coarsen(g, new_com, n_comm, width=width, impl=impl)
    return new_com, n_comm, cg


def remap_and_coarsen_by(method: str, g: Graph, com: torch.Tensor, *,
                         impl: str = "kernel"
                         ) -> Tuple[torch.Tensor, int, Graph]:
    """One aggregation step by method name (``LouvainConfig.aggregation``);
    ``impl`` picks the binned path's rank pass."""
    if method not in AGGREGATION_METHODS:
        raise ValueError(
            f"unknown aggregation {method!r}, want one of {AGGREGATION_METHODS}")
    if method == "sort":
        return remap_and_coarsen(g, com)
    return remap_and_coarsen_binned(g, com, impl=impl)


def coarsen_graph(g: Graph, new_com: torch.Tensor, n_comm: int) -> Graph:
    """Super-vertex graph for contiguous community ids ``new_com`` — the
    two-step reference path (with ``remap_communities``)."""
    n, m = g.n_max, g.m_max
    csrc = torch.where(g.edge_mask, new_com[torch.clamp(g.src, 0, n - 1)], n)
    cdst = torch.where(g.edge_mask, new_com[torch.clamp(g.dst, 0, n - 1)], n)
    w = torch.where(g.edge_mask, g.w, 0.0)
    (gk, gs, gvalid, _) = seg.groupby_sum((csrc, cdst), w, valid=g.edge_mask,
                                          bound=n)
    gsrc, gdst = gk
    grp_ok = gvalid & (gsrc < n)
    return Graph(
        src=torch.where(grp_ok, gsrc, n).to(torch.int32),
        dst=torch.where(grp_ok, gdst, n).to(torch.int32),
        w=torch.where(grp_ok, gs, 0.0),
        edge_mask=grp_ok,
        n_valid=int(n_comm),
        m_valid=int(grp_ok.sum()),
        n_max=n, m_max=m, sorted_by="src")

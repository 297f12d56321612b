"""Modularity (§II-C) on the directed-symmetric form (port of
``repro.core.modularity``).

    Q(C) = Σ_c  w_in(c)/vol(V)  −  (vol_w(c)/vol(V))²

where ``w_in(c)`` counts directed intra-community weight and
``vol(V) = Σ_v deg_w(v) = 2W``.  The sums are float32 as in the JAX package
(x64 off); their order differs from XLA's, so Q agrees with the JAX package
to float32 rounding (the tests use rel = 1e-6), and bit for bit only where
every partial sum is an exact integer.
"""
from __future__ import annotations

import torch

from repro_torch.graph import segment as seg
from repro_torch.graph.structure import Graph
from repro_torch.kernels.common import accum_dtype


def community_volumes(g: Graph, com: torch.Tensor) -> torch.Tensor:
    """vol_w(c) = Σ_{v∈c} deg_w(v), indexed by community id (capacity n_max)."""
    return seg.segment_sum(g.weighted_degrees(), com, g.n_max)


def intra_weight(g: Graph, com: torch.Tensor) -> torch.Tensor:
    """Σ_c w_in(c): directed weight of edges with both endpoints co-clustered."""
    n = g.n_max
    same = (com[torch.clamp(g.src, 0, n - 1)]
            == com[torch.clamp(g.dst, 0, n - 1)])
    return torch.sum(torch.where(g.edge_mask & same, g.w, 0.0))


def modularity(g: Graph, com: torch.Tensor, *, promote: bool = False
               ) -> torch.Tensor:
    """Newman–Girvan modularity of the partition ``com`` (float32 scalar
    tensor).  An edgeless graph (vol = 0) returns Q = 0.  ``promote``
    records the float32 accumulation risk (``kernels.common.accum_dtype``)
    and keeps float32."""
    accum_dtype(promote)
    vol_v = g.total_volume()
    w_in = intra_weight(g, com)
    vol_c = community_volumes(g, com)
    safe = torch.where(vol_v > 0, vol_v, torch.ones_like(vol_v))
    q = w_in / safe - torch.sum((vol_c / safe) ** 2)
    return torch.where(vol_v > 0, q, torch.zeros_like(q)).to(torch.float32)


def modularity_dense_reference(adj, com) -> float:
    """O(n²) dense numpy oracle for tests: ``adj`` is a symmetric matrix
    with doubled diagonal (the Graph convention), ``com`` a label per
    row."""
    import numpy as np

    adj = np.asarray(adj, dtype=np.float64)
    com = np.asarray(com)
    vol_v = adj.sum()
    deg = adj.sum(axis=1)
    q = 0.0
    for c in np.unique(com):
        idx = com == c
        w_in = adj[np.ix_(idx, idx)].sum()
        vol_c = deg[idx].sum()
        q += w_in / vol_v - (vol_c / vol_v) ** 2
    return float(q)

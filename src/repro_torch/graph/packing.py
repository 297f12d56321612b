"""Capacity padding (port of ``repro.graph.packing.pad_graph``).

The batched many-graph engine (``core.batch``) relies on one fact about
the ``Graph`` representation: arrays are capacity-padded with validity
masks, so re-padding a graph to a LARGER capacity changes only the padding
(the sentinel follows the new ``n_max``); by the capacity-portability
contract the cascade's ``shrink_graph`` descends on, results for valid
vertices stay the same at any capacity that holds the graph.

``pad_graph`` is the inverse direction of ``aggregation.shrink_graph``, on
the graph's device.  The JAX package's ``empty_slot`` / ``stack_graphs``
(a leading batch axis for ``jax.vmap``) have no counterpart yet: the
port's lanes run one after another, and the batch axis arrives with the
kernels' slot grid (ROADMAP P6).
"""
from __future__ import annotations

import torch

from repro_torch.graph.structure import Graph


def pad_graph(g: Graph, n_cap: int, m_cap: int) -> Graph:
    """Re-pad ``g`` into LARGER capacities, on its device.

    Vertex ids are untouched (valid ids live in [0, n_valid) at any
    capacity); invalid src/dst entries are rewritten from the old ``n_max``
    sentinel to ``n_cap`` and new edge slots are appended fully masked, so
    every invariant (``sorted_by``, front compaction, mask counts) holds.
    """
    n_cap, m_cap = int(n_cap), int(m_cap)
    if n_cap < g.n_max or m_cap < g.m_max:
        raise ValueError(
            f"pad_graph only grows capacities: have ({g.n_max}, {g.m_max}), "
            f"asked ({n_cap}, {m_cap})")
    if n_cap == g.n_max and m_cap == g.m_max:
        return g
    dev, pad = g.device, m_cap - g.m_max
    fill = torch.full((pad,), n_cap, dtype=torch.int32, device=dev)
    return Graph(
        src=torch.cat([torch.where(g.edge_mask, g.src, n_cap).to(torch.int32),
                       fill]),
        dst=torch.cat([torch.where(g.edge_mask, g.dst, n_cap).to(torch.int32),
                       fill]),
        w=torch.cat([torch.where(g.edge_mask, g.w, 0.0),
                     torch.zeros(pad, dtype=torch.float32, device=dev)]),
        edge_mask=torch.cat([g.edge_mask,
                             torch.zeros(pad, dtype=torch.bool, device=dev)]),
        n_valid=g.n_valid,
        m_valid=g.m_valid,
        n_max=n_cap,
        m_max=m_cap,
        sorted_by=g.sorted_by,
    )

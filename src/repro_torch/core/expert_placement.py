"""Expert placement via community detection (port of
``repro.core.expert_placement``) — the paper's technique applied INSIDE the
training framework (beyond-paper integration, DESIGN.md §9).

Problem: MoE all-to-all traffic depends on which experts co-fire for the same
token (top-k>1) or for adjacent tokens in a sequence.  Placing co-activated
experts on the same device group turns cross-device dispatch into local
dispatch for the correlated fraction of traffic.

Method: build the expert co-activation graph (edge weight = how often experts
i,j are routed together), run THE PAPER'S parallel Louvain on it, then pack
communities onto device groups greedily (balanced, capacity = experts-per-
device).  This is exactly the Arachne pipeline — GroupBy-style aggregation +
modularity maximization — reused as a systems optimization.

API:
  coactivation_graph(routing, E)   (T, k) int32 -> Graph over E experts, on
                                   ``device`` (the card unless named)
  louvain_placement(g, n_experts, n_groups) -> (E,) int32 device-group ids
  placement_traffic(routing, placement, n_groups) -> cross-group assignment frac
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core.louvain import LouvainConfig, louvain
from repro_torch.graph.builders import from_numpy_edges
from repro_torch.graph.structure import Graph


def coactivation_graph(routing: np.ndarray, n_experts: int,
                       device: Union[str, torch.device, None] = None
                       ) -> Graph:
    """routing: (T, k) int32 expert ids per token -> co-activation Graph,
    counted on the host and built on ``device``."""
    routing = np.asarray(routing)
    t, k = routing.shape
    if k < 2:
        # top-1: co-activation across ADJACENT tokens (sequence locality)
        a = routing[:-1, 0]
        b = routing[1:, 0]
    else:
        pairs = []
        for i in range(k):
            for j in range(i + 1, k):
                pairs.append((routing[:, i], routing[:, j]))
        a = np.concatenate([p[0] for p in pairs])
        b = np.concatenate([p[1] for p in pairs])
    keep = a != b
    a, b = a[keep], b[keep]
    # aggregate parallel edges (GroupBy.sum — same primitive as aggregation)
    key = a.astype(np.int64) * n_experts + b.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    u = (uniq // n_experts).astype(np.int64)
    v = (uniq % n_experts).astype(np.int64)
    return from_numpy_edges(u, v, counts.astype(np.float64), n=n_experts,
                            device=device)


def louvain_placement(g: Graph, n_experts: int, n_groups: int,
                      seed: int = 0) -> np.ndarray:
    """Louvain communities (on ``g``'s device) -> balanced device-group
    assignment (E,) int32."""
    res = louvain(g, LouvainConfig(seed=seed, track_modularity=False))
    com = np.asarray(res.labels)[:n_experts]
    cap = (n_experts + n_groups - 1) // n_groups
    # pack communities (largest first) into groups with capacity `cap`
    order = sorted(np.unique(com), key=lambda c: -(com == c).sum())
    load = np.zeros(n_groups, dtype=np.int64)
    placement = np.zeros(n_experts, dtype=np.int32)
    for c in order:
        members = np.where(com == c)[0]
        # fill the least-loaded groups, splitting if the community overflows
        while members.size:
            gidx = int(np.argmin(load))
            take = min(members.size, cap - int(load[gidx]))
            if take <= 0:
                cap += 1  # all groups full at current cap: relax
                continue
            placement[members[:take]] = gidx
            load[gidx] += take
            members = members[take:]
    return placement


def placement_traffic(routing: np.ndarray, placement: np.ndarray,
                      n_groups: int) -> float:
    """Fraction of co-routed expert pairs that cross device groups
    (a proxy for all-to-all bytes; lower is better)."""
    routing = np.asarray(routing)
    t, k = routing.shape
    if k < 2:
        a, b = routing[:-1, 0], routing[1:, 0]
    else:
        pa, pb = [], []
        for i in range(k):
            for j in range(i + 1, k):
                pa.append(routing[:, i])
                pb.append(routing[:, j])
        a, b = np.concatenate(pa), np.concatenate(pb)
    keep = a != b
    a, b = a[keep], b[keep]
    if a.size == 0:
        return 0.0
    cross = placement[a] != placement[b]
    return float(cross.mean())


def random_placement(n_experts: int, n_groups: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.repeat(np.arange(n_groups), (n_experts + n_groups - 1) // n_groups)
    return rng.permutation(base[:n_experts]).astype(np.int32)

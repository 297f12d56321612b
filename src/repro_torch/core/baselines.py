"""Sequential baselines — the paper's comparison class (NetworkX / igraph
tier); a copy of the JAX package's ``repro.core.baselines`` over the port's
``Graph`` (the port imports nothing of that package).

The paper benchmarks Arachne against NetworkX, igraph and NetworKit.  Offline
we provide:
  * ``seq_lpa`` / ``seq_louvain`` — faithful single-threaded pure-Python
    implementations (the igraph/NetworkX algorithmic tier) that double as
    correctness oracles;
  * ``nx_lpa`` / ``nx_louvain`` / ``nx_modularity`` — the actual NetworkX
    implementations, the paper's headline baseline.  networkx is imported
    inside these functions: a machine without it can still import this
    module.

Everything here is host-side numpy over ``Graph.to_numpy_edges()``, so a
graph on the card is read back once per call.
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graph.structure import Graph


def _adjacency(g: Graph) -> Tuple[List[List[Tuple[int, float]]], np.ndarray, float]:
    """(adj[v] = [(u, w)...] excluding loops, deg_w incl doubled loops, vol)."""
    src, dst, w = g.to_numpy_edges()
    n = int(g.n_valid)
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    deg_w = np.zeros(n, dtype=np.float64)
    for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()):
        deg_w[s] += x
        if s != d:
            adj[d].append((s, x))  # in-edges == out-edges by symmetry
    return adj, deg_w, float(deg_w.sum())


def seq_lpa(g: Graph, max_iterations: int = 100, seed: int = 0) -> np.ndarray:
    """Sequential asynchronous LPA (Raghavan et al.), random vertex order."""
    adj, _, _ = _adjacency(g)
    n = len(adj)
    rng = random.Random(seed)
    labels = list(range(n))
    order = list(range(n))
    for _ in range(max_iterations):
        rng.shuffle(order)
        changed = 0
        for v in order:
            if not adj[v]:
                continue
            score: Dict[int, float] = defaultdict(float)
            for u, x in adj[v]:
                score[labels[u]] += x
            best = max(score.values())
            cands = [c for c, s in score.items() if s == best]
            new = rng.choice(cands)
            if new != labels[v] and score.get(labels[v], 0.0) < best:
                labels[v] = new
                changed += 1
        if changed == 0:
            break
    return np.asarray(labels)


def seq_louvain(
    g: Graph, max_levels: int = 10, max_sweeps: int = 50, seed: int = 0
) -> np.ndarray:
    """Sequential Louvain (Blondel et al.) with real-time volume updates.

    Vertex-at-a-time Gauss–Seidel — the quality reference the paper compares
    its parallel implementation against (Fig. 3).
    """
    src0, dst0, w0 = g.to_numpy_edges()
    n0 = int(g.n_valid)
    assign = np.arange(n0)

    src, dst, w = src0.tolist(), dst0.tolist(), w0.tolist()
    n = n0
    rng = random.Random(seed)

    for _level in range(max_levels):
        adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
        deg_w = np.zeros(n, dtype=np.float64)
        loop_w = np.zeros(n, dtype=np.float64)
        for s, d, x in zip(src, dst, w):
            deg_w[s] += x
            if s == d:
                loop_w[s] += x
            else:
                adj[d].append((s, x))
        vol_v = float(deg_w.sum())
        com = list(range(n))
        vol_com = deg_w.copy()

        improved_any = False
        for _sweep in range(max_sweeps):
            moved = 0
            order = list(range(n))
            rng.shuffle(order)
            for v in order:
                if not adj[v]:
                    continue
                a = com[v]
                kvc: Dict[int, float] = defaultdict(float)
                for u, x in adj[v]:
                    kvc[com[u]] += x
                vol_com[a] -= deg_w[v]
                base = kvc.get(a, 0.0) - deg_w[v] * vol_com[a] / vol_v
                best_c, best_gain = a, 0.0
                for c, k in kvc.items():
                    if c == a:
                        continue
                    gain = (k - deg_w[v] * vol_com[c] / vol_v) - base
                    if gain > best_gain + 1e-12 or (
                        abs(gain - best_gain) <= 1e-12 and best_c != a and c < best_c
                    ):
                        best_gain, best_c = gain, c
                com[v] = best_c
                vol_com[best_c] += deg_w[v]
                if best_c != a:
                    moved += 1
            if moved == 0:
                break
            improved_any = True

        # contiguous remap
        uniq = sorted(set(com))
        remap = {c: i for i, c in enumerate(uniq)}
        com_arr = np.asarray([remap[c] for c in com])
        n_comm = len(uniq)
        if n_comm == n or not improved_any:
            break
        assign = com_arr[assign]
        # aggregate
        agg: Dict[Tuple[int, int], float] = defaultdict(float)
        for s, d, x in zip(src, dst, w):
            agg[(int(com_arr[s]), int(com_arr[d]))] += x
        src = [k[0] for k in agg]
        dst = [k[1] for k in agg]
        w = [agg[k] for k in agg]
        n = n_comm
    # final contiguous ids
    uniq = sorted(set(assign.tolist()))
    remap = {c: i for i, c in enumerate(uniq)}
    return np.asarray([remap[c] for c in assign.tolist()])


# ------------------------------------------------------------ networkx tier


def _to_networkx(g: Graph):
    import networkx as nx

    src, dst, w = g.to_numpy_edges()
    G = nx.Graph()
    G.add_nodes_from(range(int(g.n_valid)))
    for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()):
        if s <= d:
            G.add_edge(s, d, weight=(x / 2.0 if s == d else x))
    return G


def nx_lpa(g: Graph, seed: int = 0) -> np.ndarray:
    import networkx as nx

    G = _to_networkx(g)
    labels = np.arange(int(g.n_valid))
    for i, comm in enumerate(
        nx.algorithms.community.asyn_lpa_communities(G, weight="weight", seed=seed)
    ):
        for v in comm:
            labels[v] = i
    return labels


def nx_louvain(g: Graph, seed: int = 0) -> np.ndarray:
    import networkx as nx

    G = _to_networkx(g)
    labels = np.arange(int(g.n_valid))
    for i, comm in enumerate(
        nx.algorithms.community.louvain_communities(G, weight="weight", seed=seed)
    ):
        for v in comm:
            labels[v] = i
    return labels


def nx_modularity(g: Graph, labels: np.ndarray) -> float:
    import networkx as nx

    G = _to_networkx(g)
    groups: Dict[int, set] = defaultdict(set)
    for v, c in enumerate(np.asarray(labels)[: int(g.n_valid)].tolist()):
        groups[c].add(v)
    return float(
        nx.algorithms.community.modularity(G, list(groups.values()), weight="weight")
    )

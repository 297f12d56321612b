"""Synthetic graph generators (seeded, numpy-vectorized, offline-safe).

A copy of the JAX package's ``repro.graph.generators``: the same seed gives
the same edge list in both packages.  The SNAP datasets the paper benchmarks
(Table I) are not available offline, so the repo uses (a) SBM
planted-partition graphs — ground truth available, quality measured via
NMI + modularity — and (b) R-MAT graphs matched to each SNAP graph's V/E
and degree skew (scaled) for runtime curves.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def sbm(
    n: int,
    k: int,
    *,
    p_in: float,
    p_out: float,
    seed: int = 0,
    weighted: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Planted-partition stochastic block model.

    Returns (u, v, w, truth) — undirected unique edges + planted community id.
    Sampling is O(expected_edges) via binomial counts per block pair.
    """
    rng = np.random.default_rng(seed)
    sizes = np.full(k, n // k, dtype=np.int64)
    sizes[: n % k] += 1
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    truth = np.repeat(np.arange(k), sizes)

    us, vs = [], []
    for i in range(k):
        ni = sizes[i]
        # intra-block: sample pairs uniformly; expected count = p_in * ni*(ni-1)/2
        n_pairs = ni * (ni - 1) // 2
        cnt = rng.binomial(n_pairs, p_in) if n_pairs > 0 else 0
        if cnt:
            a = rng.integers(0, ni, size=int(cnt * 1.2) + 8)
            b = rng.integers(0, ni, size=int(cnt * 1.2) + 8)
            ok = a < b
            a, b = a[ok][:cnt], b[ok][:cnt]
            us.append(a + offsets[i])
            vs.append(b + offsets[i])
        for j in range(i + 1, k):
            nj = sizes[j]
            cnt = rng.binomial(ni * nj, p_out)
            if cnt:
                a = rng.integers(0, ni, size=cnt) + offsets[i]
                b = rng.integers(0, nj, size=cnt) + offsets[j]
                us.append(a)
                vs.append(b)
    if us:
        u = np.concatenate(us)
        v = np.concatenate(vs)
    else:
        u = np.zeros(0, dtype=np.int64)
        v = np.zeros(0, dtype=np.int64)
    # dedup
    key = u * n + v
    _, idx = np.unique(key, return_index=True)
    u, v = u[idx], v[idx]
    w = (
        rng.uniform(0.5, 1.5, size=u.shape[0])
        if weighted
        else np.ones(u.shape[0], dtype=np.float64)
    )
    return u, v, w, truth


def rmat(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """R-MAT power-law generator (Graph500 parameters by default).

    Returns (u, v, w) undirected edges (dedup'd, loops removed), n = 2**scale.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        right = r >= ab  # bottom half for u
        r2 = rng.random(m)
        # quadrant probabilities conditioned on u-half
        v_right_top = r2 >= (a / ab)
        v_right_bottom = r2 >= (c / (1.0 - ab))
        u |= right.astype(np.int64) << bit
        v |= np.where(right, v_right_bottom, v_right_top).astype(np.int64) << bit
    # undirected canonical form, drop loops, dedup
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    ok = lo != hi
    lo, hi = lo[ok], hi[ok]
    key = lo * n + hi
    _, idx = np.unique(key, return_index=True)
    lo, hi = lo[idx], hi[idx]
    w = (
        rng.uniform(0.5, 1.5, size=lo.shape[0])
        if weighted
        else np.ones(lo.shape[0], dtype=np.float64)
    )
    return lo, hi, w


def ring_of_cliques(
    n_cliques: int, clique_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Classic community-detection sanity graph: k cliques joined in a ring.

    Returns (u, v, w, truth).  Louvain/LPA must recover the cliques.
    """
    us, vs = [], []
    for ci in range(n_cliques):
        base = ci * clique_size
        for i in range(clique_size):
            for j in range(i + 1, clique_size):
                us.append(base + i)
                vs.append(base + j)
        nxt = ((ci + 1) % n_cliques) * clique_size
        us.append(base)  # single bridge edge to the next clique
        vs.append(nxt)
    u = np.asarray(us, dtype=np.int64)
    v = np.asarray(vs, dtype=np.int64)
    w = np.ones(u.shape[0], dtype=np.float64)
    truth = np.repeat(np.arange(n_cliques), clique_size)
    return u, v, w, truth


def random_graph(
    n: int, m: int, *, seed: int = 0, weighted: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Erdos-Renyi-ish G(n, m) (dedup'd, no loops)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=int(m * 1.3) + 16)
    v = rng.integers(0, n, size=int(m * 1.3) + 16)
    ok = u < v
    u, v = u[ok], v[ok]
    key = u * n + v
    _, idx = np.unique(key, return_index=True)
    u, v = u[idx][:m], v[idx][:m]
    w = (
        rng.uniform(0.5, 1.5, size=u.shape[0])
        if weighted
        else np.ones(u.shape[0], dtype=np.float64)
    )
    return u, v, w


def nmi(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """Normalized mutual information between two partitions (for SBM truth)."""
    a = np.asarray(labels_a)
    b = np.asarray(labels_b)
    assert a.shape == b.shape
    n = a.shape[0]
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = ai.max() + 1, bi.max() + 1
    cont = np.zeros((ka, kb), dtype=np.float64)
    np.add.at(cont, (ai, bi), 1.0)
    pij = cont / n
    pi = pij.sum(axis=1, keepdims=True)
    pj = pij.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        mi = np.nansum(pij * np.log(pij / (pi * pj)))
        ha = -np.nansum(pi * np.log(pi))
        hb = -np.nansum(pj * np.log(pj))
    if ha <= 0 or hb <= 0:
        return 1.0 if ka == kb == 1 else 0.0
    return float(mi / np.sqrt(ha * hb))

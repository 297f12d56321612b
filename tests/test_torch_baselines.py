"""The port's sequential baselines, dense modularity oracle and expert
placement ≡ the JAX package's, on the same numpy edges.

``core.baselines`` and ``modularity_dense_reference`` are host-side numpy
(networkx for the ``nx_*`` tier) over the graph's edges, so they must give
the JAX package's answers exactly.  ``coactivation_graph`` must give its
arrays, and ``louvain_placement`` (the port's ``louvain()``) its
placement; then the three cases of ``tests/test_expert_placement.py`` run
on the port.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import expert_placement as jplacement
from repro.core.modularity import \
    modularity_dense_reference as jmodularity_dense_reference
from repro.graph.builders import from_numpy_edges as jfrom_numpy_edges
from repro_torch.core import baselines
from repro_torch.core.expert_placement import (coactivation_graph,
                                               louvain_placement,
                                               placement_traffic,
                                               random_placement)
from repro_torch.core.modularity import modularity, modularity_dense_reference
from repro_torch.graph.builders import from_numpy_edges
from repro_torch.graph.generators import ring_of_cliques, sbm


def _graphs():
    u, v, w, _ = sbm(120, 4, p_in=0.3, p_out=0.02, seed=7)
    yield "sbm", u, v, None, 120
    u, v, w, _ = sbm(90, 3, p_in=0.3, p_out=0.05, seed=8, weighted=True)
    yield "weighted", u, v, w, 90
    u, v, w, _ = ring_of_cliques(6, 5)
    yield "ring", u, v, w, 30
    # a self-loop and an isolated vertex
    yield "loops", np.array([0, 1, 2, 3]), np.array([1, 2, 0, 3]), None, 5


GRAPHS = {k: (u, v, w, n) for k, u, v, w, n in _graphs()}


def _pair(kind):
    u, v, w, n = GRAPHS[kind]
    return (from_numpy_edges(u, v, w, n=n, device="cpu"),
            jfrom_numpy_edges(u, v, w, n=n))


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [0, 3])
def test_sequential_baselines_equal_jax(kind, seed):
    g, jg = _pair(kind)
    assert np.array_equal(baselines.seq_lpa(g, seed=seed),
                          jbaselines.seq_lpa(jg, seed=seed))
    assert np.array_equal(baselines.seq_louvain(g, seed=seed),
                          jbaselines.seq_louvain(jg, seed=seed))


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_networkx_baselines_equal_jax(kind):
    g, jg = _pair(kind)
    lpa = baselines.nx_lpa(g, seed=1)
    assert np.array_equal(lpa, jbaselines.nx_lpa(jg, seed=1))
    lv = baselines.nx_louvain(g, seed=1)
    assert np.array_equal(lv, jbaselines.nx_louvain(jg, seed=1))
    for labels in (lpa, lv, baselines.seq_louvain(g)):
        assert baselines.nx_modularity(g, labels) \
            == jbaselines.nx_modularity(jg, labels)


def _dense(kind):
    u, v, w, n = GRAPHS[kind]
    g = from_numpy_edges(u, v, w, n=n, device="cpu")
    src, dst, ww = g.to_numpy_edges()
    adj = np.zeros((n, n))
    np.add.at(adj, (src, dst), ww)
    return g, adj


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_dense_modularity_oracle_equals_jax_and_the_port(kind):
    g, adj = _dense(kind)
    rng = np.random.default_rng(2)
    for com in (baselines.seq_louvain(g), rng.integers(0, 4, g.n_max),
                np.arange(g.n_max)):
        q = modularity_dense_reference(adj, com)
        assert q == jmodularity_dense_reference(adj, com)
        assert float(modularity(g, torch.as_tensor(com, dtype=torch.int32))) \
            == pytest.approx(q, rel=1e-5, abs=1e-6)
        if kind != "loops":
            assert baselines.nx_modularity(g, com) == pytest.approx(q,
                                                                    rel=1e-9)


def _skewed_routing(n_tokens=4000, n_experts=32, top_k=4, n_latent=8, seed=0):
    rng = np.random.default_rng(seed)
    topic_of_expert = rng.integers(0, n_latent, n_experts)
    pools = [np.where(topic_of_expert == t)[0] for t in range(n_latent)]
    out = np.zeros((n_tokens, top_k), np.int32)
    for i in range(n_tokens):
        pool = pools[rng.integers(0, n_latent)]
        if rng.random() < 0.2 or pool.size < top_k:
            out[i] = rng.choice(n_experts, top_k, replace=False)
        else:
            out[i] = rng.choice(pool, top_k, replace=pool.size < top_k)
    return out


@pytest.mark.parametrize("top_k", [1, 4])
def test_coactivation_graph_and_placement_equal_jax(top_k):
    routing = (_skewed_routing() if top_k == 4 else
               np.random.default_rng(0).integers(0, 16, (500, 1))
               .astype(np.int32))
    e = 32 if top_k == 4 else 16
    g = coactivation_graph(routing, e, device="cpu")
    jg = jplacement.coactivation_graph(routing, e)
    for f in ("src", "dst", "w", "edge_mask"):
        assert np.array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)))
    assert (g.n_valid, g.m_valid) == (int(jg.n_valid), int(jg.m_valid))
    pl = louvain_placement(g, e, 4)
    assert np.array_equal(pl, jplacement.louvain_placement(jg, e, 4))
    assert np.array_equal(random_placement(e, 4, seed=5),
                          jplacement.random_placement(e, 4, seed=5))
    assert placement_traffic(routing, pl, 4) \
        == jplacement.placement_traffic(routing, pl, 4)


def test_coactivation_graph_defaults_to_the_card():
    routing = np.array([[0, 1], [1, 2]], np.int32)
    if torch.cuda.is_available():
        assert coactivation_graph(routing, 3).src.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coactivation_graph(routing, 3)


# the three cases of tests/test_expert_placement.py, on the port


def test_placement_is_balanced():
    routing = _skewed_routing()
    g = coactivation_graph(routing, 32, device="cpu")
    pl = louvain_placement(g, 32, 8)
    counts = np.bincount(pl, minlength=8)
    assert counts.max() - counts.min() <= 1, counts
    assert pl.shape == (32,) and pl.min() >= 0 and pl.max() < 8


def test_louvain_beats_random_placement():
    routing = _skewed_routing()
    g = coactivation_graph(routing, 32, device="cpu")
    t_rand = placement_traffic(routing, random_placement(32, 8), 8)
    t_louv = placement_traffic(routing, louvain_placement(g, 32, 8), 8)
    assert t_louv < t_rand, (t_louv, t_rand)


def test_top1_uses_sequence_adjacency():
    rng = np.random.default_rng(0)
    routing = rng.integers(0, 16, (500, 1)).astype(np.int32)
    g = coactivation_graph(routing, 16, device="cpu")
    assert int(g.m_valid) > 0
    pl = louvain_placement(g, 16, 4)
    assert pl.shape == (16,)

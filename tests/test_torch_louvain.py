"""Port ``louvain()`` ≡ the JAX package's ``louvain()``, bit for bit.

Each ``pipeline_fused`` setting of the port is held against the JAX
package's run with the SAME setting (the cascade driver, or the per-level
driver) on the same graph and config: on ``ring_of_cliques``, an SBM, and
an SBM with one star vertex of degree > 1024 (the ELL tail evaluator
runs), for backends ``segment`` and ``pallas`` and aggregations
``binned`` and ``sort``.  Every integer output and history must match
exactly, ``cascade_stages`` included (one stage on these graphs, which are
below the cascade's 4096-vertex minimum; ``tests/test_torch_cascade.py``
holds the graphs that cascade).

The streamed table layout: ``louvain()`` under ``auto`` on a banded graph
whose tables pass the port's shared-memory budget (so level 0 streams), and
with an explicit ``table_mode``, ≡ the JAX package's
``louvain(table_mode="streamed")`` through its windowed jnp oracle.

Modularity is compared with ``rel=1e-6``: it ends in
``Σ_c (vol_c / vol)²``, a float32 sum whose order differs between XLA and
PyTorch, so its last bits may differ even where every partition agrees.
"""
import numpy as np
import pytest
import torch

from repro.core.louvain import LouvainConfig as JLouvainConfig
from repro.core.louvain import louvain as jlouvain
from repro.graph.builders import from_numpy_edges
from repro.graph.generators import ring_of_cliques, sbm
from repro_torch.core.louvain import LouvainConfig, louvain
from repro_torch.graph.structure import graph_from_numpy
from repro_torch.utils import telemetry

_JAX_CACHE = {}
INT_FIELDS = ("n_communities", "levels", "sweeps_per_level",
              "n_comm_per_level", "delta_n_per_level", "cascade_stages")


def to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


def _graph(kind):
    if kind == "banded":       # Louvain tables 131 KB: past half the budget
        rng = np.random.default_rng(5)
        u = np.repeat(np.arange(8192), 3)
        v = np.clip(u + rng.integers(1, 40, size=u.size), 0, 8191)
        u, v = u[u != v], v[u != v]
        return from_numpy_edges(np.concatenate([u, v]),
                                np.concatenate([v, u]), n=8192)
    if kind == "ring":
        u, v, w, _ = ring_of_cliques(16, 8)
        return from_numpy_edges(u, v, w, n=128)
    if kind == "sbm":
        u, v, w, _ = sbm(600, 12, p_in=0.2, p_out=0.005, seed=21)
        return from_numpy_edges(u, v, w, n=600)
    if kind == "hub":
        u, v, w, _ = sbm(1100, 11, p_in=0.04, p_out=0.002, seed=8)
        leaves = np.random.default_rng(8).choice(1100, 1060, replace=False)
        u = np.concatenate([u, np.full(1060, 1100)])
        v = np.concatenate([v, leaves])
        return from_numpy_edges(u, v, np.ones(len(u)), n=1101)
    u, v, w, _ = sbm(500, 10, p_in=0.2, p_out=0.01, seed=4, weighted=True)
    return from_numpy_edges(u, v, w, n=500)


def _jax_louvain(kind, cfg):
    key = (kind, cfg)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = jlouvain(_graph(kind), cfg)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("pipeline_fused", [True, False])
@pytest.mark.parametrize("aggregation", ["binned", "sort"])
@pytest.mark.parametrize("backend", ["segment", "pallas"])
@pytest.mark.parametrize("kind", ["ring", "sbm", "hub"])
def test_louvain_matches_jax_per_level(kind, backend, aggregation,
                                       pipeline_fused):
    jcfg = JLouvainConfig(backend=backend, aggregation=aggregation,
                          pipeline_fused=pipeline_fused)
    ref = _jax_louvain(kind, jcfg)
    res = louvain(to_torch(_graph(kind)), LouvainConfig.from_dict(
        jcfg.to_dict()))
    assert bool(res.cascade_stages) == pipeline_fused
    np.testing.assert_array_equal(ref.labels, res.labels)
    for f in INT_FIELDS:
        assert getattr(res, f) == getattr(ref, f), f
    assert res.modularity == pytest.approx(ref.modularity, rel=1e-6)
    assert res.modularity_history == pytest.approx(ref.modularity_history,
                                                   rel=1e-6)
    assert res.run_report.as_dict() == ref.run_report.as_dict()
    assert len(res.aggregation_per_level) == res.levels
    if aggregation == "sort":
        assert set(res.aggregation_per_level) == {"sort"}


def test_weighted_graph_modularity_matches_jax():
    """uniform(0.5, 1.5) weights: sums are no longer exact integers, so
    only Q is compared — within rel=1e-6, the float32 summation-order
    difference (partitions may split a near-tie differently)."""
    jcfg = JLouvainConfig(pipeline_fused=False)
    ref = _jax_louvain("weighted", jcfg)
    res = louvain(to_torch(_graph("weighted")),
                  LouvainConfig.from_dict(jcfg.to_dict()))
    assert res.modularity == pytest.approx(ref.modularity, rel=1e-6)


@pytest.mark.parametrize("override,item", [
    ({"refine": True}, "Queue 1 #2"),
    ({"checkpoint_dir": "ckpt"}, "Queue 1 #3"),
])
def test_unported_options_raise(override, item, tmp_path):
    """The two options the port once refused (Leiden refinement and the
    stage checkpoint) now run.  ``refine=True`` is ``leiden()`` on both
    drivers (held against the JAX package in ``test_torch_leiden.py``);
    the ring graph is one stage, so ``checkpoint_dir`` saves nothing and
    changes nothing."""
    from repro_torch.core.louvain import leiden

    g = to_torch(_graph("ring"))
    if "checkpoint_dir" in override:
        override = {"checkpoint_dir": str(tmp_path / override[
            "checkpoint_dir"])}
        want = louvain(g, LouvainConfig())
    else:
        want = leiden(g, LouvainConfig(pipeline_fused=False))
    res = louvain(g, LouvainConfig(**override))
    np.testing.assert_array_equal(want.labels, res.labels)
    for f in INT_FIELDS[:-1] + ("modularity", "modularity_history"):
        assert getattr(res, f) == getattr(want, f), f
    assert not (tmp_path / "ckpt").exists()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs files in parallel worker processes; on the largest
    graphs here torch's intra-op threads then oversubscribe the cores and
    the run slows many times over.  One thread per worker avoids that;
    integer-weighted sums make the results independent of it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_matches(ref, res):
    np.testing.assert_array_equal(ref.labels, res.labels)
    for f in INT_FIELDS:
        assert getattr(res, f) == getattr(ref, f), f
    assert res.modularity == pytest.approx(ref.modularity, rel=1e-6)
    assert res.modularity_history == pytest.approx(ref.modularity_history,
                                                   rel=1e-6)


@pytest.mark.parametrize("backend", ["ell", "pallas"])
def test_louvain_auto_streams_and_matches_jax_streamed(backend):
    """Under ``auto`` level 0 streams the banded graph's buckets and the
    whole run gives the JAX package's ``table_mode="streamed"`` result."""
    jcfg = JLouvainConfig(backend="ell", table_mode="streamed",
                          pipeline_fused=False)
    ref = _jax_louvain("banded", jcfg)
    before = telemetry.get("local_move.streamed.w16")
    res = louvain(to_torch(_graph("banded")), LouvainConfig.from_dict(
        jcfg.replace(backend=backend, table_mode="auto").to_dict()))
    assert (telemetry.get("local_move.streamed.w16") - before
            == res.sweeps_per_level[0])
    _assert_matches(ref, res)


@pytest.mark.parametrize("table_mode", ["streamed", "resident"])
@pytest.mark.parametrize("backend", ["ell", "pallas"])
def test_louvain_table_modes_match_jax_streamed(backend, table_mode):
    """Explicit table modes on a graph with a tail vertex (whole-table
    windows) ≡ the JAX package's streamed run."""
    jcfg = JLouvainConfig(backend="ell", table_mode="streamed",
                          pipeline_fused=False)
    ref = _jax_louvain("hub", jcfg)
    res = louvain(to_torch(_graph("hub")), LouvainConfig.from_dict(
        jcfg.replace(backend=backend, table_mode=table_mode).to_dict()))
    _assert_matches(ref, res)


def test_unknown_table_mode_raises():
    with pytest.raises(ValueError, match="table_mode"):
        louvain(to_torch(_graph("ring")),
                LouvainConfig(backend="pallas", table_mode="windowed"))


@pytest.mark.parametrize("backend", ["segment", "pallas"])
@pytest.mark.parametrize("case", ["no_edges", "one_edge", "loop_only", "star"])
def test_degenerate_graphs_match_jax(case, backend):
    """Empty, single-edge, loop-only and star graphs: empty segments,
    empty ELL buckets and all-padding levels, against the JAX package."""
    from repro.core.plp import PLPConfig as JPLPConfig, plp as jplp
    from repro_torch.core.plp import PLPConfig, plp

    u, v, n = {
        "no_edges": (np.zeros(0, int), np.zeros(0, int), 5),
        "one_edge": (np.array([0]), np.array([1]), 3),
        "loop_only": (np.array([2]), np.array([2]), 4),
        "star": (np.zeros(9, int), np.arange(1, 10), 10),
    }[case]
    jg = from_numpy_edges(u, v, n=n)
    jcfg = JLouvainConfig(backend=backend, pipeline_fused=False)
    ref = jlouvain(jg, jcfg)
    res = louvain(to_torch(jg), LouvainConfig.from_dict(jcfg.to_dict()))
    np.testing.assert_array_equal(ref.labels, res.labels)
    for f in INT_FIELDS:
        assert getattr(res, f) == getattr(ref, f), f
    assert res.modularity == pytest.approx(ref.modularity, rel=1e-6, abs=1e-7)
    pref = jplp(jg, JPLPConfig(backend=backend))
    pres = plp(to_torch(jg), PLPConfig(backend=backend))
    np.testing.assert_array_equal(pref.labels, pres.labels)
    assert (pres.iterations, pres.delta_n_history) == (
        pref.iterations, pref.delta_n_history)

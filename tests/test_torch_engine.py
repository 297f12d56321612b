"""Port ``plp()`` and sweep engine ≡ the JAX package, bit for bit.

``plp()`` with backends ``segment``, ``ell`` and ``pallas`` (the plain
versions on the CPU; the JAX package runs its Pallas kernels in interpret
mode) on the same unit-weight graphs, one with a tail vertex of degree
> 1024; labels, iterations, ΔN and active histories must be identical, for
``fused`` True and False.  One config dict drives both packages.  The
streamed table layout: sweeps with ``table_mode`` streamed ≡ resident ≡
segment, and ``plp()`` under ``auto`` on a banded graph whose tables pass
the port's shared-memory budget (so it streams) ≡ the JAX package's
``plp(table_mode="streamed")`` through its windowed jnp oracle.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import EngineSpec as JSpec
from repro.core.engine import SweepEngine as JEngine
from repro.core.plp import PLPConfig as JPLPConfig
from repro.core.plp import plp as jplp
from repro.graph.builders import from_numpy_edges
from repro.graph.generators import sbm
from repro_torch.core.engine import EngineSpec, SweepEngine
from repro_torch.core.plp import PLPConfig, plp
from repro_torch.graph.structure import graph_from_numpy
from repro_torch.utils import telemetry

_JAX_CACHE = {}


def to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


def _banded(n, band=40, k=3, seed=5):
    """Undirected unit-weight edges between ids at most ``band`` apart: the
    id locality the streamed layout relies on."""
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n), k)
    v = np.clip(u + rng.integers(1, band, size=n * k), 0, n - 1)
    keep = u != v
    u, v = u[keep], v[keep]
    uu, vv = np.concatenate([u, v]), np.concatenate([v, u])
    return from_numpy_edges(uu, vv, np.ones(uu.size, np.float32))


def _graph(kind):
    if kind == "banded":
        return _banded(1024)
    if kind == "streamed":      # PLP table 131 KB: past half the budget
        return _banded(32_768)
    if kind == "sbm":
        u, v, w, _ = sbm(500, 10, p_in=0.2, p_out=0.01, seed=7)
        return from_numpy_edges(u, v, w, n=500)
    u, v, w, _ = sbm(1100, 11, p_in=0.04, p_out=0.002, seed=8)
    leaves = np.random.default_rng(8).choice(1100, 1060, replace=False)
    u = np.concatenate([u, np.full(1060, 1100)])
    v = np.concatenate([v, leaves])
    return from_numpy_edges(u, v, np.ones(len(u)), n=1101)


def _jax_plp(kind, cfg):
    key = (kind, cfg)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = jplp(_graph(kind), cfg)
    return _JAX_CACHE[key]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("backend", ["segment", "ell", "pallas"])
@pytest.mark.parametrize("kind", ["sbm", "hub"])
def test_plp_matches_jax(kind, backend, fused):
    jcfg = JPLPConfig(backend=backend)
    ref = _jax_plp(kind, jcfg)
    res = plp(to_torch(_graph(kind)),
              PLPConfig.from_dict(jcfg.replace(fused=fused).to_dict()))
    np.testing.assert_array_equal(ref.labels, res.labels)
    assert res.iterations == ref.iterations
    assert res.delta_n_history == ref.delta_n_history
    assert res.active_history == ref.active_history
    assert res.run_report.warnings == ref.run_report.warnings


@pytest.mark.parametrize("backend", ["segment", "ell", "pallas"])
def test_louvain_phase_matches_jax(backend):
    """One Louvain local-moving phase at level 0 (singletons, move_prob
    0.5), engine against engine."""
    jg = _graph("hub")
    kw = dict(evaluator="louvain", backend=backend, max_sweeps=25,
              move_prob=0.5)
    jeng = JEngine(jg, JSpec(**kw))
    jres = jeng.run_phase(*jeng.singleton_state(), seed=3)
    teng = SweepEngine(to_torch(jg), EngineSpec(**kw))
    tres = teng.run_phase(*teng.singleton_state(), seed=3)
    np.testing.assert_array_equal(np.asarray(jres.labels),
                                  tres.labels.numpy())
    assert (tres.sweeps, tres.delta_n_history, tres.active_history) == (
        jres.sweeps, jres.delta_n_history, jres.active_history)


def test_engine_rejects_unported_options():
    with pytest.raises(ValueError, match="backend"):
        EngineSpec(backend="mpi")
    # the distributed backend is driven by core.distributed, not SweepEngine
    spec = EngineSpec(evaluator="louvain", backend="distributed")
    with pytest.raises(ValueError, match="distributed_phase"):
        SweepEngine(to_torch(from_numpy_edges(np.array([0, 1, 2]),
                                             np.array([1, 2, 0]))), spec)
    with pytest.raises(ValueError, match="table_mode"):
        EngineSpec(backend="pallas", table_mode="windowed")
    assert EngineSpec(backend="pallas", table_mode="streamed").table_mode \
        == "streamed"


@pytest.mark.parametrize("evaluator", ["plp", "louvain"])
@pytest.mark.parametrize("kind", ["banded", "hub"])
def test_sweep_streamed_matches_resident_and_segment(kind, evaluator):
    """One phase with ``table_mode="streamed"`` on the ``ell`` and
    ``pallas`` backends ≡ ``"resident"`` ≡ the segment evaluator ≡ the JAX
    package's ``ell`` streamed phase: narrow windows on the banded graph,
    whole-table windows and a tail vertex on the hub graph."""
    jg = _graph(kind)
    kw = dict(evaluator=evaluator, max_sweeps=30, move_prob=0.75)
    jeng = JEngine(jg, JSpec(backend="ell", table_mode="streamed", **kw))
    ref = jeng.run_phase(*jeng.singleton_state(), seed=3)
    tg = to_torch(jg)
    for backend, tm in (("segment", "auto"), ("ell", "streamed"),
                        ("ell", "resident"), ("pallas", "streamed")):
        eng = SweepEngine(tg, EngineSpec(backend=backend, table_mode=tm, **kw))
        res = eng.run_phase(*eng.singleton_state(), seed=3)
        np.testing.assert_array_equal(np.asarray(ref.labels),
                                      res.labels.numpy())
        assert (res.sweeps, res.delta_n_history, res.active_history) == (
            ref.sweeps, ref.delta_n_history, ref.active_history)


@pytest.fixture
def one_torch_thread():
    """The suite runs files in parallel worker processes; on the largest
    graphs here torch's intra-op threads then oversubscribe the cores and
    the run slows many times over.  One thread per worker avoids that;
    integer-weighted sums make the results independent of it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("backend", ["ell", "pallas"])
def test_plp_auto_streams_and_matches_jax_streamed(backend, one_torch_thread):
    """Under ``auto`` the port streams the banded graph's buckets (its
    tables pass half the shared-memory budget) and gives the JAX package's
    ``table_mode="streamed"`` result, bit for bit."""
    jcfg = JPLPConfig(backend="ell", table_mode="streamed")
    ref = _jax_plp("streamed", jcfg)
    before = telemetry.get("local_move.streamed.w16")
    res = plp(to_torch(_graph("streamed")),
              PLPConfig.from_dict(jcfg.replace(backend=backend,
                                               table_mode="auto").to_dict()))
    assert telemetry.get("local_move.streamed.w16") - before == res.iterations
    np.testing.assert_array_equal(ref.labels, res.labels)
    assert res.iterations == ref.iterations
    assert res.delta_n_history == ref.delta_n_history
    assert res.active_history == ref.active_history

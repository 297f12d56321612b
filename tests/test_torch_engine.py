"""Port ``plp()`` and sweep engine ≡ the JAX package, bit for bit.

``plp()`` with backends ``segment``, ``ell`` and ``pallas`` (the plain
versions on the CPU; the JAX package runs its Pallas kernels in interpret
mode) on the same unit-weight graphs, one with a tail vertex of degree
> 1024; labels, iterations, ΔN and active histories must be identical, for
``fused`` True and False.  One config dict drives both packages.
"""
import numpy as np
import pytest

from repro.core.engine import EngineSpec as JSpec
from repro.core.engine import SweepEngine as JEngine
from repro.core.plp import PLPConfig as JPLPConfig
from repro.core.plp import plp as jplp
from repro.graph.builders import from_numpy_edges
from repro.graph.generators import sbm
from repro_torch.core.engine import EngineSpec, SweepEngine
from repro_torch.core.plp import PLPConfig, plp
from repro_torch.graph.structure import graph_from_numpy

_JAX_CACHE = {}


def to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


def _graph(kind):
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
        EngineSpec(backend="distributed")
    with pytest.raises(NotImplementedError, match="Queue 2 #4"):
        EngineSpec(backend="pallas", table_mode="streamed")

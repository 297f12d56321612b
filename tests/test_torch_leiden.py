"""The port's ``leiden()`` ≡ the JAX package's, field by field.

* ``leiden()`` on a 4352-vertex banded graph that descends two capacities
  equals ``repro.core.louvain.leiden`` in every ``LouvainResult`` field,
  ``cascade_stages`` included, on the ``segment``, ``ell`` and ``pallas``
  backends (``pallas`` runs the kernels' plain versions on the CPU; the
  JAX package runs its Pallas kernels in interpret mode), under both
  drivers; the two drivers and both ``fused`` settings agree with each
  other bit for bit;
* the pieces: the segment evaluator's ``restrict`` mask against the JAX
  one, the next level's macro seed (a segment max whose empty segments
  clip to 0) against ``jax.ops.segment_max``, ``run_phase(restrict=...)``
  refused off the segment backend, ``refine_sweeps=0`` refused;
* the degenerate graphs of ``tests/test_degenerate.py``, with that
  file's expected answers, where Leiden's last level coarsens nothing
  (``aggregation_per_level`` ends in ``"none"``), equal across backends;
* the refinement's own timer entry, in both drivers.

Contract: integer weights, so labels, counts and histories match bit for
bit; Q is a float32 sum whose order differs between XLA and PyTorch, so
it is compared with ``rel=1e-6`` against the JAX package (and exactly
within the port).  Each JAX run is computed once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.louvain import LouvainConfig as JLouvainConfig
from repro.core.louvain import leiden as jleiden
from repro.graph.builders import from_numpy_edges
from repro.graph.generators import sbm
from repro_torch.core import engine
from repro_torch.core import louvain as louvain_mod
from repro_torch.core.louvain import LouvainConfig, leiden
from repro_torch.graph.structure import graph_from_numpy

INT_FIELDS = ("n_communities", "levels", "sweeps_per_level",
              "n_comm_per_level", "delta_n_per_level", "cascade_stages")
BACKENDS = ("segment", "ell", "pallas")
E = np.zeros(0, np.int64)


def to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


def _banded(n=4352, band=40, k=6, seed=3):
    """Deep hierarchy that descends two capacity steps under ``auto``."""
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n), k)
    v = np.clip(u + rng.integers(1, band, size=n * k), 0, n - 1)
    keep = u != v
    u, v = u[keep], v[keep]
    uu, vv = np.concatenate([u, v]), np.concatenate([v, u])
    return from_numpy_edges(uu, vv, np.ones(uu.size, np.float32))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per worker process: the suite runs files in
    parallel, and integer weights make the results independent of it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def banded():
    jg = _banded()
    return jg, to_torch(jg)


@pytest.fixture(scope="module")
def jax_runs(banded):
    """The JAX package's ``leiden()`` per (backend, pipeline_fused), run
    once for the module."""
    cache = {}

    def get(backend, pipeline_fused):
        key = (backend, pipeline_fused)
        if key not in cache:
            cache[key] = jleiden(banded[0], JLouvainConfig(
                seed=3, backend=backend, pipeline_fused=pipeline_fused))
        return cache[key]

    return get


def _port_cfg(backend, pipeline_fused=True, **kw):
    return LouvainConfig.from_dict(JLouvainConfig(
        seed=3, backend=backend, pipeline_fused=pipeline_fused,
        **kw).to_dict())


def _assert_matches_jax(ref, res):
    np.testing.assert_array_equal(ref.labels, res.labels)
    for f in INT_FIELDS:
        assert getattr(res, f) == getattr(ref, f), f
    assert res.modularity == pytest.approx(ref.modularity, rel=1e-6)
    assert res.modularity_history == pytest.approx(ref.modularity_history,
                                                   rel=1e-6)
    assert res.run_report.as_dict() == ref.run_report.as_dict()


def _assert_bitwise_equal(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    for f in INT_FIELDS[:-1] + ("modularity", "modularity_history"):
        assert getattr(a, f) == getattr(b, f), f


# ------------------------------------------------------------ parity


@pytest.mark.parametrize("pipeline_fused", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_leiden_matches_jax(backend, pipeline_fused, banded, jax_runs):
    """Every field equal to the JAX package's ``leiden()``, the cascade's
    stages too; the cascade descends on this graph."""
    ref = jax_runs(backend, pipeline_fused)
    res = leiden(banded[1], _port_cfg(backend, pipeline_fused))
    _assert_matches_jax(ref, res)
    assert len(res.aggregation_per_level) == res.levels
    if pipeline_fused:
        assert len(res.cascade_stages) >= 2
        assert res.cascade_stages[0] == (banded[1].n_max, banded[1].m_max)
    else:
        assert res.cascade_stages == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_leiden_fused_equals_stepwise(backend, banded):
    """The cascade, the per-level driver and the stepwise engine
    (``fused=False``) give the same partition and histories."""
    g = banded[1]
    fused = leiden(g, _port_cfg(backend, True))
    per_level = leiden(g, _port_cfg(backend, False))
    stepwise = leiden(g, _port_cfg(backend, True, fused=False))
    _assert_bitwise_equal(fused, per_level)
    _assert_bitwise_equal(fused, stepwise)
    assert stepwise.cascade_stages == []


def test_refine_flag_is_leiden(banded):
    """``louvain(refine=True)`` is ``leiden()``, and Leiden's partition is
    not Louvain's on this graph."""
    from repro_torch.core.louvain import louvain

    g = banded[1]
    a = leiden(g, _port_cfg("segment"))
    b = louvain(g, _port_cfg("segment", refine=True))
    c = louvain(g, _port_cfg("segment"))
    _assert_bitwise_equal(a, b)
    assert a.n_comm_per_level != c.n_comm_per_level


# ------------------------------------------------------------ the pieces


def _restrict_case(seed):
    u, v, w, gt = sbm(300, 6, p_in=0.15, p_out=0.02, seed=seed)
    jg = from_numpy_edges(u, v, w, n=300)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 300, jg.n_max).astype(np.int32)
    active = rng.random(jg.n_max) < 0.8
    restrict = np.concatenate([gt, np.zeros(jg.n_max - len(gt), int)])
    restrict = np.where(rng.random(jg.n_max) < 0.1, 7, restrict)
    return jg, labels, active, restrict.astype(np.int32)


@pytest.mark.parametrize("seed", [1, 2])
def test_restrict_mask_matches_jax(seed):
    """The segment evaluator's Louvain branch under ``restrict``: the same
    (proposal, propose) as the JAX evaluator, and no proposal leaves its
    macro community."""
    jg, labels, active, restrict = _restrict_case(seed)
    jspec = jengine.EngineSpec(evaluator="louvain", backend="segment")
    jprop, jgo = jengine._evaluate_segment(
        jspec, jg, jnp.asarray(labels), jnp.asarray(active), jnp.uint32(5),
        jnp.uint32(0), jnp.asarray(restrict))
    g = to_torch(jg)
    spec = engine.EngineSpec(evaluator="louvain", backend="segment")
    level = (g.vertex_mask(), g.weighted_degrees(), g.total_volume())
    prop, go = engine._evaluate_segment(
        spec, g, level, torch.tensor(labels), torch.tensor(active), 5, 0,
        torch.tensor(restrict))
    np.testing.assert_array_equal(np.asarray(jgo), go.numpy())
    np.testing.assert_array_equal(np.asarray(jprop), prop.numpy())
    # a proposed label is a neighbour's, and that neighbour shares the
    # mover's macro community
    src, dst = np.asarray(jg.src), np.asarray(jg.dst)
    em = np.asarray(jg.edge_mask)
    ok = {(int(s), int(labels[d])) for s, d in zip(src[em], dst[em])
          if restrict[s] == restrict[d]}
    for vtx in np.flatnonzero(go.numpy()):
        assert (vtx, int(prop[vtx])) in ok
    # without the mask some vertex proposes across macro communities
    free, _ = engine._evaluate_segment(
        spec, g, level, torch.tensor(labels), torch.tensor(active), 5, 0)
    assert not torch.equal(free, prop)


def test_macro_seed_matches_jax_segment_max():
    """The next level's seed: a segment max of the contiguized macro ids
    over the refined groups, invalid vertices -1, empty groups clipped
    from int32's minimum to 0 — as ``jax.ops.segment_max`` does."""
    rng = np.random.default_rng(4)
    n, n_valid = 50, 41
    vmask = np.arange(n) < n_valid
    new_ref = np.where(vmask, rng.integers(0, 30, n), n).astype(np.int32)
    new_com = np.where(vmask, rng.integers(0, 12, n), n).astype(np.int32)
    want = jnp.clip(jax.ops.segment_max(
        jnp.where(jnp.asarray(vmask), jnp.asarray(new_com), -1),
        jnp.clip(jnp.asarray(new_ref), 0, n - 1), num_segments=n), 0, n - 1)
    got = louvain_mod._macro_seed(torch.tensor(new_com),
                                  torch.tensor(new_ref), torch.tensor(vmask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got[30:] == 0).all() and (got[:30] > 0).any()


@pytest.mark.parametrize("backend", ["ell", "pallas"])
def test_run_phase_restrict_requires_segment(backend):
    jg, labels, active, restrict = _restrict_case(1)
    g = to_torch(jg)
    eng = engine.SweepEngine(g, engine.EngineSpec(evaluator="louvain",
                                                  backend=backend))
    with pytest.raises(ValueError, match="segment backend"):
        eng.run_phase(*eng.singleton_state(),
                      restrict=torch.tensor(restrict))


def test_refine_sweeps_zero_rejected():
    with pytest.raises(ValueError, match="refine_sweeps"):
        LouvainConfig(refine=True, refine_sweeps=0)
    with pytest.raises(ValueError, match="refine_sweeps"):
        JLouvainConfig(refine=True, refine_sweeps=0)


# ------------------------------------------------------------ degenerate


def _degenerate():
    """tests/test_degenerate.py's graphs: name -> (args, kw, communities)."""
    two_cliques_u = np.array([0, 0, 1, 3, 3, 4], np.int64)
    two_cliques_v = np.array([1, 2, 2, 4, 5, 5], np.int64)
    return {
        "single_vertex": ((E, E, np.zeros(0)), {"n": 1}, 1),
        "all_isolates": ((E, E, np.zeros(0)), {"n": 5}, 5),
        "all_self_loops": ((np.arange(4), np.arange(4), np.ones(4)),
                           {"n": 4}, 4),
        "fully_disconnected": ((two_cliques_u, two_cliques_v, np.ones(6)),
                               {"n": 6}, 2),
    }


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(_degenerate()))
def test_leiden_degenerate(name, backend):
    """They run, the answers are ``tests/test_degenerate.py``'s (finite
    Q, the expected communities) and the same on every backend, and the
    level that ends the run coarsens nothing.  (The JAX package's own
    ``leiden()`` on them is that file's; compiling its programs for
    twelve more shapes here would only add compile time.)"""
    args, kw, expect = _degenerate()[name]
    g = to_torch(from_numpy_edges(*args, **kw))
    res = leiden(g, LouvainConfig(backend=backend))
    assert np.isfinite(res.modularity)
    assert res.n_communities == expect
    assert res.aggregation_per_level[-1] == "none"
    assert "none" not in res.aggregation_per_level[:-1]
    if backend != "segment":
        _assert_bitwise_equal(res, leiden(g, LouvainConfig()))


# ------------------------------------------------------------ timer


@pytest.mark.parametrize("pipeline_fused", [True, False])
def test_refinement_is_timed(pipeline_fused):
    """The refinement has its own timer entry in both drivers (and a
    level-tagged one with ``per_level_timing``); Louvain has none."""
    u, v, w, _ = sbm(200, 4, p_in=0.3, p_out=0.02, seed=3)
    g = to_torch(from_numpy_edges(u, v, w))
    cfg = LouvainConfig(pipeline_fused=pipeline_fused, per_level_timing=True)
    res = leiden(g, cfg)
    assert "refinement" in res.timer.totals
    assert "L00/refinement" in res.timer.totals
    assert res.timer.counts["refinement"] == sum(
        1 for p in res.aggregation_per_level if p != "none")
    from repro_torch.core.louvain import louvain

    assert "refinement" not in louvain(g, cfg).timer.totals

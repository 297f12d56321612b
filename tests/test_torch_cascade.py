"""The port's capacity cascade ≡ the JAX package's, field by field.

The JAX package's cascade spec (``tests/test_cascade.py``), run on the
port and held against the JAX package on the same graphs and configs:

* ``auto_capacity_schedule`` returns the same schedules;
* ``louvain()`` under the JAX package's DEFAULT config (pipeline fused,
  ``capacity_schedule="auto"``) equals the JAX run in every
  ``LouvainResult`` field, ``cascade_stages`` included, on graphs of at
  least 4096 vertices that cascade, for backends ``segment``, ``ell`` and
  ``pallas`` (``pallas`` runs the kernels' plain versions on the CPU; the
  JAX package runs its Pallas kernels in interpret mode); so do the
  planted-partition, never-shrinking, capacity-padded and explicit /
  oversized schedules;
* within the port, every schedule equals the single-capacity run
  (``capacity_schedule="none"``) bit for bit, the JAX package's own
  contract;
* ``traced_ell_tile`` equals the JAX package's tile, tail flags included,
  at widths 16, 64 and 256; it and ``build_ell`` keep the tile contract
  the resident Louvain kernel relies on (``graph/ell.py``: sentinel rows
  hold only sentinels of weight 0) and their layout (a live row's real
  slots fill [0, deg) with at most its masked self-loop among them) on
  coarse graphs of the banded, planted and hub-tailed kinds;
  ``tile_contract`` refuses tiles that break the contract and counts the
  rows that break the layout; the traced coarse-level evaluator equals
  the segment evaluator and the JAX package's traced evaluator;
  ``remap_communities_sorted`` and ``shrink_graph`` equal the JAX
  package's;
* a ``CapacityError`` is retried once on the single capacity and recorded
  as the JAX package records it.

Contract: every graph here has integer weights, so labels, counts and
histories match bit for bit; Q and its history are float32 sums whose
order differs between XLA and PyTorch, so they are compared with
``rel=1e-6`` against the JAX package (and exactly within the port).
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jaggregation
from repro.core.engine import EngineSpec as JSpec
from repro.core.engine import SweepEngine as JEngine
from repro.core.louvain import LouvainConfig as JLouvainConfig
from repro.core.louvain import auto_capacity_schedule as jauto
from repro.core.louvain import louvain as jlouvain
from repro.graph.builders import from_numpy_edges
from repro.graph.ell import traced_ell_tile as jtraced_ell_tile
from repro.graph.generators import sbm
from repro.graph.structure import graph_from_arrays as jgraph_from_arrays
from repro_torch.core.engine import EngineSpec, SweepEngine
from repro_torch.core.louvain import (LouvainConfig, auto_capacity_schedule,
                                      louvain)
from repro_torch.graph.ell import build_ell, tile_contract, traced_ell_tile
from repro_torch.graph.structure import graph_from_numpy
from repro_torch.utils.errors import CapacityError

louvain_mod = importlib.import_module("repro_torch.core.louvain")

INT_FIELDS = ("n_communities", "levels", "sweeps_per_level",
              "n_comm_per_level", "delta_n_per_level", "cascade_stages")
_JAX_CACHE = {}
_GRAPHS = {}


def to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


def _banded(n, band, k, seed):
    """Deep hierarchy: ~n/band communities after level 0, collapsing over
    many levels, so the run descends >= 2 capacity steps."""
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n), k)
    v = np.clip(u + rng.integers(1, band, size=n * k), 0, n - 1)
    keep = u != v
    u, v = u[keep], v[keep]
    uu, vv = np.concatenate([u, v]), np.concatenate([v, u])
    return from_numpy_edges(uu, vv, np.ones(uu.size, np.float32))


def _padded():
    """Capacity-padded sparse graph: m_max below the 2048 edge floor."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 900, 800)
    v = rng.integers(0, 900, 800)
    keep = u != v
    uu = np.concatenate([u[keep], v[keep]])
    vv = np.concatenate([v[keep], u[keep]])
    order = np.lexsort((vv, uu))
    return jgraph_from_arrays(
        jnp.asarray(uu[order], jnp.int32), jnp.asarray(vv[order], jnp.int32),
        jnp.ones((uu.size,), jnp.float32), n_max=5000, m_max=1800,
        n_valid=900, sorted_by="src")


def _graph(kind):
    if kind not in _GRAPHS:
        if kind == "banded":
            g = _banded(8192, 40, 3, 5)
        elif kind == "banded_small":
            g = _banded(4352, 40, 6, 3)
        elif kind == "planted":
            u, v, w, _ = sbm(5000, 40, p_in=0.08, p_out=0.0008, seed=11)
            g = from_numpy_edges(u, v, w)
        elif kind == "matching":     # n/2 communities: never fits n/4
            u = np.arange(0, 4500, 2)
            g = from_numpy_edges(u, u + 1, np.ones(u.size, np.float32))
        else:
            g = _padded()
        _GRAPHS[kind] = g
    return _GRAPHS[kind]


def _jax_louvain(kind, jcfg):
    key = (kind, jcfg)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = jlouvain(_graph(kind), jcfg)
    return _JAX_CACHE[key]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs files in parallel worker processes; one torch thread
    per worker keeps the cores from being oversubscribed (a test here took
    minutes instead of seconds without it).  Integer weights make the
    results independent of it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_matches_jax(ref, res):
    """Bit for bit on the integer outputs, rel 1e-6 on Q."""
    np.testing.assert_array_equal(ref.labels, res.labels)
    for f in INT_FIELDS:
        assert getattr(res, f) == getattr(ref, f), f
    assert res.modularity == pytest.approx(ref.modularity, rel=1e-6)
    assert res.modularity_history == pytest.approx(ref.modularity_history,
                                                   rel=1e-6)
    assert res.run_report.as_dict() == ref.run_report.as_dict()


def _assert_bitwise_equal(a, b):
    """Two runs of the port: everything but ``cascade_stages``, the timer
    and ``aggregation_per_level`` equal, Q included.  The aggregation path
    may differ between capacities, since the bin gate is sized from the
    capacity; both paths give the same coarse graph."""
    np.testing.assert_array_equal(a.labels, b.labels)
    for f in INT_FIELDS[:-1] + ("modularity", "modularity_history"):
        assert getattr(a, f) == getattr(b, f), f


def _port_cfg(jcfg):
    return LouvainConfig.from_dict(jcfg.to_dict())


# ------------------------------------------------------------ schedule policy


@pytest.mark.parametrize("n_max,m_max", [
    (1 << 20, 1 << 24), (2 ** 21, 28_453_888), (200, 4000), (4095, 40000),
    (4096, 40000), (8192, 47780), (5000, 1800), (300_000, 2_000_000),
    (4097, 2049)])
def test_auto_schedule_matches_jax(n_max, m_max):
    caps = auto_capacity_schedule(n_max, m_max)
    assert caps == jauto(n_max, m_max)
    assert len(caps) <= 4 and caps[0] == (n_max, m_max)


# ------------------------------------------------------------ parity suite


@pytest.mark.parametrize("backend", ["segment", "ell", "pallas"])
def test_default_config_matches_jax_on_banded(backend):
    """The JAX package's default config on an 8192-vertex banded graph,
    which descends two capacity steps: every field equal, stages too."""
    jcfg = JLouvainConfig(backend=backend)
    assert jcfg.pipeline_fused and jcfg.capacity_schedule == "auto"
    ref = _jax_louvain("banded", jcfg)
    res = louvain(to_torch(_graph("banded")), _port_cfg(jcfg))
    _assert_matches_jax(ref, res)
    assert len(res.cascade_stages) >= 2
    g = _graph("banded")
    assert res.cascade_stages[0] == (g.n_max, g.m_max)


@pytest.mark.parametrize("backend", ["segment", "pallas"])
@pytest.mark.parametrize("kind,seed", [
    ("planted", 2), ("matching", 1), ("padded", 0), ("banded_small", 3)])
def test_cascade_cases_match_jax(kind, seed, backend):
    """The JAX cascade spec's graphs: planted partition (cascades),
    never-shrinking perfect matching (one stage), capacity-padded sparse
    graph (floors clamped to its own capacity) and a 4352-vertex banded
    graph; each ≡ the JAX package and ≡ the port's single capacity."""
    jcfg = JLouvainConfig(seed=seed, backend=backend)
    ref = _jax_louvain(kind, jcfg)
    g = to_torch(_graph(kind))
    res = louvain(g, _port_cfg(jcfg))
    _assert_matches_jax(ref, res)
    one = louvain(g, _port_cfg(jcfg).replace(capacity_schedule="none"))
    _assert_bitwise_equal(res, one)
    assert one.cascade_stages == [(g.n_max, g.m_max)]
    if kind == "matching":
        assert res.cascade_stages == [(g.n_max, g.m_max)]
        assert len(auto_capacity_schedule(g.n_max, g.m_max)) > 1
    else:
        assert len(res.cascade_stages) >= 2


@pytest.mark.parametrize("backend", ["segment", "ell", "pallas"])
def test_explicit_and_oversized_schedule_match_jax(backend):
    """An explicit schedule whose first entry is larger than the graph
    (dropped) no longer raises, and ≡ the JAX package."""
    sched = ((1 << 20, 1 << 24), (1024, 12288), (320, 4096))
    jcfg = JLouvainConfig(seed=3, backend=backend, capacity_schedule=sched)
    ref = _jax_louvain("banded_small", jcfg)
    g = to_torch(_graph("banded_small"))
    res = louvain(g, _port_cfg(jcfg))
    _assert_matches_jax(ref, res)
    assert len(res.cascade_stages) >= 2
    assert all(s in ((g.n_max, g.m_max),) + sched[1:]
               for s in res.cascade_stages)


@pytest.mark.parametrize("pipeline_fused,fused", [(False, True),
                                                  (True, False)])
def test_per_level_driver_runs_no_cascade(pipeline_fused, fused):
    """Without both fusion flags the per-level driver runs: no stages, and
    every other field equal to the cascade's."""
    jcfg = JLouvainConfig(seed=3, backend="pallas",
                          pipeline_fused=pipeline_fused, fused=fused)
    ref = _jax_louvain("banded_small", jcfg)
    g = to_torch(_graph("banded_small"))
    res = louvain(g, _port_cfg(jcfg))
    _assert_matches_jax(ref, res)
    assert res.cascade_stages == []
    _assert_bitwise_equal(res, louvain(g, LouvainConfig(seed=3,
                                                        backend="pallas")))


# ------------------------------------------------------------ capacity retry


def test_capacity_retry_matches_jax(monkeypatch):
    """A CapacityError from the cascade is retried once on the single
    capacity, with the JAX package's retry record."""
    jmod = importlib.import_module("repro.core.louvain")
    jreal, real = jmod._louvain_pipeline, louvain_mod._louvain_pipeline

    def jbusted(g, cfg, g0, faults=frozenset(), promote=False):
        if cfg.capacity_schedule != "none":
            raise jmod.CapacityError("synthetic cascade capacity bust")
        return jreal(g, cfg, g0, faults, promote)

    def busted(g, cfg, g0, promote=False, faults=frozenset()):
        if cfg.capacity_schedule != "none":
            raise CapacityError("synthetic cascade capacity bust")
        return real(g, cfg, g0, promote, faults)

    monkeypatch.setattr(jmod, "_louvain_pipeline", jbusted)
    monkeypatch.setattr(louvain_mod, "_louvain_pipeline", busted)
    jg = _graph("matching")
    ref = jlouvain(jg, JLouvainConfig(seed=1))
    res = louvain(to_torch(jg), LouvainConfig(seed=1))
    _assert_matches_jax(ref, res)
    assert res.run_report.retries == [{
        "kind": "capacity", "from": "'auto'", "to": "none",
        "error": "synthetic cascade capacity bust"}]


def test_cascade_invariant_breach_raises_and_retries(monkeypatch):
    """A stage that exits without done, budget or fitting the next
    capacity breaks the cascade's invariant: the pipeline raises
    CapacityError, and louvain() retries on the single capacity."""
    real = louvain_mod._run_stage

    def forged(run, spec0, spec_coarse, next_caps, *a):
        st = real(run, spec0, spec_coarse, next_caps, *a)
        if next_caps is None:
            return st
        return dataclasses.replace(
            st, done=False, graph=dataclasses.replace(st.graph,
                                                      n_valid=1 << 30))

    g = to_torch(_graph("banded_small"))
    cfg = LouvainConfig(seed=3)
    want = louvain(g, cfg.replace(capacity_schedule="none"))
    monkeypatch.setattr(louvain_mod, "_run_stage", forged)
    with pytest.raises(CapacityError, match="invariant"):
        louvain_mod._louvain_pipeline(g, cfg, None)
    res = louvain(g, cfg)
    _assert_bitwise_equal(res, want)
    assert [r["from"] for r in res.run_report.retries] == ["'auto'"]
    assert res.cascade_stages == [(g.n_max, g.m_max)]


# ------------------------------------------------------------ traced tile


def _coarse_graph():
    """A coarse graph (``remap_and_coarsen`` output: src-sorted, with
    self-loops) whose degrees span every menu width: five merged blocks of
    100 vertices (degrees in the hundreds), hubs of 90 and 200 extra
    neighbours, and singletons of degree ~40."""
    u, v, w, gt = sbm(3000, 30, p_in=0.1, p_out=0.01, seed=4)
    rng = np.random.default_rng(4)
    hu, hv = [], []
    for hub, k in ((1000, 90), (2000, 200), (2500, 300)):
        nb = rng.choice(np.setdiff1d(np.arange(3000), [hub]), k,
                        replace=False)
        hu += [np.full(k, hub), nb]
        hv += [nb, np.full(k, hub)]
    u = np.concatenate([u] + hu)
    v = np.concatenate([v] + hv)
    w = np.concatenate([w, np.ones(sum(len(x) for x in hu), np.float32)])
    g0 = from_numpy_edges(u, v, w)
    com = np.where(gt < 5, gt, np.arange(len(gt)) + 30)
    com = np.concatenate([com, np.arange(len(gt), g0.n_max) + 30])
    com = jnp.asarray(np.minimum(com, g0.n_max - 1), jnp.int32)
    _, _, cg = jaggregation.remap_and_coarsen(g0, com)
    return cg


@pytest.mark.parametrize("kind", ["coarse", "partial"])
def test_remap_sorted_and_shrink_match_jax(kind):
    """The cascade's aggregation pieces against the JAX package's:
    ``remap_communities_sorted`` (≡ the sort-free ``remap_communities``)
    on a partition of a coarse graph, and ``shrink_graph`` of that coarse
    graph into its live counts."""
    from repro_torch.core import aggregation

    cg = _coarse_graph()
    rng = np.random.default_rng(3)
    com = rng.integers(0, 40, cg.n_max).astype(np.int32)
    if kind == "partial":
        com[::3] = np.arange(cg.n_max)[::3]
    vmask = np.arange(cg.n_max) < int(cg.n_valid)
    ref, n_ref = jaggregation.remap_communities_sorted(
        jnp.asarray(com), jnp.asarray(vmask))
    got, n_got = aggregation.remap_communities_sorted(
        torch.from_numpy(com), torch.from_numpy(vmask))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert n_got == int(n_ref)
    free, n_free = aggregation.remap_communities(torch.from_numpy(com),
                                                 torch.from_numpy(vmask))
    assert torch.equal(free, got) and n_free == n_got

    n_out, m_out = int(cg.n_valid) + 7, int(cg.m_valid) + 5
    ref_g = jaggregation.shrink_graph(cg, n_out, m_out)
    got_g = aggregation.shrink_graph(to_torch(cg), n_out, m_out)
    for f in ("src", "dst", "w", "edge_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(ref_g, f)),
                                      getattr(got_g, f).numpy(), err_msg=f)
    assert (got_g.n_max, got_g.m_max, got_g.n_valid, got_g.m_valid) == (
        n_out, m_out, int(ref_g.n_valid), int(ref_g.m_valid))


@pytest.mark.parametrize("width", [16, 64, 256])
def test_traced_ell_tile_matches_jax(width):
    cg = _coarse_graph()
    ref = jtraced_ell_tile(cg, width)
    got = traced_ell_tile(to_torch(cg), width)
    for name, r, t in zip(("rows", "nbr", "w", "is_tail"), ref, got):
        np.testing.assert_array_equal(np.asarray(r), t.numpy(), err_msg=name)
    is_tail = got[3].numpy()
    assert is_tail.any() and not is_tail.all()
    # a tail row is pure padding
    assert (got[0].numpy()[is_tail] == cg.n_max).all()
    assert (got[1].numpy()[is_tail] == cg.n_max).all()


def _contract_graph(kind):
    """A coarse graph for the tile-contract tests: the JAX-coarsened hub
    graph (``_coarse_graph``: tail vertices at every width), or the port's
    own ``remap_and_coarsen`` of a banded or planted graph under a
    partition into runs of three consecutive vertices."""
    if kind == "hubs":
        return to_torch(_coarse_graph())
    from repro_torch.core import aggregation

    g = to_torch(_graph(kind))
    com = torch.arange(g.n_max, dtype=torch.int32) // 3
    return aggregation.remap_and_coarsen(g, com)[2]


def _edge_counts(g):
    """Per vertex: edges (self-loop included) and self-loops, from the
    graph's valid edge list."""
    src, dst, _ = g.to_numpy_edges()
    n = g.n_max
    return (np.bincount(src, minlength=n),
            np.bincount(src[src == dst], minlength=n))


@pytest.mark.parametrize("width", [16, 64, 256])
@pytest.mark.parametrize("kind", ["banded_small", "planted", "hubs"])
def test_traced_ell_tile_keeps_the_tile_contract(kind, width):
    """What the resident Louvain kernel relies on, on traced tiles of
    coarse graphs: a sentinel row (padding vertex slot or tail vertex)
    holds only sentinels of weight 0; a live row v holds its deg(v) edges
    in slots [0, deg(v)), its masked self-loop (weight 0) the only
    sentinel among them, and sentinels of weight 0 after them; the counts
    ``tile_contract`` returns are the tile's."""
    g = _contract_graph(kind)
    n = g.n_max
    deg, loops = _edge_counts(g)
    assert loops.max() <= 1               # a coarse graph: merged edges
    rows, nbr, w, is_tail = (t.numpy() for t in traced_ell_tile(g, width))
    live = rows < n
    assert (nbr[~live] == n).all() and (w[~live] == 0).all()
    assert (rows[live] == np.flatnonzero(live)).all()
    assert (is_tail == ((deg > width) & (np.arange(n) < g.n_valid))).all()
    assert (~live).sum() > is_tail.sum()   # padding vertex slots too
    d = deg[live]
    j = np.arange(width)[None, :]
    inside = j < d[:, None]
    sent = nbr[live] == n
    assert (sent & ~inside).sum() == (~inside).sum()     # padding after deg
    assert ((sent & inside).sum(axis=1) == loops[live]).all()
    assert (w[live][sent] == 0).all()
    last = np.where(~sent, j + 1, 0).max(axis=1)
    assert tile_contract(*(torch.from_numpy(x) for x in (rows, nbr, w)),
                         n) == (int(live.sum()), int((~sent).sum()),
                                int(last.sum()), 0)


@pytest.mark.parametrize("kind", ["banded_small", "planted", "hubs"])
def test_build_ell_keeps_the_tile_contract(kind):
    """``build_ell`` buckets of the same coarse graphs: padding rows hold
    only sentinels of weight 0, a row of (non-loop) degree d holds its
    neighbours in slots [0, d) with no sentinel among them."""
    g = _contract_graph(kind)
    n = g.n_max
    deg, loops = _edge_counts(g)
    ell = build_ell(g)
    assert sum(b.n_rows_valid for b in ell.buckets) + int(
        ell.tail_vertices.numel()) == int(((deg - loops) > 0).sum())
    for b in ell.buckets:
        rows, nbr, w = b.rows.numpy(), b.nbr.numpy(), b.w.numpy()
        live = rows < n
        assert live.sum() == b.n_rows_valid and live[:b.n_rows_valid].all()
        d = (deg - loops)[rows[live]]
        real = nbr[live] < n
        assert (real == (np.arange(b.width)[None, :] < d[:, None])).all()
        assert (nbr[~live] == n).all() and (w[~live] == 0).all()
        assert (w[live][~real] == 0).all()
        assert tile_contract(b.rows, b.nbr, b.w, n) == (
            b.n_rows_valid, int(d.sum()), int(d.sum()), 0)


def _contract_tile():
    n = 50
    rows = torch.tensor([3, 7, n], dtype=torch.int32)
    nbr = torch.tensor([[1, n, 2, n], [4, 5, n, n], [n, n, n, n]],
                       dtype=torch.int32)
    return n, rows, nbr, (nbr < n).float()


@pytest.mark.parametrize("breach", ["dead_row_slot", "padding_weight"])
def test_tile_contract_refuses_a_broken_tile(breach):
    n, rows, nbr, w = _contract_tile()
    assert tile_contract(rows, nbr, w, n) == (2, 4, 5, 0)
    if breach == "dead_row_slot":
        nbr[2, 1] = 9
    else:
        w[1, 3] = 1.0
    with pytest.raises(ValueError, match="tile contract"):
        tile_contract(rows, nbr, w, n)


def test_tile_contract_counts_crowded_rows():
    """Two sentinels before a live row's last real slot break the
    builders' layout, not the contract: counted, not refused."""
    n, rows, nbr, _ = _contract_tile()
    nbr[0, 1], nbr[0, 2], nbr[0, 3] = n, n, 6
    assert tile_contract(rows, nbr, (nbr < n).float(), n) == (2, 4, 6, 1)


def test_traced_ell_tile_requires_src_sorted():
    g = dataclasses.replace(to_torch(_coarse_graph()), sorted_by=None)
    with pytest.raises(ValueError, match="src-sorted"):
        traced_ell_tile(g, 16)


@pytest.mark.parametrize("evaluator", ["louvain", "plp"])
@pytest.mark.parametrize("width", [16, 64, 256])
def test_traced_evaluator_matches_segment_and_jax(evaluator, width):
    """The traced ell/pallas coarse evaluator ≡ the segment evaluator ≡ the
    JAX package's traced evaluator: labels, sweeps and ΔN history; every
    width here leaves some vertex in the tail."""
    cg = _coarse_graph()
    g = to_torch(cg)
    jspec = JSpec(evaluator=evaluator, backend="ell", max_sweeps=12,
                  move_prob=0.5, ell_width=width)
    jeng = JEngine(cg, jspec)
    ref = jeng.run_phase(*jeng.singleton_state(), it0=1000, seed=3)
    runs = {}
    for backend, ew in (("segment", 0), ("ell", width), ("pallas", width)):
        spec = EngineSpec(evaluator=evaluator, backend=backend,
                          max_sweeps=12, move_prob=0.5, ell_width=ew)
        eng = SweepEngine(g, spec)
        assert (eng.ell is None) == (ew > 0 or backend == "segment")
        runs[backend] = eng.run_phase(*eng.singleton_state(), it0=1000,
                                      seed=3)
    for backend, res in runs.items():
        np.testing.assert_array_equal(np.asarray(ref.labels),
                                      res.labels.numpy(), err_msg=backend)
        assert res.sweeps == ref.sweeps, backend
        assert res.delta_n_history == ref.delta_n_history, backend
        assert res.active_history == ref.active_history, backend


def test_ell_width_spec_validation():
    with pytest.raises(ValueError, match="ell_width"):
        EngineSpec(backend="segment", ell_width=16)
    with pytest.raises(ValueError, match="ell_width"):
        EngineSpec(backend="ell", ell_width=-1)
    EngineSpec(backend="pallas", ell_width=64)


def test_explicit_schedule_round_trips_from_jax_config():
    """A JAX config with an explicit schedule drives the port's config
    (to_dict() turns the tuples into lists; from_dict() turns them back)."""
    sched = ((1024, 12288), (320, 4096))
    cfg = LouvainConfig.from_dict(
        JLouvainConfig(capacity_schedule=sched).to_dict())
    assert cfg.capacity_schedule == sched
    assert LouvainConfig.from_dict(
        LouvainConfig().to_dict()).capacity_schedule == "auto"

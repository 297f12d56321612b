"""The port's batched many-graph engine ≡ the JAX package's, and ≡ its own
single-graph drivers.

* The capacity menu (``bucket_capacity``, ``capacity_signature``, the
  schedule included) equals the JAX package's.
* ``pad_graph`` grows only, gives the JAX package's arrays, and a padded
  run gives the unpadded run's answer.
* One module-scoped JAX oracle — ``louvain_batch`` and ``plp_batch`` at
  ``backend="ell"`` on one set spanning two buckets, four JAX batch
  programs in all (XLA's CPU compiler is slow and sometimes crashes a
  worker) — against the port's batch on ``segment``, ``ell`` and
  ``pallas`` (the ``pallas`` lanes run the kernels' plain versions here).
  Q is compared with ``rel=1e-6`` (a float32 sum in another order).
* Everything else is held against the port's own single-graph drivers,
  which ``tests/test_torch_louvain.py`` and ``tests/test_torch_engine.py``
  hold against the JAX package: per-graph parity for ``louvain``, ``plp``
  and ``leiden`` on every backend, invariance to batch-mates and chunk
  width, lanes run at the bucket's capacities in input order, degenerate
  slots, the numeric guard under ``nan_weight`` and the whole-call
  deadline under ``slow_dispatch``.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.batch import louvain_batch as jlouvain_batch
from repro.core.batch import plp_batch as jplp_batch
from repro.core.louvain import LouvainConfig as JLouvainConfig
from repro.core.plp import PLPConfig as JPLPConfig
from repro.graph import packing as jpacking
from repro.graph.builders import from_numpy_edges as jfrom_numpy_edges
from repro.kernels import common as jcommon
from repro_torch.core import batch as batch_mod
from repro_torch.core.batch import louvain_batch, plp_batch
from repro_torch.core.louvain import LouvainConfig, leiden, louvain
from repro_torch.core.modularity import modularity
from repro_torch.core.plp import PLPConfig, plp
from repro_torch.graph import packing
from repro_torch.graph.builders import from_numpy_edges
from repro_torch.graph.generators import sbm
from repro_torch.graph.structure import graph_from_arrays, graph_from_numpy
from repro_torch.kernels.common import bucket_capacity, capacity_signature
from repro_torch.utils import faultinject, telemetry
from repro_torch.utils.errors import DeadlineError, NumericError

E = np.zeros(0, np.int64)
BACKENDS = ("segment", "ell", "pallas")
LOUVAIN_EXACT = ("n_communities", "levels", "sweeps_per_level",
                 "n_comm_per_level", "delta_n_per_level")
PLP_FIELDS = ("iterations", "delta_n_history", "active_history")
# the JAX oracle's set: two buckets, (64, 256) and (128, 512)
ORACLE_SIZES = (40, 60, 90, 30)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs files in parallel worker processes; one torch thread
    per worker keeps the cores from being oversubscribed (these small
    graphs run many tiny ops).  Integer weights make the results
    independent of it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_leaked_port_faults():
    """No test may leak armed port fault points into the next."""
    yield
    faultinject.disarm()


def to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


def _edges(sizes, seed0):
    return [sbm(n, 4, p_in=0.3, p_out=0.02, seed=seed0 + i)[:2] + (n,)
            for i, n in enumerate(sizes)]


def _sbm_graphs(sizes, seed0=0, **kw):
    return [from_numpy_edges(u, v, n=n, device="cpu", **kw)
            for u, v, n in _edges(sizes, seed0)]


def assert_louvain_equal(r, u):
    assert np.array_equal(r.labels, u.labels)
    assert r.modularity == u.modularity
    assert r.modularity_history == u.modularity_history
    for f in LOUVAIN_EXACT:
        assert getattr(r, f) == getattr(u, f), f
    assert r.run_report.warnings == u.run_report.warnings
    assert r.run_report.degradations == []


def assert_plp_equal(r, u):
    assert np.array_equal(r.labels, u.labels)
    for f in PLP_FIELDS:
        assert getattr(r, f) == getattr(u, f), f
    assert r.run_report.warnings == u.run_report.warnings


# ----------------------------------------------------------------- signature


@pytest.mark.parametrize("n", [0, 1, 24, 64, 65, 100, 300, 5000, 70000])
@pytest.mark.parametrize("m", [0, 1, 255, 256, 257, 1000, 90000, 2000000])
def test_capacity_signature_equals_jax(n, m):
    assert bucket_capacity(n, 64) == jcommon.bucket_capacity(n, 64)
    assert bucket_capacity(m, 256) == jcommon.bucket_capacity(m, 256)
    sig = capacity_signature(n, m)
    jsig = jcommon.capacity_signature(n, m)
    assert tuple(sig) == tuple(jsig)
    assert sig.schedule == jsig.schedule
    assert capacity_signature(n, m, ell_width=64, schedule=((8, 8),)) \
        == tuple(jcommon.capacity_signature(n, m, 64, ((8, 8),)))


def test_bucket_capacity_menu():
    assert (batch_mod.MAX_SLOTS, jcommon.BUCKET_N_FLOOR,
            jcommon.BUCKET_M_FLOOR, jcommon.BUCKET_STEP) == (8, 64, 256, 2)
    assert bucket_capacity(1, 64) == 64
    assert bucket_capacity(65, 64) == 128
    assert bucket_capacity(5000, 64) == 8192
    with pytest.raises(ValueError):
        bucket_capacity(-1, 64)
    a, b = capacity_signature(100, 900), capacity_signature(120, 1000)
    assert a == b and (a.n_cap, a.m_cap) == (128, 1024)


def test_chunks_and_resolve_backend():
    assert list(batch_mod._chunks(list(range(5)), 2)) == [[0, 1], [2, 3], [4]]
    with pytest.raises(ValueError):
        list(batch_mod._chunks([0], 0))
    before = telemetry.get("batch.unsorted_segment_fallback")
    assert batch_mod._resolve_batch_backend("pallas", True) == "pallas"
    assert batch_mod._resolve_batch_backend("ell", True) == "ell"
    assert batch_mod._resolve_batch_backend("segment", False) == "segment"
    assert telemetry.get("batch.unsorted_segment_fallback") == before
    assert batch_mod._resolve_batch_backend("pallas", False) == "segment"
    assert batch_mod._resolve_batch_backend("ell", False) == "segment"
    assert telemetry.get("batch.unsorted_segment_fallback") == before + 2


# ------------------------------------------------------------------- packing


@pytest.mark.parametrize("n_cap,m_cap", [(128, 1024), (64, 2048),
                                         (256, 512)])
def test_pad_graph_equals_jax_and_grows_only(n_cap, m_cap):
    u, v, n = _edges([50], 0)[0]
    jg = jfrom_numpy_edges(u, v, n=n)
    g = to_torch(jg)
    assert g.n_max <= 64 and g.m_max <= 512
    jp = jpacking.pad_graph(jg, n_cap, m_cap)
    p = packing.pad_graph(g, n_cap, m_cap)
    assert (p.n_max, p.m_max, p.sorted_by) == (n_cap, m_cap, "src")
    assert (p.n_valid, p.m_valid) == (g.n_valid, g.m_valid)
    for f in ("src", "dst", "w", "edge_mask"):
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(jp, f)))
    assert packing.pad_graph(g, g.n_max, g.m_max) is g
    with pytest.raises(ValueError, match="only grows"):
        packing.pad_graph(p, n_cap // 2, m_cap)


@pytest.mark.parametrize("algo", ["louvain", "plp"])
def test_padded_run_equals_unpadded(algo):
    """Capacity portability: a run of the padded graph gives the unpadded
    run's labels and histories.  Q on the padded graph adds its float32
    partition sum over the longer array, so ``g_original`` (what a batch
    lane passes) keeps Q the request graph's own, bit for bit."""
    g = _sbm_graphs([50])[0]
    p = packing.pad_graph(g, 256, 2048)
    if algo == "plp":
        a, b = plp(g), plp(p)
        assert np.array_equal(a.labels, b.labels[:g.n_max])
        assert a.delta_n_history == b.delta_n_history
        return
    a, b = louvain(g), louvain(p, g_original=g)
    assert_louvain_equal(b, a)
    c = louvain(p)
    assert np.array_equal(a.labels, c.labels[:g.n_max])
    assert c.modularity == pytest.approx(a.modularity, rel=1e-6)


# ---------------------------------------------------------- the JAX oracle


@pytest.fixture(scope="module")
def jax_oracle():
    jgs = [jfrom_numpy_edges(u, v, n=n) for u, v, n in _edges(ORACLE_SIZES, 0)]
    sigs = {jcommon.capacity_signature(g.n_max, g.m_max) for g in jgs}
    assert len(sigs) == 2
    return ([to_torch(g) for g in jgs],
            jlouvain_batch(jgs, JLouvainConfig(backend="ell")),
            jplp_batch(jgs, JPLPConfig(backend="ell")))


@pytest.mark.parametrize("backend", BACKENDS)
def test_louvain_batch_equals_jax_batch(jax_oracle, backend):
    gs, jres, _ = jax_oracle
    out = louvain_batch(gs, LouvainConfig(backend=backend))
    for g, r, j in zip(gs, out, jres):
        assert np.array_equal(r.labels, np.asarray(j.labels))
        for f in LOUVAIN_EXACT + ("cascade_stages",):
            assert getattr(r, f) == getattr(j, f), f
        assert r.modularity == pytest.approx(j.modularity, rel=1e-6)
        assert r.modularity_history == pytest.approx(j.modularity_history,
                                                     rel=1e-6)
        assert r.run_report.warnings == j.run_report.warnings
        assert len(r.aggregation_per_level) == r.levels
        sig = capacity_signature(g.n_max, g.m_max)
        assert r.cascade_stages == [(sig.n_cap, sig.m_cap)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_plp_batch_equals_jax_batch(jax_oracle, backend):
    gs, _, jres = jax_oracle
    out = plp_batch(gs, PLPConfig(backend=backend))
    for r, j in zip(out, jres):
        assert np.array_equal(r.labels, np.asarray(j.labels))
        for f in PLP_FIELDS:
            assert getattr(r, f) == getattr(j, f), f
        assert r.run_report.warnings == j.run_report.warnings


# ------------------------------------------------- single-graph parity


@pytest.fixture(scope="module")
def mixed():
    return _sbm_graphs([40, 90, 150, 300, 60])


@pytest.mark.parametrize("backend", BACKENDS)
def test_louvain_batch_equals_single_graph_driver(mixed, backend):
    cfg = LouvainConfig(backend=backend)
    assert len({capacity_signature(g.n_max, g.m_max) for g in mixed}) >= 3
    for g, r in zip(mixed, louvain_batch(mixed, cfg)):
        assert_louvain_equal(r, louvain(g, cfg))


@pytest.mark.parametrize("backend", BACKENDS)
def test_leiden_batch_equals_leiden(mixed, backend):
    cfg = LouvainConfig(backend=backend, refine=True)
    for g, r in zip(mixed, louvain_batch(mixed, cfg)):
        assert_louvain_equal(r, leiden(g, LouvainConfig(backend=backend)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_plp_batch_equals_single_graph_driver(backend):
    gs = _sbm_graphs([40, 90, 150, 300, 60], seed0=10)
    cfg = PLPConfig(backend=backend)
    for g, r in zip(gs, plp_batch(gs, cfg)):
        assert_plp_equal(r, plp(g, cfg))


def test_lane_labels_keep_the_graphs_own_sentinel():
    """A graph with fewer live vertices than its capacity: the lane's
    labels are cut to the graph's ``n_max`` and its invalid vertices carry
    the graph's sentinel ``n_max``, not the bucket's ``n_cap``."""
    u, v, n = _edges([45], 3)[0]
    g0 = from_numpy_edges(u, v, n=n, device="cpu")
    g = graph_from_arrays(g0.src[g0.edge_mask], g0.dst[g0.edge_mask],
                          g0.w[g0.edge_mask], n_max=50, n_valid=45,
                          sorted_by="src")
    r, = louvain_batch([g], LouvainConfig(backend="pallas"))
    u1 = louvain(g, LouvainConfig(backend="pallas"))
    assert_louvain_equal(r, u1)
    assert r.labels.shape == (50,) and set(r.labels[45:]) == {50}
    p, = plp_batch([g], PLPConfig(backend="pallas"))
    assert_plp_equal(p, plp(g, PLPConfig(backend="pallas")))


def test_lane_modularity_is_taken_on_the_requests_graph():
    """Q and its history come from the request's own graph, bit for bit,
    also on float32 weights, where the partition sums over the padded
    lane graph (a longer array) may round otherwise."""
    u, v, w, _ = sbm(90, 9, p_in=0.3, p_out=0.03, seed=4, weighted=True)
    g = from_numpy_edges(u, v, w, n=90, device="cpu")
    r, = louvain_batch([g])
    assert r.modularity == float(modularity(g, torch.from_numpy(r.labels)))
    assert r.levels >= 2 and len(r.modularity_history) == r.levels


def test_results_invariant_to_padding_slots_and_batch_mates():
    gs = _sbm_graphs([70, 70, 70, 70, 70], seed0=20)
    alone = louvain_batch(gs[:1])[0]
    ragged = louvain_batch(gs[:3])[0]      # two batch-mates
    full = louvain_batch(gs)[0]            # four batch-mates
    narrow = louvain_batch(gs, max_slots=2)[0]   # three chunks
    for r in (ragged, full, narrow):
        assert_louvain_equal(r, alone)
    p = [plp_batch(x)[0] for x in (gs[:1], gs[:3], gs)]
    assert_plp_equal(p[1], p[0])
    assert_plp_equal(p[2], p[0])


def _record_lanes(monkeypatch):
    """Record each lane graph a batch runs, in order: Louvain's through
    ``_single_stage_run``, PLP's through the ``SweepEngine`` it builds."""
    seen = []
    stage = batch_mod.louvain_mod._single_stage_run
    engine = batch_mod.SweepEngine

    def stage_spy(lane, cfg, spec0, spec_coarse, g_original, *a):
        seen.append((lane, g_original))
        return stage(lane, cfg, spec0, spec_coarse, g_original, *a)

    def engine_spy(lane, spec):
        seen.append((lane, None))
        return engine(lane, spec)

    monkeypatch.setattr(batch_mod.louvain_mod, "_single_stage_run",
                        stage_spy)
    monkeypatch.setattr(batch_mod, "SweepEngine", engine_spy)
    return seen


@pytest.mark.parametrize("run", [louvain_batch, plp_batch])
def test_lanes_run_at_the_bucket_capacities(run, monkeypatch):
    """Each lane is its graph padded to the bucket's signature, on the
    graph's device, bucket by bucket; a graph already at the capacities is
    run as it is."""
    gs = _sbm_graphs([40, 90], seed0=70)
    sig0 = capacity_signature(gs[0].n_max, gs[0].m_max)
    at_cap = packing.pad_graph(gs[0], sig0.n_cap, sig0.m_cap)
    assert capacity_signature(gs[1].n_max, gs[1].m_max) != sig0
    seen = _record_lanes(monkeypatch)
    run(gs + [at_cap], max_slots=8)
    assert len(seen) == 3
    # the first bucket holds gs[0] and at_cap, the second gs[1]
    for (lane, orig), g in zip(seen, [gs[0], at_cap, gs[1]]):
        sig = capacity_signature(g.n_max, g.m_max)
        assert (lane.n_max, lane.m_max) == (sig.n_cap, sig.m_cap)
        assert (lane.n_valid, lane.m_valid) == (g.n_valid, g.m_valid)
        assert lane.device == g.device and lane.sorted_by == g.sorted_by
        assert orig is (g if run is louvain_batch else None)
    assert seen[1][0] is at_cap


@pytest.mark.parametrize("max_slots", [1, 3, 4])
def test_chunks_run_in_input_order_and_preserve_parity(max_slots,
                                                       monkeypatch):
    """One bucket of ten graphs of mixed sizes, chunked at ``max_slots``:
    the lanes run in input order and every result equals the
    single-graph run."""
    sizes = [30, 110, 25, 100, 35, 120, 40, 90, 28, 105]
    gs = [from_numpy_edges(u, v, n=128, m_max=2048, device="cpu")
          for u, v, _n in _edges(sizes, 200)]
    assert len({capacity_signature(g.n_max, g.m_max) for g in gs}) == 1
    seen = _record_lanes(monkeypatch)
    cfg = PLPConfig(backend="pallas")
    before = telemetry.get("batch.plp_dispatches")
    out = plp_batch(gs, cfg, max_slots=max_slots)
    assert telemetry.get("batch.plp_dispatches") - before \
        == -(-len(gs) // max_slots)
    assert [lane.m_valid for lane, _ in seen] == [g.m_valid for g in gs]
    for g, r in zip(gs, out):
        assert_plp_equal(r, plp(g, cfg))
    if max_slots == 4:
        for g, r in zip(gs, louvain_batch(gs, LouvainConfig(backend="pallas"),
                                          max_slots=max_slots)):
            assert_louvain_equal(r, louvain(g, LouvainConfig(
                backend="pallas")))


def test_unsorted_bucket_runs_the_segment_evaluator():
    gs = _sbm_graphs([40, 60], seed0=90, sort_by="dst")
    before = telemetry.get("batch.unsorted_segment_fallback")
    out = louvain_batch(gs, LouvainConfig(backend="pallas"))
    assert telemetry.get("batch.unsorted_segment_fallback") == before + 1
    for g, r in zip(gs, out):
        assert_louvain_equal(r, louvain(g, LouvainConfig(backend="segment")))
    pout = plp_batch(gs, PLPConfig(backend="ell"))
    for g, r in zip(gs, pout):
        assert_plp_equal(r, plp(g, PLPConfig(backend="segment")))


# ---------------------------------------------------------------- degenerate


def test_batch_with_empty_graph_slot():
    g = _sbm_graphs([60], seed0=60)[0]
    empty = from_numpy_edges(E, E, n=0, device="cpu")
    mixed = [g, empty, g]
    out = louvain_batch(mixed)
    assert out[1].labels.shape == (0,)
    assert out[1].n_communities == 0 and out[1].modularity == 0.0
    assert out[1].run_report.clean
    oracle = louvain(g)
    assert_louvain_equal(out[0], oracle)
    assert_louvain_equal(out[2], oracle)
    pout = plp_batch(mixed)
    assert pout[1].labels.shape == (0,) and pout[1].iterations == 0
    assert_plp_equal(pout[0], plp(g))


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_with_all_isolates_slot(backend):
    iso = from_numpy_edges(E, E, n=5, device="cpu")
    g = _sbm_graphs([60], seed0=70)[0]
    cfg = LouvainConfig(backend=backend)
    out = louvain_batch([iso, g], cfg)
    assert_louvain_equal(out[0], louvain(iso, cfg))
    assert out[0].n_communities == 5 and out[0].modularity == 0.0
    assert_louvain_equal(out[1], louvain(g, cfg))
    pcfg = PLPConfig(backend=backend)
    pout = plp_batch([iso, g], pcfg)
    assert_plp_equal(pout[0], plp(iso, pcfg))
    assert_plp_equal(pout[1], plp(g, pcfg))


# -------------------------------------------------------------- resilience


def test_nan_weight_names_exactly_the_graphs_that_reached_level_1():
    iso = from_numpy_edges(E, E, n=5, device="cpu")
    gs = _sbm_graphs([40, 90], seed0=80)
    batch = [gs[0], iso, gs[1], iso]
    clean = louvain_batch(batch)
    reached = [i for i, r in enumerate(clean) if r.levels > 1]
    assert reached == [0, 2]
    with faultinject.inject("nan_weight"):
        with pytest.raises(NumericError) as info:
            louvain_batch(batch)
    assert f"graph(s) {reached}" in str(info.value)
    with faultinject.inject("nan_weight"):
        assert_louvain_equal(louvain_batch([iso])[0], louvain(iso))
        # PLP has no level loop: the fault does not reach it
        assert all(r.run_report.faults == ["nan_weight"]
                   for r in plp_batch(batch))


def _join_new_workers(before):
    for t in threading.enumerate():
        if t not in before and t.name == "repro-watchdog-worker":
            t.join()


@pytest.mark.parametrize("run", [louvain_batch, plp_batch])
def test_deadline_under_slow_dispatch_raises_deadline_error(run, monkeypatch):
    monkeypatch.setenv(faultinject.SLOW_DISPATCH_ENV, "1.5")
    gs = _sbm_graphs([40, 50], seed0=95)
    before = set(threading.enumerate())
    fired = telemetry.get("resilience.watchdog_fired")
    try:
        with faultinject.inject("slow_dispatch"):
            with pytest.raises(DeadlineError):
                run(gs, deadline_s=0.3)
    finally:
        # the abandoned worker sleeps out its stall, then runs its chunk
        _join_new_workers(before)
    assert telemetry.get("resilience.watchdog_fired") == fired + 1
    # with time to spare the watchdogged call answers as the clean one does
    for a, b in zip(run(gs, deadline_s=60.0), run(gs)):
        assert np.array_equal(a.labels, b.labels)


def test_transient_batch_fail_raises_kernel_error():
    from repro_torch.utils.errors import KernelError

    g = _sbm_graphs([40])
    with faultinject.inject("transient_batch_fail"):
        with pytest.raises(KernelError, match="transient"):
            louvain_batch(g)

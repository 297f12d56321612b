"""Fault injection in the port — its counterpart of ``tests/test_faults.py``
for the sites the port has.

The contract: every armed fault point either lands on a fallback path
whose result is BIT-IDENTICAL to the clean run, or raises a typed
``CommunityDetectionError`` with a populated ``RunReport`` — never a
silent wrong answer.  The registry (``repro_torch.utils.faultinject``) is
a copy of the JAX package's, held to the same arm / disarm / inject /
rate / burst / fuel / consume semantics.  Where a fault changes the run
(``oscillation``), the faulted run is also held against the JAX package's
run under the same fault.  A failing backend is not retried on another:
the error propagates and ``report.degradations`` stays empty.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core.louvain import LouvainConfig as JLouvainConfig
from repro.core.louvain import louvain as jlouvain
from repro.core.plp import PLPConfig as JPLPConfig
from repro.core.plp import plp as jplp
from repro.graph.builders import from_numpy_edges
from repro.graph.generators import sbm
from repro.utils import faultinject as jfaultinject
from repro_torch.core.engine import EngineSpec
from repro_torch.core.louvain import LouvainConfig, leiden, louvain
from repro_torch.core.plp import PLPConfig, plp
from repro_torch.graph.structure import graph_from_numpy
from repro_torch.utils import faultinject, telemetry
from repro_torch.utils.errors import KernelError, NumericError

engine_mod = importlib.import_module("repro_torch.core.engine")


def to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_port_faults():
    """No test may leak armed port fault points into the next."""
    yield
    faultinject.disarm()


@pytest.fixture(scope="module")
def jgraph():
    u, v, w, _ = sbm(200, 4, p_in=0.3, p_out=0.02, seed=3)
    return from_numpy_edges(u, v, w)


@pytest.fixture(scope="module")
def graph(jgraph):
    return to_torch(jgraph)


def _banded(n=8192):
    """Louvain tables past half the shared-memory budget with narrow
    windows: level 0's W = 16 bucket streams under ``auto``."""
    rng = np.random.default_rng(5)
    u = np.repeat(np.arange(n), 3)
    v = np.clip(u + rng.integers(1, 40, size=u.size), 0, n - 1)
    u, v = u[u != v], v[u != v]
    return to_torch(from_numpy_edges(np.concatenate([u, v]),
                                     np.concatenate([v, u]), n=n))


def _same_result(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.modularity == b.modularity
    assert a.n_comm_per_level == b.n_comm_per_level
    assert a.sweeps_per_level == b.sweeps_per_level


# ------------------------------------------------------------------ registry


class TestRegistry:
    def test_same_points_as_the_jax_package(self):
        assert faultinject.FAULT_POINTS == jfaultinject.FAULT_POINTS
        assert faultinject.FAULT_ENV == jfaultinject.FAULT_ENV

    def test_unknown_point_rejected(self):
        with pytest.raises(ValueError, match="unknown fault"):
            faultinject.is_active("not_a_fault")
        with pytest.raises(ValueError, match="unknown fault"):
            faultinject.arm("not_a_fault")

    def test_unknown_point_in_env_rejected(self, monkeypatch):
        monkeypatch.setenv(faultinject.FAULT_ENV, "nan_weight,bogus")
        with pytest.raises(ValueError, match="bogus"):
            faultinject.disarm()
        monkeypatch.delenv(faultinject.FAULT_ENV)

    def test_arm_disarm_inject(self):
        assert faultinject.active() == frozenset()
        faultinject.arm("oscillation")
        assert faultinject.is_active("oscillation")
        assert telemetry.get("fault.armed.oscillation") > 0
        faultinject.disarm("oscillation")
        assert not faultinject.is_active("oscillation")
        with faultinject.inject("nan_weight", "binned_overflow"):
            assert faultinject.active() == {"nan_weight", "binned_overflow"}
        assert faultinject.active() == frozenset()

    def test_inject_restores_on_exception(self):
        with pytest.raises(RuntimeError):
            with faultinject.inject("nan_weight"):
                raise RuntimeError("boom")
        assert faultinject.active() == frozenset()

    def test_nested_inject_each_level_restores_what_it_saw(self):
        with faultinject.inject("nan_weight"):
            with faultinject.inject("oscillation", "vmem_starve"):
                assert faultinject.active() == {
                    "nan_weight", "oscillation", "vmem_starve"}
                with faultinject.inject("nan_weight"):
                    assert "nan_weight" in faultinject.active()
                assert "nan_weight" in faultinject.active()
            assert faultinject.active() == {"nan_weight"}
        assert faultinject.active() == frozenset()

    def test_bare_disarm_restores_env_baseline(self, monkeypatch):
        monkeypatch.setenv(faultinject.FAULT_ENV, "oscillation,nan_weight")
        faultinject.arm("vmem_starve")
        faultinject.disarm()
        assert faultinject.active() == {"oscillation", "nan_weight"}
        monkeypatch.delenv(faultinject.FAULT_ENV)
        faultinject.disarm()
        assert faultinject.active() == frozenset()

    def test_rate_schedule_is_bresenham_exact(self):
        faultinject.arm("transient_batch_fail")
        faultinject.set_rate("transient_batch_fail", 0.25)
        fires = [faultinject.should_fire("transient_batch_fail")
                 for _ in range(20)]
        assert sum(fires) == 5          # exactly ⌊20 · 0.25⌋, no RNG
        assert fires == fires[:4] * 5   # periodic: every 4th query
        faultinject.disarm()
        assert not faultinject.should_fire("transient_batch_fail")
        with pytest.raises(ValueError, match="rate"):
            faultinject.set_rate("transient_batch_fail", 1.5)

    def test_burst_turns_one_fire_into_consecutive_fires(self):
        faultinject.arm("transient_batch_fail")
        faultinject.set_rate("transient_batch_fail", 0.2)
        faultinject.set_burst("transient_batch_fail", 3)
        fires = [faultinject.should_fire("transient_batch_fail")
                 for _ in range(10)]
        assert fires == [False] * 4 + [True] * 3 + [False] * 3
        with pytest.raises(ValueError, match="burst"):
            faultinject.set_burst("transient_batch_fail", 0)

    def test_fuel_bounds_total_fires(self):
        faultinject.arm("slow_dispatch")
        faultinject.set_fuel("slow_dispatch", 2)
        fires = [faultinject.should_fire("slow_dispatch") for _ in range(5)]
        assert fires == [True, True, False, False, False]
        assert telemetry.get("fault.fired.slow_dispatch") >= 2

    def test_consume_fires_once_then_self_disarms(self):
        faultinject.arm("preempt_stage")
        assert faultinject.consume("preempt_stage")
        assert not faultinject.is_active("preempt_stage")
        assert not faultinject.consume("preempt_stage")

    def test_engine_spec_rejects_unknown_faults(self):
        with pytest.raises(ValueError, match="unknown fault"):
            EngineSpec(evaluator="plp", backend="segment",
                       faults=("not_a_fault",))
        assert EngineSpec(faults=("oscillation",)).faults == ("oscillation",)


# ------------------------------------------------------- typed-error faults


@pytest.mark.parametrize("run", [louvain, leiden])
@pytest.mark.parametrize("pipeline_fused", [True, False])
def test_nan_weight_raises_numeric(graph, run, pipeline_fused):
    """Level 1's graph is poisoned on a copy: the guard raises
    ``NumericError`` with the fault in its report, on both drivers, and
    the caller's graph is untouched."""
    w0 = graph.w.clone()
    with faultinject.inject("nan_weight"):
        with pytest.raises(NumericError, match="level 1") as ei:
            run(graph, LouvainConfig(pipeline_fused=pipeline_fused))
    assert ei.value.report.faults == ["nan_weight"]
    assert torch.equal(graph.w, w0)


# --------------------------------------------------- bit-identical fallbacks


@pytest.mark.parametrize("run", [louvain, leiden])
def test_binned_overflow_forces_sort_fallback(graph, run):
    clean = run(graph, LouvainConfig())
    assert "binned" in clean.aggregation_per_level
    telemetry.reset()
    with faultinject.inject("binned_overflow"):
        faulted = run(graph, LouvainConfig())
    _same_result(clean, faulted)
    assert faulted.run_report.faults == ["binned_overflow"]
    assert telemetry.get("fault.binned_overflow.forced") > 0
    assert faulted.aggregation_per_level == [
        "sort_fallback" if p == "binned" else p
        for p in clean.aggregation_per_level]


def test_vmem_starve_is_bit_identical(graph):
    clean = louvain(graph, LouvainConfig(backend="pallas"))
    telemetry.reset()
    with faultinject.inject("vmem_starve"):
        starved = louvain(graph, LouvainConfig(backend="pallas"))
    _same_result(clean, starved)
    assert telemetry.get("fault.vmem_starve.budget_clamped") > 0
    assert starved.run_report.faults == ["vmem_starve"]


def test_vmem_starve_keeps_every_bucket_resident():
    """The trap of the card's rule: a bucket that streams under ``auto``
    goes RESIDENT under a 1 KB budget (its windows no longer fit half of
    it) — and the answer stays the clean one."""
    g = _banded()
    cfg = LouvainConfig(backend="pallas", pipeline_fused=False)
    telemetry.reset()
    clean = louvain(g, cfg)
    assert telemetry.get("local_move.streamed.w16") > 0
    telemetry.reset()
    with faultinject.inject("vmem_starve"):
        starved = louvain(g, cfg)
    assert telemetry.get("local_move.streamed.w16") == 0
    assert telemetry.get("local_move.resident.w16") > 0
    assert telemetry.get("fault.vmem_starve.budget_clamped") > 0
    _same_result(clean, starved)


# --------------------------------------------------------- oscillation


def test_oscillation_bounded_by_sweep_watchdog(jgraph, graph):
    """move_prob=1.0 (pure Jacobi): a converged labeling is a fixpoint, so
    the forced re-sweeps only burn the watchdog budget, which the report
    records — and the faulted run equals the JAX package's."""
    kw = dict(move_prob=1.0, use_need_check=False, max_sweeps=6)
    cfg = LouvainConfig(**kw)
    clean = louvain(graph, cfg)
    with faultinject.inject("oscillation"):
        faulted = louvain(graph, cfg)
    np.testing.assert_array_equal(clean.labels, faulted.labels)
    assert clean.modularity == faulted.modularity
    assert all(s == cfg.max_sweeps for s in faulted.sweeps_per_level)
    assert any(w.startswith("watchdog:max_sweeps")
               for w in faulted.run_report.warnings)
    assert not faulted.run_report.clean
    with jfaultinject.inject("oscillation"):
        ref = jlouvain(jgraph, JLouvainConfig(**kw))
    np.testing.assert_array_equal(ref.labels, faulted.labels)
    assert ref.sweeps_per_level == faulted.sweeps_per_level
    assert ref.delta_n_per_level == faulted.delta_n_per_level
    assert ref.run_report.as_dict() == faulted.run_report.as_dict()


def test_oscillation_plp_watchdog(jgraph, graph):
    cfg = PLPConfig(move_prob=1.0, use_frontier=False, max_iterations=5)
    clean = plp(graph, cfg)
    with faultinject.inject("oscillation"):
        faulted = plp(graph, cfg)
    np.testing.assert_array_equal(clean.labels, faulted.labels)
    assert faulted.iterations == cfg.max_iterations
    assert "watchdog:max_iterations" in faulted.run_report.warnings
    assert faulted.run_report.faults == ["oscillation"]
    with jfaultinject.inject("oscillation"):
        ref = jplp(jgraph, JPLPConfig(move_prob=1.0, use_frontier=False,
                                      max_iterations=5))
    assert ref.delta_n_history == faulted.delta_n_history


# ------------------------------------------------------- no descent


@pytest.mark.parametrize("error", [KernelError, RuntimeError])
def test_backend_failure_propagates_without_descent(graph, monkeypatch,
                                                    error):
    """A failing evaluator on ``pallas`` is not retried on another backend:
    the error propagates (a taxonomy error carries the run's report, whose
    ``degradations`` stay empty)."""
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise error("synthetic kernel failure")

    monkeypatch.setattr(engine_mod, "_evaluate_ell", broken)
    with pytest.raises(error, match="synthetic") as ei:
        louvain(graph, LouvainConfig(backend="pallas"))
    assert calls == [1]
    if error is KernelError:
        assert ei.value.report.degradations == []
        assert ei.value.report.retries == []


def test_clean_run_report_is_clean(graph):
    for res in (louvain(graph, LouvainConfig()),
                leiden(graph, LouvainConfig()), plp(graph, PLPConfig())):
        assert res.run_report.faults == []
        assert res.run_report.as_dict()["faults"] == []
        assert res.run_report.degradations == []

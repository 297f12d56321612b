"""The port's community-detection service (``repro_torch.launch.
community_serve``) — its counterpart of the JAX side's service tests:
``tests/test_batch.py::test_serve_engine_end_to_end``,
``tests/test_resilience.py::TestServeResilience`` and
``tests/test_chaos.py``.

The engine serves on the CPU here (``device="cpu"``).  Clean responses are
held bit for bit against the port's single-graph drivers on the same
request (and one of them against the JAX package's ``louvain``); under
every fault point every accepted request is answered, with a result or a
typed error, inside an in-test watchdog.  Tests that stall a dispatch past
its deadline join the abandoned watchdog worker before they end, so its
late work lands in no other test.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.core.louvain import LouvainConfig, louvain
from repro_torch.core.plp import PLPConfig, plp
from repro_torch.graph.builders import from_numpy_edges
from repro_torch.graph.generators import sbm
from repro_torch.kernels.common import capacity_signature
from repro_torch.launch.community_serve import (CommunityRequest,
                                                CommunityServeEngine,
                                                _estimate_cost, _smoke,
                                                smoke_requests)
from repro_torch.utils import faultinject, resilience, telemetry

FLUSH_DEADLINE_S = 300.0


@pytest.fixture(autouse=True)
def _no_leaked_port_faults():
    """No test may leak armed port fault points into the next."""
    yield
    faultinject.disarm()


@pytest.fixture
def join_workers():
    """Join the watchdog workers a test abandoned (they sleep out their
    stall, then run their chunk)."""
    before = set(threading.enumerate())
    yield
    for t in threading.enumerate():
        if t not in before and t.name == "repro-watchdog-worker":
            t.join()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _engine(**kw):
    return CommunityServeEngine(device="cpu", **kw)


def _reqs(count, n=40, seed0=500, deadline_ms=None, algo="louvain"):
    out = []
    for i in range(count):
        u, v, _w, _t = sbm(n, 4, p_in=0.3, p_out=0.02, seed=seed0 + i)
        out.append(CommunityRequest(request_id=f"q{i}", u=u, v=v, n=n,
                                    algo=algo, deadline_ms=deadline_ms))
    return out


def _single(req, lcfg=LouvainConfig(), pcfg=PLPConfig()):
    g = from_numpy_edges(req.u, req.v, req.w, n=req.n, device="cpu")
    return louvain(g, lcfg) if req.algo == "louvain" else plp(g, pcfg)


def assert_same_result(res, ref):
    assert np.array_equal(res.labels, ref.labels)
    if hasattr(ref, "modularity"):
        for f in ("modularity", "modularity_history", "levels",
                  "n_communities", "sweeps_per_level", "delta_n_per_level"):
            assert getattr(res, f) == getattr(ref, f), f
    else:
        for f in ("iterations", "delta_n_history", "active_history"):
            assert getattr(res, f) == getattr(ref, f), f


# ------------------------------------------------------------- end to end


def test_serve_engine_end_to_end():
    from repro.core.louvain import louvain as jlouvain
    from repro.graph.builders import from_numpy_edges as jfrom_numpy_edges

    eng = _engine()
    assert eng.device.type == "cpu"
    sizes = [50, 80, 120, 50]
    reqs = []
    for i, n in enumerate(sizes):
        u, v, _w, _t = sbm(n, 4, p_in=0.3, p_out=0.02, seed=80 + i)
        reqs.append(CommunityRequest(request_id=f"r{i}", u=u, v=v, n=n,
                                     algo="plp" if i == 3 else "louvain"))
        eng.submit(reqs[-1])
    # poisoned request: rejected at ingest, never joins a batch
    eng.submit(CommunityRequest(
        request_id="bad", u=np.array([0, 1]), v=np.array([1, 2]),
        w=np.array([np.nan, 1.0])))
    assert eng.pending() == 4
    resp = eng.flush()
    assert [r.request_id for r in resp] == ["r0", "r1", "r2", "r3", "bad"]
    by_id = {r.request_id: r for r in resp}
    assert not by_id["bad"].ok and "InputValidationError" in by_id["bad"].error
    for req, n in zip(reqs, sizes):
        r = by_id[req.request_id]
        assert r.ok and r.labels.shape == (n,)
        assert r.latency_s > 0 and r.batch_size >= 1
        assert_same_result(r.result, _single(req))
    # the JAX package's louvain() on the same request, once
    j = jlouvain(jfrom_numpy_edges(reqs[0].u, reqs[0].v, n=50))
    assert np.array_equal(by_id["r0"].labels, np.asarray(j.labels))
    assert by_id["r0"].result.modularity == pytest.approx(j.modularity,
                                                          rel=1e-6)
    stats = eng.stats()
    assert stats["served"] == 4 and stats["pending"] == 0
    assert "programs" not in stats
    assert stats["counters"].get("serve.ingest_reject", 0) >= 1
    # a second flush serves fresh same-signature traffic in one dispatch
    dispatches0 = eng.stats()["dispatches"]
    u, v, _w, _t = sbm(66, 4, p_in=0.3, p_out=0.02, seed=99)
    r9q = CommunityRequest(request_id="r9", u=u, v=v, n=66)
    eng.submit(r9q)
    r9 = eng.flush()[0]
    assert r9.ok and eng.stats()["dispatches"] == dispatches0 + 1
    assert_same_result(r9.result, _single(r9q))


@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_clean_traffic_takes_no_sequential_route(backend):
    """The smoke's traffic (two signatures, W = 16 and 64) on one backend:
    every response equals its single-graph run on that backend, and the
    sequential ladder is never taken."""
    lcfg, pcfg = LouvainConfig(backend=backend), PLPConfig(backend=backend)
    eng = _engine(louvain_cfg=lcfg, plp_cfg=pcfg, max_batch=8)
    reqs = smoke_requests(12, 60000.0)
    seq0 = (telemetry.get("serve.batch_fallback_sequential"),
            telemetry.get("serve.breaker_routed_sequential"))
    for r in reqs:
        assert eng.submit(r) is None
    resp = eng.flush()
    assert [r.request_id for r in resp] == [r.request_id for r in reqs]
    widths = set()
    for req, r in zip(reqs, resp):
        assert r.ok
        assert_same_result(r.result, _single(req, lcfg, pcfg))
        widths.add(r.signature[2])
    assert widths == {16, 64}
    assert (telemetry.get("serve.batch_fallback_sequential"),
            telemetry.get("serve.breaker_routed_sequential")) == seq0


# ---------------------------------------------------------- resilience


class TestServeResilience:
    def test_admission_sheds_on_depth_with_typed_overload(self):
        telemetry.reset()
        eng = _engine(max_queue_depth=2)
        accepted = [eng.submit(r) for r in _reqs(2)]
        assert accepted == [None, None]
        shed = eng.submit(_reqs(1, seed0=900)[0])
        assert shed is not None and not shed.ok
        assert "OverloadError" in shed.error and "depth" in shed.error
        assert eng.pending() == 2
        assert eng.stats()["shed"] == 1
        assert all(r.ok for r in eng.flush())

    def test_admission_sheds_on_estimated_cost(self):
        reqs = _reqs(3)
        cost1 = _estimate_cost(reqs[0])
        sig = capacity_signature(40, 2 * len(reqs[0].u))
        assert cost1 == sig.n_cap + sig.m_cap
        eng = _engine(max_queue_cost=2 * cost1)
        assert eng.submit(reqs[0]) is None
        assert eng.submit(reqs[1]) is None
        shed = eng.submit(reqs[2])
        assert shed is not None and "OverloadError" in shed.error
        assert eng.stats()["queued_cost"] == 2 * cost1
        eng.flush()
        assert eng.stats()["queued_cost"] == 0

    def test_deadline_miss_fails_only_with_typed_error(self, monkeypatch,
                                                       join_workers):
        monkeypatch.setenv(faultinject.SLOW_DISPATCH_ENV, "2.0")
        fired = telemetry.get("resilience.watchdog_fired")
        eng = _engine(max_retries=0)
        for r in _reqs(2, deadline_ms=400.0):
            eng.submit(r)
        t = time.perf_counter()
        with faultinject.inject("slow_dispatch"):
            resp = eng.flush()
        assert time.perf_counter() - t < 1.5
        assert len(resp) == 2
        for r in resp:
            assert not r.ok and "DeadlineError" in r.error
            assert r.report is not None
        assert telemetry.get("resilience.watchdog_fired") >= fired + 1

    def test_expired_while_queued_fails_before_dispatching(self):
        eng = _engine()
        for r in _reqs(1, deadline_ms=0.5):
            eng.submit(r)
        time.sleep(0.01)
        dispatches0 = eng.stats()["dispatches"]
        graphs0 = telemetry.get("batch.louvain_graphs")
        resp = eng.flush()
        assert not resp[0].ok and "DeadlineError" in resp[0].error
        # the group dispatch ran but never reached the batch engine
        assert eng.stats()["dispatches"] == dispatches0 + 1
        assert telemetry.get("batch.louvain_graphs") == graphs0
        assert eng.stats()["counters"].get(
            "serve.deadline_expired_queued", 0) >= 1

    def test_transient_batch_failure_retries_to_success(self):
        telemetry.reset()
        eng = _engine(max_retries=2, backoff_base_s=0.01)
        reqs = _reqs(2)
        for r in reqs:
            eng.submit(r)
        faultinject.arm("transient_batch_fail")
        faultinject.set_fuel("transient_batch_fail", 1)   # one-shot fault
        try:
            resp = eng.flush()
        finally:
            faultinject.disarm()
        assert all(r.ok for r in resp)
        for req, r in zip(reqs, resp):
            assert_same_result(r.result, _single(req))
        c = eng.stats()["counters"]
        assert c.get("serve.retry", 0) == 1
        assert c.get("serve.batch_fallback_sequential", 0) == 0
        assert all(b["state"] == "closed"
                   for b in eng.stats()["breakers"].values())

    def test_breaker_trips_routes_sequential_and_probes_back(self):
        telemetry.reset()
        clk = FakeClock()
        br = resilience.CircuitBreaker(threshold=2, reset_after_s=30.0,
                                       name="serve", clock=clk)
        eng = _engine(max_retries=0, breaker=br)
        reqs = _reqs(6, seed0=700)

        faultinject.arm("transient_batch_fail")
        try:
            for r in reqs[:2]:
                eng.submit(r)
            resp = eng.flush()
            assert all(r.ok for r in resp)
            # the sequential ladder runs the same driver and config
            for req, r in zip(reqs[:2], resp):
                assert_same_result(r.result, _single(req))
            for r in reqs[2:3]:
                eng.submit(r)
            assert all(r.ok for r in eng.flush())
            key = next(iter(eng.stats()["breakers"]))
            assert eng.stats()["breakers"][key]["state"] == "open"

            trips0 = telemetry.get("serve.breaker_trip")
            door = eng.submit(reqs[3])
            assert door is not None and not door.ok
            assert "OverloadError" in door.error and "breaker" in door.error
            assert eng.pending() == 0
            assert telemetry.get("serve.breaker_trip") == trips0
            assert telemetry.get("serve.breaker_reject") == 1

            clk.advance(31.0)
            assert eng.submit(reqs[4]) is None
            assert all(r.ok for r in eng.flush())   # sequential fallback
            assert eng.stats()["breakers"][key]["state"] == "open"
        finally:
            faultinject.disarm()

        clk.advance(31.0)
        assert eng.submit(reqs[5]) is None
        assert all(r.ok for r in eng.flush())
        assert eng.stats()["breakers"][key]["state"] == "closed"
        assert telemetry.get("serve.breaker_close") == 1
        assert telemetry.get("serve.batch_fallback_sequential") == 3

    def test_open_breaker_routes_queued_members_around_batched_path(self):
        telemetry.reset()
        br = resilience.CircuitBreaker(threshold=1, reset_after_s=1e9,
                                       name="serve")
        eng = _engine(max_retries=0, breaker=br)
        req = _reqs(1, seed0=760)[0]
        assert eng.submit(req) is None
        q = eng._queue[0]
        key = ("louvain",
               tuple(capacity_signature(q.graph.n_max, q.graph.m_max)))
        br.record_failure(key)                      # trips between ticks
        assert br.state(key) == "open"
        resp = eng.flush()
        assert resp[0].ok
        assert_same_result(resp[0].result, _single(req))
        assert telemetry.get("serve.breaker_routed_sequential") == 1
        assert br.state(key) == "open"              # success didn't feed it
        assert br.snapshot()[repr(key)]["failures"] == 1


# ---------------------------------------------------------------- chaos


def _traffic(eng, count=4, deadline_ms=None):
    accepted = []
    for i in range(count):
        n = 24 if i % 2 else 48
        u, v, _w, _t = sbm(n, 3, p_in=0.35, p_out=0.03, seed=40 + i)
        req = CommunityRequest(request_id=f"c{i}", u=u, v=v, n=n,
                               algo="plp" if i == 3 else "louvain",
                               deadline_ms=deadline_ms)
        if eng.submit(req) is None:
            accepted.append(req.request_id)
    return accepted


@pytest.mark.parametrize("fault", faultinject.FAULT_POINTS)
def test_service_answers_everything_under_fault(fault):
    eng = _engine(max_retries=1, backoff_base_s=0.01)
    with faultinject.inject(fault):
        accepted = _traffic(eng)
        responses = resilience.call_with_deadline(eng.flush,
                                                  FLUSH_DEADLINE_S)
    assert {r.request_id for r in responses} == set(accepted)
    for r in responses:
        if r.ok:
            assert r.labels is not None
        else:
            assert r.error and r.error.split(":")[0].endswith("Error")
    if fault == "nan_weight":
        # the Louvain requests reach level 1 and are poisoned there
        assert sorted(r.request_id for r in responses if not r.ok) \
            == ["c0", "c1", "c2"]
    accepted2 = _traffic(eng, count=2)
    responses2 = resilience.call_with_deadline(eng.flush, FLUSH_DEADLINE_S)
    assert {r.request_id for r in responses2} == set(accepted2)
    assert all(r.ok for r in responses2)


def test_service_answers_everything_under_paired_faults():
    eng = _engine(max_retries=1, backoff_base_s=0.01)
    with faultinject.inject("slow_dispatch", "transient_batch_fail"):
        faultinject.set_rate("transient_batch_fail", 0.5)
        try:
            accepted = _traffic(eng)
            responses = resilience.call_with_deadline(eng.flush,
                                                      FLUSH_DEADLINE_S)
        finally:
            faultinject.disarm("transient_batch_fail", "slow_dispatch")
    assert {r.request_id for r in responses} == set(accepted)
    assert all(r.ok or r.error for r in responses)


def test_deadlined_traffic_under_stall_is_split_not_hung(monkeypatch,
                                                         join_workers):
    monkeypatch.setenv(faultinject.SLOW_DISPATCH_ENV, "3.0")
    eng = _engine(max_retries=0)
    t = time.perf_counter()
    with faultinject.inject("slow_dispatch"):
        accepted = _traffic(eng, count=2, deadline_ms=500.0)
        responses = resilience.call_with_deadline(eng.flush, 60.0)
    assert time.perf_counter() - t < 2.5
    assert {r.request_id for r in responses} == set(accepted)
    assert all(not r.ok and "DeadlineError" in r.error for r in responses)


def test_smoke_entrypoint_is_clean(capsys):
    assert _smoke(n_requests=4, deadline_ms=60000.0, device="cpu") == 0
    assert '"ok": 4' in capsys.readouterr().out

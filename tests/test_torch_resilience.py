"""Resilience in the port: the host primitives of
``repro_torch.utils.resilience`` (the JAX package's cases of
``tests/test_resilience.py``: deadlines and the watchdog, backoff,
retryability over the error taxonomy, the circuit breaker), the
checkpointer ``repro_torch.train.checkpoint``, and the cascade's
stage-boundary checkpoint/resume: a run killed by ``preempt_stage`` right
after a boundary committed, then rerun, resumes from that boundary and
equals the uninterrupted run — the port's and the JAX package's — for
Louvain and for Leiden.  A checkpoint of another config is ignored, and a
clean run leaves no ``step_*`` directory.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.core.louvain import LouvainConfig as JLouvainConfig
from repro.core.louvain import louvain as jlouvain
from repro.graph.builders import from_numpy_edges
from repro_torch.core.louvain import LouvainConfig, leiden, louvain
from repro_torch.graph.structure import graph_from_numpy
from repro_torch.train import checkpoint
from repro_torch.utils import faultinject, resilience, telemetry
from repro_torch.utils.errors import (CapacityError, DeadlineError,
                                      KernelError, NumericError,
                                      OverloadError)

INT_FIELDS = ("n_communities", "levels", "sweeps_per_level",
              "n_comm_per_level", "delta_n_per_level", "cascade_stages")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _no_leaked_port_faults():
    yield
    faultinject.disarm()


# ------------------------------------------------------------------ deadlines


class TestDeadline:
    def test_remaining_and_expiry_follow_the_clock(self):
        clk = FakeClock()
        d = resilience.Deadline(1.5, clock=clk)
        assert d.remaining_s() == pytest.approx(1.5)
        clk.advance(1.0)
        assert d.remaining_s() == pytest.approx(0.5)
        assert not d.expired
        clk.advance(0.6)
        assert d.expired

    def test_min_remaining_skips_none_members(self):
        clk = FakeClock()
        a = resilience.Deadline(2.0, clock=clk)
        b = resilience.Deadline(0.7, clock=clk)
        assert resilience.min_remaining_s([a, None, b]) == pytest.approx(0.7)
        assert resilience.min_remaining_s([None, None]) is None
        assert resilience.min_remaining_s([]) is None

    def test_call_inline_when_no_deadline(self):
        assert resilience.call_with_deadline(lambda: 41 + 1, None) == 42

    def test_preflight_expired_never_dispatches(self):
        calls = []
        with pytest.raises(DeadlineError, match="already expired"):
            resilience.call_with_deadline(lambda: calls.append(1), -0.1)
        assert not calls

    def test_watchdog_cancels_a_hung_call(self):
        telemetry.reset()
        t0 = time.perf_counter()
        with pytest.raises(DeadlineError, match="watchdog"):
            resilience.call_with_deadline(lambda: time.sleep(5.0), 0.1)
        assert time.perf_counter() - t0 < 2.0   # released on time, not at 5s
        assert telemetry.get("resilience.watchdog_fired") == 1

    def test_result_and_exception_relay(self):
        assert resilience.call_with_deadline(lambda: "ok", 5.0) == "ok"

        def boom():
            raise NumericError("typed boom")

        with pytest.raises(NumericError, match="typed boom"):
            resilience.call_with_deadline(boom, 5.0)

        def killed():
            raise resilience.Preempted("kill relays too")

        with pytest.raises(resilience.Preempted):
            resilience.call_with_deadline(killed, 5.0)


# -------------------------------------------------------------------- retries


class TestBackoffAndRetryability:
    def test_backoff_is_deterministic_and_bounded(self):
        a = list(resilience.backoff_delays(6, base_s=0.1, max_s=0.5, seed=7))
        b = list(resilience.backoff_delays(6, base_s=0.1, max_s=0.5, seed=7))
        assert a == b
        assert all(d <= 0.5 * 1.5 for d in a)       # max_s · (1 + jitter)
        assert all(d >= 0.05 for d in a)            # base · (1 - jitter)
        assert a != list(resilience.backoff_delays(6, base_s=0.1, max_s=0.5,
                                                   seed=8))

    def test_backoff_matches_the_jax_package(self):
        from repro.utils import resilience as jresilience

        assert list(resilience.backoff_delays(5, seed=3)) == list(
            jresilience.backoff_delays(5, seed=3))

    def test_backoff_rejects_degenerate_jitter(self):
        with pytest.raises(ValueError, match="jitter"):
            list(resilience.backoff_delays(2, jitter=1.0))

    def test_retryability_follows_the_taxonomy(self):
        assert resilience.is_retryable(KernelError("transient infra"))
        assert resilience.is_retryable(RuntimeError("infra surprise"))
        assert not resilience.is_retryable(NumericError("unsafe answer"))
        assert not resilience.is_retryable(CapacityError("won't fit again"))
        assert not resilience.is_retryable(DeadlineError("budget spent"))
        assert not resilience.is_retryable(OverloadError("shed"))
        assert not resilience.is_retryable(resilience.Preempted("kill"))
        assert not resilience.is_retryable(KeyboardInterrupt())
        assert not isinstance(resilience.Preempted("kill"), Exception)


# ------------------------------------------------------------ circuit breaker


class TestCircuitBreaker:
    def test_trips_at_threshold_and_probes_back(self):
        telemetry.reset()
        clk = FakeClock()
        br = resilience.CircuitBreaker(threshold=3, reset_after_s=10.0,
                                       name="t", clock=clk)
        assert br.state("sig") == "closed"
        br.record_failure("sig")
        br.record_failure("sig")
        assert br.state("sig") == "closed"
        br.record_failure("sig")
        assert br.state("sig") == "open"
        assert telemetry.get("t.breaker_trip") == 1
        clk.advance(9.0)
        assert br.state("sig") == "open"
        clk.advance(1.5)
        assert br.state("sig") == "half_open"
        br.record_success("sig")                    # probe succeeded
        assert br.state("sig") == "closed"
        assert telemetry.get("t.breaker_close") == 1
        assert telemetry.values()["t.breaker_open_s"]["last"] \
            == pytest.approx(10.5)

    def test_failed_probe_reopens_for_a_full_window(self):
        telemetry.reset()
        clk = FakeClock()
        br = resilience.CircuitBreaker(threshold=1, reset_after_s=5.0,
                                       name="t2", clock=clk)
        br.record_failure("k")
        assert br.state("k") == "open"
        clk.advance(5.1)
        assert br.state("k") == "half_open"
        br.record_failure("k")                      # probe failed
        assert br.state("k") == "open"
        clk.advance(4.9)
        assert br.state("k") == "open"              # fresh full window
        assert telemetry.get("t2.breaker_trip") == 2

    def test_success_resets_the_consecutive_count(self):
        br = resilience.CircuitBreaker(threshold=2, name="t3")
        br.record_failure("k")
        br.record_success("k")
        br.record_failure("k")
        assert br.state("k") == "closed"            # never 2 consecutive
        assert br.snapshot()["'k'"]["failures"] == 1

    def test_keys_are_independent(self):
        br = resilience.CircuitBreaker(threshold=1, name="t4")
        br.record_failure("bad")
        assert br.state("bad") == "open"
        assert br.state("good") == "closed"


# ------------------------------------------------------------ checkpointer


class TestCheckpointer:
    def _tree(self):
        return {"graph": [torch.arange(6, dtype=torch.int32),
                          torch.tensor([0.5, 1.5, -2.0]),
                          torch.tensor([True, False, True]), np.int64(9)],
                "half": torch.ones(4, dtype=torch.bfloat16) / 3,
                "level": np.int64(3)}

    def _like(self):
        def spec(n, dtype):
            return torch.empty(n, dtype=dtype, device="meta")

        return {"graph": [spec(6, torch.int32), spec(3, torch.float32),
                          spec(3, torch.bool), np.int64(0)],
                "half": spec(4, torch.bfloat16), "level": np.int64(0)}

    def test_round_trip_is_exact(self, tmp_path):
        tree = self._tree()
        checkpoint.save(str(tmp_path), 4, tree, config_json='{"a": [1]}')
        assert checkpoint.latest_step(str(tmp_path)) == 4
        assert checkpoint.read_config(str(tmp_path), 4) == {"a": [1]}
        out = checkpoint.restore(str(tmp_path), 4, self._like(),
                                 device="cpu")
        for a, b in zip(out["graph"][:3], tree["graph"][:3]):
            assert a.dtype == b.dtype and torch.equal(a, b)
            assert a.device.type == "cpu"
        assert int(out["graph"][3]) == 9 and int(out["level"]) == 3
        assert torch.equal(out["half"], tree["half"])

    def test_uncommitted_and_old_steps(self, tmp_path):
        d = str(tmp_path)
        for step in (1, 2, 3):
            checkpoint.save(d, step, self._tree(), keep=2)
        assert checkpoint.all_steps(d) == [2, 3]
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        assert checkpoint.latest_step(d) == 3
        assert checkpoint.latest_step(str(tmp_path / "absent")) is None

    def test_mismatches_are_refused(self, tmp_path):
        d = str(tmp_path)
        checkpoint.save(d, 1, self._tree(), config_json='{"a": 1}')
        with pytest.raises(ValueError, match="config mismatch"):
            checkpoint.restore(d, 1, self._like(), device="cpu",
                               expect_config='{"a": 2}')
        like = self._like()
        like["graph"][0] = torch.empty(7, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="shape"):
            checkpoint.restore(d, 1, like, device="cpu")
        like = self._like()
        like["extra"] = np.int64(0)
        with pytest.raises(KeyError, match="extra"):
            checkpoint.restore(d, 1, like, device="cpu")


# ------------------------------------------------- checkpoint/resume (kill)


def _ring_of_cliques(n=600, k=20):
    edges = []
    for c in range(n // k):
        base = c * k
        for i in range(k):
            for j in range(i + 1, k):
                edges.append((base + i, base + j))
        edges.append((base, ((c + 1) % (n // k)) * k))
    e = np.array(edges, np.int64)
    return from_numpy_edges(e[:, 0], e[:, 1], n=n)


@pytest.fixture(scope="module")
def ring():
    jg = _ring_of_cliques()
    return jg, graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


SCHEDULE = ((256, 2048),)


def _assert_same(a, b, exact_q=True):
    np.testing.assert_array_equal(a.labels, b.labels)
    for f in INT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    if exact_q:
        assert a.modularity == b.modularity
        assert a.modularity_history == b.modularity_history
    else:
        assert a.modularity == pytest.approx(b.modularity, rel=1e-6)
        assert a.modularity_history == pytest.approx(b.modularity_history,
                                                     rel=1e-6)


def _kill_then_resume(run, g, cfg, ckpt_dir):
    """Run with ``preempt_stage`` armed (it must raise after the first
    boundary committed), then rerun clean; returns the resumed result."""
    telemetry.reset()
    cfg_ck = cfg.replace(checkpoint_dir=str(ckpt_dir))
    with pytest.raises(resilience.Preempted):
        with faultinject.inject("preempt_stage"):
            run(g, cfg_ck)
    assert any(p.startswith("step_") for p in os.listdir(ckpt_dir))
    assert telemetry.get("louvain.ckpt_save") == 1
    manifest = json.loads((ckpt_dir / "step_00000001" /
                           "manifest.json").read_text())
    assert manifest["config"]["stage"]["k"] == 1
    resumed = run(g, cfg_ck)
    assert telemetry.get("louvain.ckpt_resume") == 1
    assert telemetry.get("louvain.ckpt_save") == 1
    assert not any(p.startswith("step_") for p in os.listdir(ckpt_dir))
    return resumed


class TestCheckpointResume:
    def test_mid_cascade_kill_resumes_bit_identical(self, ring, tmp_path):
        g = ring[1]
        cfg = LouvainConfig(capacity_schedule=SCHEDULE, backend="segment")
        oracle = louvain(g, cfg)
        assert len(oracle.cascade_stages) == 2  # the kill window exists
        resumed = _kill_then_resume(louvain, g, cfg, tmp_path)
        _assert_same(resumed, oracle)
        assert resumed.aggregation_per_level == oracle.aggregation_per_level
        assert resumed.run_report.as_dict() == oracle.run_report.as_dict()

    def test_mismatched_fingerprint_is_ignored_not_resumed(self, ring,
                                                           tmp_path):
        g = ring[1]
        cfg = LouvainConfig(capacity_schedule=SCHEDULE, backend="segment",
                            checkpoint_dir=str(tmp_path))
        with pytest.raises(resilience.Preempted):
            with faultinject.inject("preempt_stage"):
                louvain(g, cfg)
        telemetry.reset()
        # a different config must NOT resume someone else's stage state
        other = louvain(g, cfg.replace(seed=cfg.seed + 1))
        assert telemetry.get("louvain.ckpt_mismatch_ignored") == 1
        assert telemetry.get("louvain.ckpt_resume") == 0
        assert other.run_report.clean
        _assert_same(other, louvain(g, cfg.replace(seed=cfg.seed + 1,
                                                   checkpoint_dir=None)))

    def test_clean_run_with_checkpoint_dir_leaves_no_debris(self, ring,
                                                            tmp_path):
        g = ring[1]
        cfg = LouvainConfig(capacity_schedule=SCHEDULE, backend="segment",
                            checkpoint_dir=str(tmp_path))
        telemetry.reset()
        res = louvain(g, cfg)
        assert res.run_report.clean
        assert telemetry.get("louvain.ckpt_save") == 1
        assert not any(p.startswith("step_") for p in os.listdir(tmp_path))

    @pytest.mark.parametrize("backend", ["segment", "pallas"])
    def test_resumed_run_matches_jax_uninterrupted(self, ring, tmp_path,
                                                   backend):
        """The resumed port run ≡ the JAX package's uninterrupted run; the
        restored state lies on the graph's device."""
        jcfg = JLouvainConfig(capacity_schedule=SCHEDULE, backend=backend)
        ref = jlouvain(ring[0], jcfg)
        resumed = _kill_then_resume(
            louvain, ring[1], LouvainConfig.from_dict(jcfg.to_dict()),
            tmp_path)
        _assert_same(resumed, ref, exact_q=False)
        assert resumed.run_report.as_dict() == ref.run_report.as_dict()

    def test_leiden_kill_and_resume(self, ring, tmp_path):
        g = ring[1]
        cfg = LouvainConfig(capacity_schedule=SCHEDULE, backend="pallas")
        oracle = leiden(g, cfg)
        assert len(oracle.cascade_stages) == 2
        resumed = _kill_then_resume(leiden, g, cfg, tmp_path)
        _assert_same(resumed, oracle)
        assert resumed.aggregation_per_level == oracle.aggregation_per_level

    def test_single_stage_run_saves_nothing(self, ring, tmp_path):
        """A schedule that cannot cascade crosses no boundary: nothing is
        saved, and an armed ``preempt_stage`` never fires."""
        cfg = LouvainConfig(capacity_schedule="none",
                            checkpoint_dir=str(tmp_path))
        telemetry.reset()
        with faultinject.inject("preempt_stage"):
            louvain(ring[1], cfg)
        assert telemetry.get("louvain.ckpt_save") == 0
        assert os.listdir(tmp_path) == []

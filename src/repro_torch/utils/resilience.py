"""Serving-grade resilience primitives (a copy of the JAX package's
``repro.utils.resilience``; the port imports nothing of that package).

* ``Deadline`` / ``call_with_deadline`` — a host-side watchdog for device
  dispatches.  A launched CUDA kernel cannot be cancelled from the host, so
  the watchdog runs the dispatch in a daemon worker thread and ABANDONS it
  on timeout, raising a typed ``DeadlineError``: the caller is released on
  time even if the device work limps on in the background (the thread's
  eventual result is dropped).  ``timeout_s=None`` short-circuits to a
  plain call — the clean path never pays for a thread.
* ``Preempted`` — models SIGKILL/preemption at a host boundary.
  Deliberately a ``BaseException``: no retry ladder may swallow a kill;
  only the layers that genuinely survive one (a serving tick, the
  checkpoint/resume harness) catch it by name.
* ``backoff_delays`` — deterministic jittered exponential backoff for
  transient-failure retries (seeded ``random.Random``; no global RNG, so
  schedules are reproducible in tests and benchmarks).
* ``is_retryable`` — maps the error taxonomy (``utils.errors``) onto the
  retry decision: taxonomy errors other than ``KernelError`` mean the
  ANSWER is unsafe (retrying cannot help), deadline/overload mean the
  BUDGET is spent; ``KernelError`` and non-taxonomy exceptions are
  transient infra.
* ``CircuitBreaker`` — per-key closed → open → half-open breaker.  A key
  that keeps failing trips open so a service stops burning its deadline
  budget on a known-bad path and routes around it; after
  ``reset_after_s`` one half-open probe is allowed through — success
  closes the breaker, failure re-opens it.

The batched engine (``core.batch``) runs each chunk under
``call_with_deadline``; the service (``launch.community_serve``) uses the
rest; ``Preempted`` also fires at ``core.louvain``'s stage boundary.  An
abandoned worker thread runs its torch work on the default stream of the
graph's device and sets no global state.  Everything here is host-side
and thread-compatible.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Iterator, Optional, TypeVar

from repro_torch.utils import telemetry
from repro_torch.utils.errors import (CapacityError, CommunityDetectionError,
                                ConvergenceError, DeadlineError,
                                InputValidationError, KernelError,
                                NumericError, OverloadError, ShardError)

T = TypeVar("T")


class Preempted(BaseException):
    """The process was "killed" at a host boundary (fault point
    ``preempt_stage``, or a real SIGKILL in deployment modelling).

    A ``BaseException`` on purpose: no ``except Exception`` handler may
    absorb a preemption as a backend failure — it propagates until a layer
    that genuinely survives kills (a fresh process, which resumes from the
    stage checkpoint) handles it."""


# ------------------------------------------------------------------ deadlines


class Deadline:
    """A wall-clock budget anchored at construction time.

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.monotonic``).  ``None`` budgets are represented by NOT creating
    a Deadline — callers pass ``Optional[Deadline]`` around.
    """

    __slots__ = ("budget_s", "_t0", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = float(budget_s)
        self._clock = clock
        self._t0 = clock()

    def remaining_s(self) -> float:
        return self.budget_s - (self._clock() - self._t0)

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0


def min_remaining_s(deadlines) -> Optional[float]:
    """Tightest remaining budget among ``Optional[Deadline]`` members —
    the watchdog timeout of a batch that serves them all (``None`` when no
    member carries a deadline)."""
    rem = [d.remaining_s() for d in deadlines if d is not None]
    return min(rem) if rem else None


def call_with_deadline(fn: Callable[[], T],
                       timeout_s: Optional[float]) -> T:
    """Run ``fn()`` under a watchdog: raise ``DeadlineError`` if it has not
    returned within ``timeout_s`` seconds.

    ``timeout_s=None`` calls ``fn`` inline (zero overhead — the clean
    path).  Otherwise ``fn`` runs in a daemon worker thread; on timeout
    the thread is ABANDONED (its eventual result/exception is dropped) —
    launched kernels cannot be cancelled, only disowned.  Exceptions from
    ``fn`` (including ``BaseException`` like ``Preempted``) re-raise in
    the caller.
    """
    if timeout_s is None:
        return fn()
    if timeout_s <= 0:
        telemetry.bump("resilience.deadline_expired_preflight")
        raise DeadlineError(
            f"deadline already expired ({timeout_s:.3f}s remaining) — "
            "not dispatching")
    box: list = []

    def _run():
        try:
            box.append(("ok", fn()))
        except BaseException as err:  # noqa: BLE001 — relayed to caller
            box.append(("err", err))

    worker = threading.Thread(target=_run, daemon=True,
                              name="repro-watchdog-worker")
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        telemetry.bump("resilience.watchdog_fired")
        raise DeadlineError(
            f"dispatch exceeded its {timeout_s:.3f}s deadline; watchdog "
            "cancelled the wait (worker abandoned)")
    if not box:  # worker died without reporting (should not happen)
        raise KernelError("watchdog worker exited without a result")
    kind, val = box[0]
    if kind == "err":
        raise val
    return val


# -------------------------------------------------------------------- retries


def backoff_delays(attempts: int, base_s: float = 0.05, factor: float = 2.0,
                   jitter: float = 0.5, max_s: float = 2.0,
                   seed: int = 0) -> Iterator[float]:
    """Deterministic jittered exponential backoff: delay k is
    ``min(base·factor^k, max) · U[1-jitter, 1+jitter]`` with a private
    ``random.Random(seed)`` — same seed, same schedule (reproducible
    chaos runs), distinct seeds decorrelate retry storms across dispatch
    groups."""
    if jitter < 0 or jitter >= 1:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    rng = random.Random(seed)
    for k in range(attempts):
        d = min(base_s * (factor ** k), max_s)
        yield d * (1.0 - jitter + 2.0 * jitter * rng.random())


#: Taxonomy types whose meaning is "the ANSWER is unsafe" or "the BUDGET is
#: spent" — retrying the same inputs cannot help.
_NON_RETRYABLE = (InputValidationError, NumericError, CapacityError,
                  ConvergenceError, ShardError, DeadlineError, OverloadError)


def is_retryable(err: BaseException) -> bool:
    """Retry decision over the error taxonomy: ``KernelError`` (a backend
    failed — the classic transient: OOM, recompile crash, lost launch) and
    non-taxonomy ``Exception``s (infra surprises) are retryable; every
    other taxonomy type, and every ``BaseException`` (kills), is not."""
    if isinstance(err, _NON_RETRYABLE):
        return False
    if isinstance(err, KernelError):
        return True
    if isinstance(err, CommunityDetectionError):
        return False
    return isinstance(err, Exception)


# ------------------------------------------------------------ circuit breaker


class _BreakerEntry:
    __slots__ = ("failures", "state", "opened_at")

    def __init__(self):
        self.failures = 0
        self.state = "closed"
        self.opened_at = 0.0


class CircuitBreaker:
    """Per-key closed → open → half-open circuit breaker.

    ``record_failure(key)`` counts CONSECUTIVE failures; at ``threshold``
    the key trips open (counter ``{name}.breaker_trip``).  While open,
    ``state(key)`` returns ``"open"`` — callers route around the protected
    path — until ``reset_after_s`` has elapsed, when it returns
    ``"half_open"``: the caller may send ONE probe through.  A recorded
    success closes the breaker (``{name}.breaker_close``, open duration
    observed as ``{name}.breaker_open_s``); a failure re-opens it for
    another full ``reset_after_s`` (counted as a new trip).

    Single-owner discipline: its owner is synchronous, so no internal
    locking; ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, threshold: int = 3, reset_after_s: float = 30.0,
                 name: str = "serve",
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.reset_after_s = float(reset_after_s)
        self.name = name
        self._clock = clock
        self._keys: Dict[object, _BreakerEntry] = {}

    def _entry(self, key) -> _BreakerEntry:
        e = self._keys.get(key)
        if e is None:
            e = self._keys[key] = _BreakerEntry()
        return e

    def state(self, key) -> str:
        """``"closed"`` | ``"open"`` | ``"half_open"`` (open and due a
        probe)."""
        e = self._keys.get(key)
        if e is None or e.state == "closed":
            return "closed"
        if self._clock() - e.opened_at >= self.reset_after_s:
            return "half_open"
        return "open"

    def record_success(self, key) -> None:
        e = self._entry(key)
        if e.state == "open":
            telemetry.observe(f"{self.name}.breaker_open_s",
                              self._clock() - e.opened_at)
            telemetry.bump(f"{self.name}.breaker_close")
        e.state = "closed"
        e.failures = 0

    def record_failure(self, key) -> None:
        e = self._entry(key)
        e.failures += 1
        if e.state == "open" or e.failures >= self.threshold:
            # trip (or re-trip from a failed half-open probe): a fresh
            # full reset window starts now
            if e.state != "open" or self.state(key) == "half_open":
                telemetry.bump(f"{self.name}.breaker_trip")
            e.state = "open"
            e.opened_at = self._clock()

    def snapshot(self) -> Dict[str, dict]:
        """Observability view for ``stats()``: resolved state + consecutive
        failures per key."""
        return {repr(k): {"state": self.state(k), "failures": e.failures}
                for k, e in self._keys.items()}

"""Deterministic, env/config-gated fault injection (a copy of the JAX
package's ``repro.utils.faultinject``; the port imports nothing of that
package).

Each name in ``FAULT_POINTS`` is a site in the production code that, when
armed, deterministically perturbs the run in a way a real deployment could
encounter:

* ``nan_weight``       — a NaN edge weight appears mid-pipeline (level 1,
                         on a copy of the level's graph), modelling corrupt
                         upstream data / a bad reduction; the drivers'
                         guard must raise ``NumericError``.
* ``binned_overflow``  — the binned-aggregation overflow predicate is forced
                         true, modelling a hub row busting the bin width;
                         every level takes the one-sort fallback.
* ``oscillation``      — the local-move convergence signal never reports a
                         fixpoint, modelling two vertices trading labels
                         forever (Lu & Halappanavar, arXiv:1410.1237 §4).
* ``vmem_starve``      — the shared-memory budget of the table-layout policy
                         collapses to 1 KB (``kernels.common``).
* ``shard_drop``       — one device's edge shard is zeroed after
                         partitioning, modelling a lost worker.
* ``slow_dispatch``    — a batch dispatch stalls for
                         ``REPRO_SLOW_DISPATCH_S`` seconds (default 0.25)
                         before running, modelling a hung device.
* ``transient_batch_fail`` — a batch dispatch raises a retryable
                         ``KernelError`` before reaching the device,
                         modelling a transient infra failure.
* ``preempt_stage``    — the process is "killed" (a ``resilience.Preempted``
                         BaseException) at a cascade stage boundary of
                         ``core.louvain``, right AFTER the stage checkpoint
                         committed.  Fires ONCE then self-disarms
                         (``consume``) — a preemption is an event, not a
                         state — so the resumed run completes.

The port has the sites of every point but ``shard_drop``: ``slow_dispatch``
and ``transient_batch_fail`` fire in the batched engine's chunk dispatch
(``core.batch._dispatch_guarded``), ``preempt_stage`` also at the serving
tick (``launch.community_serve``).  ``shard_drop`` acts in the
distributed driver, which the port does not have yet: its name stays
registered, so one ``REPRO_FAULTS`` value arms both packages, and arming it
changes nothing here.

The drivers read the armed set once per run (``active()``) and thread it
down (``EngineSpec.faults``, ``remap_and_coarsen_by(faults=...)``); the
shared-memory budget policy reads ``is_active("vmem_starve")`` when it
resolves a layout.  Sites cost nothing when their fault is off.

Gates: the ``REPRO_FAULTS`` env var (comma-separated names, read at import
AND re-read as the baseline by a bare ``disarm()``) or the ``inject()``
context manager / ``arm()``+``disarm()`` pair in tests.

Host-side sites fire through ``should_fire(name)``, which adds
deterministic RATE control: ``set_rate(name, r)`` fires the site on a
Bresenham error-accumulator schedule (exactly ⌊k·r⌋ fires after k
queries — no RNG, reproducible), ``set_burst(name, b)`` turns each
scheduled fire into ``b`` CONSECUTIVE fires, and ``set_fuel(name, n)``
bounds total fires (one-shot faults).  Defaults: rate 1.0, burst 1,
unlimited fuel — armed means fires.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, FrozenSet, Iterator, Set

from repro_torch.utils import telemetry

FAULT_ENV = "REPRO_FAULTS"
SLOW_DISPATCH_ENV = "REPRO_SLOW_DISPATCH_S"
DEFAULT_SLOW_DISPATCH_S = 0.25

FAULT_POINTS = (
    "nan_weight",
    "binned_overflow",
    "oscillation",
    "vmem_starve",
    "shard_drop",
    "slow_dispatch",
    "transient_batch_fail",
    "preempt_stage",
)


def _from_env() -> Set[str]:
    raw = os.environ.get(FAULT_ENV, "")
    names = {s.strip() for s in raw.split(",") if s.strip()}
    unknown = names - set(FAULT_POINTS)
    if unknown:
        raise ValueError(
            f"{FAULT_ENV} names unknown fault point(s) {sorted(unknown)}; "
            f"registry: {FAULT_POINTS}")
    return names


_active: Set[str] = _from_env()

# host-site firing schedule (should_fire); absent name == defaults
_rates: Dict[str, float] = {}
_fuel: Dict[str, int] = {}
_burst: Dict[str, int] = {}
_bres_err: Dict[str, float] = {}
_burst_left: Dict[str, int] = {}


def _check(name: str) -> None:
    if name not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {name!r}; registry: {FAULT_POINTS}")


def active() -> FrozenSet[str]:
    """The armed fault set, read once per run by the drivers."""
    return frozenset(_active)


def is_active(name: str) -> bool:
    _check(name)
    return name in _active


def arm(*names: str) -> None:
    for name in names:
        _check(name)
        _active.add(name)
        telemetry.bump(f"fault.armed.{name}")


def disarm(*names: str) -> None:
    """Disarm the given points; with no args, reset to the env-armed
    baseline.

    The bare form deliberately restores ``REPRO_FAULTS`` (re-read, so a
    monkeypatched env is honored) rather than clearing to empty: a test
    calling ``disarm()`` to undo its own arming must not silently switch
    off the faults a CI chaos step configured for the whole process.
    Firing-schedule state (rate/burst/fuel) is reset for the disarmed
    points either way.
    """
    if not names:
        _active.clear()
        _active.update(_from_env())
        _rates.clear()
        _fuel.clear()
        _burst.clear()
        _bres_err.clear()
        _burst_left.clear()
        return
    for name in names:
        _check(name)
        _active.discard(name)
        for d in (_rates, _fuel, _burst, _bres_err, _burst_left):
            d.pop(name, None)


def set_rate(name: str, rate: float) -> None:
    """Fire the host site on a deterministic Bresenham schedule: after k
    queries exactly ⌊k·rate⌋ have fired (rate 1.0 = every query, the
    default)."""
    _check(name)
    if not (0.0 <= rate <= 1.0):
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    _rates[name] = float(rate)
    _bres_err[name] = 0.0


def set_burst(name: str, burst: int) -> None:
    """Each scheduled fire becomes ``burst`` CONSECUTIVE fires (rate counts
    burst STARTS), modelling correlated failures that defeat isolated
    retries."""
    _check(name)
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    _burst[name] = int(burst)


def set_fuel(name: str, fuel: int) -> None:
    """Bound TOTAL fires of the host site (None/absent = unlimited):
    ``set_fuel(name, 1)`` is a one-shot fault."""
    _check(name)
    if fuel < 0:
        raise ValueError(f"fuel must be >= 0, got {fuel}")
    _fuel[name] = int(fuel)


def should_fire(name: str) -> bool:
    """Host-site gate: is ``name`` armed AND scheduled to fire on THIS
    query?  Counts the query against the rate/burst/fuel schedule."""
    if not is_active(name):
        return False
    if _fuel.get(name) == 0:
        return False
    if _burst_left.get(name, 0) > 0:
        _burst_left[name] -= 1
        fire = True
    else:
        rate = _rates.get(name, 1.0)
        err = _bres_err.get(name, 0.0) + rate
        fire = err >= 1.0
        _bres_err[name] = err - 1.0 if fire else err
        if fire:
            _burst_left[name] = _burst.get(name, 1) - 1
    if fire:
        if name in _fuel:
            _fuel[name] -= 1
        telemetry.bump(f"fault.fired.{name}")
    return fire


def consume(name: str) -> bool:
    """One-shot host-site gate: fire per the schedule, then SELF-DISARM.

    Models event faults (a preemption happens once, then the world moves
    on): the retried/resumed attempt runs clean without the caller having
    to know a fault registry exists."""
    if should_fire(name):
        disarm(name)
        return True
    return False


def slow_dispatch_seconds() -> float:
    """Stall duration of the ``slow_dispatch`` site
    (``REPRO_SLOW_DISPATCH_S`` env override, read per fire so tests can
    monkeypatch it)."""
    env = os.environ.get(SLOW_DISPATCH_ENV)
    return float(env) if env else DEFAULT_SLOW_DISPATCH_S


@contextlib.contextmanager
def inject(*names: str) -> Iterator[None]:
    """Arm ``names`` for the duration of the block, restoring the previous
    set on exit (exception-safe); nests — each level restores exactly what
    it saw."""
    prev = set(_active)
    arm(*names)
    try:
        yield
    finally:
        _active.clear()
        _active.update(prev)

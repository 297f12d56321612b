"""Process-local telemetry counters for the robustness guard rails.

Counters are bumped on the host (guard activations, which aggregation path a
level took) — never inside a kernel — so they cost nothing on the device hot
path.

>>> from repro_torch.utils import telemetry
>>> telemetry.bump("agg.pack_disabled")
>>> telemetry.get("agg.pack_disabled")
1
"""
from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, int] = {}
_values: Dict[str, Dict[str, float]] = {}


def bump(name: str, k: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + k


def get(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def observe(name: str, value: float) -> None:
    """Record one sample of a host-side measurement (latency, backoff sleep,
    breaker-open duration, …) into a cheap running aggregate —
    count/sum/min/max/last, no per-sample storage.  Same host-only
    discipline as ``bump``: never called from inside a compiled program."""
    v = float(value)
    with _lock:
        agg = _values.get(name)
        if agg is None:
            _values[name] = {"count": 1, "sum": v, "min": v, "max": v,
                             "last": v}
        else:
            agg["count"] += 1
            agg["sum"] += v
            agg["min"] = min(agg["min"], v)
            agg["max"] = max(agg["max"], v)
            agg["last"] = v


def values() -> Dict[str, Dict[str, float]]:
    with _lock:
        return {k: dict(v) for k, v in _values.items()}


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
        _values.clear()

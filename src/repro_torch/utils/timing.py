"""Wall-clock timing helpers used by benchmarks and the phase breakdown.

The paper reports per-phase runtimes (Fig. 4 breaks Louvain into local-moving
and aggregation).  ``Timer`` accumulates named phases so the benchmark harness
can reproduce that breakdown.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator


def format_seconds(s: float) -> str:
    if s < 1e-6:
        return f"{s * 1e9:.1f}ns"
    if s < 1e-3:
        return f"{s * 1e6:.1f}us"
    if s < 1.0:
        return f"{s * 1e3:.2f}ms"
    return f"{s:.3f}s"


@dataclass
class Timer:
    """Accumulating phase timer.

    >>> t = Timer()
    >>> with t.phase("local_moving"):
    ...     pass
    >>> "local_moving" in t.totals
    True
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @property
    def total(self) -> float:
        return sum(self.totals.values())

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"  {name:<24s} {format_seconds(total):>10s}  (n={self.counts[name]})"
            )
        lines.append(f"  {'TOTAL':<24s} {format_seconds(self.total):>10s}")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(label: str = "") -> Iterator[list]:
    """Context manager yielding a one-element list that receives the elapsed time."""
    out = [0.0]
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out[0] = time.perf_counter() - t0
        if label:
            print(f"[timed] {label}: {format_seconds(out[0])}")

"""Typed failure taxonomy + run reporting for the hardened execution layer.

A copy of the JAX package's ``repro.utils.errors`` (the port imports nothing
of that package).  Every way a community-detection run can go wrong maps to
exactly one exception type below, and every run carries a ``RunReport``
describing what (if anything) was repaired, retried, or degraded on the way
to the result.

Kept in ``utils`` so every layer (graph builders, kernels, core drivers)
can import the taxonomy without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class RunReport:
    """What happened on the way to a result (attached to ``LouvainResult`` /
    ``PLPResult`` / ``DistLouvainResult`` as ``run_report``).

    * ``repairs``       — the ingest ``RepairReport`` (or None if the graph
                          came in through a non-robust entry point)
    * ``retries``       — capacity-tier retries, as
                          ``{"kind": "capacity", "from": ..., "to": ...}``
    * ``degradations``  — backend descents, as ``{"kind": "backend_descent",
                          "from": "pallas", "to": "ell", "error": ...}``
    * ``warnings``      — bounded-but-suspicious outcomes, e.g.
                          ``"watchdog:max_sweeps:level3"``,
                          ``"precision:f32_accum_risk"``
    * ``faults``        — fault-injection points active during the run
                          (always empty in the port, which has no fault
                          injection yet)
    """

    repairs: Optional[Any] = None
    retries: list = dataclasses.field(default_factory=list)
    degradations: list = dataclasses.field(default_factory=list)
    warnings: list = dataclasses.field(default_factory=list)
    faults: list = dataclasses.field(default_factory=list)

    @property
    def clean(self) -> bool:
        """True iff nothing was repaired, retried, degraded, or flagged."""
        return (not self.retries and not self.degradations
                and not self.warnings
                and (self.repairs is None or getattr(self.repairs, "clean", True)))

    def as_dict(self) -> dict:
        return {
            "repairs": (dataclasses.asdict(self.repairs)
                        if dataclasses.is_dataclass(self.repairs)
                        else self.repairs),
            "retries": list(self.retries),
            "degradations": list(self.degradations),
            "warnings": list(self.warnings),
            "faults": list(self.faults),
        }


class CommunityDetectionError(Exception):
    """Base of the typed failure taxonomy (DESIGN.md §Robustness).

    ``report`` carries the RunReport of the failed run so callers see what
    the degradation ladder already tried before giving up.
    """

    def __init__(self, message: str, report: Optional[RunReport] = None):
        super().__init__(message)
        self.report = report if report is not None else RunReport()


class InputValidationError(CommunityDetectionError):
    """Malformed input graph: asymmetric edges, out-of-range or negative
    endpoint ids, non-finite or negative weights, mask/count mismatches."""


class CapacityError(CommunityDetectionError):
    """A static capacity was busted (graph does not fit a stage capacity, or
    the cascade's fits-next-capacity invariant was violated)."""


class KernelError(CommunityDetectionError):
    """A compute backend failed: a CUDA kernel did not build or its launch
    returned an error."""


class ConvergenceError(CommunityDetectionError):
    """Local-moving or the level loop failed to converge within the watchdog
    bounds AND the caller asked for strict convergence."""


class NumericError(CommunityDetectionError):
    """Non-finite values reached a result accumulator (NaN/Inf modularity,
    volume overflow) — the numeric guard rails refused the answer."""


class ShardError(CommunityDetectionError):
    """The distributed edge partition lost coverage (a dropped or corrupted
    shard): the per-shard edge counts no longer cover the graph."""


class DeadlineError(CommunityDetectionError):
    """A dispatch (or a whole request) overran its deadline and was
    cancelled by the watchdog (``utils.resilience.call_with_deadline``).
    NOT retryable: the time budget is spent — retrying can only miss
    harder.  The abandoned work may still complete in the background; the
    contract is only that the CALLER is released on time."""


class OverloadError(CommunityDetectionError):
    """Admission control shed this request: the serving queue is at its
    configured depth/cost bound (DESIGN.md §Resilience).  The typed
    backpressure signal — clients should back off and resubmit; retrying
    immediately on the same engine will meet the same bound."""

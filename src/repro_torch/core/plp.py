"""Parallel Label Propagation (paper Alg. 1) — port of ``repro.core.plp``.

  * singleton initialization (l.4)
  * active-vertex set with deactivate-on-stable / reactivate-on-neighbor-change
    (l.5, l.19-20, l.25) — a boolean frontier mask
  * per-iteration move: every active vertex adopts
    argmax_c Σ_{u∈N(v): C(u)=c} w(v,u)   (l.18)
  * termination: ΔN ≤ threshold or maxIteration (l.7-11)

The asynchronous shared-array update of the paper is a synchronous Jacobi
sweep with seeded hash tie noise and a Luby move gate, as in the JAX
package.  ``plp()`` runs on the device of the graph it is given.

The JAX package's ``pallas → ell → segment`` backend-descent ladder is left
out on purpose: a kernel that fails to build or launch raises
``KernelError`` instead of quietly running another backend.  Armed fault
points (``utils.faultinject``) are read once per run; the sweep's
(``oscillation``) ride ``EngineSpec.faults`` and all of them are listed in
``result.run_report.faults``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from repro_torch.config import ConfigBase
from repro_torch.core.engine import EngineSpec, PhaseResult, SweepEngine
from repro_torch.core.louvain import ENGINE_FAULTS
from repro_torch.graph.structure import Graph
from repro_torch.utils import faultinject
from repro_torch.utils.errors import RunReport
from repro_torch.utils.timing import Timer


@dataclasses.dataclass(frozen=True)
class PLPConfig(ConfigBase):
    max_iterations: int = 100
    threshold: int = 0          # paper's ΔN threshold θ
    seed: int = 0
    tie_eps: float = 0.25       # < min weight gap on unit-weight graphs
    use_frontier: bool = True   # the paper's active-vertex optimization
    backend: str = "segment"    # segment | ell | pallas
    reshuffle_ties: bool = False
    move_prob: float = 0.75     # Luby-style move gating (1.0 = pure Jacobi)
    fused: bool = True          # accepted for config parity; same loop
    table_mode: str = "auto"    # auto | resident | streamed (ell, pallas)


@dataclasses.dataclass
class PLPResult:
    labels: np.ndarray
    iterations: int
    delta_n_history: list
    active_history: list
    timer: Timer
    run_report: RunReport = dataclasses.field(default_factory=RunReport)


def engine_spec(cfg: PLPConfig, faults: frozenset = frozenset()
                ) -> EngineSpec:
    return EngineSpec(
        evaluator="plp",
        backend=cfg.backend,
        max_sweeps=cfg.max_iterations,
        threshold=cfg.threshold,
        tie_eps=float(cfg.tie_eps),
        move_prob=float(cfg.move_prob),
        use_frontier=cfg.use_frontier,
        reshuffle_ties=cfg.reshuffle_ties,
        table_mode=cfg.table_mode,
        faults=tuple(sorted(f for f in faults if f in ENGINE_FAULTS)),
    )


def _trivial_result(report: RunReport) -> PLPResult:
    """Degenerate zero-capacity graph: nothing to label, nothing to run."""
    return PLPResult(labels=np.zeros((0,), np.int32), iterations=0,
                     delta_n_history=[], active_history=[], timer=Timer(),
                     run_report=report)


def _result(res: PhaseResult, n: int, cfg: PLPConfig, timer: Timer,
            report: RunReport) -> PLPResult:
    """The phase's labels of the first ``n`` vertices (a batch lane's
    graph is padded past its request's ``n_max``) and its histories, with
    the iteration watchdog recorded in ``report``."""
    if res.sweeps >= cfg.max_iterations:
        report.warnings.append("watchdog:max_iterations")
    return PLPResult(
        labels=res.labels[:n].cpu().numpy(),
        iterations=res.sweeps,
        delta_n_history=res.delta_n_history,
        active_history=res.active_history,
        timer=timer,
        run_report=report,
    )


def plp(g: Graph, cfg: PLPConfig = PLPConfig(), ell_graph=None) -> PLPResult:
    """Run Parallel Label Propagation; returns final labels + history.
    Iteration-budget exhaustion is flagged as a watchdog warning in
    ``result.run_report``."""
    faults = frozenset(faultinject.active())
    report = RunReport(faults=sorted(faults))
    if g.n_max == 0:
        return _trivial_result(report)
    spec = engine_spec(cfg, faults)
    timer = Timer()
    with timer.phase("ell_build") if cfg.backend in ("ell", "pallas") \
            else contextlib.nullcontext():
        engine = SweepEngine(g, spec, ell=ell_graph)
    labels, active = engine.singleton_state()
    with timer.phase("move"):
        res = engine.run_phase(labels, active, seed=cfg.seed, fused=cfg.fused)
    return _result(res, g.n_max, cfg, timer, report)

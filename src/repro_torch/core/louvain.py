"""Parallel Louvain (paper Alg. 2 + Alg. 3) — port of ``repro.core.louvain``.

  * singleton init with comID = vertexID (Alg. 2 l.3-8)
  * local-moving: per-vertex parallel Δ𝑄 evaluation over neighboring
    communities (Eq. 1), greedy argmax move when Δ𝑄 > 0 (l.9-24), with the
    needCheck frontier (l.11, l.21, l.25)
  * level loop: local-moving then aggregation until |C| == |V| (Alg. 3)

This slice ports the JAX package's per-level driver (``_louvain_per_level``)
and runs it whatever ``pipeline_fused`` says: the JAX package's own
contracts make its fused pipeline bit-identical to that driver in labels,
levels, Q and every per-level history.  Level 0 runs the configured backend
(``pallas`` = the CUDA kernels); coarse levels run the segment evaluator,
as in the JAX per-level driver.  Aggregation's ``bin_rank`` pass uses its
CUDA kernel when the backend is ``pallas`` and its plain version otherwise.

``table_mode`` (``auto``/``resident``/``streamed``) picks the level-0 ELL
table layout on the ``ell`` and ``pallas`` backends.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): Leiden refinement (``refine=True``), explicit cascade capacity
schedules and stage-boundary checkpointing.  The backend-descent ladder is
left out too: a kernel failure raises ``KernelError`` instead of quietly
running another backend.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ConfigBase
from repro_torch.core import aggregation
from repro_torch.core.engine import EngineSpec, SweepEngine
from repro_torch.core.modularity import modularity
from repro_torch.graph.structure import Graph
from repro_torch.kernels.common import accum_needs_promotion
from repro_torch.utils import telemetry
from repro_torch.utils.errors import (CommunityDetectionError, NumericError,
                                      RunReport)
from repro_torch.utils.timing import Timer

# Sweep-counter stride per level: level L's local-moving phase hashes tie
# noise / Luby gates from it0 = L·LEVEL_IT_STRIDE (the JAX package's value).
LEVEL_IT_STRIDE = 1000


def _validate_schedule(sched) -> None:
    if isinstance(sched, str) and sched in ("auto", "none"):
        return
    ok = isinstance(sched, tuple) and len(sched) > 0
    if ok:
        for c in sched:
            if not (isinstance(c, tuple) and len(c) == 2 and all(
                    isinstance(x, int) and not isinstance(x, bool) and x > 0
                    for x in c)):
                ok = False
                break
    if ok:
        for a, b in zip(sched, sched[1:]):
            if not (b[0] <= a[0] and b[1] <= a[1] and b != a):
                ok = False
                break
    if not ok:
        raise ValueError(
            "capacity_schedule must be 'auto', 'none', or an explicit tuple "
            "of descending (n_cap, m_cap) positive-int pairs such as "
            f"((8192, 131072), (2048, 32768)); got {sched!r}")


@dataclasses.dataclass(frozen=True)
class LouvainConfig(ConfigBase):
    """The JAX package's ``LouvainConfig`` fields, so one ``to_dict()``
    drives both packages."""

    max_levels: int = 10
    max_sweeps: int = 25        # Alg. 2 maxIteration
    sweep_threshold: int = 0    # stop local-moving when ΔN <= this
    backend: str = "segment"    # segment | ell | pallas
    aggregation: str = "binned"  # binned | sort
    table_mode: str = "auto"    # auto | resident | streamed (ell, pallas)
    use_need_check: bool = True
    singleton_rule: bool = True # Lu et al. swap suppression
    move_prob: float = 0.5      # Luby-style move gating (1.0 = pure Jacobi)
    seed: int = 0
    track_modularity: bool = True
    fused: bool = True          # accepted for config parity; same loop
    pipeline_fused: bool = True  # accepted; the per-level driver always runs
    # "auto"/"none" both run the per-level driver (no cascade in this slice);
    # an explicit schedule raises
    capacity_schedule: "str | Tuple[Tuple[int, int], ...]" = "auto"
    refine: bool = False        # Leiden refinement: not ported
    refine_sweeps: int = 8
    per_level_timing: bool = False
    checkpoint_dir: Optional[str] = None  # not ported

    def __post_init__(self):
        if self.max_levels < 1:
            raise ValueError(
                f"max_levels must be >= 1, got {self.max_levels}")
        if not (0.0 < self.move_prob <= 1.0):
            raise ValueError(
                f"move_prob must be in (0, 1], got {self.move_prob}")
        if self.refine_sweeps < 1:
            raise ValueError(
                f"refine_sweeps must be >= 1, got {self.refine_sweeps}")
        if self.aggregation not in aggregation.AGGREGATION_METHODS:
            raise ValueError(
                f"aggregation must be one of "
                f"{aggregation.AGGREGATION_METHODS}, got {self.aggregation!r}")
        _validate_schedule(self.capacity_schedule)


@dataclasses.dataclass
class LouvainResult:
    labels: np.ndarray            # community id per ORIGINAL vertex (contiguous)
    n_communities: int
    levels: int
    modularity: float
    modularity_history: list      # per level
    sweeps_per_level: list
    timer: Timer
    n_comm_per_level: list = dataclasses.field(default_factory=list)
    delta_n_per_level: list = dataclasses.field(default_factory=list)
    # the per-level driver runs no cascade, so this stays empty
    cascade_stages: list = dataclasses.field(default_factory=list)
    run_report: RunReport = dataclasses.field(default_factory=RunReport)
    # per level: "binned", "sort_fallback" (the bin gate overflowed) or "sort"
    aggregation_per_level: list = dataclasses.field(default_factory=list)


def engine_spec(cfg: LouvainConfig, backend: Optional[str] = None) -> EngineSpec:
    return EngineSpec(
        evaluator="louvain",
        backend=backend or cfg.backend,
        max_sweeps=cfg.max_sweeps,
        threshold=cfg.sweep_threshold,
        move_prob=float(cfg.move_prob),
        use_frontier=cfg.use_need_check,
        singleton_rule=cfg.singleton_rule,
        table_mode=cfg.table_mode,
    )


def _coarse_backend(backend: str) -> str:
    """The ELL layout covers the finest graph only: every coarse level runs
    the segment evaluator, as in the JAX per-level driver."""
    return "segment" if backend in ("ell", "pallas") else backend


def _check_supported(cfg: LouvainConfig) -> None:
    if cfg.refine:
        raise NotImplementedError(
            "Leiden refinement (refine=True) is not ported yet: ROADMAP "
            "Queue 1 #6.4")
    if cfg.checkpoint_dir is not None:
        raise NotImplementedError(
            "stage-boundary checkpointing is not ported yet: ROADMAP "
            "Queue 1 #6.6")
    if not isinstance(cfg.capacity_schedule, str):
        raise NotImplementedError(
            "explicit capacity schedules (the coarse-level cascade) are not "
            "ported yet: ROADMAP Queue 1 #6.3")


def _trivial_result(report: RunReport) -> LouvainResult:
    """Degenerate zero-capacity graph: nothing to cluster, nothing to run."""
    return LouvainResult(
        labels=np.zeros((0,), np.int32), n_communities=0, levels=0,
        modularity=0.0, modularity_history=[], sweeps_per_level=[],
        timer=Timer(), run_report=report)


def _finalize_report(res: LouvainResult, cfg: LouvainConfig,
                     report: RunReport) -> LouvainResult:
    """Watchdog accounting + the final numeric gate."""
    for i, s in enumerate(res.sweeps_per_level):
        if s >= cfg.max_sweeps:
            report.warnings.append(f"watchdog:max_sweeps:level{i}")
    if res.levels >= cfg.max_levels:
        report.warnings.append("watchdog:max_levels")
    res.run_report = report
    if not math.isfinite(res.modularity):
        raise NumericError(
            f"non-finite final modularity {res.modularity!r}", report=report)
    return res


def louvain(g: Graph, cfg: LouvainConfig = LouvainConfig(),
            g_original: Optional[Graph] = None) -> LouvainResult:
    """Run Louvain on the device of ``g``: the per-level driver, with the
    float32-accumulation warning and watchdog accounting of the JAX
    package's hardened driver in ``result.run_report``."""
    _check_supported(cfg)
    report = RunReport()
    if g.n_max == 0:
        return _trivial_result(report)
    promote = accum_needs_promotion(g.m_max)
    if promote:
        report.warnings.append("precision:f32_accum_risk")
    try:
        res = _louvain_per_level(g, cfg, g_original, promote)
    except CommunityDetectionError as err:
        err.report = report
        raise
    return _finalize_report(res, cfg, report)


def _tphase(timer: Timer, name: str, level: int, per_level: bool):
    """timer.phase(name), optionally doubled with a level-tagged entry."""
    if not per_level:
        return timer.phase(name)
    stack = contextlib.ExitStack()
    stack.enter_context(timer.phase(name))
    stack.enter_context(timer.phase(f"L{level:02d}/{name}"))
    return stack


def _louvain_per_level(g: Graph, cfg: LouvainConfig,
                       g_original: Optional[Graph],
                       promote: bool = False) -> LouvainResult:
    """Per-level driver: one local-moving phase per level, then aggregation
    and the Alg. 3 convergence check on the host."""
    timer = Timer()
    g0 = g_original if g_original is not None else g
    n, dev = g.n_max, g.device
    # the pallas backend ranks bins with the bin_rank wrapper, which
    # launches its kernel on the card; every other backend stays plain
    impl = "kernel" if cfg.backend == "pallas" else "ref"

    assign = torch.arange(n, dtype=torch.int32, device=dev)
    cur = g
    mod_hist: list = []
    sweeps_per_level: list = []
    n_comm_per_level: list = []
    delta_n_per_level: list = []
    agg_paths: list = []
    levels = 0

    for level in range(cfg.max_levels):
        spec = engine_spec(cfg, backend=cfg.backend if level == 0
                           else _coarse_backend(cfg.backend))
        # numeric guard rail: non-finite weights poison every sum silently
        if bool(torch.any(cur.edge_mask & ~torch.isfinite(cur.w))):
            raise NumericError(
                f"non-finite edge weight detected at level {level}")
        with timer.phase("ell_build") if spec.backend in ("ell", "pallas") \
                else contextlib.nullcontext():
            engine = SweepEngine(cur, spec)
        com = torch.arange(n, dtype=torch.int32, device=dev)
        need = cur.vertex_mask()

        with _tphase(timer, "local_moving", level, cfg.per_level_timing):
            res = engine.run_phase(com, need, it0=level * LEVEL_IT_STRIDE,
                                   seed=cfg.seed, fused=cfg.fused)
        com = res.labels
        sweeps_per_level.append(res.sweeps)
        delta_n_per_level.append(res.delta_n_history)

        with _tphase(timer, "aggregation", level, cfg.per_level_timing):
            fallbacks = telemetry.get("agg.sort_fallback")
            new_com, n_comm, coarse = aggregation.remap_and_coarsen_by(
                cfg.aggregation, cur, com, impl=impl)
            agg_paths.append(
                "sort" if cfg.aggregation == "sort"
                else "sort_fallback"
                if telemetry.get("agg.sort_fallback") > fallbacks
                else "binned")
            macro_assign = new_com[torch.clamp(assign, 0, n - 1)]
            n_comm_per_level.append(n_comm)
            done = n_comm == cur.n_valid          # Alg. 3 l.6 convergence
            if not done:
                assign = macro_assign
                cur = coarse
        levels = level + 1
        if cfg.track_modularity:
            mod_hist.append(float(modularity(g0, macro_assign,
                                             promote=promote)))
        if done:
            break

    final_assign, n_final = aggregation.remap_communities(
        macro_assign, g0.vertex_mask())
    q = float(modularity(g0, final_assign, promote=promote))
    return LouvainResult(
        labels=final_assign.cpu().numpy(),
        n_communities=n_final,
        levels=levels,
        modularity=q,
        modularity_history=mod_hist,
        sweeps_per_level=sweeps_per_level,
        timer=timer,
        n_comm_per_level=n_comm_per_level,
        delta_n_per_level=delta_n_per_level,
        aggregation_per_level=agg_paths,
    )

"""Parallel Louvain (paper Alg. 2 + Alg. 3) and Leiden — port of
``repro.core.louvain``.

  * singleton init with comID = vertexID (Alg. 2 l.3-8)
  * local-moving: per-vertex parallel Δ𝑄 evaluation over neighboring
    communities (Eq. 1), greedy argmax move when Δ𝑄 > 0 (l.9-24), with the
    needCheck frontier (l.11, l.21, l.25)
  * level loop: local-moving then aggregation until |C| == |V| (Alg. 3)
  * ``refine=True`` (``leiden()``): each level not yet done refines its
    communities from singletons with moves confined to them (the segment
    evaluator's ``restrict`` mask), coarsens by the REFINED partition and
    seeds the next level with each super-vertex's macro community.

Two drivers, as in the JAX package, bit-identical to each other:

* ``pipeline_fused=True`` with ``fused=True`` (the default) runs the
  capacity cascade (``_louvain_pipeline``): the level loop runs in stages,
  and once the carried coarse graph fits a smaller capacity of the
  schedule (``capacity_schedule``: ``"auto"`` derives a bounded one from
  the graph, ``"none"`` pins one stage, or an explicit tuple) the stage
  ends, the graph is compacted into that capacity on the device
  (``aggregation.shrink_graph``) and the loop resumes there.  Inside a
  cascade the ``ell``/``pallas`` backends also run the coarse levels,
  through one vertex-aligned ELL tile rebuilt per level on the device
  (``graph.ell.traced_ell_tile``) at the stage's width; outside one, and
  in the per-level driver, coarse levels run the segment evaluator.
  ``LouvainResult.cascade_stages`` lists the capacities entered.  With
  ``checkpoint_dir`` every stage boundary is saved (``train.checkpoint``)
  and a rerun with the same config and graph resumes from the last one.
* otherwise the per-level driver (``_louvain_per_level``) runs, with
  ``cascade_stages == []``.

The batched engine (``core.batch``) runs one stage of the cascade's form
per graph, at its bucket's capacity (``_single_stage_run``).

The JAX package fuses a stage into one compiled program; here a stage is
a Python loop over eager levels that reads back per sweep and per level.
Level 0 runs the configured backend (``pallas`` = the CUDA kernels) on the
host-built ELL layout, whose ``table_mode`` (``auto``/``resident``/
``streamed``) picks the table layout.  Aggregation's ``bin_rank`` pass
uses its CUDA kernel when the backend is ``pallas`` and its plain version
otherwise.  Leiden's refinement runs the segment evaluator on every
backend, as in the JAX package.

Fault points (``utils.faultinject``) are read once per run and listed in
``run_report.faults``.  The backend-descent ladder of the JAX package is
left out on purpose: a kernel failure raises ``KernelError`` instead of
quietly running another backend.  A ``CapacityError`` from the cascade is
retried once on ``capacity_schedule="none"``, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ConfigBase
from repro_torch.core import aggregation
from repro_torch.core.engine import EngineSpec, SweepEngine
from repro_torch.core.modularity import modularity
from repro_torch.graph.ell import build_ell
from repro_torch.graph.structure import Graph
from repro_torch.kernels.common import accum_needs_promotion, pick_ell_width
from repro_torch.train import checkpoint
from repro_torch.utils import faultinject, resilience, telemetry
from repro_torch.utils.errors import (CapacityError, CommunityDetectionError,
                                      NumericError, RunReport)
from repro_torch.utils.timing import Timer

# Fault points that act inside the sweep and ride ``EngineSpec.faults``;
# the others act at the aggregation and driver layers.
ENGINE_FAULTS = ("oscillation", "vmem_starve")

# Sweep-counter stride per level and the refinement phase's offset within a
# level: level L's local-moving phase hashes tie noise / Luby gates from
# it0 = L·LEVEL_IT_STRIDE, Leiden's refinement from it0 + REFINE_IT_OFFSET
# (the JAX package's values).
LEVEL_IT_STRIDE = 1000
REFINE_IT_OFFSET = 500


# ------------------------------------------------------------ capacity schedule


def auto_capacity_schedule(
    n_max: int,
    m_max: int,
    *,
    max_stages: int = 4,
    shrink: int = 4,
    n_floor: int = 256,
    m_floor: int = 2048,
    min_n: int = 4096,
) -> Tuple[Tuple[int, int], ...]:
    """Bounded capacity schedule of the cascade (the JAX package's):
    quarter steps from the full capacity down to the floors, at most
    ``max_stages`` entries.  Graphs below ``min_n`` vertices keep one
    capacity.  The floors are clamped to the previous capacity, so a
    capacity-padded sparse graph is never scheduled to grow."""
    caps = [(int(n_max), int(m_max))]
    if n_max < min_n:
        return tuple(caps)
    while len(caps) < max_stages:
        nc = min(caps[-1][0], max(n_floor, -(-caps[-1][0] // shrink)))
        mc = min(caps[-1][1], max(m_floor, -(-caps[-1][1] // shrink)))
        if (nc, mc) == caps[-1]:
            break
        caps.append((nc, mc))
    return tuple(caps)


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
    # with fused=True: the capacity cascade; otherwise the per-level driver
    pipeline_fused: bool = True
    # the cascade's schedule: "auto" (bounded, from (n_max, m_max)), "none"
    # (one capacity) or a tuple of descending (n_cap, m_cap) pairs
    capacity_schedule: "str | Tuple[Tuple[int, int], ...]" = "auto"
    # Leiden: refine each level's communities before aggregating, and seed
    # the next level with the macro partition (``leiden()`` sets it)
    refine: bool = False
    refine_sweeps: int = 8
    per_level_timing: bool = False
    # the cascade saves every stage boundary here, and a rerun with the same
    # config and graph resumes from the last one; cleared on success
    checkpoint_dir: Optional[str] = None

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
    # (n_cap, m_cap) of each cascade stage entered, in order; empty from the
    # per-level driver
    cascade_stages: list = dataclasses.field(default_factory=list)
    run_report: RunReport = dataclasses.field(default_factory=RunReport)
    # per level, the coarsening that built the next level's graph:
    # "binned", "sort_fallback" (the bin gate overflowed) or "sort".  Under
    # Leiden it is the REFINED partition's, and the level that ends the run
    # coarsens nothing: "none".  (Louvain's last level still coarsens.)
    aggregation_per_level: list = dataclasses.field(default_factory=list)


def engine_spec(cfg: LouvainConfig, backend: Optional[str] = None,
                max_sweeps: Optional[int] = None,
                faults: frozenset = frozenset()) -> EngineSpec:
    return EngineSpec(
        evaluator="louvain",
        backend=backend or cfg.backend,
        max_sweeps=cfg.max_sweeps if max_sweeps is None else max_sweeps,
        threshold=cfg.sweep_threshold,
        move_prob=float(cfg.move_prob),
        use_frontier=cfg.use_need_check,
        singleton_rule=cfg.singleton_rule,
        table_mode=cfg.table_mode,
        faults=tuple(sorted(f for f in faults if f in ENGINE_FAULTS)),
    )


def _coarse_backend(backend: str) -> str:
    """The host-built ELL layout covers the finest graph only: outside a
    cascade every coarse level runs the segment evaluator."""
    return "segment" if backend in ("ell", "pallas") else backend


def _resolve_schedule(cfg: LouvainConfig, g: Graph
                      ) -> Tuple[Tuple[int, int], ...]:
    """This graph's schedule: the full capacity first, then the entries of
    an explicit schedule that fit under it and shrink it."""
    sched = cfg.capacity_schedule
    full = (g.n_max, g.m_max)
    if sched == "none":
        return (full,)
    if sched == "auto":
        return auto_capacity_schedule(g.n_max, g.m_max)
    caps = [full]
    for c in sched:
        c = (int(c[0]), int(c[1]))
        if (c[0] <= full[0] and c[1] <= full[1]
                and (c[0] < caps[-1][0] or c[1] < caps[-1][1])):
            caps.append(c)
    return tuple(caps)


def _cascade_coarse_spec(cfg: LouvainConfig, cascade: bool, width: int,
                         faults: frozenset = frozenset()) -> EngineSpec:
    """Coarse-level spec of one stage: inside a cascade the ``ell``/
    ``pallas`` backends keep the local_move family on the traced tile of
    the stage's ``width``; outside one the segment evaluator runs."""
    if cascade and cfg.backend in ("ell", "pallas"):
        return engine_spec(cfg, faults=faults).replace(ell_width=width)
    return engine_spec(cfg, backend=_coarse_backend(cfg.backend),
                       faults=faults)


def _refine_spec(cfg: LouvainConfig,
                 faults: frozenset = frozenset()) -> EngineSpec:
    """Leiden's refinement phase: the segment evaluator (the only one with
    the ``restrict`` mask), ``refine_sweeps`` sweeps, threshold 0."""
    return engine_spec(cfg, backend="segment", max_sweeps=cfg.refine_sweeps,
                       faults=faults).replace(threshold=0)


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


def leiden(g: Graph, cfg: LouvainConfig = LouvainConfig(),
           g_original: Optional[Graph] = None) -> LouvainResult:
    """Leiden = Louvain + a refinement phase + macro-seeded levels."""
    return louvain(g, cfg.replace(refine=True), g_original)


def louvain(g: Graph, cfg: LouvainConfig = LouvainConfig(),
            g_original: Optional[Graph] = None) -> LouvainResult:
    """Run Louvain (Leiden with ``refine``) on the device of ``g``: the
    capacity cascade (``pipeline_fused`` and ``fused``) or the per-level
    driver.  The armed fault points are read once and listed in
    ``run_report.faults``.  A ``CapacityError`` from the cascade is retried
    once on the single capacity (``capacity_schedule="none"``) and
    recorded in ``result.run_report.retries``; the float32-accumulation
    warning and the watchdog accounting land there too, as in the JAX
    package.  Every other error propagates with the report attached."""
    faults = frozenset(faultinject.active())
    report = RunReport(faults=sorted(faults))
    if g.n_max == 0:
        return _trivial_result(report)
    promote = accum_needs_promotion(g.m_max)
    if promote:
        report.warnings.append("precision:f32_accum_risk")
    cfg_try = cfg
    while True:
        try:
            if cfg_try.pipeline_fused and cfg_try.fused:
                res = _louvain_pipeline(g, cfg_try, g_original, promote,
                                        faults)
            else:
                res = _louvain_per_level(g, cfg_try, g_original, promote,
                                         faults)
            break
        except CapacityError as err:
            if cfg_try.capacity_schedule == "none":
                err.report = report
                raise
            telemetry.bump("ladder.capacity_retry")
            report.retries.append({
                "kind": "capacity",
                "from": repr(cfg_try.capacity_schedule), "to": "none",
                "error": str(err)})
            cfg_try = cfg_try.replace(capacity_schedule="none")
        except CommunityDetectionError as err:
            err.report = report
            raise
    return _finalize_report(res, cfg_try, report)


def _tphase(timer: Timer, name: str, level: int, per_level: bool):
    """timer.phase(name), optionally doubled with a level-tagged entry."""
    if not per_level:
        return timer.phase(name)
    stack = contextlib.ExitStack()
    stack.enter_context(timer.phase(name))
    stack.enter_context(timer.phase(f"L{level:02d}/{name}"))
    return stack


@dataclasses.dataclass
class _Levels:
    """Per-level histories, one entry per level run, in level order — the
    cascade's stages add to the same lists, as the JAX package writes its
    history buffers at absolute level indices."""

    modularity: list = dataclasses.field(default_factory=list)
    sweeps: list = dataclasses.field(default_factory=list)
    n_comm: list = dataclasses.field(default_factory=list)
    delta_n: list = dataclasses.field(default_factory=list)
    aggregation: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Run:
    """What one Louvain run shares across its levels."""

    cfg: LouvainConfig
    g0: Graph
    impl: str                 # bin_rank pass: "kernel" (pallas) or "ref"
    promote: bool
    faults: frozenset         # the armed fault points, read once
    timer: Timer
    hist: _Levels


def _refine_partition(cur: Graph, com_macro: torch.Tensor,
                      cfg: LouvainConfig, level: int,
                      faults: frozenset = frozenset()) -> torch.Tensor:
    """Leiden refinement: greedy modularity merges restricted to the macro
    communities ``com_macro``, starting from singletons, so every
    aggregated super-vertex lies inside (and is connected within) one
    macro community."""
    engine = SweepEngine(cur, _refine_spec(cfg, faults))
    res = engine.run_phase(
        *engine.singleton_state(),
        it0=level * LEVEL_IT_STRIDE + REFINE_IT_OFFSET, seed=cfg.seed,
        restrict=com_macro, fused=cfg.fused)
    return res.labels


def _aggregate(run: _Run, cur: Graph, com: torch.Tensor):
    """``remap_and_coarsen_by`` on the run's method, ``bin_rank`` impl and
    faults; returns ``(new_com, n_comm, coarse, path)``."""
    cfg = run.cfg
    fallbacks = telemetry.get("agg.sort_fallback")
    new_com, n_comm, coarse = aggregation.remap_and_coarsen_by(
        cfg.aggregation, cur, com, impl=run.impl, faults=run.faults)
    path = ("sort" if cfg.aggregation == "sort"
            else "sort_fallback"
            if telemetry.get("agg.sort_fallback") > fallbacks
            else "binned")
    return new_com, n_comm, coarse, path


def _macro_seed(new_com: torch.Tensor, new_ref: torch.Tensor,
                vmask: torch.Tensor) -> torch.Tensor:
    """Leiden's next-level seed: each refined group's CONTIGUIZED macro id
    (all members of a group share it), the JAX package's
    ``clip(segment_max(where(vmask, new_com, -1), clip(new_ref)), 0, n-1)``.
    Empty segments start at int32's minimum and clip to 0, as JAX's do."""
    n = new_com.shape[0]
    out = torch.full((n,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                     device=new_com.device)
    out.scatter_reduce_(0, torch.clamp(new_ref, 0, n - 1).long(),
                        torch.where(vmask, new_com, -1).to(torch.int32),
                        "amax")
    return torch.clamp(out, 0, n - 1)


def _run_level(run: _Run, cur: Graph, assign, init_com, level: int,
               spec: EngineSpec, ell=None):
    """One level: local moving from ``init_com`` → remap (+ coarsen) →
    modularity; under Leiden, when the level is not done, refinement →
    coarsen by the refined partition → macro seed.  Returns
    ``(next_graph, next_assign, next_init, macro_assign, done)``; when
    done the graph, assignment and seed stay (Alg. 3 l.6), as the JAX
    package's ``stay`` branch keeps them."""
    cfg, timer = run.cfg, run.timer
    per_level = cfg.per_level_timing
    n = cur.n_max
    if "nan_weight" in run.faults and level == 1:
        # fault injection: poison one weight of level 1's graph, on a copy
        w = cur.w.clone()
        w[0] = float("nan")
        cur = dataclasses.replace(cur, w=w)
    # numeric guard rail: non-finite weights poison every sum silently
    if bool(torch.any(cur.edge_mask & ~torch.isfinite(cur.w))):
        raise NumericError(
            f"non-finite edge weight detected at level {level}")
    vmask = cur.vertex_mask()
    with timer.phase("ell_build") if ell is None and spec.ell_width == 0 \
            and spec.backend in ("ell", "pallas") \
            else contextlib.nullcontext():
        engine = SweepEngine(cur, spec, ell)
    with _tphase(timer, "local_moving", level, per_level):
        res = engine.run_phase(init_com, vmask,
                               it0=level * LEVEL_IT_STRIDE, seed=cfg.seed,
                               fused=cfg.fused)
    com = res.labels
    with _tphase(timer, "aggregation", level, per_level):
        if cfg.refine:
            # Leiden coarsens by the REFINED partition below
            new_com, n_comm = aggregation.remap_communities(com, vmask)
            path = "none"
        else:
            new_com, n_comm, coarse, path = _aggregate(run, cur, com)
        macro_assign = new_com[torch.clamp(assign, 0, n - 1)]
    done = n_comm == cur.n_valid              # Alg. 3 l.6 convergence
    if cfg.refine and not done:
        with _tphase(timer, "refinement", level, per_level):
            ref = _refine_partition(cur, com, cfg, level, run.faults)
        with _tphase(timer, "aggregation", level, per_level):
            new_ref, _n_ref, coarse, path = _aggregate(run, cur, ref)
            next_assign = new_ref[torch.clamp(assign, 0, n - 1)]
            next_init = _macro_seed(new_com, new_ref, vmask)
    elif not done:
        next_assign = macro_assign
        next_init = torch.arange(n, dtype=torch.int32, device=cur.device)
    hist = run.hist
    hist.sweeps.append(res.sweeps)
    hist.delta_n.append(res.delta_n_history)
    hist.n_comm.append(n_comm)
    hist.aggregation.append(path)
    if cfg.track_modularity:
        # a batch lane's g0 is the request's own graph, below the lane's
        # capacity: its vertices are the prefix of the lane's
        hist.modularity.append(float(modularity(
            run.g0, macro_assign[:run.g0.n_max], promote=run.promote)))
    if done:
        return cur, assign, init_com, macro_assign, True
    return coarse, next_assign, next_init, macro_assign, False


def _new_run(g: Graph, cfg: LouvainConfig, g_original: Optional[Graph],
             promote: bool, faults: frozenset) -> _Run:
    # the pallas backend ranks bins with the bin_rank wrapper, which
    # launches its kernel on the card; every other backend stays plain
    return _Run(cfg=cfg, g0=g_original if g_original is not None else g,
                impl="kernel" if cfg.backend == "pallas" else "ref",
                promote=promote, faults=faults, timer=Timer(),
                hist=_Levels())


def _result(run: _Run, macro, levels: int, stages: list) -> LouvainResult:
    """The final remap on the original vertices, Q and the histories."""
    g0 = run.g0
    final_assign, n_final = aggregation.remap_communities(
        macro[:g0.n_max], g0.vertex_mask())
    h = run.hist
    return LouvainResult(
        labels=final_assign.cpu().numpy(),
        n_communities=n_final,
        levels=levels,
        modularity=float(modularity(g0, final_assign, promote=run.promote)),
        modularity_history=h.modularity,
        sweeps_per_level=h.sweeps,
        timer=run.timer,
        n_comm_per_level=h.n_comm,
        delta_n_per_level=h.delta_n,
        cascade_stages=stages,
        aggregation_per_level=h.aggregation,
    )


def _louvain_per_level(g: Graph, cfg: LouvainConfig,
                       g_original: Optional[Graph],
                       promote: bool = False,
                       faults: frozenset = frozenset()) -> LouvainResult:
    """Per-level driver: one local-moving phase per level, then aggregation
    and the Alg. 3 convergence check; level 0 on the configured backend,
    coarse levels on the segment evaluator."""
    run = _new_run(g, cfg, g_original, promote, faults)
    assign = torch.arange(g.n_max, dtype=torch.int32, device=g.device)
    init_com, cur = assign, g
    for level in range(cfg.max_levels):
        spec = engine_spec(cfg, backend=cfg.backend if level == 0
                           else _coarse_backend(cfg.backend), faults=faults)
        cur, assign, init_com, macro, done = _run_level(
            run, cur, assign, init_com, level, spec)
        if done:
            break
    return _result(run, macro, level + 1, [])


# ------------------------------------------------------------ the cascade


@dataclasses.dataclass
class _Stage:
    """What one cascade stage hands back to the scheduler."""

    graph: Graph              # the carried graph, at the stage's capacity
    assign: torch.Tensor      # original vertex -> current super-vertex
    init_com: torch.Tensor    # the next level's seed partition
    macro: torch.Tensor       # the last level's partition of the original
    level: int                # levels run so far
    done: bool
    max_deg: int              # carried graph's largest degree, loops incl.


def _run_stage(run: _Run, spec0: Optional[EngineSpec],
               spec_coarse: EngineSpec,
               next_caps: Optional[Tuple[int, int]], g: Graph, ell, assign,
               init_com, macro, level: int) -> _Stage:
    """One stage of the cascade at ``g``'s capacity (the JAX package's
    ``_build_stage``).  ``spec0`` marks stage 0: level 0 is peeled out —
    the only level that may use the host-built ELL ``ell``.  The level
    loop then runs ``spec_coarse`` until the run is done, the level budget
    is spent, or the carried graph (Leiden's: the one coarsened by the
    refined partition) fits ``next_caps`` (the next capacity), and hands
    control back to the scheduler."""
    cur, done = g, False
    if spec0 is not None:
        cur, assign, init_com, macro, done = _run_level(
            run, g, assign, init_com, 0, spec0, ell)
        level = 1

    def fits():
        return (next_caps is not None and cur.n_valid <= next_caps[0]
                and cur.m_valid <= next_caps[1])

    while level < run.cfg.max_levels and not done and not fits():
        cur, assign, init_com, macro, done = _run_level(
            run, cur, assign, init_com, level, spec_coarse)
        level += 1
    max_deg = 0
    if next_caps is not None:
        # only a stage that can descend pays for the degree count: the
        # next stage's tile width is picked from it
        deg = torch.bincount(cur.src[cur.edge_mask].long(),
                             minlength=cur.n_max)
        max_deg = int(deg[:cur.n_valid].max()) if cur.n_valid else 0
    return _Stage(cur, assign, init_com, macro, level, done, max_deg)


def _single_stage_run(g: Graph, cfg: LouvainConfig, spec0: EngineSpec,
                      spec_coarse: EngineSpec, g_original: Graph,
                      promote: bool, faults: frozenset) -> LouvainResult:
    """The single-capacity whole-run stage on ``g`` (the JAX package's
    ``_build_stage(..., next_caps=None)``): level 0 on ``spec0`` with no
    host-built ELL, then ``spec_coarse`` until the run is done or
    ``max_levels`` is spent — the batched engine's Louvain lane.

    ``g`` is the request ``g_original`` padded to its bucket's capacity.
    Labels, Q and its history are taken on ``g_original``: the padded
    vertices are the suffix of ``g``'s, and ``torch.sum`` over an array
    with trailing zeros may round otherwise than over the array without
    them, so Q on the padded graph could differ from the single-graph
    run's in its last bits.  ``cascade_stages`` is ``g``'s capacity.  No
    report is attached (the caller finalizes it)."""
    run = _new_run(g, cfg, g_original, promote, faults)
    ar = torch.arange(g.n_max, dtype=torch.int32, device=g.device)
    with run.timer.phase("pipeline"):
        st = _run_stage(run, spec0, spec_coarse, None, g, None, ar, ar, ar,
                        0)
    return _result(run, st.macro, st.level, [(g.n_max, g.m_max)])


# ------------------------------------------------- stage checkpoint/resume


def _ckpt_fingerprint(cfg: LouvainConfig, g: Graph) -> dict:
    """Identity of a checkpointable run: the full config (minus the
    checkpoint location) and a cheap graph identity (capacities, live
    counts, masked weight sum).  A checkpoint whose fingerprint differs is
    IGNORED (``louvain.ckpt_mismatch_ignored``): resuming another run's
    state would be a silent wrong answer.  The json round trip turns
    tuples into lists, so the comparison with the manifest is exact."""
    d = cfg.to_dict()
    d.pop("checkpoint_dir", None)
    return json.loads(json.dumps({
        "cfg": d,
        "graph": {"n_max": int(g.n_max), "m_max": int(g.m_max),
                  "n_valid": int(g.n_valid), "m_valid": int(g.m_valid),
                  "w_sum": float(torch.sum(
                      torch.where(g.edge_mask, g.w, 0.0)))}}))


def _ckpt_save_stage(ckpt_dir: str, fp: dict, k: int, width: int,
                     stage_idxs, g_k: Graph, assign, init_com, macro,
                     level: int, hist: _Levels) -> None:
    """Save the carried state at a cascade stage boundary — the graph
    entering stage ``k`` (after its shrink), the assignment chain, the
    next level's seed, the last macro partition and the level counter —
    through the atomic write-then-rename checkpointer, so a crash mid-save
    never corrupts the last committed boundary.  The host-side histories,
    ``k``, the traced-tile width and the stages entered ride the
    manifest."""
    tree = {"graph": [g_k.src, g_k.dst, g_k.w, g_k.edge_mask,
                      np.int64(g_k.n_valid), np.int64(g_k.m_valid)],
            "assign": assign, "init_com": init_com, "macro": macro,
            "level": np.int64(level)}
    meta = {"fingerprint": fp,
            "stage": {"k": int(k), "width": int(width),
                      "stage_idxs": [int(j) for j in stage_idxs]},
            "hist": dataclasses.asdict(hist)}
    checkpoint.save(ckpt_dir, len(stage_idxs), tree,
                    config_json=json.dumps(meta), keep=2)
    telemetry.bump("louvain.ckpt_save")


def _ckpt_try_resume(cfg: LouvainConfig, caps, n0: int, fp: dict,
                     device: torch.device):
    """The latest committed stage boundary, restored onto ``device`` (the
    graph's), or None: no checkpoint, or one of another run."""
    ckpt_dir = cfg.checkpoint_dir
    step = checkpoint.latest_step(ckpt_dir)
    if step is None:
        return None
    meta = checkpoint.read_config(ckpt_dir, step)
    if meta.get("fingerprint") != fp:
        telemetry.bump("louvain.ckpt_mismatch_ignored")
        return None
    stage = meta["stage"]
    k, width = int(stage["k"]), int(stage["width"])
    stage_idxs = [int(j) for j in stage["stage_idxs"]]
    if not 0 < k < len(caps):
        telemetry.bump("louvain.ckpt_mismatch_ignored")
        return None
    n_k, m_k = caps[k]

    def spec(size, dtype=torch.int32):
        return torch.empty(size, dtype=dtype, device="meta")

    like = {"graph": [spec(m_k), spec(m_k), spec(m_k, torch.float32),
                      spec(m_k, torch.bool), np.int64(0), np.int64(0)],
            "assign": spec(n0), "init_com": spec(n_k), "macro": spec(n0),
            "level": np.int64(0)}
    tree = checkpoint.restore(ckpt_dir, step, like, device=device)
    src, dst, w, em, nv, mv = tree["graph"]
    g_k = Graph(src=src, dst=dst, w=w, edge_mask=em, n_valid=int(nv),
                m_valid=int(mv), n_max=n_k, m_max=m_k, sorted_by="src")
    return (k, width, stage_idxs, g_k, tree["assign"], tree["init_com"],
            tree["macro"], int(tree["level"]), _Levels(**meta["hist"]))


def _ckpt_clear(ckpt_dir: str) -> None:
    """Drop the committed stage checkpoints after a successful run, so the
    next run in this directory starts fresh."""
    for s in checkpoint.all_steps(ckpt_dir):
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _louvain_pipeline(g: Graph, cfg: LouvainConfig,
                      g_original: Optional[Graph],
                      promote: bool = False,
                      faults: frozenset = frozenset()) -> LouvainResult:
    """The capacity cascade (the JAX package's ``_louvain_pipeline``): at
    most ``len(schedule)`` stages, each descending to the SMALLEST
    capacity the carried graph fits, with the next stage's traced-tile
    width re-picked from the carried graph's largest degree.  A one-entry
    schedule is the single-capacity pipeline, ≡ the per-level driver.
    With ``checkpoint_dir`` each boundary is saved after the shrink, and a
    run finding a checkpoint of its own config and graph resumes there: a
    resumed stage k > 0 scores its coarse levels on traced tiles, so it
    needs no host-built ELL."""
    run = _new_run(g, cfg, g_original, promote, faults)
    caps = _resolve_schedule(cfg, g)
    cascade = len(caps) > 1
    spec0 = engine_spec(cfg, faults=faults)
    arange0 = torch.arange(g.n_max, dtype=torch.int32, device=g.device)
    assign = init_com = macro = arange0
    k, level, g_k, ell_k = 0, 0, g, None
    width = pick_ell_width(None, *caps[0])
    stage_idxs: list = []
    # only a cascading schedule has boundaries to commit
    ckpt_fp = None
    if cfg.checkpoint_dir and cascade:
        ckpt_fp = _ckpt_fingerprint(cfg, g)
        resumed = _ckpt_try_resume(cfg, caps, g.n_max, ckpt_fp, g.device)
        if resumed is not None:
            (k, width, stage_idxs, g_k, assign, init_com, macro, level,
             run.hist) = resumed
            telemetry.bump("louvain.ckpt_resume")
    if k == 0 and cfg.backend in ("ell", "pallas"):
        with run.timer.phase("ell_build"):
            ell_k = build_ell(g)
    with run.timer.phase("pipeline"):
        while True:
            st = _run_stage(run, spec0 if k == 0 else None,
                            _cascade_coarse_spec(cfg, cascade, width, faults),
                            caps[k + 1] if k + 1 < len(caps) else None,
                            g_k, ell_k, assign, init_com, macro, level)
            assign, init_com, macro, level = (st.assign, st.init_com,
                                              st.macro, st.level)
            stage_idxs.append(k)
            if k + 1 >= len(caps) or st.done or level >= cfg.max_levels:
                break
            nv, mv = st.graph.n_valid, st.graph.m_valid
            k2 = k
            for j in range(k + 1, len(caps)):
                if nv <= caps[j][0] and mv <= caps[j][1]:
                    k2 = j
            if k2 == k:
                # unreachable by the stage's exit predicate (done, budget
                # or fits-next); typed so louvain() retries on one capacity
                raise CapacityError(
                    "cascade invariant violated: stage exited without "
                    f"done/budget and ({nv}, {mv}) fits no capacity in "
                    f"{caps[k + 1:]}")
            g_k = aggregation.shrink_graph(st.graph, *caps[k2])
            # Leiden's seed is a contiguized macro id < n_comm <= nv, so it
            # stays valid in the smaller capacity
            init_com = init_com[:caps[k2][0]]
            ell_k, k = None, k2
            width = pick_ell_width(st.max_deg, *caps[k])
            if ckpt_fp is not None:
                _ckpt_save_stage(cfg.checkpoint_dir, ckpt_fp, k, width,
                                 stage_idxs, g_k, assign, init_com, macro,
                                 level, run.hist)
            if faultinject.consume("preempt_stage"):
                # AFTER the checkpoint committed: a kill between stages,
                # the window the resume path must cover
                raise resilience.Preempted(
                    "injected preemption at cascade stage boundary "
                    f"(entering stage k={k})")
    if ckpt_fp is not None:
        _ckpt_clear(cfg.checkpoint_dir)
    return _result(run, macro, level, [caps[j] for j in stage_idxs])

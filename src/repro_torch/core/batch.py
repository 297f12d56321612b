"""Batched many-graph engine (port of ``repro.core.batch``).

The single-graph drivers make ONE graph fast.  Serving traffic is the
opposite shape — many small graphs (ego-nets, session graphs), where the
per-graph overhead around the kernels dominates.  ``louvain_batch`` /
``plp_batch`` take that traffic as the JAX package does:

  1. **bucket** the graphs by ``kernels.common.capacity_signature``: the
     capacities quantize onto a doubling menu with ego-net-scale floors,
     so traffic of any size lands on a handful of buckets;
  2. **chunk** each bucket, in input order, into at most ``max_slots``
     graphs, each chunk one watchdogged dispatch;
  3. **run** the chunk's graphs one after another, each padded to the
     bucket's capacities (``graph.packing.pad_graph``).  The JAX package
     stacks a chunk along a batch axis and lifts one compiled program over
     it with ``jax.vmap``; the port has no vmap, and the batch axis is not
     yet in the kernels' grid (ROADMAP P6), so each lane launches its own
     kernels and there is nothing to stack.

A Louvain lane is the single-capacity whole-run stage
(``louvain._single_stage_run``): level 0 on the bucket's traced ELL tile
(``EngineSpec.ell_width`` = the signature's width, so no host layout is
built per request), coarse levels on the segment evaluator.  A PLP lane is
one phase of the sweep engine on the same traced tile.  On the ``pallas``
backend the lanes launch the ``local_move`` kernels on their tiles and
``bin_rank`` in each binned coarsening; the JAX package sends ``pallas`` to
``ell`` under vmap instead, which the port does not need.  Buckets whose
graphs are not sorted by source run the segment evaluator (the traced tile
needs the sort), counted as ``batch.unsorted_segment_fallback``.  Per-graph
results equal the single-graph drivers' (``louvain(g, cfg)``,
``plp(g, cfg)``) by the capacity-portability contract, bit for bit where
the weights are integers (every float32 sum exact); see
``louvain._single_stage_run`` for Q.

Per-graph ``RunReport`` discipline holds: zero-capacity graphs return the
trivial result without a slot; a non-finite weight found by a lane's
per-level guard poisons that lane only, and one ``NumericError`` names the
offending graphs after the loop (the clean lanes' results are dropped with
it, as in the JAX package); watchdog and precision warnings are recorded
per lane.  ``deadline_s`` bounds the whole call: each chunk runs under the
remaining-budget watchdog (``utils.resilience.call_with_deadline``), where
the serving fault sites ``slow_dispatch`` and ``transient_batch_fail``
fire.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import louvain as louvain_mod
from repro_torch.core import plp as plp_mod
from repro_torch.core.engine import SweepEngine
from repro_torch.core.louvain import LouvainConfig, LouvainResult
from repro_torch.core.plp import PLPConfig, PLPResult
from repro_torch.graph import packing
from repro_torch.graph.structure import Graph
from repro_torch.kernels.common import (CapacitySignature,
                                        accum_needs_promotion,
                                        capacity_signature)
from repro_torch.utils import faultinject, resilience, telemetry
from repro_torch.utils.errors import (DeadlineError, KernelError,
                                      NumericError, RunReport)
from repro_torch.utils.timing import Timer

#: Default chunk width: a bucket wider than this is split into chunks of at
#: most ``MAX_SLOTS`` graphs (the JAX package's value, which bounds the
#: lockstep waste of its vmapped while-loops; here it bounds the
#: watchdog's unit of work).
MAX_SLOTS = 8


def _dispatch_guarded(run, deadline: Optional[resilience.Deadline]):
    """Run one chunk under the serving resilience contract: the fault sites
    fire HERE, inside the watchdogged callable (a stalled dispatch looks
    like a hung device), and with a deadline the whole chunk runs under
    ``resilience.call_with_deadline`` — on overrun the wait ends with a
    typed ``DeadlineError`` and the worker thread is abandoned (its device
    work runs on; its results are dropped).  ``deadline=None`` is the clean
    path: a plain inline call, no thread."""

    def attempt():
        if faultinject.should_fire("slow_dispatch"):
            # a hung device: stall inside the watchdog window
            time.sleep(faultinject.slow_dispatch_seconds())
        if faultinject.should_fire("transient_batch_fail"):
            raise KernelError(
                "injected transient batch dispatch failure "
                "(fault point: transient_batch_fail)")
        return run()

    return resilience.call_with_deadline(
        attempt, deadline.remaining_s() if deadline is not None else None)


def _resolve_batch_backend(backend: str, sorted_ok: bool) -> str:
    """``ell``/``pallas`` → ``segment`` for a bucket without the src-sorted
    invariant the traced tile needs (bit-identical by the parity
    contracts, counted as ``batch.unsorted_segment_fallback``)."""
    if backend in ("ell", "pallas") and not sorted_ok:
        telemetry.bump("batch.unsorted_segment_fallback")
        backend = "segment"
    return backend


def _chunks(idxs: List[int], max_slots: int):
    if max_slots < 1:
        raise ValueError(f"max_slots must be >= 1, got {max_slots}")
    for k in range(0, len(idxs), max_slots):
        yield idxs[k:k + max_slots]


def _buckets(graphs, trivial, results, active_faults):
    """Zero-capacity graphs get ``trivial(report)``; the rest are grouped
    by ``(capacity signature, sorted_by)``, in input order."""
    buckets: Dict[Tuple, List[int]] = {}
    for i, g in enumerate(graphs):
        if g.n_max == 0:
            results[i] = trivial(RunReport(faults=list(active_faults)))
            continue
        sig = capacity_signature(g.n_max, g.m_max)
        buckets.setdefault((sig, g.sorted_by), []).append(i)
    return buckets


def _run_buckets(buckets, max_slots, deadline, deadline_s,
                 run_chunk) -> None:
    for (sig, sorted_by), idxs in buckets.items():
        for chunk in _chunks(idxs, max_slots):
            if deadline is not None and deadline.expired:
                raise DeadlineError(
                    f"batch deadline ({deadline_s:.3f}s) expired with "
                    "bucket dispatches still pending")
            run_chunk(chunk, sig, sorted_by)


# ------------------------------------------------------------------- louvain


def _louvain_specs(cfg: LouvainConfig, sig: CapacitySignature,
                   backend: str, faults: frozenset):
    spec0 = louvain_mod.engine_spec(cfg, backend=backend, faults=faults)
    if backend in ("ell", "pallas"):
        # no host-built layout in the batched path: level 0 scores the
        # traced tile at the signature's static menu width
        spec0 = spec0.replace(ell_width=sig.ell_width)
    # coarse levels as in the single-capacity run: the segment evaluator
    spec_coarse = louvain_mod.engine_spec(
        cfg, backend=louvain_mod._coarse_backend(backend), faults=faults)
    return spec0, spec_coarse


def louvain_batch(graphs: Sequence[Graph],
                  cfg: LouvainConfig = LouvainConfig(),
                  max_slots: int = MAX_SLOTS,
                  deadline_s: Optional[float] = None
                  ) -> List[LouvainResult]:
    """Run Louvain (Leiden under ``cfg.refine``) over many graphs, bucketed
    by capacity signature; buckets wider than ``max_slots`` are chunked in
    input order.

    Results are positionally aligned with ``graphs`` and equal
    ``louvain(g, cfg)`` per graph in labels, Q, levels, communities and
    every per-level history; ``cascade_stages`` holds the bucket's one
    capacity, and ``aggregation_per_level`` may differ where the bin gate,
    sized from the capacity, differs.  Zero-capacity graphs return the
    trivial result without a slot; if the numeric guard flags non-finite
    weights in some lanes, one ``NumericError`` names those graph indices.

    ``deadline_s`` bounds the WHOLE call: each chunk runs under the
    remaining-budget watchdog and overrun raises ``DeadlineError`` (the
    serving layer splits per-request deadlines).  ``None`` is the clean
    path: no watchdog thread."""
    graphs = list(graphs)
    results: List[Optional[LouvainResult]] = [None] * len(graphs)
    active_faults = sorted(faultinject.active())
    faults = frozenset(active_faults)
    deadline = (resilience.Deadline(deadline_s)
                if deadline_s is not None else None)
    bad: List[int] = []

    def run_chunk(idxs, sig, sorted_by):
        backend = _resolve_batch_backend(cfg.backend, sorted_by == "src")
        spec0, spec_coarse = _louvain_specs(cfg, sig, backend, faults)
        promote = accum_needs_promotion(sig.m_cap)

        def lanes():
            out: list = []
            for i in idxs:
                report = RunReport(faults=list(active_faults))
                if promote:
                    report.warnings.append("precision:f32_accum_risk")
                lane = packing.pad_graph(graphs[i], sig.n_cap, sig.m_cap)
                try:
                    res = louvain_mod._single_stage_run(
                        lane, cfg, spec0, spec_coarse, graphs[i], promote,
                        faults)
                    out.append(louvain_mod._finalize_report(res, cfg,
                                                            report))
                except NumericError as err:
                    err.report = report
                    out.append(err)
            return out

        done = _dispatch_guarded(lanes, deadline)
        telemetry.bump("batch.louvain_dispatches")
        telemetry.bump("batch.louvain_graphs", len(idxs))
        for i, res in zip(idxs, done):
            if isinstance(res, NumericError):
                bad.append(i)
            else:
                results[i] = res

    _run_buckets(_buckets(graphs, louvain_mod._trivial_result, results,
                          active_faults),
                 max_slots, deadline, deadline_s, run_chunk)
    if bad:
        raise NumericError(
            "non-finite edge weight detected inside the level loop for "
            f"graph(s) {sorted(bad)}")
    return results  # type: ignore[return-value]


# ----------------------------------------------------------------------- plp


def plp_batch(graphs: Sequence[Graph],
              cfg: PLPConfig = PLPConfig(),
              max_slots: int = MAX_SLOTS,
              deadline_s: Optional[float] = None) -> List[PLPResult]:
    """Run PLP over many graphs — ``louvain_batch``'s contract (positional
    results equal to ``plp(g, cfg)`` per graph, the trivial result for
    zero-capacity inputs, a per-lane RunReport, the ``max_slots`` chunk
    bound, the ``deadline_s`` whole-call watchdog) for the
    label-propagation evaluator.  A lane is one sweep-engine phase from
    singletons (the JAX package's ``device_phase`` lane)."""
    graphs = list(graphs)
    results: List[Optional[PLPResult]] = [None] * len(graphs)
    active_faults = sorted(faultinject.active())
    faults = frozenset(active_faults)
    deadline = (resilience.Deadline(deadline_s)
                if deadline_s is not None else None)

    def run_chunk(idxs, sig, sorted_by):
        backend = _resolve_batch_backend(cfg.backend, sorted_by == "src")
        spec = plp_mod.engine_spec(cfg, faults).replace(backend=backend)
        if backend in ("ell", "pallas"):
            spec = spec.replace(ell_width=sig.ell_width)

        def lanes():
            out = []
            for i in idxs:
                timer = Timer()
                engine = SweepEngine(
                    packing.pad_graph(graphs[i], sig.n_cap, sig.m_cap), spec)
                with timer.phase("move"):
                    res = engine.run_phase(*engine.singleton_state(), it0=0,
                                           seed=cfg.seed)
                report = RunReport(faults=list(active_faults))
                out.append(plp_mod._result(res, graphs[i].n_max, cfg, timer,
                                           report))
            return out

        done = _dispatch_guarded(lanes, deadline)
        telemetry.bump("batch.plp_dispatches")
        telemetry.bump("batch.plp_graphs", len(idxs))
        for i, res in zip(idxs, done):
            results[i] = res

    _run_buckets(_buckets(graphs, plp_mod._trivial_result, results,
                          active_faults),
                 max_slots, deadline, deadline_s, run_chunk)
    return results  # type: ignore[return-value]

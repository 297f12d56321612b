"""Community detection over the ranks of a ``torch.distributed`` process
group (port of ``repro.core.distributed``).

Decomposition, as in the JAX package:
  * directed edges are sorted by destination and split into contiguous,
    edge-balanced vertex ranges (``graph.partition``); rank d OWNS the
    vertices in its range and ALL edges into them, so the per-vertex
    GroupBy (``core.moves``) needs no cross-rank reduction;
  * the O(n) state (labels, communities, degrees) is replicated; each sweep
    ends with an all-reduce that merges the disjoint per-owner proposals
    (``core.engine.make_distributed_step``);
  * derived O(n) state (community volumes and sizes) is recomputed on every
    rank from replicated inputs.

Every rank calls the same driver on the same ``Graph``; the group's size is
the JAX mesh's device count and its rank the linear device index.  Every
tensor stays on ``g.device``: an ``nccl`` group needs the graph on the card,
``gloo`` takes it on the CPU or on the card (several ranks may share one
card).  The edge partition itself is host numpy, as in the JAX package.

Louvain aggregation comes in three forms:
  * per level (``pipeline_fused=False``): every rank coarsens the whole
    level graph, then re-partitions it for the next level;
  * fused, SHARD-LOCAL coarsening (the default): each rank coarsens only
    its owned edges with the binned aggregation (``bin_rank``); community
    ids are made contiguous by a two-phase scheme (per-rank stripes of the
    presence bitmap and an all-gather of the stripe counts), the first
    ``halo_cap`` partial groups of every rank are all-gathered and merged
    by a second, identity-map coarsening.  An all-reduced flag records a
    rank whose partial list overflowed the cap; the driver then reruns
    replicated;
  * fused, REPLICATED coarsening: the parity oracle — the shard is
    all-gathered once, and every rank coarsens the whole list.
Coarse levels sweep on the merged (replicated) coarse list, masked by a
contiguous ``ceil(n/D)``-vertex dst-range ownership.

The JAX package runs the fused level loop inside one ``shard_map``
program; here it is a host loop over eager levels.  Every branch that
holds a collective runs on every rank alike, and every loop exit depends
on all-reduced values only, so the ranks stay in lockstep.

Shard-local, replicated and single-device results are equal bit for bit
on integer-valued weights: every cross-rank sum is a sum of integers,
exact in float32 below ``kernels.common.F32_ACCUM_SAFE`` in any order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import aggregation
from repro_torch.core.engine import (EngineSpec, all_gather_cat,
                                     all_gather_stack, all_reduce_max,
                                     all_reduce_sum, distributed_phase)
from repro_torch.core.modularity import modularity
from repro_torch.graph import segment as seg
from repro_torch.graph.partition import (EdgePartition, build_halo,
                                         partition_edges_by_dst,
                                         partition_quality)
from repro_torch.graph.structure import Graph
from repro_torch.kernels.aggregation.ops import binned_coarsen
from repro_torch.kernels.common import (EDGE_WIRE_BYTES, LABEL_WIRE_BYTES,
                                        accum_dtype, accum_needs_promotion,
                                        cdiv, dist_comm_bytes_per_level,
                                        pick_halo_cap)
from repro_torch.utils import faultinject, telemetry
from repro_torch.utils.errors import RunReport, ShardError
from repro_torch.utils.timing import Timer

COARSENING_MODES = ("shard_local", "replicated")


# ----------------------------------------------------------------- helpers


def _world(g: Graph, group) -> tuple[int, int]:
    """(D, d): the group's size and this process's rank in it.  An
    ``nccl`` group with a graph off the card is refused: nothing carries on
    on the CPU when the card was asked for."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "torch.distributed is not initialized: start the ranks with "
            "launch.ranks.init_group (or init_process_group) first")
    if dist.get_backend(group) == "nccl" and g.device.type != "cuda":
        raise ValueError(
            f"an nccl group needs the graph on the card, not on {g.device}")
    return dist.get_world_size(group), dist.get_rank(group)


def _engine_faults(faults: frozenset) -> tuple:
    from repro_torch.core.louvain import ENGINE_FAULTS

    return tuple(sorted(f for f in faults if f in ENGINE_FAULTS))


def _prepare_partition(g: Graph, n_devices: int) -> EdgePartition:
    """Partition and the shard-coverage guard.

    The ``shard_drop`` fault site masks out rank 0's whole edge shard after
    partitioning — a lost or corrupted shard.  The guard re-counts the
    masks against the graph's ``m_valid`` BEFORE any compute: losing edges
    would otherwise give a quietly worse partition.  Every rank partitions
    the same graph, so every rank raises."""
    part = partition_edges_by_dst(g, n_devices)
    if faultinject.is_active("shard_drop"):
        telemetry.bump("fault.shard_drop.injected")
        emask = np.array(part.edge_mask)
        emask[0, :] = False
        part = dataclasses.replace(part, edge_mask=emask)
    covered = int(np.asarray(part.edge_mask).sum())
    expect = int(g.m_valid)
    if covered != expect:
        raise ShardError(
            f"edge partition covers {covered} directed edges, graph has "
            f"{expect}: a shard was dropped or corrupted")
    return part


def shard_edges(p: EdgePartition, rank: int, device) -> tuple:
    """This rank's row of the partition arrays, on ``device``:
    ``(src, dst, w, edge_mask)``, each of length ``m_pad``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a[rank])).to(device)
                 for a in (p.src, p.dst, p.w, p.edge_mask))


# ----------------------------------------------------------------- PLP


def distributed_plp(
    g: Graph,
    group=None,
    max_iterations: int = 100,
    threshold: int = 0,
    seed: int = 0,
    tie_eps: float = 0.25,
    move_prob: float = 0.75,
):
    """Partition once, then one distributed PLP phase with the tie noise
    re-drawn every sweep.  Returns ``(labels, ΔN history)`` (numpy, list),
    the same on every rank."""
    D, d = _world(g, group)
    n = g.n_max
    part = _prepare_partition(g, D)
    shard = shard_edges(part, d, g.device)
    spec = EngineSpec(
        evaluator="plp",
        backend="distributed",
        max_sweeps=max_iterations,
        threshold=threshold,
        tie_eps=tie_eps,
        move_prob=move_prob,
        reshuffle_ties=True,
        faults=_engine_faults(faultinject.active()),
    )
    labels = torch.arange(n, dtype=torch.int32, device=g.device)
    zero = torch.zeros(n, dtype=torch.float32, device=g.device)
    res = distributed_phase(spec, group, n, shard, labels, g.vertex_mask(),
                            0, seed, zero, torch.ones((), device=g.device),
                            g.n_valid)
    return res.labels.cpu().numpy(), res.delta_n_history


# ----------------------------------------------------------------- Louvain


@dataclasses.dataclass
class DistLouvainResult:
    labels: np.ndarray
    n_communities: int
    levels: int
    modularity: float
    timer: Timer
    sweeps_per_level: list = dataclasses.field(default_factory=list)
    n_comm_per_level: list = dataclasses.field(default_factory=list)
    modularity_history: list = dataclasses.field(default_factory=list)
    delta_n_per_level: list = dataclasses.field(default_factory=list)
    # the coarsening that produced the answer ("shard_local", "replicated"
    # or "per_level"), after any overflow degradation
    coarsening: str = "replicated"
    # partition health (graph.partition.partition_quality._asdict()) and the
    # per-level collective-payload accounting of the fused pipeline
    partition_stats: dict = dataclasses.field(default_factory=dict)
    comm_stats: dict = dataclasses.field(default_factory=dict)
    run_report: RunReport = dataclasses.field(default_factory=RunReport)


@dataclasses.dataclass
class _PipelineOut:
    final: torch.Tensor
    n_final: int
    levels: int
    modularity: float
    sweeps: list
    n_comm: list
    mod_hist: list
    delta_n: list
    gathered: list           # partial groups gathered per level, -1: none
    overflow: bool


def _pipeline(group, shard, n: int, n_valid0: int, m_pad: int,
              spec: EngineSpec, max_levels: int, agg_method: str,
              faults: frozenset, coarsening: str, halo_cap: int,
              refine_sweeps: int, track_modularity: bool, promote: bool,
              seed: int) -> _PipelineOut:
    """The fused level loop on this rank's level-0 ``shard`` (the JAX
    package's ``make_distributed_pipeline`` worker):

      * level 0 sweeps on the local edge-balanced shard;
      * ``shard_local``: ``contiguize`` + per-rank binned coarsening of
        the owned edges, the first ``h_cap`` partial groups all-gathered
        and merged at capacity ``D·h_cap``; ``replicated``: the shard is
        all-gathered once into the ``D·m_pad`` list and every rank
        coarsens it alike;
      * coarse levels sweep on the merged list under a ``ceil(n/D)``
        dst-range ownership;
      * ``refine_sweeps > 0`` is Leiden: a threshold-0 phase from
        singletons restricted to the macro communities, aggregation by the
        refined partition, the next level seeded with each super-vertex's
        macro id.  It runs on the level that ends the run too, as in the
        JAX package, whose gathered-group count and overflow flag come
        from it;
      * Q is the all-reduced decomposition of ``core.modularity`` over the
        level-0 shards (``dist_q``)."""
    from repro_torch.core.louvain import (LEVEL_IT_STRIDE, REFINE_IT_OFFSET,
                                          _macro_seed)

    D, d = dist.get_world_size(group), dist.get_rank(group)
    stride = cdiv(n, D)       # coarse-ownership dst-range width
    n_pad_c = D * stride - n  # stripe padding of the presence bitmap
    if coarsening == "shard_local":
        h_cap = halo_cap      # resolved by _resolve_halo_cap
        m_c = D * h_cap       # capacity of the merged coarse list
    else:
        h_cap = 0
        m_c = D * m_pad       # capacity of the gathered edge list
    refine = refine_sweeps > 0
    refine_spec = (spec.replace(max_sweeps=refine_sweeps, threshold=0)
                   if refine else None)
    force_overflow = "binned_overflow" in faults
    accum_dtype(promote)      # records the float32 risk; the sums stay float32
    src_l, dst_l, w_l, emask_l = shard
    dev = src_l.device
    lo = d * stride
    hi = min(lo + stride, n)
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)

    def clip(x):
        return torch.clamp(x, 0, n - 1)

    def sweep(sp, s, n_valid, vmask, init_com, it0, restrict=None):
        """One local-moving phase over the edge arrays ``s``."""
        src, dst, w, own = s
        deg = all_reduce_sum(seg.segment_sum(
            torch.where(own, w, 0.0), clip(src), n), group)
        res = distributed_phase(sp, group, n, s, init_com, vmask, it0, seed,
                                deg, torch.sum(deg), n_valid, restrict)
        return res.labels, res.sweeps, res.delta_n_history

    def dist_q(com):
        """``core.modularity`` from the level-0 shards' partial sums, one
        all-reduce: each is a sum of integers for integer weights, so the
        result is the single-device Q bit for bit."""
        wm = torch.where(emask_l, w_l, 0.0)
        same = com[clip(src_l)] == com[clip(dst_l)]
        local = torch.cat([seg.segment_sum(wm, src_l, n),
                           torch.sum(wm).reshape(1),
                           torch.sum(torch.where(same, wm, 0.0)).reshape(1)])
        tot = all_reduce_sum(local, group)
        deg, vol_v, w_in = tot[:n], tot[n], tot[n + 1]
        vol_c = seg.segment_sum(deg, com, n)
        safe = torch.where(vol_v > 0, vol_v, torch.ones_like(vol_v))
        q = w_in / safe - torch.sum((vol_c / safe) ** 2)
        return float(torch.where(vol_v > 0, q, torch.zeros_like(q)))

    def contiguize(com, vmask):
        """Two-phase contiguization ≡ ``aggregation.remap_communities``:
        each rank ranks the ids of ITS stride-wide stripe of the presence
        bitmap; an all-gather of the stripe counts gives every stripe's
        offset, and an all-gather of the stripe tables the remap table."""
        idx = torch.clamp(torch.where(vmask, com, n), 0, n).long()
        p = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        p[idx] = 1
        p = p[:n]
        if n_pad_c:
            p = torch.cat([p, torch.zeros(n_pad_c, dtype=torch.int32,
                                          device=dev)])
        p_d = p[lo:lo + stride]
        counts = all_gather_cat(torch.sum(p_d, dtype=torch.int32).reshape(1),
                                group)
        off_d = (torch.cumsum(counts, 0) - counts)[d]
        t_d = torch.where(p_d == 1, off_d + torch.cumsum(p_d, 0) - 1,
                          n).to(torch.int32)
        table = all_gather_cat(t_d, group)[:n]
        new_com = torch.where(vmask, table[clip(com)], n).to(torch.int32)
        return new_com, int(torch.sum(counts))

    def coarsen_by(gl, new_com, n_comm):
        if agg_method == "sort":
            return aggregation.coarsen_graph(gl, new_com, n_comm)
        return binned_coarsen(gl, new_com, n_comm, impl="kernel",
                              force_overflow=force_overflow)

    def level_graph(a, n_valid, m_cap):
        src, dst, w, mask = a
        return Graph(src=src, dst=dst, w=w, edge_mask=mask, n_valid=n_valid,
                     m_valid=int(mask.sum()), n_max=n, m_max=m_cap,
                     sorted_by=None)

    def aggregate_shard_local(a, n_valid, com, vmask, m_cap):
        """Partial per-rank coarsening → halo exchange → merge.  The
        payload is the contiguization table and D·h_cap partial groups,
        never O(m); both coarsenings emit groups in canonical (cs, cd)
        order, so the merged graph is the replicated one bit for bit."""
        new_com, n_comm = contiguize(com, vmask)
        part = coarsen_by(level_graph(a, n_valid, m_cap), new_com, n_comm)
        flags = all_reduce_sum(torch.tensor(
            [int(part.m_valid > h_cap), min(part.m_valid, h_cap)],
            dtype=torch.int32, device=dev), group)
        ids = all_gather_stack(torch.stack([
            part.src[:h_cap], part.dst[:h_cap],
            part.edge_mask[:h_cap].to(torch.int32)]), group)
        ids = ids.permute(1, 0, 2).reshape(3, D * h_cap)
        gw = all_gather_cat(part.w[:h_cap].contiguous(), group)
        g_part = level_graph((ids[0], ids[1], gw, ids[2] != 0), n_comm, m_c)
        cg = coarsen_by(g_part, arange_n, n_comm)
        return new_com, n_comm, cg, bool(flags[0] > 0), int(flags[1])

    def aggregate_replicated(a, n_valid, com):
        """The parity oracle: the same coarsening on every rank."""
        new_com, n_comm, cg = aggregation.remap_and_coarsen_by(
            agg_method, level_graph(a, n_valid, m_c), com, impl="kernel",
            faults=faults)
        n_comm = int(all_reduce_max(torch.tensor(
            [n_comm], dtype=torch.int32, device=dev), group)[0])
        return new_com, n_comm, cg, False, -1

    def aggregate(a, n_valid, com, vmask, m_cap):
        if coarsening == "shard_local":
            return aggregate_shard_local(a, n_valid, com, vmask, m_cap)
        return aggregate_replicated(a, n_valid, com)

    def run_level(s, a, n_valid, level, init_com, assign, m_cap):
        """One level: local moving → (refinement) → remap + coarsen → Q.
        ``s`` are the sweep arrays (the local view), ``a`` the aggregation
        arrays at capacity ``m_cap``."""
        vmask = arange_n < n_valid
        it0 = level * LEVEL_IT_STRIDE
        com, sweeps, dn_h = sweep(spec, s, n_valid, vmask, init_com, it0)
        if not refine:
            new_com, n_comm, cg, over, pgroups = aggregate(
                a, n_valid, com, vmask, m_cap)
            macro = new_com[clip(assign)]
            assign2, init2, nv2 = macro, arange_n, n_comm
        else:
            if coarsening == "shard_local":
                new_com, n_comm = contiguize(com, vmask)
            else:
                new_com, n_comm = aggregation.remap_communities(com, vmask)
            macro = new_com[clip(assign)]
            ref, _, _ = sweep(refine_spec, s, n_valid, vmask, arange_n,
                              it0 + REFINE_IT_OFFSET, restrict=com)
            new_ref, nv2, cg, over, pgroups = aggregate(
                a, n_valid, ref, vmask, m_cap)
            init2 = _macro_seed(new_com, new_ref, vmask)
            assign2 = new_ref[clip(assign)]
        done = n_comm == n_valid              # Alg. 3 l.6 convergence
        q = dist_q(macro) if track_modularity else 0.0
        own = cg.edge_mask & (cg.dst >= lo) & (cg.dst < hi)
        return (cg, own, nv2, assign2, init2, macro, sweeps, dn_h, n_comm, q,
                over, pgroups, done)

    # ---- level 0 on the local edge-balanced shard
    if coarsening == "replicated":
        # gather the shard ONCE into the replicated full-capacity list
        a0 = (all_gather_cat(src_l, group), all_gather_cat(dst_l, group),
              all_gather_cat(w_l, group), all_gather_cat(emask_l, group))
        m_cap0 = m_c
    else:
        a0, m_cap0 = shard, m_pad
    out = _PipelineOut(None, 0, 0, 0.0, [], [], [], [], [], False)
    level, n_valid = 0, n_valid0
    s, a, m_cap = shard, a0, m_cap0
    init_com = assign = arange_n
    done = False
    while level < max_levels and not done:
        (cg, own, n_valid, assign, init_com, macro, sweeps, dn_h, n_comm, q,
         over, pgroups, done) = run_level(s, a, n_valid, level, init_com,
                                          assign, m_cap)
        out.sweeps.append(sweeps)
        out.n_comm.append(n_comm)
        out.mod_hist.append(q)
        out.delta_n.append(dn_h)
        out.gathered.append(pgroups)
        out.overflow |= over
        level += 1
        if out.overflow:
            # the merged graph may have lost groups: the driver refuses
            # the whole answer and reruns replicated, so stop here (the
            # flag is all-reduced, so every rank stops alike)
            break
        s = (cg.src, cg.dst, cg.w, own)
        a = (cg.src, cg.dst, cg.w,
             own if coarsening == "shard_local" else cg.edge_mask)
        m_cap = m_c
    out.levels = level
    out.final, out.n_final = aggregation.remap_communities(
        macro, arange_n < n_valid0)
    out.modularity = dist_q(out.final)
    return out


def _resolve_halo_cap(halo_cap, m_pad: int, n_devices: int) -> int:
    cap = int(halo_cap) if halo_cap else pick_halo_cap(m_pad, n_devices)
    return min(cap, int(m_pad))


def distributed_louvain(
    g: Graph,
    group=None,
    max_levels: int = 10,
    max_sweeps: int = 25,
    sweep_threshold: int = 0,
    seed: int = 0,
    move_prob: float = 0.5,
    singleton_rule: bool = True,
    pipeline_fused: bool = True,
    aggregation_method: str = "binned",
    coarsening: str = "shard_local",
    halo_cap: Optional[int] = None,
    refine: bool = False,
    refine_sweeps: int = 8,
    track_modularity: bool = True,
) -> DistLouvainResult:
    """Distributed Louvain/Leiden on the ranks of ``group`` (the world
    group by default); every rank calls it on the same graph and gets the
    same result.

    ``coarsening`` picks the fused pipeline's aggregation:
    ``"shard_local"`` (per-rank partial coarsening and a halo-capped merge)
    or ``"replicated"`` (the parity oracle); the two are equal bit for bit.
    A rank whose partial coarse list overflows ``halo_cap`` flags the run,
    and the driver reruns it replicated, recording the degradation in
    ``run_report`` and ``dist.halo_overflow_retry``.  ``refine`` is Leiden
    (fused pipeline only).  ``pipeline_fused=False`` re-partitions every
    level."""
    if coarsening not in COARSENING_MODES:
        raise ValueError(f"coarsening must be one of {COARSENING_MODES}, "
                         f"got {coarsening!r}")
    if refine and not pipeline_fused:
        raise ValueError("Leiden refinement (refine=True) requires "
                         "pipeline_fused=True")
    D, d = _world(g, group)
    timer = Timer()
    n = g.n_max
    faults = frozenset(faultinject.active())
    report = RunReport(faults=sorted(faults))
    promote = accum_needs_promotion(g.m_max)
    spec = EngineSpec(
        evaluator="louvain",
        backend="distributed",
        max_sweeps=max_sweeps,
        threshold=sweep_threshold,
        move_prob=move_prob,
        singleton_rule=singleton_rule,
        faults=_engine_faults(faults),
    )

    if pipeline_fused:
        with timer.phase("partition"):
            part = _prepare_partition(g, D)
            shard = shard_edges(part, d, g.device)
            pq = partition_quality(part, build_halo(part))
        h_cap = _resolve_halo_cap(halo_cap, part.m_pad, D)
        used = coarsening
        rs = refine_sweeps if refine else 0

        def run(mode):
            with timer.phase("pipeline"):
                return _pipeline(group, shard, n, g.n_valid, part.m_pad, spec,
                                 max_levels, aggregation_method, faults, mode,
                                 h_cap, rs, track_modularity, promote, seed)

        out = run(used)
        if out.overflow and used == "shard_local":
            # a partial coarse list busted the halo cap somewhere in the
            # level loop: the merged graph may have lost groups, so the
            # answer is refused and the run repeated replicated
            telemetry.bump("dist.halo_overflow_retry")
            report.degradations.append({
                "kind": "halo_overflow", "from": "shard_local",
                "to": "replicated",
                "error": f"partial coarse list overflowed halo_cap={h_cap}"})
            used = "replicated"
            out = run(used)
        model = dist_comm_bytes_per_level(n, part.m_pad, h_cap, D)
        table_bytes = (n + D) * LABEL_WIRE_BYTES
        comm_stats = {
            "mode": used,
            "requested": coarsening,
            "n_devices": D,
            "m_pad": int(part.m_pad),
            "halo_cap": h_cap,
            "bytes_per_level_model": model,
            "gathered_groups_per_level": out.gathered,
            "actual_bytes_per_level": [
                (table_bytes + gct * EDGE_WIRE_BYTES) if gct >= 0
                else model["replicated"] for gct in out.gathered],
            "halo_labels": int(pq.total_ghosts),
        }
        return DistLouvainResult(
            labels=out.final.cpu().numpy(),
            n_communities=out.n_final,
            levels=out.levels,
            modularity=out.modularity,
            timer=timer,
            sweeps_per_level=out.sweeps,
            n_comm_per_level=out.n_comm,
            modularity_history=out.mod_hist if track_modularity else [],
            delta_n_per_level=out.delta_n,
            coarsening=used,
            partition_stats=dict(pq._asdict()),
            comm_stats=comm_stats,
            run_report=report,
        )

    from repro_torch.core.louvain import LEVEL_IT_STRIDE

    assign = torch.arange(n, dtype=torch.int32, device=g.device)
    cur = g
    sweeps_per_level: list = []
    n_comm_per_level: list = []
    partition_stats: dict = {}
    for level in range(max_levels):
        with timer.phase("partition"):
            # the coverage guard applies per level: each re-partition may
            # lose a shard
            part = _prepare_partition(cur, D)
            shard = shard_edges(part, d, g.device)
        if level == 0:
            partition_stats = dict(partition_quality(part)._asdict())
        with timer.phase("local_moving"):
            res = distributed_phase(
                spec, group, n, shard,
                torch.arange(n, dtype=torch.int32, device=g.device),
                cur.vertex_mask(), level * LEVEL_IT_STRIDE, seed,
                cur.weighted_degrees(), cur.total_volume(), cur.n_valid)
        sweeps_per_level.append(res.sweeps)
        with timer.phase("aggregation"):
            new_com, n_comm, coarse = aggregation.remap_and_coarsen_by(
                aggregation_method, cur, res.labels, impl="kernel",
                faults=faults)
            n_comm_per_level.append(n_comm)
            done = n_comm == cur.n_valid
            if not done:
                assign = new_com[torch.clamp(assign, 0, n - 1)]
                cur = coarse
        if done:
            break

    final_assign, n_final = aggregation.remap_communities(
        assign, g.vertex_mask())
    return DistLouvainResult(
        labels=final_assign.cpu().numpy(),
        n_communities=n_final,
        levels=level + 1,
        modularity=float(modularity(g, final_assign, promote=promote)),
        timer=timer,
        sweeps_per_level=sweeps_per_level,
        n_comm_per_level=n_comm_per_level,
        coarsening="per_level",
        partition_stats=partition_stats,
        run_report=report,
    )


def distributed_leiden(g: Graph, group=None, **kwargs) -> DistLouvainResult:
    """Leiden = Louvain + the refinement phase between move and aggregate
    (fused pipeline only), as ``core.louvain.leiden``."""
    kwargs.setdefault("refine", True)
    return distributed_louvain(g, group, **kwargs)

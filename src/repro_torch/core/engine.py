"""Local-moving sweep engine (port of ``repro.core.engine``).

  evaluator  ×  backend
  ---------     -------
  ``plp``       ``segment``      sort + segment GroupBy over the edge list
  ``louvain``   ``ell``          degree-bucketed ELL tiles, plain PyTorch
                ``pallas``       the same tiles through the CUDA kernels
                ``distributed``  the segment GroupBy over one rank's edge
                                 shard, merged across a ``torch.distributed``
                                 process group (``make_distributed_step``)

An evaluator proposes moves — ``(proposal[n], propose[n])`` per vertex — and
the engine owns everything around it: the Luby move-probability coin, the
adopt/changed bookkeeping, ΔN accounting and active-frontier propagation.

The ``ell``/``pallas`` backends read a host-built degree-bucketed layout
(``graph.ell.build_ell``, level 0), or with ``EngineSpec.ell_width > 0``
one vertex-aligned tile rebuilt per level on the device
(``graph.ell.traced_ell_tile``, the cascade's coarse levels).

The JAX package runs a whole phase as one jitted ``lax.while_loop``
(``fused=True``) or one jitted call per sweep (``fused=False``).  Here both
are the same Python loop over eager tensor ops with one ΔN readback per
sweep — the loop condition needs it — so both give identical results;
``fused`` is accepted so one config drives both packages.

The ``distributed`` backend has no ``SweepEngine``: ``core.distributed``
drives ``distributed_phase`` on each rank's shard.  The JAX package's
``shard_map`` collectives map onto the helpers below — ``psum`` onto
``all_reduce_sum``, ``pmax`` onto ``all_reduce_max``, a tiled
``all_gather`` onto ``all_gather_cat`` and an untiled one onto
``all_gather_stack`` — over a process group whose size is the JAX mesh's
device count and whose rank is its linear device index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import ConfigBase
from repro_torch.core import moves
from repro_torch.core.common import luby_move_gate, neighbor_or_self_changed
from repro_torch.graph.ell import build_ell, grid_view, traced_ell_tile
from repro_torch.graph.structure import Graph
from repro_torch.kernels.local_move import ops as lm_ops
from repro_torch.utils.faultinject import FAULT_POINTS

# Per-evaluator Luby coin stream constants (the JAX package's values).
_GATE_CONST = {"plp": (0x85EBCA6B, 313), "louvain": (0x9E3779B1, 101)}

EVALUATORS = ("plp", "louvain")
BACKENDS = ("segment", "ell", "pallas", "distributed")


@dataclasses.dataclass(frozen=True)
class EngineSpec(ConfigBase):
    """Static sweep configuration.  The loop runs while
    ``sweep < max_sweeps and ΔN > threshold``."""

    evaluator: str = "plp"       # plp | louvain
    backend: str = "segment"     # segment | ell | pallas | distributed
    max_sweeps: int = 100
    threshold: int = 0           # paper's ΔN threshold θ
    tie_eps: float = 0.25        # PLP tie noise amplitude
    move_prob: float = 1.0       # Luby move gate (1.0 = pure Jacobi)
    use_frontier: bool = True    # paper's active-vertex optimization
    reshuffle_ties: bool = False # PLP: re-draw tie noise each sweep
    singleton_rule: bool = True  # Louvain: Lu et al. swap suppression
    table_mode: str = "auto"     # auto | resident | streamed (ell, pallas)
    # ell/pallas with no host-built layout: rebuild one vertex-aligned ELL
    # tile of this width per level on the device (the cascade's coarse
    # levels, ``graph.ell.traced_ell_tile``).  0 = host-built layout.
    ell_width: int = 0
    # Armed fault-injection points that act in the sweep
    # (``utils.faultinject``): "oscillation" pins the reported ΔN above the
    # threshold; "vmem_starve" rides along, its site being the table-layout
    # policy.  The drivers keep only ``core.louvain.ENGINE_FAULTS`` here.
    faults: tuple = ()

    def __post_init__(self):
        if self.evaluator not in EVALUATORS:
            raise ValueError(f"unknown evaluator {self.evaluator!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}, want one of "
                             f"{BACKENDS}")
        lm_ops.check_table_mode(self.table_mode)
        if any(f not in FAULT_POINTS for f in self.faults):
            raise ValueError(f"unknown fault point(s) in {self.faults!r}")
        if self.ell_width < 0:
            raise ValueError(f"ell_width must be >= 0, got {self.ell_width}")
        if self.ell_width > 0 and self.backend not in ("ell", "pallas"):
            raise ValueError(
                "ell_width (traced re-bucketing) requires the ell or pallas "
                f"backend, not {self.backend!r}")


@dataclasses.dataclass
class PhaseResult:
    """Result of one local-moving phase (all sweeps of one level)."""

    labels: torch.Tensor
    active: torch.Tensor
    sweeps: int
    delta_n_history: list
    active_history: list


# ----------------------------------------------------------------- evaluators


def _evaluate_segment(spec: EngineSpec, g: Graph, level, labels, active,
                      it: int, seed: int, restrict=None):
    """Sort+segment evaluator over the full edge list.  ``restrict``
    (Louvain only; Leiden's refinement) keeps the edges whose endpoints
    share its value, so no move leaves the enclosing macro community."""
    n = g.n_max
    valid = g.edge_mask & active[torch.clamp(g.dst, 0, n - 1)]
    if spec.evaluator == "plp":
        noise_it = it if spec.reshuffle_ties else 0
        best_score, best_lab, cur_score = moves.plp_best_labels(
            g.src, g.dst, g.w, valid, labels, n, noise_it, seed, spec.tie_eps)
        return best_lab, active & (best_lab >= 0) & (best_score > cur_score)

    vmask, deg, vol_v = level
    vol_com, size_com = moves.community_aux(labels, deg, vmask, n)
    if restrict is not None:
        valid = valid & (restrict[torch.clamp(g.src, 0, n - 1)]
                         == restrict[torch.clamp(g.dst, 0, n - 1)])
    best_gain, best_cand = moves.louvain_best_moves(
        g.src, g.dst, g.w, valid, labels, deg, vol_com, size_com, vol_v, n,
        singleton_rule=spec.singleton_rule)
    return best_cand, vmask & active & (best_cand >= 0) & (best_gain > 0.0)


def _ell_evaluators(spec: EngineSpec, g: Graph, level, labels, it: int,
                    seed: int, use_pallas: bool, table_mode: str):
    """Per-sweep closures ``(eval_bucket, eval_tail)``: the per-vertex
    tables are built ONCE here per sweep; ``eval_bucket(rows, nbr, w,
    windows)`` hands them to the local_move family (gathers fused into the
    kernel; ``windows`` is the bucket's metadata for the streamed layout),
    ``eval_tail(src, dst, w, valid)`` scores an edge list off the same
    extended tables.  Shared by the host-built bucket evaluator and the
    traced coarse-level one."""
    n = g.n_max
    ext = moves.extend

    if spec.evaluator == "plp":
        labels_ext = ext(labels, n)
        noise_it = it if spec.reshuffle_ties else 0
        noise_seed = (seed + noise_it) & 0xFFFFFFFF

        def eval_bucket(rows, nbr, w, windows):
            return lm_ops.local_move_plp(
                rows, nbr, w, labels_ext, noise_seed, tie_eps=spec.tie_eps,
                sentinel=n, use_pallas=use_pallas, windows=windows,
                table_mode=table_mode)

        def eval_tail(src, dst, w, valid):
            best_score, best_lab, cur_score = moves.plp_best_labels_tables(
                src, dst, w, valid, labels_ext, n, noise_it, seed,
                spec.tie_eps)
            return best_lab, (best_lab >= 0) & (best_score > cur_score)

        return eval_bucket, eval_tail

    vmask, deg, vol_v = level
    vol_com, size_com = moves.community_aux(labels, deg, vmask, n)
    com_ext, vol_ext = ext(labels, n), ext(vol_com, 0)
    size_ext, deg_ext = ext(size_com, 0), ext(deg, 0)
    composed = lm_ops.compose_louvain_tables(com_ext, vol_ext, size_ext,
                                             deg_ext, n)

    def eval_bucket(rows, nbr, w, windows):
        return lm_ops.local_move_louvain(
            rows, nbr, w, com_ext, vol_ext, size_ext, deg_ext, vol_v,
            sentinel=n, singleton_rule=spec.singleton_rule,
            use_pallas=use_pallas, windows=windows,
            table_mode=table_mode, composed=composed)

    def eval_tail(src, dst, w, valid):
        best_gain, best_cand = moves.louvain_best_moves_tables(
            src, dst, w, valid, com_ext, vol_ext, size_ext, deg_ext, vol_v,
            n, singleton_rule=spec.singleton_rule)
        return best_cand, vmask & (best_cand >= 0) & (best_gain > 0.0)

    return eval_bucket, eval_tail


def _evaluate_ell(spec: EngineSpec, g: Graph, level, ell, labels, active,
                  it: int, seed: int):
    """Degree-bucketed evaluator: one local_move call per non-empty bucket
    (a CUDA launch on the ``pallas`` backend), per-row proposals scattered
    into per-vertex arrays (slot n is the sink of padding rows), then the
    tail vertices through the sort+segment scoring of their edges."""
    n = g.n_max
    dev = labels.device
    eval_bucket, eval_tail = _ell_evaluators(
        spec, g, level, labels, it, seed, use_pallas=spec.backend == "pallas",
        table_mode=spec.table_mode)
    proposal = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    propose = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for b in ell.buckets:
        if b.n_rows_valid == 0:
            continue
        rows, nbr, w = grid_view(b)
        best, good = eval_bucket(rows, nbr, w, b.windows)
        row_prop = (rows < n) & active[torch.clamp(rows, 0, n - 1)] & good
        idx = torch.where(row_prop, torch.clamp(rows, 0, n - 1), n).long()
        proposal[idx] = torch.where(row_prop, best, -1)
        propose[idx] = row_prop
    proposal, propose = proposal[:n], propose[:n]
    if ell.has_tail:
        tdst = ell.tail_dst
        valid_t = ((ell.tail_src < n) & (tdst < n)
                   & active[torch.clamp(tdst, 0, n - 1)])
        best, good = eval_tail(ell.tail_src, tdst, ell.tail_w, valid_t)
        tail_prop = ell.is_tail & active & good
        proposal = torch.where(tail_prop, best, proposal)
        propose = propose | tail_prop
    return proposal, propose


def _evaluate_ell_traced(spec: EngineSpec, g: Graph, level, tile, labels,
                         active, it: int, seed: int):
    """Coarse-level evaluator with no host-built layout: the per-level
    tile of ``traced_ell_tile`` goes through the SAME local_move family as
    level 0, with the tables resident (coarse tables are small, and
    streaming needs per-block window metadata).  Rows are vertex-aligned,
    so the bucket scatter reduces to a ``where``.  Vertices wider than the
    tile take the tables tail evaluator over their edges, only when the
    level has any (``_traced_tile``)."""
    n = g.n_max
    rows, nbr, w_t, is_tail, tail = tile
    eval_bucket, eval_tail = _ell_evaluators(
        spec, g, level, labels, it, seed, use_pallas=spec.backend == "pallas",
        table_mode="resident")
    best, good = eval_bucket(rows, nbr, w_t, None)
    propose = (rows < n) & active & good
    proposal = torch.where(propose, best, -1)
    if tail is not None:
        src_t, dst_t, w_tail = tail
        best_t, good_t = eval_tail(src_t, dst_t, w_tail,
                                   active[dst_t.long()])
        tail_prop = is_tail & active & good_t
        proposal = torch.where(tail_prop, best_t, proposal)
        propose = propose | tail_prop
    return proposal, propose


def _traced_tile(g: Graph, width: int):
    """One level's traced tile ``(rows, nbr, w, is_tail, tail)``, built
    once per phase and shared by its sweeps.  ``tail`` holds the edges
    whose destination is a tail vertex, in edge order — what the tail
    evaluator scores: the JAX package masks the full edge list every
    sweep, which keeps the same edges in the same order — or None when
    the level has no tail vertex (one read-back per level)."""
    rows, nbr, w_t, is_tail = traced_ell_tile(g, width)
    tail = None
    if bool(is_tail.any()):
        keep = g.edge_mask & is_tail[torch.clamp(g.dst, 0, g.n_max - 1)]
        tail = (g.src[keep], g.dst[keep], g.w[keep])
    return rows, nbr, w_t, is_tail, tail


# ----------------------------------------------------------------- step / loop


def make_step(spec: EngineSpec, g: Graph, ell):
    """The shared sweep step: evaluate → gate → adopt → frontier.  Returns
    ``step(labels, active, it, seed, restrict=None) -> (labels, active,
    ΔN tensor)``; ``restrict`` reaches the segment evaluator only."""
    n = g.n_max
    mult, salt = _GATE_CONST[spec.evaluator]
    vmask = g.vertex_mask()
    # loop-invariant within a level: the vertex mask, weighted degrees and
    # vol(V), computed once per phase instead of once per sweep
    level = ((vmask, g.weighted_degrees(), g.total_volume())
             if spec.evaluator == "louvain" else None)
    tile = None
    if spec.backend != "segment" and ell is None and spec.ell_width > 0:
        # loop-invariant within a level too: one tile build per phase
        tile = _traced_tile(g, spec.ell_width)

    def step(labels, active, it: int, seed: int, restrict=None):
        if spec.backend == "segment":
            proposal, propose = _evaluate_segment(spec, g, level, labels,
                                                  active, it, seed, restrict)
        elif tile is not None:
            proposal, propose = _evaluate_ell_traced(spec, g, level, tile,
                                                     labels, active, it, seed)
        else:
            proposal, propose = _evaluate_ell(spec, g, level, ell, labels,
                                              active, it, seed)
        adopt = propose
        if spec.move_prob < 1.0:
            adopt = adopt & luby_move_gate(n, it, seed, spec.move_prob, mult,
                                           salt, labels.device)
        new_labels = torch.where(adopt, proposal, labels)
        changed = adopt & (new_labels != labels)
        delta_n = torch.sum(changed.to(torch.int32))
        if "oscillation" in spec.faults:
            # the convergence signal never reports a fixpoint; labels and
            # frontier are untouched, so the phase runs to max_sweeps
            delta_n = torch.clamp(delta_n, min=spec.threshold + 1)
        next_active = (neighbor_or_self_changed(g, changed)
                       if spec.use_frontier else vmask)
        return new_labels, next_active, delta_n

    return step


class SweepEngine:
    """Local-moving sweep engine for one graph (one coarsening level).
    The ``ell``/``pallas`` backends build the ELL layout on the graph's
    device at construction, unless ``spec.ell_width`` asks for the traced
    per-level tile instead."""

    def __init__(self, g: Graph, spec: EngineSpec, ell=None):
        if spec.backend == "distributed":
            raise ValueError(
                "use distributed_phase() for the distributed backend")
        self.g = g
        self.spec = spec
        self.ell = None
        if spec.backend in ("ell", "pallas") and spec.ell_width == 0:
            self.ell = ell if ell is not None else build_ell(g)
        self._step = make_step(spec, g, self.ell)

    def singleton_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(labels, active): singleton init + full active set (Alg. 1 l.4-5)."""
        return (torch.arange(self.g.n_max, dtype=torch.int32,
                             device=self.g.device),
                self.g.vertex_mask())

    def run_phase(self, labels: torch.Tensor, active: torch.Tensor, *,
                  it0: int = 0, seed: int = 0,
                  restrict: Optional[torch.Tensor] = None,
                  fused: bool = True) -> PhaseResult:
        """Run one local-moving phase to convergence (ΔN ≤ threshold or the
        sweep budget).  ``restrict`` confines Louvain moves to vertices that
        share its value (Leiden's macro communities; segment backend only).
        ``fused`` selects the same loop either way."""
        del fused
        spec = self.spec
        if restrict is not None and spec.backend != "segment":
            raise ValueError(
                "restrict (Leiden macro confinement) is only implemented for "
                f"the segment backend, not {spec.backend!r}")
        dn_hist, act_hist = [], []
        s = 0
        while s < spec.max_sweeps:
            labels, active, dn = self._step(labels, active,
                                            (it0 + s) & 0xFFFFFFFF, seed,
                                            restrict)
            dn_hist.append(dn)
            act_hist.append(torch.sum(active.to(torch.int32)))
            s += 1
            if int(dn) <= spec.threshold:
                break
        return PhaseResult(labels, active, s,
                           [int(x) for x in dn_hist],
                           [int(x) for x in act_hist])


# ----------------------------------------------------------------- distributed


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the element-wise sum over the group's ranks, as a new
    tensor.  gloo reduces no ``bool``: callers cast flags to int32."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.pmax``: the element-wise maximum over the group's ranks."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x``, in rank order.  The list form of
    ``all_gather`` works on every backend and device; a ``bool`` tensor
    travels as uint8."""
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return [p.to(torch.bool) for p in parts] if x.dtype == torch.bool \
        else parts


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the ranks' tensors concatenated
    along the first axis, in rank order."""
    return torch.cat(_all_gather(x, group))


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.all_gather(..., tiled=False)``: the ranks' tensors stacked on a
    new leading axis, in rank order."""
    return torch.stack(_all_gather(x, group))


def make_distributed_step(spec: EngineSpec, group, n: int, src, dst, w,
                          emask, deg, vol_v, vmask, restrict=None):
    """One sweep step over this rank's edge shard: evaluate on the local
    in-edges with the segment evaluator, merge the per-owner proposals
    across the group, gate, adopt, propagate the frontier.

    ``emask`` is this rank's ownership mask: every vertex's in-edges lie on
    one rank, so the all-reduced sum of the proposals is a disjoint union.
    ``deg``/``vol_v`` are the level's Louvain invariants (unused by PLP);
    ``restrict`` confines Louvain moves to vertices sharing its value
    (Leiden's refinement), as in ``_evaluate_segment``.  Labels and the
    frontier are replicated: every rank computes the same ones."""
    mult, salt = _GATE_CONST[spec.evaluator]
    dstc = torch.clamp(dst, 0, n - 1)
    srcc = torch.clamp(src, 0, n - 1)
    # the edges moves are scored on; the frontier reads all owned edges
    scored = emask if restrict is None else \
        emask & (restrict[srcc] == restrict[dstc])

    def evaluate(labels, active, it: int, seed: int):
        valid = scored & active[dstc]
        if spec.evaluator == "plp":
            noise_it = it if spec.reshuffle_ties else 0
            best_score, best_lab, cur_score = moves.plp_best_labels(
                src, dst, w, valid, labels, n, noise_it, seed, spec.tie_eps)
            propose_l = active & (best_lab >= 0) & (best_score > cur_score)
            proposal_l = best_lab
        else:
            # the O(n) community state, recomputed on every rank alike
            vol_com, size_com = moves.community_aux(labels, deg, vmask, n)
            best_gain, best_cand = moves.louvain_best_moves(
                src, dst, w, valid, labels, deg, vol_com, size_com, vol_v,
                n, singleton_rule=spec.singleton_rule)
            propose_l = active & (best_cand >= 0) & (best_gain > 0.0)
            proposal_l = best_cand
        # one all-reduce carries both: the disjoint-owner merge of the
        # proposals and the count of ranks that propose
        both = all_reduce_sum(torch.stack([
            torch.where(propose_l, proposal_l, 0).to(torch.int32),
            propose_l.to(torch.int32)]), group)
        propose = both[1] > 0
        return torch.where(propose, both[0], -1), propose

    def frontier(changed):
        contrib = emask & changed[srcc]
        hit = torch.zeros(n + 1, dtype=torch.int32, device=changed.device)
        hit[torch.where(contrib, dstc, n).long()] = 1
        return changed | (all_reduce_sum(hit[:n], group) > 0)

    def step(labels, active, it: int, seed: int):
        proposal, propose = evaluate(labels, active, it, seed)
        adopt = propose
        if spec.move_prob < 1.0:
            adopt = adopt & luby_move_gate(n, it, seed, spec.move_prob, mult,
                                           salt, labels.device)
        new_labels = torch.where(adopt, proposal, labels)
        changed = adopt & (new_labels != labels)
        delta_n = torch.sum(changed.to(torch.int32))
        next_active = frontier(changed) if spec.use_frontier else vmask
        return new_labels, next_active, delta_n

    return step


def distributed_phase(spec: EngineSpec, group, n: int, shard, labels,
                      active, it0: int, seed: int, deg, vol_v, n_valid: int,
                      restrict=None) -> PhaseResult:
    """One local-moving phase on this rank's ``shard`` = (src, dst, w,
    emask): the step above until ΔN ≤ threshold or the sweep budget.  ΔN
    is computed from replicated state, so it is the same on every rank and
    all ranks leave the loop after the same sweep."""
    src, dst, w, emask = shard
    vmask = torch.arange(n, device=labels.device) < n_valid
    step = make_distributed_step(spec, group, n, src, dst, w, emask, deg,
                                 vol_v, vmask, restrict)
    dn_hist, act_hist = [], []
    s = 0
    while s < spec.max_sweeps:
        labels, active, dn = step(labels, active, (it0 + s) & 0xFFFFFFFF,
                                  seed)
        dn_hist.append(dn)
        act_hist.append(torch.sum(active.to(torch.int32)))
        s += 1
        if int(dn) <= spec.threshold:
            break
    return PhaseResult(labels, active, s, [int(x) for x in dn_hist],
                       [int(x) for x in act_hist])

"""Local-moving sweep engine (port of ``repro.core.engine``).

  evaluator  ×  backend
  ---------     -------
  ``plp``       ``segment``      sort + segment GroupBy over the edge list
  ``louvain``   ``ell``          degree-bucketed ELL tiles, plain PyTorch
                ``pallas``       the same tiles through the CUDA kernels

An evaluator proposes moves — ``(proposal[n], propose[n])`` per vertex — and
the engine owns everything around it: the Luby move-probability coin, the
adopt/changed bookkeeping, ΔN accounting and active-frontier propagation.

The JAX package runs a whole phase as one jitted ``lax.while_loop``
(``fused=True``) or one jitted call per sweep (``fused=False``).  Here both
are the same Python loop over eager tensor ops with one ΔN readback per
sweep — the loop condition needs it — so both give identical results;
``fused`` is accepted so one config drives both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.config import ConfigBase
from repro_torch.core import moves
from repro_torch.core.common import luby_move_gate, neighbor_or_self_changed
from repro_torch.graph.ell import build_ell, grid_view
from repro_torch.graph.structure import Graph
from repro_torch.kernels.local_move import ops as lm_ops

# Per-evaluator Luby coin stream constants (the JAX package's values).
_GATE_CONST = {"plp": (0x85EBCA6B, 313), "louvain": (0x9E3779B1, 101)}

EVALUATORS = ("plp", "louvain")
BACKENDS = ("segment", "ell", "pallas")


@dataclasses.dataclass(frozen=True)
class EngineSpec(ConfigBase):
    """Static sweep configuration.  The loop runs while
    ``sweep < max_sweeps and ΔN > threshold``."""

    evaluator: str = "plp"       # plp | louvain
    backend: str = "segment"     # segment | ell | pallas
    max_sweeps: int = 100
    threshold: int = 0           # paper's ΔN threshold θ
    tie_eps: float = 0.25        # PLP tie noise amplitude
    move_prob: float = 1.0       # Luby move gate (1.0 = pure Jacobi)
    use_frontier: bool = True    # paper's active-vertex optimization
    reshuffle_ties: bool = False # PLP: re-draw tie noise each sweep
    singleton_rule: bool = True  # Louvain: Lu et al. swap suppression
    table_mode: str = "auto"     # auto | resident ("streamed" not ported)

    def __post_init__(self):
        if self.evaluator not in EVALUATORS:
            raise ValueError(f"unknown evaluator {self.evaluator!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}, want one of "
                             f"{BACKENDS}")
        lm_ops.check_table_mode(self.table_mode)


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
                      it: int, seed: int):
    """Sort+segment evaluator over the full edge list."""
    n = g.n_max
    valid = g.edge_mask & active[torch.clamp(g.dst, 0, n - 1)]
    if spec.evaluator == "plp":
        noise_it = it if spec.reshuffle_ties else 0
        best_score, best_lab, cur_score = moves.plp_best_labels(
            g.src, g.dst, g.w, valid, labels, n, noise_it, seed, spec.tie_eps)
        return best_lab, active & (best_lab >= 0) & (best_score > cur_score)

    vmask, deg, vol_v = level
    vol_com, size_com = moves.community_aux(labels, deg, vmask, n)
    best_gain, best_cand = moves.louvain_best_moves(
        g.src, g.dst, g.w, valid, labels, deg, vol_com, size_com, vol_v, n,
        singleton_rule=spec.singleton_rule)
    return best_cand, vmask & active & (best_cand >= 0) & (best_gain > 0.0)


def _ell_evaluators(spec: EngineSpec, g: Graph, level, labels, it: int,
                    seed: int, use_pallas: bool):
    """Per-sweep closures ``(eval_bucket, eval_tail)``: the per-vertex
    tables are built ONCE here per sweep; ``eval_bucket(rows, nbr, w)``
    hands them to the local_move family (gathers fused into the kernel),
    ``eval_tail(src, dst, w, valid)`` scores an edge list off the same
    extended tables."""
    n = g.n_max
    ext = moves.extend

    if spec.evaluator == "plp":
        labels_ext = ext(labels, n)
        noise_it = it if spec.reshuffle_ties else 0
        noise_seed = (seed + noise_it) & 0xFFFFFFFF

        def eval_bucket(rows, nbr, w):
            return lm_ops.local_move_plp(
                rows, nbr, w, labels_ext, noise_seed, tie_eps=spec.tie_eps,
                sentinel=n, use_pallas=use_pallas, table_mode=spec.table_mode)

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

    def eval_bucket(rows, nbr, w):
        return lm_ops.local_move_louvain(
            rows, nbr, w, com_ext, vol_ext, size_ext, deg_ext, vol_v,
            sentinel=n, singleton_rule=spec.singleton_rule,
            use_pallas=use_pallas, table_mode=spec.table_mode,
            composed=composed)

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
        spec, g, level, labels, it, seed, use_pallas=spec.backend == "pallas")
    proposal = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    propose = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for b in ell.buckets:
        if b.n_rows_valid == 0:
            continue
        rows, nbr, w = grid_view(b)
        best, good = eval_bucket(rows, nbr, w)
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


# ----------------------------------------------------------------- step / loop


def make_step(spec: EngineSpec, g: Graph, ell):
    """The shared sweep step: evaluate → gate → adopt → frontier.  Returns
    ``step(labels, active, it, seed) -> (labels, active, ΔN tensor)``."""
    n = g.n_max
    mult, salt = _GATE_CONST[spec.evaluator]
    vmask = g.vertex_mask()
    # loop-invariant within a level: the vertex mask, weighted degrees and
    # vol(V), computed once per phase instead of once per sweep
    level = ((vmask, g.weighted_degrees(), g.total_volume())
             if spec.evaluator == "louvain" else None)

    def step(labels, active, it: int, seed: int):
        if spec.backend == "segment":
            proposal, propose = _evaluate_segment(spec, g, level, labels,
                                                  active, it, seed)
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
        next_active = (neighbor_or_self_changed(g, changed)
                       if spec.use_frontier else vmask)
        return new_labels, next_active, delta_n

    return step


class SweepEngine:
    """Local-moving sweep engine for one graph (one coarsening level).
    The ``ell``/``pallas`` backends build the ELL layout on the graph's
    device at construction."""

    def __init__(self, g: Graph, spec: EngineSpec, ell=None):
        self.g = g
        self.spec = spec
        self.ell = None
        if spec.backend in ("ell", "pallas"):
            self.ell = ell if ell is not None else build_ell(g)
        self._step = make_step(spec, g, self.ell)

    def singleton_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(labels, active): singleton init + full active set (Alg. 1 l.4-5)."""
        return (torch.arange(self.g.n_max, dtype=torch.int32,
                             device=self.g.device),
                self.g.vertex_mask())

    def run_phase(self, labels: torch.Tensor, active: torch.Tensor, *,
                  it0: int = 0, seed: int = 0, fused: bool = True
                  ) -> PhaseResult:
        """Run one local-moving phase to convergence (ΔN ≤ threshold or the
        sweep budget).  ``fused`` selects the same loop either way."""
        del fused
        spec = self.spec
        dn_hist, act_hist = [], []
        s = 0
        while s < spec.max_sweeps:
            labels, active, dn = self._step(labels, active,
                                            (it0 + s) & 0xFFFFFFFF, seed)
            dn_hist.append(dn)
            act_hist.append(torch.sum(active.to(torch.int32)))
            s += 1
            if int(dn) <= spec.threshold:
                break
        return PhaseResult(labels, active, s,
                           [int(x) for x in dn_hist],
                           [int(x) for x in act_hist])

"""Mixture-of-Experts layer with sort-based dispatch (port of
``repro.models.moe``).

The dispatch is the paper's GroupBy, as in the Louvain aggregation: the
token-to-expert assignments are sorted by expert id (a stable sort), each
run's start is carried forward by a running maximum, and an assignment's
rank within its expert's run decides whether it fits the expert's
capacity.  Every gather and scatter stays inside a dispatch group:

  x (B,S,D) -> (G, Tg, D)        G = number of dispatch groups
  router/top-k/sort/capacity     per group, batched over G
  buf (G, E·C, D)                kept rows placed at their slots
  expert FFN                     SwiGLU, batched over (G, E)
  combine                        each token's k slots summed in order

``_n_groups`` follows the active mesh's data extent, as the JAX
package's does; a data-parallel train step runs each data rank's rows as
one of the JAX package's dispatch groups (``launch/train_step.py``).

Expert parallelism (``moe_layer(..., split=mesh)``, where the JAX
package's ``experts_act`` resolves to ``model``: E divides by the model
extent n).  The JAX layout has no all-to-all: ``xg`` is replicated over
``model`` (``("batch", None, None)``), the dispatch into ``buf`` is
local, and its one reshard puts E on ``model``.  So model rank m holds
the expert weights of experts [m·E/n, (m+1)·E/n) and:

* routes every token of its data shard (``route`` and
  ``_dispatch_indices`` replicated: capacity and keep are the same on
  every model rank);
* fills only its experts' slots (``dispatch(..., experts=...)``) and runs
  the expert FFN on (G, E/n, C, D);
* combines a partial output from its own slots, and the ranks' partials
  are summed over ``model`` in rank order.

That sum, of one (G, Tg, D) tensor, is the one collective a MoE layer
runs in the forward pass: no all-to-all and no gather of rows.  The
tokens and the top-k weights are replicated values that feed the split
dispatch and combine, so they enter through ``copy_to`` (their
cotangents summed over ``model``), and the router's gradient comes out
whole on every rank; the aux loss is replicated and already whole.

Parity with the JAX package, which the port's tests hold bit for bit on
the integer parts:

* top-k is a stable descending sort of the probabilities, so ties keep
  the lower expert id first as ``jax.lax.top_k`` does (``torch.topk``
  orders ties otherwise);
* kept slots are unique, so the scatter is a plain ``index_put``
  (dropped assignments write zeros to a spare row past ``E·C``), never an
  atomic float accumulate, which is not deterministic on the card;
* the combine adds a token's k weighted slots in position order from
  zeros in ``x.dtype``, rounding after every add, as XLA's scatter-add
  does.

Aux losses: the Switch load-balance loss plus the router z-loss, averaged
over groups (over every data rank's groups when the rows are split over
the mesh).  Plain PyTorch throughout, differentiable under autograd.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.launch import collectives as coll
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh


# the aux loss's weights (the JAX package's ``moe_layer`` defaults; no
# config carries its own)
ROUTER_Z_COEF = 1e-3
BALANCE_COEF = 1e-2


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


def _n_groups(total_tokens: int) -> int:
    """Dispatch groups of this rank's ``total_tokens``: the JAX package's
    static count, the data-parallel extent of the active mesh halved until
    it divides the tokens, taken over every rank's tokens where the rows
    are split over the mesh (``launch.sharding.split_rows``), of which
    this rank holds its share."""
    mesh = shd.active_mesh()
    if mesh is None:
        return 1
    g = 1
    for ax in ("pod", "data"):
        g *= mesh.axis_size(ax)
    split = 1
    for ax in shd.row_axes():
        split *= mesh.axis_size(ax)
    while g > 1 and (total_tokens * split) % g:
        g //= 2
    if max(1, g) % split:
        raise ValueError(f"{g} dispatch groups over rows split {split} ways")
    return max(1, g) // split


def _dispatch_indices(expert_ids: torch.Tensor, n_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """expert_ids: (..., T) int — returns (slot, keep), each (..., T):
    ``slot`` in [0, E·C) int64, ``keep`` the assignments whose rank in
    their expert's run is under ``capacity``.  Integer work only."""
    t = expert_ids.shape[-1]
    sorted_e, order = torch.sort(expert_ids, dim=-1, stable=True)
    starts = torch.ones_like(sorted_e, dtype=torch.bool)
    starts[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    pos = torch.arange(t, dtype=torch.int64, device=expert_ids.device)
    pos = pos.expand_as(order)
    run_start = torch.where(starts, pos, torch.zeros_like(pos))
    run_start = torch.cummax(run_start, dim=-1).values
    rank = torch.empty_like(pos).scatter_(-1, order, pos - run_start)
    keep = rank < capacity
    slot = (torch.clamp(expert_ids.long(), 0, n_experts - 1) * capacity
            + torch.clamp(rank, 0, capacity - 1))
    return slot, keep


def route(xg: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Router of (G, Tg, D) tokens: float32 logits and probabilities
    (G, Tg, E), the top-k expert ids (G, Tg, k) in descending probability
    (ties to the lower id) and their renormalised weights."""
    logits = torch.einsum("gtd,de->gte", xg.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return logits, probs, top_e, top_p


def capacity_of(capacity_factor: float, top_k: int, tg: int, e: int) -> int:
    """Slots per expert in a group of ``tg`` tokens (the JAX package's
    Python arithmetic)."""
    return max(8, int(capacity_factor * top_k * tg / e))


def dispatch(xg: torch.Tensor, top_e: torch.Tensor, n_experts: int,
             capacity: int, experts: Optional[Tuple[int, int]] = None):
    """Sort, rank and scatter: (buf (G, E, C, D), slot, keep), slot and
    keep (G, Tg·k) over the assignments in token-major order.  Kept rows
    go to their slots, which are unique; dropped rows write their zeros to
    the spare row E·C, which is cut off.  ``experts`` (first, count): only
    those experts' slots, buf (G, count, C, D), ``slot`` counted from the
    first one's and ``keep`` false for the other experts' assignments."""
    G, tg, d = xg.shape
    top_k = top_e.shape[-1]
    slot, keep = _dispatch_indices(top_e.reshape(G, tg * top_k), n_experts,
                                   capacity)
    if experts is not None:
        first, n_experts = experts
        slot = slot - first * capacity
        keep = keep & (slot >= 0) & (slot < n_experts * capacity)
        slot = slot.clamp(0, n_experts * capacity - 1)
    ec = n_experts * capacity
    token_of = torch.arange(tg, device=xg.device).repeat_interleave(top_k)
    group_of = torch.arange(G, device=xg.device)[:, None]
    idx = torch.where(keep, slot, ec)
    rows = torch.where(keep[..., None], xg[:, token_of], 0.0)
    buf = xg.new_zeros((G, ec + 1, d)).index_put((group_of, idx), rows)
    return buf[:, :ec].reshape(G, n_experts, capacity, d), slot, keep


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its slots, batched over (G, E):
    (G, E, C, D) -> (G, E·C, D)."""
    G, e, c, d = buf.shape
    g_ = torch.einsum("gecd,edf->gecf", buf, w_gate)
    u_ = torch.einsum("gecd,edf->gecf", buf, w_up)
    h = torch.nn.functional.silu(g_.float()).to(buf.dtype) * u_
    return torch.einsum("gecf,efd->gecd", h, w_down).reshape(G, e * c, d)


def combine(yb: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
            top_p: torch.Tensor) -> torch.Tensor:
    """Each assignment's expert output, weighted, summed over its token's
    k slots in position order from zeros in ``yb.dtype``: (G, Tg, D)."""
    G, tg, top_k = top_p.shape
    d = yb.shape[-1]
    group_of = torch.arange(G, device=yb.device)[:, None]
    contrib = torch.where(keep[..., None], yb[group_of, slot], 0.0)
    contrib = (contrib * top_p.reshape(G, tg * top_k, 1).to(yb.dtype)
               ).reshape(G, tg, top_k, d)
    y = torch.zeros((G, tg, d), dtype=yb.dtype, device=yb.device)
    for i in range(top_k):
        y = y + contrib[:, :, i]
    return y


def aux_loss(logits: torch.Tensor, probs: torch.Tensor,
             top_e: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss plus router z-loss, float32 scalar; its
    means over every rank's tokens where the rows are split over the
    mesh."""
    e = probs.shape[-1]
    one_hot_top1 = torch.nn.functional.one_hot(top_e[..., 0], e).float()
    z2 = torch.logsumexp(logits, dim=-1) ** 2
    rows = shd.row_axes()
    if rows:
        mesh = shd.active_mesh()
        n = probs.shape[0] * probs.shape[1]
        me, ce = torch.sum(probs, dim=(0, 1)), torch.sum(one_hot_top1,
                                                         dim=(0, 1))
        z = torch.sum(z2)
        for a in rows:
            me = coll.reduce_from(me, mesh, a)
            ce = mesh.sum(ce, a)
            z = coll.reduce_from(z, mesh, a)
            n *= mesh.axis_size(a)
        me, ce, z = me / n, ce / n, z / n
    else:
        me = torch.mean(probs, dim=(0, 1))                      # (E,)
        ce = torch.mean(one_hot_top1, dim=(0, 1))
        z = torch.mean(z2)
    balance = e * torch.sum(me * ce)
    return (BALANCE_COEF * balance + ROUTER_Z_COEF * z).float()


def moe_layer(
    x: torch.Tensor,            # (B, S, D)
    w_router: torch.Tensor,     # (D, E)
    w_gate: torch.Tensor,       # (E, D, F)
    w_up: torch.Tensor,         # (E, D, F)
    w_down: torch.Tensor,       # (E, F, D)
    top_k: int,
    capacity_factor: float = 1.25,
    *,
    split: Optional[Mesh] = None,
) -> MoEOut:
    """The MoE layer; with ``split``, the mesh whose ``model`` axis the
    experts are split over (``w_gate``, ``w_up`` and ``w_down`` hold this
    rank's E/n experts), expert-parallel as the module docstring says."""
    b, s, d = x.shape
    e = w_router.shape[-1]
    t = b * s
    G = _n_groups(t)
    tg = t // G
    xg = x.reshape(G, tg, d)
    logits, probs, top_e, top_p = route(xg, w_router, top_k)
    capacity = capacity_of(capacity_factor, top_k, tg, e)
    if split is None:
        buf, slot, keep = dispatch(xg, top_e, e, capacity)
        yb = expert_ffn(buf, w_gate, w_up, w_down)
        y = combine(yb, slot, keep, top_p)
    else:
        local = w_gate.shape[0]
        buf, slot, keep = dispatch(
            coll.copy_to(xg, split, "model"), top_e, e, capacity,
            experts=(split.coord("model") * local, local))
        yb = expert_ffn(buf, w_gate, w_up, w_down)
        y = coll.reduce_from(
            combine(yb, slot, keep, coll.copy_to(top_p, split, "model")),
            split, "model")
    aux = aux_loss(logits, probs, top_e)
    return MoEOut(y.reshape(b, s, d), aux)

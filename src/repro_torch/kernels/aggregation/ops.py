"""Sort-free binned coarsening (port of ``repro.kernels.aggregation.ops``).

Stages, each the JAX package's:

  1. *Gate*: count each source community's edges; if any row has more edges
     than the static bin width, skip probing and take the one-sort path
     (``agg.sort_fallback`` counter).  This is the JAX package's gate
     exactly (``max row_edges <= W``), so the same levels take each path.
  2. *Insert*: scatter-min claim rounds (``scatter_reduce_(..., "amin")``)
     give each distinct (src-community, dst-community) pair one slot of the
     (n+1, width) bin-key table; edges of the SAME pair share the probe
     sequence, so they resolve together.  A survivor after ``width`` rounds
     raises the overflow fallback.
  3. *Rank*: per edge, the rank of its destination key within its bin row
     (``bin_rank`` — its wrapper or its plain version, ``impl``) plus a
     per-row occupancy count and an exclusive ``cumsum`` give the canonical
     front-compacted, src-sorted output position.
  4. *Output*: an id scatter and a deterministic weight segment sum keyed
     by output position, adding each group's weights in original edge
     order — so the result equals the one-sort ``remap_and_coarsen`` coarse
     graph bit for bit.

The JAX package runs the gate, the rounds and the fallback on device under
``lax.cond``/``lax.while_loop``; here they are host decisions, one scalar
readback each.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.graph import segment as seg
from repro_torch.graph.structure import Graph
from repro_torch.kernels.aggregation.kernel import bin_rank_kernel
from repro_torch.kernels.aggregation.ref import bin_rank_ref
from repro_torch.kernels.common import BIN_IMPLS, hash_u32, pick_bin_width
from repro_torch.utils import telemetry


def community_edge_keys(g: Graph, new_com: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge (src-community, dst-community) int32 keys; masked edges get
    the ``n_max`` sentinel on both sides (they route to the sink row)."""
    n = g.n_max
    cs = torch.where(g.edge_mask, new_com[torch.clamp(g.src, 0, n - 1)], n)
    cd = torch.where(g.edge_mask, new_com[torch.clamp(g.dst, 0, n - 1)], n)
    return cs.to(torch.int32), cd.to(torch.int32)


def insert_bins(
    g: Graph,
    cs: torch.Tensor,
    cd: torch.Tensor,
    *,
    width: int,
    max_rounds: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, bool, int]:
    """Gate + probing insert.  Returns ``(keys_flat, resolved, overflow,
    rounds)``: the ((n+1)·width + 1,) bin-key table (last element is the
    claim sink), per-edge resolution, the fallback predicate, and the
    number of probe rounds run."""
    n, W = g.n_max, width
    dev = cs.device
    empty = n
    active = g.edge_mask
    rounds_max = max_rounds if max_rounds is not None else W
    sink = (n + 1) * W          # the claim sink: the table's last element
    row_base = torch.where(active, cs, n).long() * W
    h0 = hash_u32(cd) % W
    keys = torch.full((sink + 1,), empty, dtype=torch.int32, device=dev)

    # gate: a row with more than W edges MAY hold more than W distinct
    # destinations; skip probing entirely and let the sort path run.  Only
    # active edges are counted: routing the padding to one sink bin would
    # pile every atomic onto one address.
    row_edges = torch.bincount(cs[active].long(), minlength=n + 1)
    fits = n == 0 or int(row_edges[:n].max()) <= W
    resolved = ~active
    rounds = 0
    if fits:
        while rounds < rounds_max and bool((~resolved).any()):
            idx = row_base + (h0 + rounds) % W
            k_cur = keys[idx]
            hit = ~resolved & (k_cur == cd)
            claim = ~resolved & (k_cur == empty)
            # only claimers write (the JAX package sends the rest to the
            # sink element, which no read ever reaches)
            keys.scatter_reduce_(0, idx[claim], cd[claim], "amin")
            won = claim & (keys[idx] == cd)
            resolved = resolved | hit | won
            rounds += 1
    overflow = bool((active & ~resolved).any())
    return keys, resolved, overflow, rounds


def binned_coarsen(
    g: Graph,
    new_com: torch.Tensor,
    n_comm: int,
    *,
    width: Optional[int] = None,
    impl: str = "kernel",
    max_rounds: Optional[int] = None,
) -> Graph:
    """Sort-free coarse graph for CONTIGUOUS community ids ``new_com``;
    bit-for-bit the one-sort ``core.aggregation.coarsen_graph`` output.

    ``impl`` picks the rank pass: ``"kernel"`` the ``bin_rank`` wrapper
    (which launches the CUDA kernel for tensors on the card and runs the
    plain version for tensors on the CPU), ``"ref"`` the plain version on
    any device.  The JAX package also weighed a VMEM budget here; the
    card's kernel reads the bin table from device memory, so none applies."""
    if impl not in BIN_IMPLS:
        raise ValueError(f"unknown bin impl {impl!r}, want one of {BIN_IMPLS}")
    n, m = g.n_max, g.m_max
    W = width if width is not None else pick_bin_width(n, m)
    dev = g.device
    active = g.edge_mask

    cs, cd = community_edge_keys(g, new_com)
    keys, _resolved, overflow, _rounds = insert_bins(
        g, cs, cd, width=W, max_rounds=max_rounds)
    w_act = torch.where(active, g.w, 0.0)

    if overflow:
        # the one-sort GroupBy, exactly coarsen_graph's massaging
        telemetry.bump("agg.sort_fallback")
        (gk, gs, gvalid, _ng) = seg.groupby_sum(
            (cs, cd), w_act, valid=active, bound=n)
        grp_ok = gvalid & (gk[0] < n)
        return Graph(
            src=torch.where(grp_ok, gk[0], n).to(torch.int32),
            dst=torch.where(grp_ok, gk[1], n).to(torch.int32),
            w=torch.where(grp_ok, gs, 0.0),
            edge_mask=grp_ok,
            n_valid=int(n_comm),
            m_valid=int(grp_ok.sum()),
            n_max=n, m_max=m, sorted_by="src")

    telemetry.bump("agg.binned")
    keys_flat = keys[:-1]
    cnt = torch.sum(keys_flat.view(n + 1, W)[:n] != n, dim=1)
    row_start = torch.cumsum(cnt, 0) - cnt
    n_groups = int(cnt.sum())
    cs_c = torch.clamp(cs, 0, n)
    rank_fn = bin_rank_kernel if impl == "kernel" else bin_rank_ref
    rank_e = rank_fn(keys_flat, cs_c, cd, width=W, empty=n)
    epos = torch.where(active, row_start[torch.clamp(cs, 0, n - 1).long()]
                       + rank_e, m)
    # all edges of a group share (cs, cd), so duplicate positions write
    # identical ids; (cs, cd) packs exactly into one int64 id scatter
    base = n + 1
    packed = torch.full((m + 1,), n * base + n, dtype=torch.long, device=dev)
    packed[epos] = cs.long() * base + cd.long()
    packed = packed[:m]
    # active edges land in [0, n_groups); the masked ones (position m) drop
    sums = torch.zeros(m, dtype=g.w.dtype, device=dev)
    sums[:n_groups] = seg.segment_sum(w_act, epos, n_groups)
    gmask = torch.arange(m, device=dev) < n_groups
    return Graph(
        src=(packed // base).to(torch.int32),
        dst=(packed % base).to(torch.int32),
        w=sums,
        edge_mask=gmask,
        n_valid=int(n_comm),
        m_valid=n_groups,
        n_max=n, m_max=m, sorted_by="src")

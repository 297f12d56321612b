"""Segment / GroupBy primitives (port of ``repro.graph.segment``).

The JAX package groups with a multi-operand stable ``lax.sort``; here the
keys fold into ONE composite int64 key sorted with ``torch.sort(stable=True)``,
which orders entries exactly as the lexicographic multi-key sort does (equal
composite keys keep their input order).  Keys are small non-negative ids
(vertex or community ids, the ``n`` sentinel, and ``-1`` as a "sorts first"
marker), so callers pass ``bound`` — the largest key value — and every key
must lie in ``[-1, bound]``.

Float segment sums go through ``segment_sum``: a sort by segment id followed
by ``torch.segment_reduce``, which is deterministic on the card.
``index_add_`` on CUDA adds with atomics in no fixed order, so float sums
past 2^24 (community volumes of big graphs) would differ from run to run and
could flip a decision between two backends that should agree.  Segment
lengths come from a binary search over the sorted ids, and dropped entries
(padding, the sink id) are cut off before reducing: on a coarse level most
of the edge capacity is padding, and atomics or a single block on that one
crowded segment cost more than the rest of the sweep.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _sorted_lengths(ids: torch.Tensor, num_segments: int
                    ) -> Tuple[torch.Tensor, int]:
    """Segment lengths of ascending ``ids`` in [0, num_segments] (the last
    value marks dropped entries), by binary search — no atomics, so a
    crowded segment costs nothing extra."""
    bounds = torch.searchsorted(
        ids, torch.arange(num_segments + 1, device=ids.device))
    return bounds[1:] - bounds[:-1], int(bounds[-1])


def _in_range(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num_segments: int,
                *, ids_sorted: bool = False) -> torch.Tensor:
    """``out[s] = Σ vals[ids == s]`` for s in [0, num_segments); ids outside
    that range are dropped (as ``jax.ops.segment_sum`` drops them).

    Float sums add each segment's values in input order through a sorted
    reduction (deterministic); integer sums use ``index_add_``, which is
    exact in any order.  ``ids_sorted`` skips the sort when the caller knows
    ``ids`` ascend with every dropped id last (e.g. ``src`` of a src-sorted
    graph, whose padding holds the ``n_max`` sentinel)."""
    ids = _in_range(ids, num_segments)
    if not vals.is_floating_point():
        out = torch.zeros(num_segments + 1, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, ids, vals)[:num_segments]
    if not ids_sorted:
        ids, order = torch.sort(ids, stable=True)
        vals = vals[order]
    lengths, end = _sorted_lengths(ids, num_segments)
    return torch.segment_reduce(vals[:end], "sum", lengths=lengths,
                                unsafe=True)


def composite_key(keys: Sequence[torch.Tensor], bound: int,
                  first_size: int | None = None) -> torch.Tensor:
    """One int64 key ordering like the lexicographic tuple ``keys``.

    Each key lies in ``[-1, bound]``; ``first_size`` narrows the leading
    key's range to ``[0, first_size)`` (a 0/1 validity flag), which keeps
    three-key composites of multi-million-vertex graphs inside int64."""
    base = bound + 2
    out = keys[0].long() if first_size is not None else keys[0].long() + 1
    span = first_size if first_size is not None else base
    for k in keys[1:]:
        span *= base
        out = out * base + (k.long() + 1)
    if span >= 2**63:
        raise OverflowError(f"composite key of {len(keys)} keys with bound "
                            f"{bound} does not fit int64")
    return out


def run_starts(sorted_key: torch.Tensor) -> torch.Tensor:
    """bool[m]: True at the first element of each equal-key run."""
    starts = torch.ones_like(sorted_key, dtype=torch.bool)
    starts[1:] = sorted_key[1:] != sorted_key[:-1]
    return starts


def run_ids(starts: torch.Tensor) -> torch.Tensor:
    """int64[m]: dense run index (0-based) for each element."""
    return torch.cumsum(starts.long(), 0) - 1


def groupby_sum(
    keys: Sequence[torch.Tensor],
    values: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    bound: int,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupBy(keys).sum(values) with static output capacity.

    Invalid entries sort after every valid one.  Returns (group_keys,
    group_sums, group_valid, n_groups) exactly as the JAX package's
    ``groupby_sum`` with its default scatter compaction: representatives
    compacted to the front in key order, sums in group order; slots past
    ``n_groups`` are unspecified and masked by ``group_valid``.
    """
    m = values.shape[0]
    dev = values.device
    if valid is None:
        valid = torch.ones(m, dtype=torch.bool, device=dev)
    flag = torch.where(valid, 0, 1)
    key = composite_key((flag, *keys), bound, first_size=2)
    skey, order = torch.sort(key, stable=True)
    svalid = valid[order]
    sv = values[order]
    starts_all = run_starts(skey)
    starts = starts_all & svalid
    rid = run_ids(starts_all)
    n_groups = int(starts.sum())
    # valid runs are the first n_groups runs; the invalid tail (mostly
    # padding) is dropped before the reduction and its sums stay 0
    sums = torch.zeros(m, dtype=values.dtype, device=dev)
    sums[:n_groups] = segment_sum(sv, torch.where(svalid, rid, n_groups),
                                  n_groups, ids_sorted=True)
    group_valid = torch.arange(m, device=dev) < n_groups
    # valid runs sort first, so the j-th valid run start has rid == j:
    # scatter each start's position into slot rid, then gather (slot m is
    # the sink of non-start entries; slots >= n_groups keep index 0)
    pos = torch.where(starts, rid, m)
    idx = torch.zeros(m + 1, dtype=torch.long, device=dev)
    idx[pos] = torch.arange(m, device=dev)
    idx = order[idx[:m]]
    group_keys = tuple(k[idx] for k in keys)
    return group_keys, sums, group_valid, n_groups


def compact(mask: torch.Tensor, arrays: Sequence[torch.Tensor]
            ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Stable-move entries where mask is True to the front. Returns
    (arrays, count): True entries land at their True-rank, False entries at
    count + False-rank, both in original order."""
    m = mask.shape[0]
    csum = torch.cumsum(mask.long(), 0)
    count = csum[-1] if m else torch.zeros((), dtype=torch.long,
                                           device=mask.device)
    pos = torch.where(mask, csum - 1,
                      count + torch.arange(m, device=mask.device) - csum)
    perm = torch.empty(m, dtype=torch.long, device=mask.device)
    perm[pos] = torch.arange(m, device=mask.device)
    return tuple(a[perm] for a in arrays), count


def contiguize_ids(keys: torch.Tensor, valid: torch.Tensor, size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-free dense-id assignment for integer keys in ``[0, size)``:
    presence bitmap + ``cumsum``.  Returns ``(table, count)``: ``table[k]``
    is the dense id of present key ``k`` (ascending in key order) and
    ``size`` for absent keys; ``count`` is the number of distinct keys."""
    idx = torch.clamp(torch.where(valid, keys.long(), size), 0, size)
    p = torch.zeros(size + 1, dtype=torch.int32, device=keys.device)
    p[idx] = 1
    p = p[:size]
    table = torch.where(p == 1, torch.cumsum(p, 0, dtype=torch.int32) - 1,
                        size).to(torch.int32)
    return table, torch.sum(p)


def segment_argmax(
    scores: torch.Tensor,
    candidates: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    valid: torch.Tensor | None = None,
    *,
    segments_sorted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (max score, candidate achieving it; smallest-candidate
    tie-break).  Empty segments get (-inf, -1); segment ids outside
    [0, num_segments) are dropped.

    Both reductions are sorted-segment reductions (max, then min over the
    candidates that reach it, held exactly as float64), not scatter
    atomics, which crawl when many entries share one segment.
    ``segments_sorted`` skips the sort when ``segments`` ascend with every
    dropped id last."""
    neg_inf = float("-inf")
    if valid is not None:
        scores = torch.where(valid, scores, neg_inf)
    seg = _in_range(segments, num_segments)
    if not segments_sorted:
        seg, order = torch.sort(seg, stable=True)
        scores, candidates = scores[order], candidates[order]
    lengths, end = _sorted_lengths(seg, num_segments)
    seg, scores, candidates = seg[:end], scores[:end], candidates[:end]
    best = torch.segment_reduce(scores, "max", lengths=lengths, unsafe=True,
                                initial=neg_inf)
    is_best = scores == best[seg]
    big = float(2**31 - 1)
    cand_masked = torch.where(is_best & (scores > neg_inf),
                              candidates.to(torch.float64), big)
    best_cand = torch.segment_reduce(cand_masked, "min", lengths=lengths,
                                     unsafe=True, initial=big)
    return best, torch.where(best_cand == big, -1, best_cand).to(torch.int32)

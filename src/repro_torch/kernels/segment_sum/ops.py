"""Sorted segment sum = block kernel + O(num_blocks) spine fix-up (port of
``repro.kernels.segment_sum.ops``).

``use_pallas=True`` pads the keys with INT32_MAX to a block multiple, runs
the block pass through its wrapper (a CUDA launch for tensors on the card,
the plain version for tensors on the CPU) and stitches runs that cross
block boundaries with tensor ops, as the JAX package does outside Pallas.
The stitch adds each block's first-key partial to the run that started in
an earlier block; a run spanning several blocks gets several such
partials, and they are added in block order by the sorted reduction of
``graph.segment.segment_sum`` (the run ids of the blocks' first positions
ascend), not by ``index_add_``, whose float sums on the card follow no
fixed order.  The JAX package reduces them over all m run ids; here over
the num_blocks block-first runs, which gives the same sums in the same
order without an m-segment reduction.  ``use_pallas=False`` runs the
plain version on any device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.graph.segment import run_ids, run_starts, segment_sum
from repro_torch.kernels.segment_sum.kernel import (DEFAULT_BLOCK,
                                                    block_segment_sums_kernel)
from repro_torch.kernels.segment_sum.ref import sorted_segment_sum_ref

INT32_MAX = 2**31 - 1


def sorted_segment_sum(
    keys: torch.Tensor,
    vals: torch.Tensor,
    *,
    block: int = DEFAULT_BLOCK,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, starts): run totals at run-start positions of SORTED ``keys``.

    Keys may contain any int32 values (including sentinels) as long as they
    are non-decreasing; padding added here uses INT32_MAX."""
    keys = keys.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    if not use_pallas:
        return sorted_segment_sum_ref(keys, vals)

    m = keys.shape[0]
    pad = (-m) % block
    kp = torch.cat([keys, keys.new_full((pad,), INT32_MAX)])
    vp = torch.cat([vals, vals.new_zeros(pad)])
    mp = m + pad

    within = block_segment_sums_kernel(kp, vp, block=block)

    starts = run_starts(kp)
    rid = run_ids(starts)

    # spine fix-up: attribute each block's first-key partial to the run that
    # started in an earlier block (skip blocks whose first element IS a start)
    p0 = torch.arange(0, mp, block, device=kp.device)
    contrib = torch.where(starts[p0], 0.0, within[p0])
    # extra[r] = Σ contrib over the blocks whose first position lies in run
    # r, in block order: summed over the nb block-first runs (dense ids),
    # then written to extra at the run ids — every block of one run writes
    # the same total, so the write order does not matter
    rb = rid[p0]
    rbd = run_ids(run_starts(rb))
    per_run = segment_sum(contrib, rbd, rb.shape[0], ids_sorted=True)
    extra = torch.zeros(mp, dtype=torch.float32, device=kp.device)
    extra[rb] = per_run[rbd]

    sums = torch.where(starts, within + extra[rid], 0.0)
    return sums[:m], starts[:m]

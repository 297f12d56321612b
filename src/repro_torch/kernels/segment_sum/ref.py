"""Plain PyTorch versions of the sorted segment sum (port of
``repro.kernels.segment_sum.ref``, with the block pass of its kernel).

Semantics: given SORTED int32 ``keys`` (runs of equal keys = segments) and
float32 ``vals``, ``sorted_segment_sum_ref`` returns ``(sums, starts)``
where ``starts[p]`` marks the first element of each run and ``sums[p]`` is
the TOTAL of p's run if ``starts[p]`` else 0.  The run totals are the
deterministic sorted reduction of ``graph.segment.segment_sum`` (the JAX
package's ``jax.ops.segment_sum`` over run ids, which ascend).

``block_segment_sums_ref`` is the plain version of the CUDA block kernel:
per block of ``block`` positions, ``out[p] = Σ_q vals[q]·[keys[q] ==
keys[p]]`` over q in p's block — the JAX kernel's (block, block) equality
reduction, expression for expression, over bounded chunks of blocks.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.graph.segment import run_ids, run_starts, segment_sum
from repro_torch.kernels.common import PAIRWISE_ELEMS


def sorted_segment_sum_ref(keys: torch.Tensor, vals: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = keys.shape[0]
    starts = run_starts(keys)
    rid = run_ids(starts)
    totals = segment_sum(vals, rid, m, ids_sorted=True)
    return torch.where(starts, totals[rid], 0.0), starts


def block_segment_sums_ref(keys: torch.Tensor, vals: torch.Tensor,
                           block: int) -> torch.Tensor:
    """Per-position within-block run totals; the length divides ``block``."""
    m = keys.shape[0]
    k2, v2 = keys.reshape(-1, block), vals.reshape(-1, block)
    step = max(1, PAIRWISE_ELEMS // (block * block))
    out = []
    for a in range(0, k2.shape[0], step):
        k, v = k2[a:a + step], v2[a:a + step]
        eq = k[:, :, None] == k[:, None, :]           # (blocks, B, B)
        out.append(torch.sum(torch.where(eq, v[:, :, None], 0.0), dim=1))
    return torch.cat(out).reshape(m) if out else vals.new_zeros(0)

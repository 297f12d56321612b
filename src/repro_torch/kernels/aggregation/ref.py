"""Plain PyTorch version of the binned aggregation rank pass (port of
``repro.kernels.aggregation.ref``).

After the probing insert (ops.py) every valid edge's destination community
sits in exactly one slot of its source community's (width,) bin row; the
coarse graph's canonical slot order then only needs, per edge, the RANK of
its destination key within its row.
"""
from __future__ import annotations

import torch

# Edges per chunk: the gathered (edges, width) key rows stay below 64 MB.
EDGE_CHUNK = (1 << 24) // 256


def bin_rank_ref(
    keys_flat: torch.Tensor,   # (n_rows·width,) int32 — bin-key table
    cs: torch.Tensor,          # (R,) int32 — per-edge row (source community)
    cd: torch.Tensor,          # (R,) int32 — per-edge key (destination community)
    *,
    width: int,
    empty: int,
) -> torch.Tensor:
    """Per-edge within-row rank: # occupied slots in row ``cs`` with a key
    strictly below ``cd``.  Masked edges carry the sink row, whose keys stay
    ``empty``, so they rank 0."""
    iota_w = torch.arange(width, device=cs.device)
    out = []
    for a in range(0, max(cs.shape[0], 1), EDGE_CHUNK):
        c, d = cs[a:a + EDGE_CHUNK].long(), cd[a:a + EDGE_CHUNK]
        row_keys = keys_flat[c[:, None] * width + iota_w[None, :]]  # (R, width)
        less = (row_keys != empty) & (row_keys < d[:, None])
        out.append(torch.sum(less.to(torch.int32), dim=1, dtype=torch.int32))
    return torch.cat(out)

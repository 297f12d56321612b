"""Shared pieces of the two community-detection algorithms (port of
``repro.core.common``).  ``hash_u32``/``tie_noise`` live in
``kernels.common`` (one copy; the JAX package keeps two identical ones)."""
from __future__ import annotations

import torch

from repro_torch.graph.structure import Graph
from repro_torch.kernels.common import _M32, _mul_u32, _u32, hash_u32, tie_noise

__all__ = ["hash_u32", "tie_noise", "luby_move_gate",
           "neighbor_or_self_changed"]


def luby_move_gate(
    n: int,
    sweep_key,
    seed,
    move_prob: float,
    mult: int,
    salt: int,
    device: torch.device,
) -> torch.Tensor:
    """bool[n]: Luby-style per-vertex move coin for one synchronous sweep.

    Moving a random ``move_prob`` fraction of intenders per sweep breaks
    synchronous two-cycles; ``mult``/``salt`` decorrelate the PLP and
    Louvain coin streams.  The threshold ``int(move_prob · (2^32 − 1))``
    compares as an unsigned 32-bit value, as in the JAX package."""
    key = (_u32(sweep_key) + _mul_u32(_u32(seed), salt)) & _M32
    coin = hash_u32(
        _mul_u32(torch.arange(n, device=device, dtype=torch.long), mult)
        ^ hash_u32(key.to(device)))
    return coin < int(move_prob * 4294967295.0)


def neighbor_or_self_changed(g: Graph, changed: torch.Tensor) -> torch.Tensor:
    """Active-set propagation (Alg. 1 l.25 / Alg. 2 l.21): a vertex needs
    re-checking iff it changed or any neighbor changed."""
    n = g.n_max
    contrib = g.edge_mask & changed[torch.clamp(g.src, 0, n - 1)]
    hit = torch.zeros(n + 1, dtype=torch.bool, device=changed.device)
    hit[torch.where(contrib, g.dst, n).long()] = True
    return changed | hit[:n]

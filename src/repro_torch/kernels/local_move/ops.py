"""Dispatch for the fused local_move family (port of
``repro.kernels.local_move.ops``, resident tables only).

``use_pallas=True`` (the ``pallas`` engine backend) goes through the kernel
wrappers of ``kernel.py`` — a CUDA launch for tensors on the card, the plain
version for tensors on the CPU; ``use_pallas=False`` (the ``ell`` backend)
runs the plain version on any device.  The JAX package's windowed
"streamed" table layout is not ported yet (ROADMAP Queue 2 #4):
``table_mode="streamed"`` raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import TABLE_MODES
from repro_torch.kernels.local_move.kernel import (local_move_louvain_kernel,
                                                   local_move_plp_kernel)
from repro_torch.kernels.local_move.ref import (compose_louvain_tables,
                                                local_move_louvain_tables_ref,
                                                local_move_plp_ref)


def check_table_mode(table_mode: str) -> None:
    if table_mode not in TABLE_MODES:
        raise ValueError(
            f"unknown table_mode {table_mode!r}, want one of {TABLE_MODES}")
    if table_mode == "streamed":
        raise NotImplementedError(
            "table_mode='streamed' (windowed table streaming) is not ported "
            "yet: ROADMAP Queue 2 #4")


def local_move_plp(
    rows: torch.Tensor,        # (R,) int32 vertex id per row
    nbr: torch.Tensor,         # (R, W) int32 neighbor ids
    w: torch.Tensor,           # (R, W) float32 edge weights
    labels_ext: torch.Tensor,  # (n+1,) labels table, labels_ext[n] = n
    seed: int,                 # uint32 tie-noise seed
    *,
    tie_eps: float,
    sentinel: int,
    use_pallas: bool = False,
    table_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_label, propose) per row, gathers fused into the evaluator."""
    check_table_mode(table_mode)
    fn = local_move_plp_kernel if use_pallas else local_move_plp_ref
    return fn(rows, nbr, w, labels_ext, seed, tie_eps=tie_eps,
              sentinel=sentinel)


def local_move_louvain(
    rows: torch.Tensor,       # (R,) int32 vertex id per row
    nbr: torch.Tensor,        # (R, W) int32 neighbor ids
    w: torch.Tensor,          # (R, W) float32 edge weights
    com_ext: torch.Tensor,    # (n+1,) community table, com_ext[n] = n
    vol_ext: torch.Tensor,    # (n+1,) community volumes, vol_ext[n] = 0
    size_ext: torch.Tensor,   # (n+1,) community sizes, size_ext[n] = 0
    deg_ext: torch.Tensor,    # (n+1,) weighted degrees, deg_ext[n] = 0
    vol_total: torch.Tensor,  # scalar vol(V)
    *,
    sentinel: int,
    singleton_rule: bool = True,
    use_pallas: bool = False,
    table_mode: str = "auto",
    composed=None,            # per-vertex composed table 4-tuple
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community, propose) per row; the gain test is Eq. 1 > 0.
    ``composed`` passes the tables of ``compose_louvain_tables`` built once
    per sweep, shared by every bucket."""
    check_table_mode(table_mode)
    inv_vol = (1.0 / vol_total).to(torch.float32)
    if composed is None:
        composed = compose_louvain_tables(
            com_ext.to(torch.int32), vol_ext.to(torch.float32),
            size_ext.to(torch.int32), deg_ext.to(torch.float32), sentinel)
    fn = local_move_louvain_kernel if use_pallas else local_move_louvain_tables_ref
    return fn(rows, nbr, w, *composed, inv_vol, sentinel=sentinel,
              singleton_rule=singleton_rule)

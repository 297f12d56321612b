"""Dispatch for the fused local_move family (port of
``repro.kernels.local_move.ops``).

``use_pallas=True`` (the ``pallas`` engine backend) goes through the kernel
wrappers of ``kernel.py`` — a CUDA launch for tensors on the card, the plain
version for tensors on the CPU; ``use_pallas=False`` (the ``ell`` backend)
runs the plain version on any device.

Table layout: ``table_mode`` picks between the resident layout (every row
reads the whole per-vertex tables) and the streamed one (each block of
rows reads only its window of each table, ``graph.ell.TableWindows``,
staged in the block's shared memory on the card).  ``auto`` resolves per
bucket from the shared-memory budget (``_resolve_mode``), and the mode
taken is counted in telemetry as ``local_move.<mode>.w<W>``.  Both layouts
give identical results, on the card and in the plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.common import (TABLE_LANE, TABLE_MODES, cdiv,
                                        resolve_table_mode)
from repro_torch.kernels.local_move.kernel import (
    local_move_louvain_kernel, local_move_louvain_streamed_kernel,
    local_move_plp_kernel, local_move_plp_streamed_kernel)
from repro_torch.kernels.local_move.ref import (
    compose_louvain_tables, local_move_louvain_tables_ref,
    local_move_louvain_windowed_ref, local_move_plp_ref,
    local_move_plp_windowed_ref)
from repro_torch.utils import telemetry


def check_table_mode(table_mode: str) -> None:
    if table_mode not in TABLE_MODES:
        raise ValueError(
            f"unknown table_mode {table_mode!r}, want one of {TABLE_MODES}")


def _resolve_mode(table_mode: str, windows, n_tables: int, sentinel: int,
                  smem_budget: Optional[int]) -> str:
    """Resident-vs-streamed decision for one bucket, the JAX package's rule
    on the card's shared-memory budget.  ``auto`` streams only when

    * the tables exceed half the budget (``resolve_table_mode``),
    * the window is narrower than the table — with poor id locality one
      outlier row widens every block's window to the whole id range, and
      streaming then copies the whole table per block, and
    * the windows one block of the streamed kernel stages (one buffer of
      2·slot entries per table, not the TPU pipeline's two) fit half the
      budget, which leaves the other half for the row staging.

    Explicit ``"streamed"`` is honored unchecked, as in the JAX package; on
    the card a window over the block's shared memory then raises
    ``KernelError``.  Under the ``vmem_starve`` fault the budget is 1 KB
    (``kernels.common.smem_budget_bytes``), no window fits half of it, and
    ``auto`` keeps every bucket resident."""
    if windows is None:
        if table_mode == "streamed":
            raise ValueError(
                "table_mode='streamed' requires window metadata "
                "(graph.ell.TableWindows); build buckets with build_ell()")
        return "resident"
    n_pad = cdiv(sentinel + 1, TABLE_LANE) * TABLE_LANE
    mode = resolve_table_mode(table_mode, 4 * n_tables * n_pad, smem_budget)
    if mode == "streamed" and table_mode == "auto":
        win_bytes = 4 * n_tables * 2 * windows.slot
        if (2 * windows.slot >= n_pad
                or resolve_table_mode("auto", win_bytes, smem_budget)
                != "resident"):
            return "resident"
    return mode


def _mode(table_mode, windows, n_tables: int, sentinel: int, width: int
          ) -> str:
    """The bucket's mode under the default budget, counted in telemetry."""
    mode = _resolve_mode(table_mode, windows, n_tables, sentinel, None)
    telemetry.bump(f"local_move.{mode}.w{width}")
    return mode


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
    windows=None,              # graph.ell.TableWindows | None
    table_mode: str = "auto",  # auto | resident | streamed
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_label, propose) per row, gathers fused into the evaluator."""
    mode = _mode(table_mode, windows, 1, sentinel, nbr.shape[1])
    kw = dict(tie_eps=tie_eps, sentinel=sentinel)
    if mode == "streamed":
        fn = (local_move_plp_streamed_kernel if use_pallas
              else local_move_plp_windowed_ref)
        kw["windows"] = windows
    else:
        fn = local_move_plp_kernel if use_pallas else local_move_plp_ref
    return fn(rows, nbr, w, labels_ext, seed, **kw)


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
    windows=None,             # graph.ell.TableWindows | None
    table_mode: str = "auto", # auto | resident | streamed
    composed=None,            # per-vertex composed table 4-tuple
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community, propose) per row; the gain test is Eq. 1 > 0.
    ``composed`` passes the tables of ``compose_louvain_tables`` built once
    per sweep, shared by every bucket."""
    mode = _mode(table_mode, windows, 4, sentinel, nbr.shape[1])
    inv_vol = (1.0 / vol_total).to(torch.float32)
    if composed is None:
        composed = compose_louvain_tables(
            com_ext.to(torch.int32), vol_ext.to(torch.float32),
            size_ext.to(torch.int32), deg_ext.to(torch.float32), sentinel)
    kw = dict(sentinel=sentinel, singleton_rule=singleton_rule)
    if mode == "streamed":
        fn = (local_move_louvain_streamed_kernel if use_pallas
              else local_move_louvain_windowed_ref)
        kw["windows"] = windows
    else:
        fn = (local_move_louvain_kernel if use_pallas
              else local_move_louvain_tables_ref)
    return fn(rows, nbr, w, *composed, inv_vol, **kw)

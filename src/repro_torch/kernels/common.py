"""Shared kernel utilities (port of ``repro.kernels.common``).

The uint32 hashes of the JAX package wrap modulo 2^32.  PyTorch has few
uint32 kernels, so the plain versions here emulate them in int64 with an
explicit ``& 0xFFFFFFFF`` after every step; each 32-bit product is split
into 16-bit halves so no int64 product can overflow.  The CUDA kernels
compute the same hashes in native ``uint32_t``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils import faultinject, telemetry

# Largest integer float32 accumulates exactly (24-bit mantissa).
F32_ACCUM_SAFE = 1 << 24

TABLE_MODES = ("auto", "resident", "streamed")
BIN_IMPLS = ("kernel", "ref")

# Window-offset granularity of the streamed table layout: a bucket's slot
# stride is a multiple of this.  It is the JAX package's value (the TPU lane
# width), kept so the port's windows are the JAX package's windows.
TABLE_LANE = 128

# Shared memory one block can use on an NVIDIA H100 (SXM): 227 KB, above
# 48 KB only as dynamic shared memory after an opt-in.  The streamed layout
# stages each block's table windows there, so this is the budget the
# resident-vs-streamed policy weighs tables and windows against.
SMEM_BUDGET_BYTES = 232_448

# Static width menu shared by the ELL re-bucketing and the bin table.
STAGE_WIDTH_MENU = (16, 64, 256)

_M32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant
    ``c`` < 2^32, with every intermediate below 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _u32(x) -> torch.Tensor:
    """The uint32 value of ``x`` (an integer tensor), held in int64."""
    return torch.as_tensor(x).long() & _M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 avalanche on uint32 values (held in int64)."""
    x = _u32(x)
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def noise_scale(eps: float) -> np.float32:
    """The float32 factor turning a uint32 hash into noise in [0, eps)."""
    return np.float32(eps / 4294967296.0)


def tie_noise(a: torch.Tensor, b: torch.Tensor, seed, eps: float) -> torch.Tensor:
    """Deterministic pseudo-random tie-break noise in [0, eps), float32:
    ``hash(a·0x9E3779B1 ^ hash(b + seed))`` scaled by ``eps / 2^32``."""
    b = _u32(b)
    seed = _u32(seed).to(b.device)
    h = hash_u32(_mul_u32(_u32(a), 0x9E3779B1) ^ hash_u32((b + seed) & _M32))
    scale = torch.tensor(noise_scale(eps), device=h.device)
    return h.to(torch.float32) * scale


def check_tensor(t: torch.Tensor, what: str, dtype: torch.dtype, shape,
                 device) -> None:
    """A kernel wrapper's input check: raise unless ``t`` lies on
    ``device`` with this dtype and shape, contiguous."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Pairwise-tensor elements per row chunk of the plain scoring versions
# (128 MB of float32 per temporary).
PAIRWISE_ELEMS = 1 << 25


def row_chunks(R: int, W: int):
    """[(a, b), ...] row ranges covering R rows of width W, each small enough
    that its (rows, W, W) pairwise tensor holds ``PAIRWISE_ELEMS`` entries
    at most.  Rows are scored independently, so chunking changes no value."""
    step = max(1, PAIRWISE_ELEMS // max(1, W * W))
    return [(i, min(R, i + step)) for i in range(0, R, step)] or [(0, 0)]


def smem_budget_bytes(budget_bytes: int | None = None) -> int:
    """The shared-memory budget the table-layout policy weighs against:
    ``budget_bytes``, else ``SMEM_BUDGET_BYTES``.  Under the ``vmem_starve``
    fault it is clamped to ``min(b, 1024)`` and
    ``fault.vmem_starve.budget_clamped`` is bumped — the JAX package's rule
    for its VMEM budget, applied to the card's.

    The clamp does not land where the TPU's starved regime did: ``auto``
    streams a bucket only when its windows fit half the budget
    (``local_move.ops._resolve_mode``), which no window does under 1 KB, so
    every bucket stays RESIDENT.  What the fault holds is the JAX
    package's contract: labels and Q equal to the clean run's, and the
    counter moved."""
    b = SMEM_BUDGET_BYTES if budget_bytes is None else int(budget_bytes)
    if faultinject.is_active("vmem_starve"):
        telemetry.bump("fault.vmem_starve.budget_clamped")
        b = min(b, 1024)
    return b


def resolve_table_mode(mode: str, table_bytes: int,
                       budget_bytes: int | None = None) -> str:
    """Resident-vs-streamed policy for the local_move per-vertex tables:
    ``auto`` keeps them resident while they fit half the shared-memory
    budget (``smem_budget_bytes``), the JAX package's rule with the card's
    budget, and streams per-block windows beyond that."""
    if mode not in TABLE_MODES:
        raise ValueError(
            f"unknown table_mode {mode!r}, want one of {TABLE_MODES}")
    if mode != "auto":
        return mode
    budget = smem_budget_bytes(budget_bytes)
    return "resident" if table_bytes <= budget // 2 else "streamed"


def pick_ell_width(max_deg: int | None, n_cap: int, m_cap: int) -> int:
    """Smallest menu width covering ``max_deg`` (4×-average-degree
    heuristic over the capacities when ``max_deg`` is None)."""
    if max_deg is None:
        max_deg = max(STAGE_WIDTH_MENU[0], (4 * m_cap) // max(1, n_cap))
    for width in STAGE_WIDTH_MENU:
        if max_deg <= width:
            return width
    return STAGE_WIDTH_MENU[-1]


def pick_bin_width(n_cap: int, m_cap: int) -> int:
    """Static per-src-community bin-row width for the sort-free
    aggregation: the same 4×-average-degree menu pick as the JAX package.
    Rows that exceed it at run time take the one-sort fallback, so the
    width changes speed, never results."""
    return pick_ell_width(None, n_cap, m_cap)


# ------------------------------------------------------------ capacity buckets

# Static capacity menu of the batched many-graph engine (``core.batch``), the
# JAX package's: doubling steps up from ego-net-scale floors.  A graph is
# padded to the smallest menu capacity that holds it, so the set of distinct
# padded shapes — and of cached bucket runners — grows logarithmically in
# the largest graph served, not with the number of distinct sizes.  The
# step is 2 (not the cascade's 4) to bound the padding every lane pays for
# at < 2x.
BUCKET_N_FLOOR = 64
BUCKET_M_FLOOR = 256
BUCKET_STEP = 2


def bucket_capacity(x: int, floor: int, step: int = BUCKET_STEP) -> int:
    """Smallest menu capacity >= x, menu = floor · step^k (k >= 0)."""
    if x < 0:
        raise ValueError(f"capacity must be >= 0, got {x}")
    cap = int(floor)
    while cap < x:
        cap *= step
    return cap


class CapacitySignature(NamedTuple):
    """Hashable identity of one batch bucket: the padded capacities
    (``n_cap``, ``m_cap``), the traced-tile width they pick
    (``ell_width``) and the capacity schedule the padded graph would
    cascade through.  Graphs with equal signatures pack into one bucket
    and share one cached bucket runner."""

    n_cap: int
    m_cap: int
    ell_width: int
    schedule: tuple


def capacity_signature(n_cap: int, m_cap: int,
                       ell_width: int | None = None,
                       schedule: tuple | None = None) -> CapacitySignature:
    """Bucket a graph's ``(n_max, m_max)`` onto the capacity menu above;
    ``ell_width`` defaults to ``pick_ell_width``'s pick at the bucket
    capacities (``pick_bin_width`` resolves the same) and ``schedule`` to
    ``auto_capacity_schedule`` at them."""
    nb = bucket_capacity(int(n_cap), BUCKET_N_FLOOR)
    mb = bucket_capacity(int(m_cap), BUCKET_M_FLOOR)
    if ell_width is None:
        ell_width = pick_ell_width(None, nb, mb)
    if schedule is None:
        # late import: core.louvain imports this module at load time
        from repro_torch.core.louvain import auto_capacity_schedule

        schedule = auto_capacity_schedule(nb, mb)
    return CapacitySignature(nb, mb, int(ell_width), tuple(schedule))


def bin_table_bytes(n_cap: int, width: int) -> int:
    """Footprint of the (n_cap+1, width) int32 bin-key table (the +1 row is
    the sink for masked edges)."""
    return 4 * (n_cap + 1) * width


def accum_needs_promotion(m_cap: int, w_max: float = 1.0) -> bool:
    """True when ``m_cap`` edge weights of magnitude ``w_max`` could sum
    past float32's exact-integer range."""
    return float(m_cap) * max(float(w_max), 1.0) >= float(F32_ACCUM_SAFE)


def accum_dtype(promote: bool) -> torch.dtype:
    """Accumulator dtype for volume/modularity sums: float32 always, as the
    JAX package runs with x64 off; a requested promotion is recorded as the
    ``numeric.f32_accum_risk`` counter instead."""
    if promote:
        telemetry.bump("numeric.f32_accum_risk")
    return torch.float32

"""Shared kernel utilities (port of ``repro.kernels.common``).

The uint32 hashes of the JAX package wrap modulo 2^32.  PyTorch has few
uint32 kernels, so the plain versions here emulate them in int64 with an
explicit ``& 0xFFFFFFFF`` after every step; each 32-bit product is split
into 16-bit halves so no int64 product can overflow.  The CUDA kernels
compute the same hashes in native ``uint32_t``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import telemetry

# Largest integer float32 accumulates exactly (24-bit mantissa).
F32_ACCUM_SAFE = 1 << 24

TABLE_MODES = ("auto", "resident", "streamed")
BIN_IMPLS = ("kernel", "ref")

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

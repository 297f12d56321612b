"""Wrappers of the CUDA local-move kernels (``csrc/local_move_plp.cu``,
``csrc/local_move_louvain.cu``).

Each wrapper takes the plain version (``ref.py``) for tensors on the CPU
and launches its kernel for tensors on the card; there is no fallback from
one to the other.  For a launch it checks device, dtype, shape and
contiguity, allocates the outputs, launches on PyTorch's current stream
and raises ``KernelError`` if the launch returned an error.  ``launches``
on each wrapper counts its kernel launches, and nothing else.

Callers guarantee the ids: row and neighbor ids lie in [0, sentinel], and
the tables have sentinel + 1 entries.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import noise_scale
from repro_torch.kernels.local_move.ref import (local_move_louvain_tables_ref,
                                                local_move_plp_ref)

WIDTHS = (16, 64, 256, 1024)

_P = ctypes.c_void_p


def _lib(name: str, argtypes) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def _check_tiles(rows, nbr, w, n_tab: int, sentinel: int):
    R, W = nbr.shape
    if W not in WIDTHS:
        raise ValueError(f"ELL width {W} is not one of {WIDTHS}")
    if n_tab != sentinel + 1:
        raise ValueError(f"tables need sentinel + 1 = {sentinel + 1} entries, "
                         f"got {n_tab}")
    dev = rows.device
    _check(rows, "rows", torch.int32, (R,), dev)
    _check(nbr, "nbr", torch.int32, (R, W), dev)
    _check(w, "w", torch.float32, (R, W), dev)
    return R, W, dev


def local_move_plp_kernel(
    rows: torch.Tensor,        # (R,) int32
    nbr: torch.Tensor,         # (R, W) int32
    w: torch.Tensor,           # (R, W) float32
    labels_ext: torch.Tensor,  # (n+1,) int32
    seed: int,                 # uint32 tie-noise seed
    *,
    tie_eps: float,
    sentinel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_label[R] int32, propose[R] bool) of the PLP move."""
    if rows.device.type == "cpu":
        return local_move_plp_ref(rows, nbr, w, labels_ext, seed,
                                  tie_eps=tie_eps, sentinel=sentinel)
    R, W, dev = _check_tiles(rows, nbr, w, labels_ext.shape[0], sentinel)
    _check(labels_ext, "labels_ext", torch.int32, (sentinel + 1,), dev)
    fn = _lib("local_move_plp", [_P, _P, _P, _P, ctypes.c_uint32,
                                 ctypes.c_float, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int, _P, _P, _P])
    best = torch.empty(R, dtype=torch.int32, device=dev)
    prop = torch.empty(R, dtype=torch.bool, device=dev)
    err = fn(rows.data_ptr(), nbr.data_ptr(), w.data_ptr(),
             labels_ext.data_ptr(), int(seed) & 0xFFFFFFFF,
             float(noise_scale(tie_eps)), sentinel, R, W, best.data_ptr(),
             prop.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("local_move_plp", err)
    local_move_plp_kernel.launches += 1
    return best, prop


local_move_plp_kernel.launches = 0


def local_move_louvain_kernel(
    rows: torch.Tensor,       # (R,) int32
    nbr: torch.Tensor,        # (R, W) int32
    w: torch.Tensor,          # (R, W) float32
    com_v: torch.Tensor,      # (n+1,) int32   composed per-vertex tables
    volcom_v: torch.Tensor,   # (n+1,) float32 (ref.compose_louvain_tables)
    sizecom_v: torch.Tensor,  # (n+1,) int32
    deg_v: torch.Tensor,      # (n+1,) float32
    inv_vol: torch.Tensor,    # float32 0-dim tensor 1 / vol(V), same device
    *,
    sentinel: int,
    singleton_rule: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community[R] int32, propose[R] bool) of the Louvain move."""
    if rows.device.type == "cpu":
        return local_move_louvain_tables_ref(
            rows, nbr, w, com_v, volcom_v, sizecom_v, deg_v, inv_vol,
            sentinel=sentinel, singleton_rule=singleton_rule)
    R, W, dev = _check_tiles(rows, nbr, w, com_v.shape[0], sentinel)
    n1 = (sentinel + 1,)
    _check(com_v, "com_v", torch.int32, n1, dev)
    _check(volcom_v, "volcom_v", torch.float32, n1, dev)
    _check(sizecom_v, "sizecom_v", torch.int32, n1, dev)
    _check(deg_v, "deg_v", torch.float32, n1, dev)
    _check(inv_vol, "inv_vol", torch.float32, (), dev)
    fn = _lib("local_move_louvain",
              [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_int, _P, _P, _P])
    best = torch.empty(R, dtype=torch.int32, device=dev)
    prop = torch.empty(R, dtype=torch.bool, device=dev)
    err = fn(rows.data_ptr(), nbr.data_ptr(), w.data_ptr(), com_v.data_ptr(),
             volcom_v.data_ptr(), sizecom_v.data_ptr(), deg_v.data_ptr(),
             inv_vol.data_ptr(), int(bool(singleton_rule)), sentinel, R, W,
             best.data_ptr(),
             prop.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("local_move_louvain", err)
    local_move_louvain_kernel.launches += 1
    return best, prop


local_move_louvain_kernel.launches = 0

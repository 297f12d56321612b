"""Wrappers of the CUDA local-move kernels: the resident layout
(``csrc/local_move_plp.cu``, ``csrc/local_move_louvain.cu``) and the
streamed layout (``csrc/local_move_plp_streamed.cu``,
``csrc/local_move_louvain_streamed.cu``).

Each wrapper takes the plain version (``ref.py``) for tensors on the CPU
and launches its kernel for tensors on the card; there is no fallback from
one to the other.  For a launch it checks device, dtype, shape and
contiguity, allocates the outputs, launches on PyTorch's current stream
and raises ``KernelError`` if the launch returned an error.  A streamed
wrapper also raises ``KernelError``, naming the bytes, when the block's
windows do not fit the shared memory a block can use on the device.
``launches`` on each wrapper counts its kernel launches, and nothing else:
an empty tile (R = 0) returns empty outputs without a launch.

Callers guarantee the ids: row and neighbor ids lie in [0, sentinel], and
the tables have sentinel + 1 entries.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor, noise_scale
from repro_torch.kernels.local_move.ref import (
    check_windows, local_move_louvain_tables_ref,
    local_move_louvain_windowed_ref, local_move_plp_ref,
    local_move_plp_windowed_ref)
from repro_torch.utils.errors import KernelError

WIDTHS = (16, 64, 256, 1024)

_P = ctypes.c_void_p

# (kernel, width) -> bytes of windows one block can stage, per process
_SMEM_LIMITS: Dict[Tuple[str, int], int] = {}


def _check_window_fits(name: str, windows, n_tables: int, width: int) -> None:
    """Raise ``KernelError`` when a block's windows exceed the shared memory
    a block of kernel ``name`` can take on this device — the counterpart of
    the TPU kernel's compile failure; nothing runs in its place."""
    key = (name, width)
    if key not in _SMEM_LIMITS:
        fn = build.entry(name, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                         "smem_limit")
        out = ctypes.c_int(0)
        build.check_launch(name, fn(width, ctypes.byref(out)))
        _SMEM_LIMITS[key] = out.value
    need = 4 * n_tables * 2 * windows.slot
    if need > _SMEM_LIMITS[key]:
        raise KernelError(
            f"{name}: the windows of a block ({n_tables} table(s) of "
            f"2·{windows.slot} entries) take {need} bytes of shared memory; "
            f"a block of the W={width} kernel can take {_SMEM_LIMITS[key]} "
            f"on this device.  Use the resident layout or smaller blocks.")


def _check_win_blk(windows, R: int, dev) -> None:
    check_tensor(windows.win_blk, "win_blk", torch.int32,
                 (check_windows(windows, R),), dev)


def _check_tiles(rows, nbr, w, n_tab: int, sentinel: int):
    R, W = nbr.shape
    if W not in WIDTHS:
        raise ValueError(f"ELL width {W} is not one of {WIDTHS}")
    if n_tab != sentinel + 1:
        raise ValueError(f"tables need sentinel + 1 = {sentinel + 1} entries, "
                         f"got {n_tab}")
    dev = rows.device
    check_tensor(rows, "rows", torch.int32, (R,), dev)
    check_tensor(nbr, "nbr", torch.int32, (R, W), dev)
    check_tensor(w, "w", torch.float32, (R, W), dev)
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
    check_tensor(labels_ext, "labels_ext", torch.int32, (sentinel + 1,), dev)
    best = torch.empty(R, dtype=torch.int32, device=dev)
    prop = torch.empty(R, dtype=torch.bool, device=dev)
    if R == 0:
        return best, prop
    fn = build.entry("local_move_plp",
                     [_P, _P, _P, _P, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P,
                      _P])
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
    check_tensor(com_v, "com_v", torch.int32, n1, dev)
    check_tensor(volcom_v, "volcom_v", torch.float32, n1, dev)
    check_tensor(sizecom_v, "sizecom_v", torch.int32, n1, dev)
    check_tensor(deg_v, "deg_v", torch.float32, n1, dev)
    check_tensor(inv_vol, "inv_vol", torch.float32, (), dev)
    best = torch.empty(R, dtype=torch.int32, device=dev)
    prop = torch.empty(R, dtype=torch.bool, device=dev)
    if R == 0:
        return best, prop
    fn = build.entry("local_move_louvain",
                     [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P,
                      _P])
    err = fn(rows.data_ptr(), nbr.data_ptr(), w.data_ptr(), com_v.data_ptr(),
             volcom_v.data_ptr(), sizecom_v.data_ptr(), deg_v.data_ptr(),
             inv_vol.data_ptr(), int(bool(singleton_rule)), sentinel, R, W,
             best.data_ptr(),
             prop.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("local_move_louvain", err)
    local_move_louvain_kernel.launches += 1
    return best, prop


local_move_louvain_kernel.launches = 0


def local_move_plp_streamed_kernel(
    rows: torch.Tensor,        # (R,) int32
    nbr: torch.Tensor,         # (R, W) int32
    w: torch.Tensor,           # (R, W) float32
    labels_ext: torch.Tensor,  # (n+1,) int32
    seed: int,                 # uint32 tie-noise seed
    *,
    tie_eps: float,
    sentinel: int,
    windows,                   # graph.ell.TableWindows of these tiles
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_label[R] int32, propose[R] bool) of the PLP move, each block
    reading the label table only inside its window."""
    if rows.device.type == "cpu":
        return local_move_plp_windowed_ref(
            rows, nbr, w, labels_ext, seed, tie_eps=tie_eps,
            sentinel=sentinel, windows=windows)
    R, W, dev = _check_tiles(rows, nbr, w, labels_ext.shape[0], sentinel)
    check_tensor(labels_ext, "labels_ext", torch.int32, (sentinel + 1,), dev)
    _check_win_blk(windows, R, dev)
    name = "local_move_plp_streamed"
    _check_window_fits(name, windows, 1, W)
    best = torch.empty(R, dtype=torch.int32, device=dev)
    prop = torch.empty(R, dtype=torch.bool, device=dev)
    if R == 0:
        return best, prop
    fn = build.entry(name, [_P, _P, _P, _P, _P, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float,
                            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P,
                            _P, _P])
    err = fn(rows.data_ptr(), nbr.data_ptr(), w.data_ptr(),
             labels_ext.data_ptr(), windows.win_blk.data_ptr(), windows.slot,
             windows.block_rows, int(seed) & 0xFFFFFFFF,
             float(noise_scale(tie_eps)), sentinel, R, W, best.data_ptr(),
             prop.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(name, err)
    local_move_plp_streamed_kernel.launches += 1
    return best, prop


local_move_plp_streamed_kernel.launches = 0


def local_move_louvain_streamed_kernel(
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
    windows,                  # graph.ell.TableWindows of these tiles
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_community[R] int32, propose[R] bool) of the Louvain move, each
    block reading the four tables only inside its window."""
    if rows.device.type == "cpu":
        return local_move_louvain_windowed_ref(
            rows, nbr, w, com_v, volcom_v, sizecom_v, deg_v, inv_vol,
            sentinel=sentinel, singleton_rule=singleton_rule,
            windows=windows)
    R, W, dev = _check_tiles(rows, nbr, w, com_v.shape[0], sentinel)
    n1 = (sentinel + 1,)
    check_tensor(com_v, "com_v", torch.int32, n1, dev)
    check_tensor(volcom_v, "volcom_v", torch.float32, n1, dev)
    check_tensor(sizecom_v, "sizecom_v", torch.int32, n1, dev)
    check_tensor(deg_v, "deg_v", torch.float32, n1, dev)
    check_tensor(inv_vol, "inv_vol", torch.float32, (), dev)
    _check_win_blk(windows, R, dev)
    name = "local_move_louvain_streamed"
    _check_window_fits(name, windows, 4, W)
    best = torch.empty(R, dtype=torch.int32, device=dev)
    prop = torch.empty(R, dtype=torch.bool, device=dev)
    if R == 0:
        return best, prop
    fn = build.entry(name, [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_int, _P, _P, _P])
    err = fn(rows.data_ptr(), nbr.data_ptr(), w.data_ptr(), com_v.data_ptr(),
             volcom_v.data_ptr(), sizecom_v.data_ptr(), deg_v.data_ptr(),
             inv_vol.data_ptr(), windows.win_blk.data_ptr(), windows.slot,
             windows.block_rows, int(bool(singleton_rule)), sentinel, R, W,
             best.data_ptr(), prop.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(name, err)
    local_move_louvain_streamed_kernel.launches += 1
    return best, prop


local_move_louvain_streamed_kernel.launches = 0

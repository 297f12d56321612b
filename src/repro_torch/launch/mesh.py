"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

A ``Mesh`` names its axes, their sizes, this rank's coordinate on each and,
for each axis, the process group of the ranks on this rank's line along it
(every other coordinate equal).  Ranks lie row-major over the axes, as
JAX's ``np.array(devices).reshape(shape)`` lays out devices: on a
``('data', 'model')`` mesh, ``rank = d * model + m``.

Every cross-rank sum adds the ranks' values in coordinate order from the
first (a list ``all_gather``, then a fold on this rank): the same bits on
every rank of the line, the same bits run after run, and no collective
beyond the two gloo takes for CUDA tensors (``all_reduce`` is not used:
its order is the backend's).  An axis of size 1 needs no group and no
collective.

``make_production_mesh`` returns a mesh of shape only (no groups, no
coordinates): it serves the spec accounting (``launch.sharding``) and its
collectives raise.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """Axis names and sizes (``shape``, a dict in axis order, as JAX's
    ``Mesh.shape``), this rank's ``coords`` and one group per axis; built
    by ``make_host_mesh`` or, shape only, by ``Mesh(shape, axis_names)``
    and ``make_production_mesh``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 coords: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, object]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.coords = dict(coords) if coords is not None else None
        self._groups = dict(groups or {})
        # bytes this rank received in gathers and in sums (the train step's
        # traffic accounting)
        self.bytes_gathered = 0
        self.bytes_summed = 0

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def origin(self) -> bool:
        """Whether this rank sits at coordinate 0 of every axis (the rank
        that writes and prints)."""
        return all(self.coord(a) == 0 for a in self.shape)

    def coord(self, axis: str) -> int:
        if self.shape.get(axis, 1) == 1:
            return 0
        if self.coords is None:
            raise RuntimeError("a mesh of shape only has no coordinates")
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"

    # ---------------------------------------------------------- collectives

    def _group(self, axis: str):
        if self.coords is None:
            raise RuntimeError(
                f"a mesh of shape only ({self.shape}) runs no collective")
        return self._groups[axis]

    def all_gather(self, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """``x`` of every rank on this rank's line along ``axis``, in
        coordinate order."""
        parts = self._all_gather(x, axis)
        self.bytes_gathered += self._received(x, axis)
        return parts

    def _all_gather(self, x: torch.Tensor, axis: str) -> List[torch.Tensor]:
        n = self.axis_size(axis)
        if n == 1:
            return [x]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self._group(axis))
        return parts

    def _received(self, x: torch.Tensor, axis: str) -> int:
        return (self.axis_size(axis) - 1) * x.numel() * x.element_size()

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over ``axis`` in coordinate order from the first, the
        same bits on every rank; bf16 and f16 add in float32 and round
        once."""
        if self.axis_size(axis) == 1:
            return x
        low = x.dtype in (torch.bfloat16, torch.float16)
        xs = x.float() if low else x
        parts = self._all_gather(xs, axis)
        self.bytes_summed += self._received(xs, axis)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc.to(x.dtype) if low else acc

    def max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return x
        parts = self._all_gather(x, axis)
        self.bytes_summed += self._received(x, axis)
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p)
        return acc

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def _line_groups(shape: Sequence[int], names: Sequence[str], rank: int
                 ) -> Dict[str, object]:
    """Every line's group along every axis, created in the same order on
    every rank (``new_group`` is collective over the world); the groups of
    this rank's lines."""
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    mine = {}
    for a, name in enumerate(names):
        if shape[a] == 1:
            continue
        others = [range(s) if i != a else range(1)
                  for i, s in enumerate(shape)]
        for base in itertools.product(*others):
            start = sum(c * st for c, st in zip(base, strides))
            ranks = [start + j * strides[a] for j in range(shape[a])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[name] = group
    return mine


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``('data', 'model')`` mesh over the ranks of the initialized
    world, which must hold ``data * model`` of them; rank ``d * model +
    m`` sits at ``(d, m)``.  A ``(1, 1)`` mesh needs no world."""
    shape, names = (data, model), ("data", "model")
    if data * model == 1:
        return Mesh(shape, names, coords={"data": 0, "model": 0})
    if not dist.is_initialized():
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs an initialized process group "
            f"of {data * model} ranks (launch.ranks.init_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the world has {world}")
    coords = {"data": rank // model, "model": rank % model}
    return Mesh(shape, names, coords=coords,
                groups=_line_groups(shape, names, rank))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layout, shape only: (16, 16) over ('data', 'model'),
    or (2, 16, 16) over ('pod', 'data', 'model')."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(mesh.shape)


# Hardware constants for the roofline model, one NVIDIA H100 80GB HBM3 at
# 700 W (NVIDIA's data sheet, SXM part, dense rates).
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # bytes/s
# NVLink 4: 900 GB/s per card over its 18 links, 50 GB/s a link each way
# (NVIDIA's data sheet); not measured: the port has run on one card only.
NVLINK_BW_PER_LINK = 50e9     # bytes/s per link
HBM_BYTES = 80 * 1024**3      # 80 GiB

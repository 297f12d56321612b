"""Logical-axis sharding: named dims -> mesh axes (port of
``repro.launch.sharding``).

Model code tags tensors and parameters with *logical* names ('embed',
'heads', 'mlp', 'vocab', 'batch', ...); a rule table maps them to mesh
axes.  Resolution is divisibility-aware: a rule is dropped (the dim
replicated) when the dim does not divide by the axis size, and an axis
serves at most one dim of a spec.  The rule table is the JAX package's:

  'embed'   -> ('pod', 'data')          weight rows, ZeRO-3 style
  'vocab', 'heads', 'mlp', 'experts' -> 'model'   tensor/expert parallel
  'batch'   -> ('pod', 'data')          data-parallel activations
  'heads_act', 'vocab_act' -> 'model'   activation TP dims
  'embed_act' -> 'model' iff cfg.shard_residual_embed

A ``PartitionSpec`` is a tuple with one entry a dim (None, an axis name or
a tuple of several) and no trailing Nones.  The port has no partitioner: a
spec says where a tensor's shards are stored (``param_specs``) and, at an
activation, whether the compute splits that dim (``models/transformer.py``
reads ``resolve_spec`` there).  The collectives that GSPMD would insert
are explicit (``launch/collectives.py``), so ``constrain`` changes
nothing.

``split_rows`` marks the rows of the batch being run as split over mesh
axes (the train step's microbatch slices): the losses then reduce their
means over those axes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.utils.tree import tree_leaves, tree_map

_state = threading.local()


DEFAULT_RULES: dict = {
    "embed": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "mlp": "model",
    "experts": "model",
    "layers": None,
    "batch": ("pod", "data"),
    "heads_act": "model",
    "vocab_act": "model",
    "experts_act": "model",
    "embed_act": None,          # flipped to 'model' by shard_residual_embed
    "kv": None,
    "seq": None,
}


class PartitionSpec(tuple):
    """A dim-by-dim placement: None (replicated), an axis name, or a
    tuple of axis names (major to minor); a tuple of one axis is that
    axis (as JAX's), and trailing Nones are dropped."""

    def __new__(cls, *parts):
        parts = [p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts]
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"

    def padded(self, ndim: int) -> Tuple:
        return tuple(self) + (None,) * (ndim - len(self))


PS = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


def _get() -> Tuple[Optional[Mesh], dict]:
    return getattr(_state, "mesh", None), getattr(_state, "rules",
                                                  DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Activate a mesh and rule table for this thread."""
    prev = _get()
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _get()[0]


@contextlib.contextmanager
def split_rows(axes: Tuple[str, ...]):
    """Mark the batch rows being run as split over ``axes`` of the active
    mesh (each rank holds its share); ``()`` for rows every rank holds
    whole."""
    prev = getattr(_state, "row_axes", ())
    _state.row_axes = tuple(axes)
    try:
        yield
    finally:
        _state.row_axes = prev


def row_axes() -> Tuple[str, ...]:
    """The mesh axes of more than one rank the current rows are split
    over (see ``split_rows``)."""
    mesh = active_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in getattr(_state, "row_axes", ())
                 if mesh.axis_size(a) > 1)


def snapshot() -> tuple:
    """This thread's mesh, rules and row axes, for ``restored``."""
    return (*_get(), getattr(_state, "row_axes", ()))


@contextlib.contextmanager
def restored(state: tuple):
    """Run with a ``snapshot``'s mesh, rules and row axes: a remat
    recompute runs in autograd's thread (a CUDA backward has its own), and
    the state is this module's per thread."""
    prev = snapshot()
    _state.mesh, _state.rules, _state.row_axes = state
    try:
        yield
    finally:
        _state.mesh, _state.rules, _state.row_axes = prev


def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(axis, 1)


def _filter_axes(mesh: Mesh, axis):
    """Drop axes not present in the mesh (e.g. 'pod' on a single-pod
    mesh)."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in mesh.shape)
        return kept if kept else None
    return axis if axis in mesh.shape else None


def resolve_spec(names: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Logical names -> PartitionSpec under the active mesh and rules.
    With ``shape``, a rule whose axis size does not divide the dim is
    dropped (the dim replicated)."""
    mesh, rules = _get()
    if mesh is None:
        return PS()
    parts = []
    used: set = set()
    for i, nm in enumerate(names):
        axis = _filter_axes(mesh, rules.get(nm)) if nm else None
        if axis is not None:
            flat = axis if isinstance(axis, tuple) else (axis,)
            if any(a in used for a in flat):
                axis = None  # an axis may appear once per spec
        if axis is not None and shape is not None:
            if shape[i] % _axis_size(mesh, axis) != 0:
                axis = None
        if axis is not None:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                used.add(a)
        parts.append(axis)
    return PS(*parts)


def sharding_for(names: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None
                 ) -> Optional[NamedSharding]:
    mesh, _ = _get()
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve_spec(names, shape))


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """``x`` unchanged.  In the JAX package a sharding constraint lets
    GSPMD reshard; in the port the model code's explicit collectives
    (``launch/collectives.py``) stand in for that resharding."""
    return x


# ------------------------------------------------------------ param trees


def param_specs(decls):
    """ParamDecl tree -> PartitionSpec tree (divisibility-aware)."""
    return tree_map(lambda d: resolve_spec(d.names, d.shape), decls)


def param_shardings(decls):
    mesh, _ = _get()
    if mesh is None:
        raise RuntimeError("param_shardings requires an active mesh")
    return tree_map(lambda d: NamedSharding(
        mesh, resolve_spec(d.names, d.shape)), decls)


def spec_bytes_per_device(decls) -> int:
    """Static estimate: per-device parameter bytes under current rules."""
    mesh, _ = _get()
    total = 0
    for d in tree_leaves(decls):
        n = 1
        for s in d.shape:
            n *= s
        shard = 1
        for ax in resolve_spec(d.names, d.shape):
            if ax is not None:
                shard *= _axis_size(mesh, ax)
        total += n // max(1, shard) * d.dtype.itemsize
    return total


# ------------------------------------------------------------ local shards


def dim_axes(spec: PartitionSpec, mesh: Mesh, ndim: int
             ) -> Tuple[Tuple[str, ...], ...]:
    """Per dim, the axes of more than one rank that split it (major to
    minor)."""
    out = []
    for part in spec.padded(ndim):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        out.append(tuple(a for a in axes if mesh.axis_size(a) > 1))
    return tuple(out)


def split_axes(spec: PartitionSpec, mesh: Mesh, ndim: int
               ) -> Tuple[str, ...]:
    """Every axis of more than one rank that splits some dim."""
    return tuple(a for axes in dim_axes(spec, mesh, ndim) for a in axes)


def _block(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this rank's block index, block count) over ``axes``, major to
    minor."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.coord(a)
        n *= mesh.axis_size(a)
    return idx, n


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of this rank's block of a ``shape`` tensor."""
    out = []
    for size, axes in zip(shape, dim_axes(spec, mesh, len(shape))):
        for a in axes:
            size //= mesh.axis_size(a)
        out.append(size)
    return tuple(out)


def local_shard(full, spec: PartitionSpec, mesh: Mesh, *,
                skip: Tuple[str, ...] = ()):
    """This rank's block of ``full`` (a tensor or numpy array) under
    ``spec``; axes in ``skip`` are left whole."""
    out = full
    for dim, axes in enumerate(dim_axes(spec, mesh, full.ndim)):
        axes = tuple(a for a in axes if a not in skip)
        if not axes:
            continue
        idx, n = _block(mesh, axes)
        size = full.shape[dim] // n
        index = [slice(None)] * full.ndim
        index[dim] = slice(idx * size, (idx + 1) * size)
        out = out[tuple(index)]
    return out


def gather_shard(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh,
                 axes: Tuple[str, ...]) -> torch.Tensor:
    """``x``'s block gathered over ``axes`` (the others stay split):
    minor axes first, so the blocks concatenate in major-to-minor
    order."""
    for dim, dax in enumerate(dim_axes(spec, mesh, x.dim())):
        for a in reversed(dax):
            if a in axes:
                x = torch.cat(mesh.all_gather(x, a), dim=dim)
    return x


def full_leaf(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh
              ) -> torch.Tensor:
    """The whole tensor from every rank's block (collective)."""
    return gather_shard(x, spec, mesh, tuple(mesh.axis_names))

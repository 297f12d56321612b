"""The port's tensor-parallel collectives as autograd functions, the ones
GSPMD inserts for the JAX package's sharding constraints.

Every rank runs the same program on its own shards and backpropagates its
own copy of the (replicated) loss.  The convention that keeps the
gradient the JAX function's: a value replicated over an axis carries the
same, whole cotangent on every rank of it; a value split over the axis,
or a rank's partial term of a sum, carries its own.  Hence three
operations, each a pair of a forward and its dual:

* ``copy_to(x, axis)``: the identity; backward, the sum over ``axis``.  A
  replicated value entering compute that each rank does for its own
  share (its heads, its columns) gets a partial cotangent from each rank.
* ``reduce_from(x, axis)``: the sum over ``axis``; backward, the
  identity.  Each rank's partial term of a sum receives the sum's
  cotangent.
* ``gather_from(x, axis, dim)``: the blocks of every rank along ``axis``
  concatenated on ``dim``; backward, this rank's block of the cotangent.
  The gathered value feeds replicated compute, whose cotangent is already
  whole on every rank, so the dual reduce has nothing left to add: the
  sums happened at the ``copy_to`` where that replicated compute began.

Sums add in coordinate order from the first (``Mesh.sum``), so every rank
gets the same bits and a recompute (remat) gets the bits of the first
pass.  On an axis of one rank each is the identity.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum(g, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return torch.cat(mesh.all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coord(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    return _Copy.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    return _Reduce.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
                ) -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim())

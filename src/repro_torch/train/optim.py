"""Optimizers on trees of tensors (port of ``repro.train.optim``): AdamW and
Adafactor.

Everything is float32 tensor arithmetic in the JAX package's association,
so the two packages round alike: JAX runs with x64 off, so its schedule is
float32 arithmetic on an int32 step, and so is this one (a Python-float
schedule would differ in the last bits, and so would every parameter
after it).  A Python scalar meets a tensor as a float32 value, as a weak-
typed scalar does in JAX; a scalar divided by a tensor is a division of
two tensors (``fdiv``).

The updates write the parameters and the optimizer state IN PLACE (the
JAX package donates their buffers): a functional update of qwen3-1.7b
would hold two copies of its 8 GB of master weights and 16 GB of AdamW
moments at once.  Each in-place product or sum is the one the JAX package
computes, so the values are the same.  They return the updated trees.

Adafactor is the memory policy of the largest architectures: a factored
second moment (row and column statistics instead of a full float32
tensor) for every leaf whose last two dims are at least
``factored_min_dim``.

Sharded trees: given ``specs`` (the leaves' ``PartitionSpec``s under the
active mesh, ``launch.sharding``), each leaf is this rank's block and the
quantities over a whole leaf or tree are taken across the ranks that
split it, each replicated block counted once: the global norm, Adafactor's
row and column means and its update RMS.  A leaf no axis splits takes the
unsharded code path, so a mesh of one rank computes the same bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.config import ConfigBase
from repro_torch.launch import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimConfig(ConfigBase):
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32, 0-dim
    m: Any
    v: Any


class AdafactorState(NamedTuple):
    step: torch.Tensor              # int32, 0-dim
    # per leaf: {'v': full} or {'vr': row, 'vc': col}
    stats: Any


def fdiv(x, y) -> torch.Tensor:
    """``x / y`` in float32, rounded once as JAX divides: an integer tensor
    is cast to float32 and a Python number becomes a tensor beside the
    other operand (``torch`` turns ``number / tensor`` into a reciprocal
    and a product, and so does CUDA for ``tensor / number``)."""
    t = x if isinstance(x, torch.Tensor) else y

    def f32(a):
        if isinstance(a, torch.Tensor):
            return a if a.is_floating_point() else a.float()
        return torch.full((), a, dtype=torch.float32, device=t.device)

    return f32(x) / f32(y)


def lr_schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay (standard LM schedule); ``step`` an
    int32 tensor, the result float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(fdiv(step + 1, max(1, cfg.warmup_steps)), max=1.0)
    prog = torch.clamp(fdiv(step - cfg.warmup_steps,
                            max(1, cfg.total_steps - cfg.warmup_steps)),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _split_dims(specs, leaves):
    """Per leaf, per dim, the mesh axes that split it (all empty without
    ``specs``)."""
    if specs is None:
        return [((),) * x.dim() for x in leaves]
    mesh = shd.active_mesh()
    return [shd.dim_axes(s, mesh, x.dim())
            for s, x in zip(tree_leaves(specs), leaves)]


def _sum_over(x: torch.Tensor, axes) -> torch.Tensor:
    mesh = shd.active_mesh()
    for a in axes:
        x = mesh.sum(x, a)
    return x


def _mean(x: torch.Tensor, dim: int, axes, keepdim: bool = False
          ) -> torch.Tensor:
    """``torch.mean`` over ``dim``, whose blocks are split over mesh
    ``axes``."""
    if not axes:
        return torch.mean(x, dim=dim, keepdim=keepdim)
    return _sum_over(torch.sum(x, dim=dim, keepdim=keepdim), axes) / (
        x.shape[dim] * _extent(axes))


def global_norm(tree, specs=None) -> torch.Tensor:
    leaves = tree_leaves(tree)
    sums = [_sum_over(torch.sum(torch.square(x.float())),
                      [a for axes in dims for a in axes])
            for x, dims in zip(leaves, _split_dims(specs, leaves))]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(fdiv(max_norm, torch.clamp(gn, min=1e-12)), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to a global norm of at most ``max_norm``, in
    float32; its global norm before)."""
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x.float() * scale, tree), gn


def _step_tensor(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    p.copy_(new.to(p.dtype))


# ----------------------------------------------------------------- AdamW


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(_step_tensor(params), tree_map(zeros, params),
                      tree_map(zeros, params))


@torch.no_grad()
def adamw_update(cfg: OptimConfig, grads, state: AdamWState, params,
                 specs=None):
    """One AdamW step on clipped gradients; writes ``params`` and the
    state's moments in place.  Returns (params, new state, {grad_norm,
    lr})."""
    gn = global_norm(grads, specs)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        _write(p, p.float() - lr * delta)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gn, "lr": lr}


# ----------------------------------------------------------------- Adafactor


def _factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(params, cfg: Optional[OptimConfig] = None
                   ) -> AdafactorState:
    min_dim = cfg.factored_min_dim if cfg else 128

    def init(p):
        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
        if _factored(p.shape, min_dim):
            return {"vr": zeros(p.shape[:-1]),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:])}
        return {"v": zeros(p.shape)}

    return AdafactorState(_step_tensor(params), tree_map(init, params))


@torch.no_grad()
def adafactor_update(cfg: OptimConfig, grads, state: AdafactorState, params,
                     specs=None):
    """One Adafactor step on clipped gradients; writes ``params`` and the
    state's statistics in place.  Returns (params, new state, {grad_norm,
    lr})."""
    gn = global_norm(grads, specs)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    beta2 = 1.0 - (step.float() + 1.0) ** (-cfg.decay_rate)
    # the stats tree's leaves are the per-parameter dicts
    stats = [st for _, st in _stat_leaves(state.stats)]
    leaves = tree_leaves(params)
    for p, g, st, dims in zip(leaves, tree_leaves(grads), stats,
                              _split_dims(specs, leaves)):
        g = g.float() * scale
        g2 = torch.square(g) + 1e-30
        if "vr" in st:
            vr, vc = st["vr"], st["vc"]
            vr.mul_(beta2).add_((1 - beta2) * _mean(g2, -1, dims[-1]))
            vc.mul_(beta2).add_((1 - beta2) * _mean(g2, -2, dims[-2]))
            denom = _mean(vr, -1, dims[-2], keepdim=True)
            pre = (vr[..., None] / torch.clamp(denom[..., None], min=1e-30)) \
                * vc[..., None, :]
            update = g * torch.rsqrt(torch.clamp(pre, min=1e-30))
        else:
            v = st["v"]
            v.mul_(beta2).add_((1 - beta2) * g2)
            update = g * torch.rsqrt(torch.clamp(v, min=1e-30))
        # update clipping (RMS <= 1): the Adafactor stabilizer
        axes = [a for d in dims for a in d]
        if axes:
            sq = _sum_over(torch.sum(torch.square(update)), axes)
            rms = torch.sqrt(sq / (update.numel() * _extent(axes)) + 1e-30)
        else:
            rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        pf = p.float()
        _write(p, pf - lr * update - lr * cfg.weight_decay * pf)
    return params, AdafactorState(step, state.stats), \
        {"grad_norm": gn, "lr": lr}


def _extent(axes) -> int:
    n = 1
    for a in axes:
        n *= shd.active_mesh().axis_size(a)
    return n


def _stat_leaves(tree, path=()):
    """The per-parameter stats dicts of a stats tree, in parameter
    order."""
    if isinstance(tree, dict) and ("v" in tree or "vr" in tree):
        return [(path, tree)]
    return [kv for k in sorted(tree) for kv in _stat_leaves(tree[k],
                                                            path + (k,))]


# ----------------------------------------------------------------- dispatch


def init_opt(name: str, params, cfg: Optional[OptimConfig] = None):
    if name == "adamw":
        return adamw_init(params)
    if name == "adafactor":
        return adafactor_init(params, cfg)
    raise ValueError(name)


def apply_opt(name: str, cfg: OptimConfig, grads, state, params,
              specs=None):
    """One step of optimizer ``name``; ``specs`` (the parameters'
    ``PartitionSpec`` tree under the active mesh) when the trees hold
    each rank's blocks."""
    if name == "adamw":
        return adamw_update(cfg, grads, state, params, specs)
    if name == "adafactor":
        return adafactor_update(cfg, grads, state, params, specs)
    raise ValueError(name)

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.config import ConfigBase
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


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


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
def adamw_update(cfg: OptimConfig, grads, state: AdamWState, params):
    """One AdamW step on clipped gradients; writes ``params`` and the
    state's moments in place.  Returns (params, new state, {grad_norm,
    lr})."""
    gn = global_norm(grads)
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
def adafactor_update(cfg: OptimConfig, grads, state: AdafactorState, params):
    """One Adafactor step on clipped gradients; writes ``params`` and the
    state's statistics in place.  Returns (params, new state, {grad_norm,
    lr})."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    beta2 = 1.0 - (step.float() + 1.0) ** (-cfg.decay_rate)
    # the stats tree's leaves are the per-parameter dicts
    stats = [st for _, st in _stat_leaves(state.stats)]
    for p, g, st in zip(tree_leaves(params), tree_leaves(grads), stats):
        g = g.float() * scale
        g2 = torch.square(g) + 1e-30
        if "vr" in st:
            vr, vc = st["vr"], st["vc"]
            vr.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
            vc.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
            denom = torch.mean(vr, dim=-1, keepdim=True)
            pre = (vr[..., None] / torch.clamp(denom[..., None], min=1e-30)) \
                * vc[..., None, :]
            update = g * torch.rsqrt(torch.clamp(pre, min=1e-30))
        else:
            v = st["v"]
            v.mul_(beta2).add_((1 - beta2) * g2)
            update = g * torch.rsqrt(torch.clamp(v, min=1e-30))
        # update clipping (RMS <= 1): the Adafactor stabilizer
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        pf = p.float()
        _write(p, pf - lr * update - lr * cfg.weight_decay * pf)
    return params, AdafactorState(step, state.stats), \
        {"grad_norm": gn, "lr": lr}


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


def apply_opt(name: str, cfg: OptimConfig, grads, state, params):
    if name == "adamw":
        return adamw_update(cfg, grads, state, params)
    if name == "adafactor":
        return adafactor_update(cfg, grads, state, params)
    raise ValueError(name)

"""Train and serve step construction (port of ``repro.launch.train_step``),
on one device.

``make_train_step`` returns (step_fn, None, None, None), the JAX package's
tuple without the shardings:
  * gradient accumulation over ``cfg.grad_accum`` microbatches (a loop
    where the JAX package scans), which bounds activation memory;
  * float32 gradients: each microbatch's from ``loss.backward()`` into the
    parameters' ``.grad`` (the parameters are leaf tensors that require
    grad), which sums them in microbatch order, then divided by the count;
  * optional int8 gradient compression (``quantize_grads_int8``);
  * the optimizer writes the parameters and its state in place
    (``train.optim``), as the JAX package donates their buffers.

A mesh (data- or model-parallel training) raises ``NotImplementedError``:
it is ROADMAP Queue 1 #8's first item.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.api import ModelAPI
from repro_torch.models.arch_config import ShapeCell
from repro_torch.train import optim
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

_NO_MESH = ("data/model-parallel {} (a mesh) is not ported yet "
            "(ROADMAP Queue 1 #8: launch/mesh.py, launch/sharding.py)")


def _refuse_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(_NO_MESH.format(what))


def quantize_grads_int8(grads):
    """Deterministic per-tensor int8 quantization (gradient compression)."""
    def q(g):
        scale = optim.fdiv(torch.max(torch.abs(g)), 127.0) + 1e-30
        qi = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return qi.float() * scale
    return tree_map(q, grads)


def _micro_grads(model: ModelAPI, params, leaves, batch: Dict, accum: int):
    """(float32 gradients summed over the microbatches, the summed loss,
    the last microbatch's metrics)."""
    mb = batch["tokens"].shape[0] // accum
    lsum, metrics = None, None
    for p in leaves:
        p.grad = None
    for i in range(accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        with torch.enable_grad():
            loss, metrics = model.loss_fn(params, micro)
            loss.backward()
        loss = loss.detach()
        lsum = loss if lsum is None else lsum + loss
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    for p in leaves:
        p.grad = None
    return grads, lsum, {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: ModelAPI, opt_cfg: optim.OptimConfig,
                    cell: ShapeCell, mesh=None, *,
                    compress_grads: bool = False):
    """Returns (train_step, None, None, None); ``train_step(params,
    opt_state, batch) -> (params, opt_state, metrics)`` with metrics
    {ce, aux, loss, grad_norm, lr}."""
    _refuse_mesh(mesh, "training")
    c = model.cfg
    accum = max(1, c.grad_accum)

    def train_step(params, opt_state, batch):
        b = batch["tokens"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum "
                             f"{accum}")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads, lsum, metrics = _micro_grads(model, params, leaves, batch,
                                            accum)
        loss = lsum
        if accum > 1:
            n = torch.full((), accum, dtype=torch.float32, device=lsum.device)
            for g in grads:
                g.div_(n)               # in place: one copy of the grads
            loss = lsum / n
        grads = tree_unflatten(params, grads)
        if compress_grads:
            grads = quantize_grads_int8(grads)
        new_params, new_opt, stats = optim.apply_opt(
            c.optimizer, opt_cfg, grads, opt_state, params)
        return new_params, new_opt, dict(metrics, loss=loss, **stats)

    return train_step, None, None, None


# -------------------------------------------------------------- serve steps


def make_prefill_step(model: ModelAPI, cell: ShapeCell, mesh=None):
    _refuse_mesh(mesh, "prefill")

    def prefill_step(params, batch):
        return model.prefill_fn(params, batch)

    return prefill_step, None, None


def make_decode_step(model: ModelAPI, cell: ShapeCell, mesh=None):
    _refuse_mesh(mesh, "decode")

    def decode_step(params, token, state):
        return model.decode_fn(params, token, state)

    return decode_step, None, None

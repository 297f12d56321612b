"""Train and serve step construction (port of ``repro.launch.train_step``).

``make_train_step`` returns (step_fn, in_specs, out_specs, batch_specs),
the JAX package's tuple with the port's ``PartitionSpec`` trees in place
of its ``NamedSharding``s (all None without a mesh):
  * gradient accumulation over ``cfg.grad_accum`` microbatches (a loop
    where the JAX package scans), which bounds activation memory;
  * float32 gradients: each microbatch's from ``loss.backward()`` into the
    ``.grad`` of leaf views of the parameters that require grad, which
    sums them in microbatch order, then divided by the count;
  * optional int8 gradient compression (``quantize_grads_int8``);
  * the optimizer writes the parameters and its state in place
    (``train.optim``), as the JAX package donates their buffers.

On a mesh (``launch/mesh.py``; every rank of it calls the step with the
same global batch):
  * storage follows ``param_specs``: each rank holds its block of every
    parameter and of the optimizer state (AdamW's moments as the
    parameters, Adafactor's factored statistics as ``_opt_specs`` drops
    the factored dim);
  * at step start each parameter is gathered over the data axes, keeping
    its split over ``model`` (the tensor-parallel compute of every
    family: ``models/transformer.py``, ``moe.py``, ``rwkv6.py`` and
    ``ssm.py``);
  * ``_batch_spec`` applies to each microbatch of the global batch: data
    rank r runs rows ``[i*mb + r*mb/n, i*mb + (r+1)*mb/n)`` of
    microbatch i, the losses' means taken over every rank's rows
    (``sharding.split_rows``); where ``mb % n != 0`` every data rank runs
    the whole microbatch;
  * the gradients are summed over the data axes in rank order (when the
    rows were split), each rank keeps its block, and they are divided by
    the microbatch count;
  * the global norm and clipping, Adafactor's means and update RMS and
    the int8 compression's per-tensor max are taken over the whole tree,
    each replicated block counted once.
Without a mesh the step runs on a ``(1, 1)`` one, which splits nothing
and runs no collective: the unsharded step.  The mesh paths of the serve
steps raise: only the JAX package's dry run used them (ROADMAP #6).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models.api import ModelAPI
from repro_torch.models.arch_config import ArchConfig, ShapeCell
from repro_torch.train import optim
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

PS = shd.PartitionSpec
_NO_MESH = ("the mesh path of the {} step is not ported: only the JAX "
            "package's dry run used it (ROADMAP Queue 1 #6, launch/dryrun.py)")


def _refuse_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(_NO_MESH.format(what))


def _data_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _batch_spec(mesh: Mesh, cell: ShapeCell, arr_ndim: int) -> PS:
    """Tokens/labels: batch over ('pod','data') when divisible."""
    axes = _data_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if axes and cell.global_batch % n == 0:
        return PS(axes, *([None] * (arr_ndim - 1)))
    return PS(*([None] * arr_ndim))


def _rules_for(c: ArchConfig) -> dict:
    rules = {}
    if c.shard_residual_embed:
        rules["embed_act"] = "model"
    return rules


def _opt_specs(c: ArchConfig, model: ModelAPI, pspecs,
               opt_cfg: optim.OptimConfig):
    """Optimizer state specs mirror the parameter specs; Adafactor's
    factored statistics drop the dim they average over.  (The JAX package
    decides which leaves factor at ``factored_min_dim`` 128 whatever the
    config; here the config's, which is the state's.)"""
    if c.optimizer == "adamw":
        return optim.AdamWState(PS(), pspecs, pspecs)

    def stat_spec(decl, spec):
        parts = list(spec.padded(len(decl.shape)))
        if optim._factored(decl.shape, opt_cfg.factored_min_dim):
            return {"vr": PS(*parts[:-1]), "vc": PS(*(parts[:-2]
                                                     + parts[-1:]))}
        return {"v": PS(*parts)}

    return optim.AdafactorState(PS(), tree_map(stat_spec, model.decls,
                                               pspecs))


def quantize_grads_int8(grads, specs=None):
    """Deterministic per-tensor int8 quantization (gradient compression);
    with ``specs`` (under the active mesh) each leaf is this rank's block
    and its max is the whole tensor's."""
    mesh = shd.active_mesh()
    spec_leaves = [None] * len(tree_leaves(grads)) if specs is None \
        else tree_leaves(specs)

    def q(g, spec):
        top = torch.max(torch.abs(g))
        if spec is not None:
            for a in shd.split_axes(spec, mesh, g.dim()):
                top = mesh.max(top, a)
        scale = optim.fdiv(top, 127.0) + 1e-30
        qi = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return qi.float() * scale
    return tree_unflatten(grads, [q(g, s) for g, s in
                                  zip(tree_leaves(grads), spec_leaves)])


def _micro_grads(model: ModelAPI, params, leaves, batch: Dict, accum: int,
                 rows=None, row_axes: tuple = ()):
    """(float32 gradients summed over the microbatches, the summed loss,
    the last microbatch's metrics).  ``rows(i, mb)``: the rows of
    microbatch i this rank runs (default all of them), split over
    ``row_axes``."""
    mb = batch["tokens"].shape[0] // accum
    lsum, metrics = None, None
    for p in leaves:
        p.grad = None
    for i in range(accum):
        sl = rows(i, mb) if rows else slice(i * mb, (i + 1) * mb)
        micro = {k: v[sl] for k, v in batch.items()}
        with torch.enable_grad(), shd.split_rows(row_axes):
            loss, metrics = model.loss_fn(params, micro)
            loss.backward()
        loss = loss.detach()
        lsum = loss if lsum is None else lsum + loss
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    for p in leaves:
        p.grad = None
    return grads, lsum, {k: v.detach() for k, v in metrics.items()}


def _average(grads, lsum, accum: int):
    """The gradients divided by the microbatch count in place (one copy
    of the grads) and the mean loss."""
    if accum == 1:
        return lsum
    n = torch.full((), accum, dtype=torch.float32, device=lsum.device)
    for g in grads:
        g.div_(n)
    return lsum / n


def make_train_step(model: ModelAPI, opt_cfg: optim.OptimConfig,
                    cell: ShapeCell, mesh: Optional[Mesh] = None, *,
                    compress_grads: bool = False):
    """Returns (train_step, in_specs, out_specs, batch_specs);
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics {ce, aux, loss, grad_norm, lr}.  On a mesh the
    trees hold this rank's blocks and ``batch`` is the global batch;
    without one the step runs on a (1, 1) mesh, which splits nothing, and
    the specs are None."""
    c = model.cfg
    accum = max(1, c.grad_accum)
    on = make_host_mesh(1, 1) if mesh is None else mesh
    rules = _rules_for(c)
    with shd.use_mesh(on, rules):
        pspecs = shd.param_specs(model.decls)
        ospecs = _opt_specs(c, model, pspecs, opt_cfg)
        batch_specs = {k: _batch_spec(on, cell, len(v.shape))
                       for k, v in model.input_specs(cell).items()}
    spec_leaves = tree_leaves(pspecs)
    data = tuple(a for a in _data_axes(on) if on.axis_size(a) > 1)
    n_data = 1
    for a in data:
        n_data *= on.axis_size(a)
    others = tuple(a for a in on.axis_names if a not in data)

    def train_step(params, opt_state, batch):
        b = batch["tokens"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum "
                             f"{accum}")
        mb = b // accum
        split = n_data > 1 and mb % n_data == 0
        r = 0
        for a in data:
            r = r * on.axis_size(a) + on.coord(a)
        share = mb // n_data

        def rows(i, mb):
            return slice(i * mb + r * share, i * mb + (r + 1) * share)

        with shd.use_mesh(on, rules):
            work = [shd.gather_shard(p.detach(), s, on, data)
                    .requires_grad_(True)
                    for p, s in zip(tree_leaves(params), spec_leaves)]
            grads, lsum, metrics = _micro_grads(
                model, tree_unflatten(params, work), work, batch, accum,
                rows if split else None, data if split else ())
            del work
            for i, s in enumerate(spec_leaves):
                g = grads[i]
                if split:
                    for a in data:
                        g = on.sum(g, a)
                mine = shd.local_shard(g, s, on, skip=others)
                # a block of the summed tensor: a copy frees the rest
                grads[i] = mine.clone() if mine.numel() < g.numel() else mine
            loss = _average(grads, lsum, accum)
            grads = tree_unflatten(params, grads)
            if compress_grads:
                grads = quantize_grads_int8(grads, pspecs)
            new_params, new_opt, stats = optim.apply_opt(
                c.optimizer, opt_cfg, grads, opt_state, params, pspecs)
        return new_params, new_opt, dict(metrics, loss=loss, **stats)

    if mesh is None:
        return train_step, None, None, None
    scalar = PS()
    out_specs = (pspecs, ospecs, {"ce": scalar, "aux": scalar,
                                  "loss": scalar, "grad_norm": scalar,
                                  "lr": scalar})
    return train_step, (pspecs, ospecs, batch_specs), out_specs, batch_specs


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

"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch qwen3-1.7b ... [--device cpu]``.

It trains on one device, the card unless ``--device`` names another
(without a card and without ``--device cpu`` it raises "no CUDA device"),
or with ``--data D --model M`` on a (D, M) mesh of ``D * M`` ranks that
it spawns (``launch/ranks.py``), joined by ``--backend`` (gloo, the
default, runs anywhere and lets ranks share one card; nccl needs a card a
rank).  Each rank trains on ``cuda:(rank mod the card count)``, or on the
CPU with ``--device cpu``; rank 0 alone prints.  ``--model`` above 1
splits every family's compute over the model axis (tensor and expert
parallelism, the vocabulary; ``models/transformer.py``).

Fault-tolerance contract (``tests/test_torch_train.py``):
  * checkpoint every ``--ckpt-every`` steps (atomic; ``train/checkpoint.py``);
  * on start, auto-resume from the newest committed checkpoint;
  * ``--simulate-failure-at N`` hard-exits (``os._exit(42)``) once step N
    is done, to prove that the next launch resumes losslessly: the data
    pipeline is counter-based, so batch N after a restart is bit-identical
    to batch N without the failure;
  * elastic restart: a checkpoint holds unsharded arrays (a mesh's save
    gathers them, and records the mesh's shape), and a run restores its
    own blocks of them, so it may resume on another mesh;
  * straggler watch: a step taking more than ``step_timeout_factor`` times
    the median of the last 20 logs a straggler warning.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import apply_overrides, parse_cli_overrides
from repro_torch.graph.structure import resolve_device
from repro_torch.launch import ranks
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train_step import make_train_step
from repro_torch.models import api as model_api
from repro_torch.models.arch_config import ShapeCell
from repro_torch.models.common import init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optim
from repro_torch.train.data import DataConfig, make_batch
from repro_torch.utils.tree import tree_map


def build_trainer(c, cell, mesh=None, opt_cfg=None, *, device=None):
    """(model, step_fn(params, opt, batch), init_fn(seed)) on ``device``
    (the card unless the caller names another); on a mesh the trees are
    this rank's blocks."""
    return _trainer(c, cell, mesh, opt_cfg, device)[:3]


def _trainer(c, cell, mesh, opt_cfg, device):
    """``build_trainer``'s three and the step's in-specs (None without a
    mesh)."""
    dev = resolve_device(device)
    model = model_api.build(c)
    opt_cfg = opt_cfg or optim.OptimConfig(name=c.optimizer)
    step, in_specs, _, _ = make_train_step(model, opt_cfg, cell, mesh)

    def init_fn(seed=0):
        if mesh is None:
            params = init_params(model.decls, seed=seed, device=dev)
            return params, optim.init_opt(c.optimizer, params, opt_cfg)
        # every rank draws the whole tree and keeps its blocks
        full = init_params(model.decls, seed=seed, device="cpu")
        params = tree_map(lambda t, s: shd.local_shard(t, s, mesh)
                          .contiguous().to(dev), full, in_specs[0])
        _, o0 = _shapes(c, model, opt_cfg)
        opt_state = tree_map(lambda t, s: torch.zeros(
            shd.local_shape(t.shape, s, mesh), dtype=t.dtype, device=dev),
            o0, in_specs[1])
        return params, opt_state

    return model, step, init_fn, in_specs


def _shapes(c, model, opt_cfg):
    """The (params, opt state) trees as data-free ``meta`` tensors: the
    structure a checkpoint is restored into."""
    params = tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                            device="meta"), model.decls)
    return params, optim.init_opt(c.optimizer, params, opt_cfg)


def train(c, cell: ShapeCell, *, steps: int, ckpt_dir: str | None = None,
          ckpt_every: int = 0, mesh=None, seed: int = 0,
          simulate_failure_at: int = -1, step_timeout_factor: float = 5.0,
          log_every: int = 10, data_cfg: DataConfig = DataConfig(),
          device=None):
    """Train ``steps`` steps (from the newest checkpoint in ``ckpt_dir``,
    if any); returns (params, opt state, per-step history)."""
    dev = resolve_device(device)
    opt_cfg = optim.OptimConfig(name=c.optimizer)
    model, step_fn, init_fn, in_specs = _trainer(c, cell, mesh, opt_cfg,
                                                 dev)
    specs = None if mesh is None else {"params": in_specs[0],
                                       "opt": in_specs[1]}
    lead = mesh is None or mesh.origin
    say = (lambda msg: print(msg, flush=True)) if lead else (lambda msg: None)
    start = 0
    params = opt_state = None
    if ckpt_dir:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            say(f"[train] resuming from checkpoint step {last}")
            p0, o0 = _shapes(c, model, opt_cfg)
            with shd.use_mesh(mesh):
                bundle = ckpt_lib.restore(
                    ckpt_dir, last, {"params": p0, "opt": o0}, device=dev,
                    expect_config=c.to_json(), specs=specs)
            params, opt_state = bundle["params"], bundle["opt"]
            start = last
    if params is None:
        params, opt_state = init_fn(seed)

    history = []
    durations = []
    for step in range(start, steps):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in make_batch(c, cell, step, data_cfg).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        durations.append(dt)
        med = float(np.median(durations[-20:]))
        if len(durations) > 5 and dt > step_timeout_factor * med:
            say(f"[train] STRAGGLER step {step}: {dt:.2f}s vs median "
                f"{med:.2f}s")
        gnorm = float(metrics["grad_norm"])
        history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "sec": dt})
        if log_every and step % log_every == 0:
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"gnorm {gnorm:.3f} {dt:.2f}s")
        done = step + 1
        if ckpt_dir and ckpt_every and done % ckpt_every == 0:
            with shd.use_mesh(mesh):
                ckpt_lib.save(
                    ckpt_dir, done, {"params": params, "opt": opt_state},
                    config_json=c.to_json(), specs=specs,
                    mesh_shape=dict(mesh.shape) if mesh else {})
        if simulate_failure_at >= 0 and done >= simulate_failure_at:
            say(f"[train] SIMULATED FAILURE at step {done}")
            os._exit(42)
    return params, opt_state, history


def _run(args, unknown, mesh=None, device=None) -> None:
    """Train as ``args`` say on ``mesh`` (None: one device); the rank at
    the mesh's origin prints the JSON line."""
    c = configs.get(args.arch, reduced=args.reduced)
    _, overrides = parse_cli_overrides(unknown)
    if overrides:
        c = apply_overrides(c, overrides)
    cell = ShapeCell("cli", "train", args.seq_len, args.global_batch)
    _, _, hist = train(
        c, cell, steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, mesh=mesh, seed=args.seed,
        simulate_failure_at=args.simulate_failure_at, device=device)
    if mesh is None or mesh.origin:
        print(json.dumps({"final_loss": hist[-1]["loss"] if hist else None,
                          "steps_run": len(hist)}), flush=True)


def _rank(rank: int, world: int, args, unknown) -> None:
    """One rank of a ``--data``/``--model`` run (spawned)."""
    dev = torch.device("cpu") if args.device == "cpu" else torch.device(
        "cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _run(args, unknown, make_host_mesh(args.data, args.model), dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--data", type=int, default=1, help="data-parallel size")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel size")
    ap.add_argument("--backend", default="gloo", choices=ranks.BACKENDS,
                    help="the ranks' process group backend (with --data or "
                         "--model above 1)")
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="train on this device (default: the card)")
    args, unknown = ap.parse_known_args(argv)

    dev = resolve_device(args.device)
    world = args.data * args.model
    if world == 1:
        _run(args, unknown, device=dev)
        return
    ranks.check_backend(args.backend, world)
    if args.backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on the card, not on "
                         f"{dev.type}; use gloo")
    try:
        ranks.spawn_ranks(_rank, world, backend=args.backend,
                          args=(args, unknown))
    except torch.multiprocessing.ProcessExitedException as err:
        if err.exit_code == 42:         # the ranks' simulated failure
            sys.exit(42)
        raise


if __name__ == "__main__":
    main()

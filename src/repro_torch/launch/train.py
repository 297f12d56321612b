"""Training launcher (port of ``repro.launch.train``):
``python -m repro_torch.launch.train --arch qwen3-1.7b ... [--device cpu]``.

It trains on one device, the card unless ``--device`` names another
(without a card and without ``--device cpu`` it raises "no CUDA device").

Fault-tolerance contract (``tests/test_torch_train.py``):
  * checkpoint every ``--ckpt-every`` steps (atomic; ``train/checkpoint.py``);
  * on start, auto-resume from the newest committed checkpoint;
  * ``--simulate-failure-at N`` hard-exits (``os._exit(42)``) once step N
    is done, to prove that the next launch resumes losslessly: the data
    pipeline is counter-based, so batch N after a restart is bit-identical
    to batch N without the failure;
  * straggler watch: a step taking more than ``step_timeout_factor`` times
    the median of the last 20 logs a straggler warning.
Data- and model-parallel runs (``--data``/``--model`` above 1) raise
``NotImplementedError``: ROADMAP Queue 1 #8's first item.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import apply_overrides, parse_cli_overrides
from repro_torch.graph.structure import resolve_device
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
    (the card unless the caller names another)."""
    dev = resolve_device(device)
    model = model_api.build(c)
    opt_cfg = opt_cfg or optim.OptimConfig(name=c.optimizer)
    step, _, _, _ = make_train_step(model, opt_cfg, cell, mesh)

    def init_fn(seed=0):
        params = init_params(model.decls, seed=seed, device=dev)
        return params, optim.init_opt(c.optimizer, params, opt_cfg)

    return model, step, init_fn


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
    model, step_fn, init_fn = build_trainer(c, cell, mesh, opt_cfg,
                                            device=dev)
    start = 0
    params = opt_state = None
    if ckpt_dir:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            print(f"[train] resuming from checkpoint step {last}", flush=True)
            p0, o0 = _shapes(c, model, opt_cfg)
            bundle = ckpt_lib.restore(
                ckpt_dir, last, {"params": p0, "opt": o0}, device=dev,
                expect_config=c.to_json())
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
            print(f"[train] STRAGGLER step {step}: {dt:.2f}s vs median "
                  f"{med:.2f}s", flush=True)
        gnorm = float(metrics["grad_norm"])
        history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "sec": dt})
        if log_every and step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {gnorm:.3f} {dt:.2f}s", flush=True)
        done = step + 1
        if ckpt_dir and ckpt_every and done % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, done, {"params": params, "opt": opt_state},
                          config_json=c.to_json())
        if simulate_failure_at >= 0 and done >= simulate_failure_at:
            print(f"[train] SIMULATED FAILURE at step {done}", flush=True)
            os._exit(42)
    return params, opt_state, history


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
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="train on this device (default: the card)")
    args, unknown = ap.parse_known_args(argv)

    if args.data * args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: data/model-parallel "
            f"training is not ported yet (ROADMAP Queue 1 #8: "
            f"launch/mesh.py, launch/sharding.py)")
    dev = resolve_device(args.device)
    c = configs.get(args.arch, reduced=args.reduced)
    _, overrides = parse_cli_overrides(unknown)
    if overrides:
        c = apply_overrides(c, overrides)
    cell = ShapeCell("cli", "train", args.seq_len, args.global_batch)
    _, _, hist = train(
        c, cell, steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed,
        simulate_failure_at=args.simulate_failure_at, device=dev)
    print(json.dumps({"final_loss": hist[-1]["loss"] if hist else None,
                      "steps_run": len(hist)}))


if __name__ == "__main__":
    main()

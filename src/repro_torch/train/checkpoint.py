"""Checkpointing with fault-tolerance semantics (port of
``repro.train.checkpoint``, on trees of torch tensors and numpy leaves).

  * ATOMIC saves: write to ``step_N.tmp/`` then ``rename`` — a crash
    mid-save never corrupts the latest checkpoint;
  * MANIFEST (json): step, config, one entry per leaf (key, file, shape,
    dtype, kind) — ``restore`` can validate the config against the running
    one and REJECTS mismatches loudly;
  * retention: keep the newest ``keep`` checkpoints, delete older ones only
    AFTER the new save committed;
  * partial-failure recovery: ``latest_step`` skips ``.tmp`` directories,
    so a killed run resumes from the last committed step.

A tree is nested dicts, lists and tuples (NamedTuples keep their type,
as the optimizer states need) whose leaves are torch tensors, numpy
arrays or Python/numpy scalars.  Leaves are saved as flat byte
views (``np.save`` cannot hold bfloat16), their true dtype and shape in
the manifest.  ``restore`` rebuilds the structure of ``like`` and puts
every tensor leaf on one device: the one it is given, else the card
(``graph.structure.resolve_device``), as every entry point of the port.

Sharded trees (a mesh's train state, ``launch/train.py``): ``save`` given
``specs`` gathers each tensor leaf whole from every rank's block, one
leaf at a time, and the rank at coordinate 0 of every axis writes it;
the manifest records ``mesh_shape``.  ``restore`` given ``specs`` reads
the whole arrays and keeps this rank's block of each.  A checkpoint
therefore holds unsharded arrays, and a run resumes on another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.graph.structure import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.utils.tree import tree_leaves


def _leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key, leaf), ...]`` in a fixed order: dict keys sorted, list and
    tuple entries by index; keys are ``/``-joined paths."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{prefix}{i}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _rebuild(like, values: list):
    """``like``'s structure with its leaves replaced, in ``_leaves`` order."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], values) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):   # NamedTuple
        return type(like)(*(_rebuild(v, values) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values) for v in like)
    return values.pop(0)


def _as_bytes(leaf) -> Tuple[np.ndarray, list, str, str]:
    """(flat uint8 view, shape, dtype name, kind) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return raw, list(t.shape), str(t.dtype).replace("torch.", ""), \
            "torch"
    arr = np.array(leaf, order="C")     # 0-d stays 0-d
    return arr.reshape(-1).view(np.uint8), list(arr.shape), str(arr.dtype), \
        "numpy"


def _spec_list(specs, n: int) -> list:
    """``specs``' leaves in ``_leaves`` order, or n Nones."""
    return [None] * n if specs is None else tree_leaves(specs)


def save(ckpt_dir: str, step: int, tree: Any, *, config_json: str = "{}",
         mesh_shape: Optional[dict] = None, keep: int = 3,
         specs: Any = None) -> str:
    """Atomically save ``tree`` at ``step``; returns the committed path.
    With ``specs`` (under the active mesh) every rank calls it with its
    blocks and the whole leaves are written once."""
    mesh = shd.active_mesh() if specs is not None else None
    writer = mesh is None or mesh.origin
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    manifest = {"step": step, "config": json.loads(config_json),
                "mesh_shape": dict(mesh_shape or {}), "leaves": []}
    leaves = _leaves(tree)
    for (key, leaf), spec in zip(leaves, _spec_list(specs, len(leaves))):
        if spec is not None:
            leaf = shd.full_leaf(leaf, spec, mesh)
        if not writer:
            continue
        raw, shape, dtype, kind = _as_bytes(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), raw)
        manifest["leaves"].append({"key": key, "file": fname, "shape": shape,
                                   "dtype": dtype, "kind": kind})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                   # commit point
        _gc(ckpt_dir, keep)
    if mesh is not None:
        mesh.barrier()                          # every rank sees the commit
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_config(ckpt_dir: str, step: int) -> Any:
    """The ``config`` a step was saved with."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["config"]


def restore(ckpt_dir: str, step: int, like: Any, *,
            device: Union[str, torch.device, None] = None,
            expect_config: Optional[str] = None, specs: Any = None) -> Any:
    """Restore into the structure of ``like``, whose leaves give each
    saved leaf's expected shape (torch tensors — on any device, ``meta``
    included — numpy arrays or scalars).  Tensor leaves land on
    ``device``, the card when it is None; numpy leaves stay on the host.
    A leaf saved as a tensor comes back as one, with its saved dtype.
    With ``specs`` (under the active mesh) each tensor leaf is this rank's
    block of the saved array, read through a memory map."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if expect_config is not None:
        saved = json.dumps(manifest["config"], sort_keys=True)
        want = json.dumps(json.loads(expect_config), sort_keys=True)
        if saved != want:
            raise ValueError(
                "checkpoint config mismatch — refusing to restore "
                f"(saved != running):\n{saved}\nvs\n{want}")
    dev = None
    by_key = {m["key"]: m for m in manifest["leaves"]}
    mesh = shd.active_mesh() if specs is not None else None
    out = []
    leaves = _leaves(like)
    for (key, leaf), spec in zip(leaves, _spec_list(specs, len(leaves))):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        want_shape = tuple(np.shape(leaf) if not isinstance(
            leaf, torch.Tensor) else leaf.shape)
        if tuple(meta["shape"]) != want_shape:
            raise ValueError(
                f"leaf '{key}': shape {tuple(meta['shape'])} != {want_shape}")
        raw = np.load(os.path.join(path, meta["file"]),
                      mmap_mode="r" if spec is not None else None)
        if meta["kind"] == "torch":
            if dev is None:
                dev = resolve_device(device)
            dtype = getattr(torch, meta["dtype"])
            if spec is not None:
                # the block of the raw bytes, viewed as the saved dtype's
                # integer twin of the same width
                width = torch.empty((), dtype=dtype).element_size()
                block = shd.local_shard(
                    raw.view(f"<i{width}").reshape(meta["shape"]), spec,
                    mesh)
                t = torch.from_numpy(np.array(block)).view(dtype)   # a copy
            else:
                t = torch.from_numpy(raw.copy()).view(dtype).reshape(
                    meta["shape"])
            out.append(t.to(dev))
        else:
            out.append(np.frombuffer(raw.tobytes(), dtype=np.dtype(
                meta["dtype"])).reshape(meta["shape"]).copy())
    return _rebuild(like, out)

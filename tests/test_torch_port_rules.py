"""The port stands alone and runs on the card unless told otherwise.

* ``repro_torch`` and every submodule import without JAX or the ``repro``
  package ever entering ``sys.modules`` (checked in a fresh interpreter),
  and no source file of the port names either in an import.
* Without a card, the entry points refuse to build on the CPU silently:
  ``from_numpy_edges``/``datasets.load``, the language model's
  ``init_params`` and ``ServeEngine``, the training launcher
  (``launch/train.py``), and ``CommunityServeEngine`` with
  no ``device`` raise, and so
  does ``train.checkpoint.restore``; the cascade's resume restores onto
  the device of the graph it resumes.
* The distributed drivers keep every tensor on the graph's device (each
  collective and coarsening sees it there), an ``nccl`` group without a
  card is refused, and so is a graph off the card in an ``nccl`` group;
  ``nccl`` ranks bind cards of their own, and a group with more ranks
  than cards is refused.
"""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.graph import datasets
from repro_torch.graph.builders import from_numpy_edges
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import api as model_api
from repro_torch.models.common import init_params

PORT = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)],
                                                        "repro_torch."))


def test_every_module_is_visited():
    mods = _modules()
    for m in ("repro_torch.core.louvain", "repro_torch.kernels.build",
              "repro_torch.kernels.local_move.kernel",
              "repro_torch.kernels.aggregation.ops",
              "repro_torch.graph.ell",
              "repro_torch.kernels.label_argmax.kernel",
              "repro_torch.kernels.label_argmax.ops",
              "repro_torch.kernels.delta_q.kernel",
              "repro_torch.kernels.delta_q.ops",
              "repro_torch.kernels.segment_sum.kernel",
              "repro_torch.kernels.segment_sum.ops",
              "repro_torch.kernels.segment_sum.ref",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.models.arch_config", "repro_torch.models.common",
              "repro_torch.models.attention",
              "repro_torch.models.transformer", "repro_torch.models.api",
              "repro_torch.configs.qwen3_1_7b", "repro_torch.configs.qwen3_8b",
              "repro_torch.launch.serve", "repro_torch.utils.faultinject",
              "repro_torch.utils.resilience", "repro_torch.utils.logging",
              "repro_torch.train.checkpoint", "repro_torch.core.batch",
              "repro_torch.graph.packing",
              "repro_torch.launch.community_serve",
              "repro_torch.core.baselines",
              "repro_torch.core.expert_placement",
              "repro_torch.graph.partition", "repro_torch.core.distributed",
              "repro_torch.launch.ranks", "repro_torch.configs.phi3_medium_14b",
              "repro_torch.utils.tree", "repro_torch.utils.prng",
              "repro_torch.train.optim", "repro_torch.train.data",
              "repro_torch.launch.train_step", "repro_torch.launch.train",
              "repro_torch.models.rwkv6", "repro_torch.models.ssm",
              "repro_torch.configs.rwkv6_1_6b",
              "repro_torch.configs.zamba2_1_2b",
              "repro_torch.launch.mesh", "repro_torch.launch.sharding",
              "repro_torch.launch.collectives"):
        assert m in mods


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "('jax.') or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(PORT)}: {name}")
    assert offenders == []


def test_entry_points_default_to_the_card():
    u, v = np.array([0, 1, 2]), np.array([1, 2, 0])
    if torch.cuda.is_available():
        assert from_numpy_edges(u, v).src.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy_edges(u, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        datasets.load("ring-of-cliques")
    assert from_numpy_edges(u, v, device="cpu").src.device.type == "cpu"


def test_community_service_defaults_to_the_card():
    """``CommunityServeEngine`` resolves its device when it is built: with
    no card and no ``device``, it raises there, not at the first request."""
    from repro_torch.launch.community_serve import (CommunityRequest,
                                                    CommunityServeEngine)

    if torch.cuda.is_available():
        assert CommunityServeEngine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CommunityServeEngine()
    eng = CommunityServeEngine(device="cpu")
    u, v = np.array([0, 1, 2, 3]), np.array([1, 2, 0, 0])
    assert eng.submit(CommunityRequest("a", u, v)) is None
    assert eng._queue[0].graph.device.type == "cpu"
    r, = eng.flush()
    assert r.ok and r.labels.shape == (4,)


def test_model_entry_points_default_to_the_card():
    c = configs.get("qwen3-1.7b", reduced=True)
    decls = model_api.build(c).decls
    if torch.cuda.is_available():
        assert init_params(decls)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(decls)
    params = init_params(decls, device="cpu")
    assert params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(c, params)
    with pytest.raises(ValueError, match="lies on cpu"):
        ServeEngine(c, params, device="meta")
    assert ServeEngine(c, params, device="cpu").device.type == "cpu"


def test_trainer_defaults_to_the_card():
    """The training launcher and its pieces build on the card unless told
    otherwise: ``build_trainer``, ``train`` and ``main`` without a device
    (``python -m repro_torch.launch.train`` without ``--device cpu``)
    raise without one, and ``named_generator`` too."""
    from repro_torch.launch import train
    from repro_torch.models.arch_config import ShapeCell
    from repro_torch.utils.prng import named_generator

    c = configs.get("qwen3-1.7b", reduced=True)
    cell = ShapeCell("t", "train", 8, 2)
    if torch.cuda.is_available():
        _, _, init_fn = train.build_trainer(c, cell)
        assert init_fn(0)[0]["embed"].device.type == "cuda"
        return
    for call in (lambda: train.build_trainer(c, cell),
                 lambda: train.train(c, cell, steps=1),
                 lambda: train.main(["--arch", "qwen3-1.7b", "--reduced",
                                     "--steps", "1"]),
                 lambda: named_generator(0, "init")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    _, _, init_fn = train.build_trainer(c, cell, device="cpu")
    assert init_fn(0)[0]["embed"].device.type == "cpu"


def test_checkpoint_restore_defaults_to_the_card(tmp_path):
    """``restore`` puts tensor leaves on the device it is given, the card
    when none is; the cascade's resume passes the graph's device."""
    from repro_torch.train import checkpoint

    checkpoint.save(str(tmp_path), 1, {"a": torch.arange(3)})
    like = {"a": torch.empty(3, dtype=torch.int64, device="meta")}
    if torch.cuda.is_available():
        assert checkpoint.restore(str(tmp_path), 1, like)["a"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            checkpoint.restore(str(tmp_path), 1, like)
    out = checkpoint.restore(str(tmp_path), 1, like, device="cpu")
    assert out["a"].device.type == "cpu"


def test_resume_restores_onto_the_graphs_device(tmp_path, monkeypatch):
    from repro_torch.core import louvain as louvain_mod
    from repro_torch.utils import faultinject

    n, k = 600, 20
    edges = [(c * k + i, c * k + j) for c in range(n // k)
             for i in range(k) for j in range(i + 1, k)]
    edges += [(c * k, ((c + 1) % (n // k)) * k) for c in range(n // k)]
    e = np.array(edges)
    g = from_numpy_edges(e[:, 0], e[:, 1], n=n, device="cpu")
    cfg = louvain_mod.LouvainConfig(capacity_schedule=((256, 2048),),
                                    checkpoint_dir=str(tmp_path))
    with pytest.raises(BaseException, match="preemption"):
        with faultinject.inject("preempt_stage"):
            louvain_mod.louvain(g, cfg)
    seen = []
    real = louvain_mod._ckpt_try_resume

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out)
        return out

    monkeypatch.setattr(louvain_mod, "_ckpt_try_resume", spy)
    louvain_mod.louvain(g, cfg)
    (k_, _w, _s, g_k, assign, init_com, macro, _lvl, _h), = seen
    assert k_ == 1
    for t in (g_k.src, g_k.w, assign, init_com, macro):
        assert t.device == g.device


def _one_rank_gloo(tmp_path):
    from repro_torch.launch.ranks import init_group

    return init_group("gloo", 0, 1, f"file://{tmp_path}/rendezvous")


def test_distributed_calls_stay_on_the_graphs_device(tmp_path, monkeypatch):
    """Every collective of ``distributed_louvain``/``distributed_leiden``/
    ``distributed_plp`` (both coarsenings and the per-level driver) and
    every coarsening they run sees tensors on the graph's device — the card
    where there is one — and the results come back as host numpy."""
    import torch.distributed as dist

    from repro_torch.core import distributed as dmod

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    n, k = 60, 6
    edges = [(c * k + i, c * k + j) for c in range(n // k)
             for i in range(k) for j in range(i + 1, k)]
    edges += [(c * k, ((c + 1) % (n // k)) * k) for c in range(n // k)]
    e = np.array(edges)
    g = from_numpy_edges(e[:, 0], e[:, 1], n=n, device=dev)
    seen = set()

    def spy(fn):
        def wrapped(*a, **kw):
            for x in list(a) + list(kw.values()):
                for t in (x if isinstance(x, list) else [x]):
                    if isinstance(t, torch.Tensor):
                        seen.add(t.device)
                    elif hasattr(t, "src"):
                        seen.add(t.src.device)
            return fn(*a, **kw)
        return wrapped

    for name in ("all_reduce", "all_gather"):
        monkeypatch.setattr(dist, name, spy(getattr(dist, name)))
    monkeypatch.setattr(dmod, "binned_coarsen", spy(dmod.binned_coarsen))
    _one_rank_gloo(tmp_path)
    try:
        for kw in ({}, {"coarsening": "replicated"},
                   {"pipeline_fused": False}):
            res = dmod.distributed_louvain(g, **kw)
            assert isinstance(res.labels, np.ndarray)
        assert isinstance(dmod.distributed_leiden(g).labels, np.ndarray)
        labels, _ = dmod.distributed_plp(g)
        assert isinstance(labels, np.ndarray)
    finally:
        dist.destroy_process_group()
    assert seen == {g.device}


def test_nccl_needs_the_card(tmp_path, monkeypatch):
    """``init_group("nccl")`` without a card raises and starts no group;
    a graph off the card in an ``nccl`` group is refused by the drivers
    before they partition it."""
    import torch.distributed as dist

    from repro_torch.core import distributed as dmod
    from repro_torch.launch.ranks import init_group

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_group("nccl", 0, 1, f"file://{tmp_path}/nccl")
        assert not dist.is_initialized()
    u, v = np.array([0, 1, 2]), np.array([1, 2, 0])
    g = from_numpy_edges(u, v, device="cpu")
    _one_rank_gloo(tmp_path)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(ValueError, match="on the card"):
            dmod.distributed_louvain(g)
        with pytest.raises(ValueError, match="on the card"):
            dmod.distributed_plp(g)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_nccl_ranks_bind_cards_of_their_own(monkeypatch):
    """Each ``nccl`` rank binds ``cuda:(rank mod the card count)``, so two
    ranks on two cards never share one; more ranks than cards is refused
    before a group starts."""
    import torch.distributed as dist

    from repro_torch.launch.ranks import init_group

    bound, started = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: started.append(
                            (backend, kw["rank"], kw["world_size"])))
    for rank in (0, 1):
        init_group("nccl", rank, 2, "file:///unused")
    assert bound == [0, 1]
    assert started == [("nccl", 0, 2), ("nccl", 1, 2)]
    with pytest.raises(ValueError, match="a card a rank"):
        init_group("nccl", 0, 3, "file:///unused")
    assert bound == [0, 1] and len(started) == 2

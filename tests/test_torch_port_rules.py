"""The port stands alone and runs on the card unless told otherwise.

* ``repro_torch`` and every submodule import without JAX or the ``repro``
  package ever entering ``sys.modules`` (checked in a fresh interpreter),
  and no source file of the port names either in an import.
* Without a card, the entry points refuse to build on the CPU silently:
  ``from_numpy_edges``/``datasets.load`` with no ``device`` raise.
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
from repro_torch.graph import datasets
from repro_torch.graph.builders import from_numpy_edges

PORT = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)],
                                                        "repro_torch."))


def test_every_module_is_visited():
    mods = _modules()
    for m in ("repro_torch.core.louvain", "repro_torch.kernels.build",
              "repro_torch.kernels.local_move.kernel",
              "repro_torch.kernels.aggregation.ops",
              "repro_torch.graph.ell"):
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

"""Architecture registry (port of ``repro.configs``): ``--arch <id>``
resolution for launchers and tests.

Each module defines CONFIG (the exact published dims) and REDUCED (a same-
family small config for CPU tests).  The port holds the dense configs whose
every feature it runs (RMS norm, SwiGLU, qk-norm, GQA, bf16 KV cache);
the JAX package's other architectures join as their families are ported
(ROADMAP Queue 1 #11).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.arch_config import (SHAPE_CELLS, SHAPES, ArchConfig,
                                            ShapeCell, cell_applicable)

_MODULES = {
    "qwen3-8b": "qwen3_8b",
    "qwen3-1.7b": "qwen3_1_7b",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str, *, reduced: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(*, reduced: bool = False) -> Dict[str, ArchConfig]:
    return {a: get(a, reduced=reduced) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "get", "all_configs", "SHAPE_CELLS", "SHAPES",
           "ShapeCell", "cell_applicable"]

"""Architecture registry (port of ``repro.configs``): ``--arch <id>``
resolution for launchers and tests.

Each module defines CONFIG (the exact published dims) and REDUCED (a same-
family small config for CPU tests).  The port holds every config of the
JAX registry, in its order.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.arch_config import (SHAPE_CELLS, SHAPES, ArchConfig,
                                            ShapeCell, cell_applicable)

_MODULES = {
    "qwen3-8b": "qwen3_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-large-v3": "whisper_large_v3",
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

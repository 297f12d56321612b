"""Deterministic generator derivation (port of ``repro.utils.prng``).

Every stochastic component derives its generator from a (seed, name, step)
triple, so that restarts are bit-exact whatever order the components ask
in.  The (name, step) pair folds through the JAX package's blake2b digest
(``named_key``); JAX's threefry stream has no counterpart, so the numbers
drawn differ from the JAX package's: only their stability and independence
carry over.
"""
from __future__ import annotations

import hashlib
from typing import Union

import torch

from repro_torch.graph.structure import resolve_device


def _fold(name: str, step: int) -> int:
    """The 32-bit fold of ``named_key``: blake2b of ``"name:step"``."""
    digest = hashlib.blake2b(f"{name}:{step}".encode(),
                             digest_size=4).digest()
    return int.from_bytes(digest, "little")


def named_seed(seed: int, name: str, step: int = 0) -> int:
    """A 64-bit seed from (seed, name, step): blake2b of the seed and the
    fold, so that every bit depends on all three (the CPU generator keeps
    only the low 32 bits of its seed)."""
    digest = hashlib.blake2b(f"{int(seed)}:{_fold(name, step)}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def named_generator(seed: int, name: str, step: int = 0,
                    device: Union[str, torch.device, None] = None
                    ) -> torch.Generator:
    """A generator on ``device`` (the card unless the caller names
    another) seeded from (seed, name, step); independent of call
    order."""
    gen = torch.Generator(device=resolve_device(device))
    return gen.manual_seed(named_seed(seed, name, step))


def split_named(seed: int, name: str, n: int, step: int = 0,
                device: Union[str, torch.device, None] = None
                ) -> list[torch.Generator]:
    """``n`` generators under one (seed, name, step), each its own fold."""
    return [named_generator(named_seed(seed, name, step), f"{name}/{i}",
                            step, device) for i in range(n)]

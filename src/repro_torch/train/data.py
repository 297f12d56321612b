"""Deterministic synthetic data pipeline (port of ``repro.train.data``).

Host numpy, the JAX package's own code, so every batch is bit-identical to
the JAX package's:
  * tokens come from a counter-based generator keyed on (seed, step): any
    worker can regenerate any batch, so a restore from a checkpoint needs
    no data state beyond the step counter (the pipeline is stateless);
  * a background prefetch thread keeps ``prefetch`` batches ready;
  * a light Zipf-ish token distribution (realistic vocabulary skew).
The trainer moves each batch to its device itself.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.config import ConfigBase
from repro_torch.models.arch_config import ArchConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class DataConfig(ConfigBase):
    seed: int = 0
    zipf_alpha: float = 1.1
    prefetch: int = 2


def _hash_tokens(step: int, seed: int, shape, vocab: int, alpha: float
                 ) -> np.ndarray:
    """Counter-based generation: philox keyed on (seed, step)."""
    rng = np.random.default_rng(np.random.Philox(key=seed + (step << 20)))
    u = rng.random(shape)
    # inverse-CDF Zipf over [0, vocab): p(k) ~ (k+1)^-alpha
    ranks = np.floor((u ** (1.0 / (1.0 - alpha))) - 1.0)  # heavy-tailed
    toks = np.clip(ranks, 0, vocab - 1).astype(np.int32)
    # permute ranks -> ids deterministically so frequent ids are spread out
    perm_mult = 2654435761 % vocab
    return ((toks.astype(np.int64) * perm_mult) % vocab).astype(np.int32)


def make_batch(c: ArchConfig, cell: ShapeCell, step: int,
               cfg: DataConfig = DataConfig()) -> Dict[str, np.ndarray]:
    """The full global batch for ``step``, as host numpy arrays: tokens
    and labels (the JAX package's VLM and audio inputs come with those
    families, which the port does not build yet)."""
    b, s = cell.global_batch, cell.seq_len
    toks = _hash_tokens(step, cfg.seed, (b, s + 1), c.vocab_size,
                        cfg.zipf_alpha)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DataPipeline:
    """Background-prefetching iterator over deterministic synthetic
    batches.  ``close`` stops its thread."""

    def __init__(self, c: ArchConfig, cell: ShapeCell,
                 cfg: DataConfig = DataConfig(), start_step: int = 0):
        self.c, self.cell, self.cfg = c, cell, cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = make_batch(self.c, self.cell, step, self.cfg)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10)

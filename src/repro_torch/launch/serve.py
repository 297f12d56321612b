"""Batched serving driver: prefill + decode with slot-based batching (port
of ``repro.launch.serve``).

  * a fixed decode batch of B slots; requests (prompt, max_new) occupy
    slots;
  * prompts are prefilled one at a time by repeated decode steps on a
    one-slot state, which is then written into the batch state's slot;
    decodes run batched (the continuous-batching decomposition);
  * a finished slot (EOS/max_new) is recycled for the next queued request;
  * greedy sampling (argmax, first index on ties) for determinism.

Every family runs: the transformer families' KV caches (a per-slot
position vector), RWKV6's recurrent state and Zamba2's (conv buffers, SSM
states and the shared block's caches).  A prefilled slot writes every leaf
of the one-slot state into the batch state by the JAX package's rules
(``_slot_write``); a scalar position (Zamba2's, and RWKV6's unused one) is
replaced by the one-slot state's, the JAX package's "shared timeline".
The engine owns its batch state, so it is written in place.  It runs on
the device its parameters lie on, which must be the one it was asked for
(the card unless the caller names another).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.graph.structure import resolve_device
from repro_torch.models import api as model_api
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.common import tree_leaves


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new: int = 16
    eos_id: int = -1          # -1: never stops early
    # filled by the engine:
    output: Optional[List[int]] = None
    latency_s: float = 0.0


class ServeEngine:
    """Slot-based batched decoding over a fixed batch of B slots."""

    def __init__(self, c: ArchConfig, params, *, batch_slots: int = 4,
                 max_seq: int = 512, device=None):
        self.device = resolve_device(device)
        for t in tree_leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"a parameter lies on {t.device}, the "
                                 f"engine runs on {self.device}")
        self.c = c
        self.model = model_api.build(c)
        self.params = params
        self.B = batch_slots
        self.max_seq = max_seq

    def _prefill_into(self, state, slot: int, prompt: Sequence[int]):
        """Single-sequence prefill via repeated decode steps on a one-slot
        state, then written into the batch state at ``slot``."""
        one = self.model.init_decode_state(self.params, 1, self.max_seq)
        last_logits = None
        for t in prompt:
            tok = torch.full((1,), int(t), dtype=torch.int64,
                             device=self.device)
            last_logits, one = self.model.decode_fn(self.params, tok, one)
        for batch_t, one_t in zip(tree_leaves(state), tree_leaves(one)):
            _slot_write(batch_t, one_t, slot)
        return state, last_logits

    def run(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        active: List[Optional[Request]] = [None] * self.B
        new_counts = [0] * self.B
        state = self.model.init_decode_state(self.params, self.B,
                                             self.max_seq)
        cur_tok = np.zeros((self.B,), np.int64)
        t_start = [0.0] * self.B
        done: List[Request] = []
        # a KV cache carries a PER-SLOT position vector, so slots hold
        # sequences of different lengths and recycle independently (the
        # recurrent states are position-free by construction)
        while queue or any(a is not None for a in active):
            for i in range(self.B):
                if active[i] is None and queue:
                    req = queue.pop(0)
                    t_start[i] = time.time()
                    state, logits = self._prefill_into(state, i, req.prompt)
                    req.output = []
                    active[i] = req
                    new_counts[i] = 0
                    cur_tok[i] = int(torch.argmax(logits[0]))
            if not any(a is not None for a in active):
                break
            logits, state = self.model.decode_fn(
                self.params, torch.from_numpy(cur_tok).to(self.device), state)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for i in range(self.B):
                req = active[i]
                if req is None:
                    continue
                req.output.append(int(cur_tok[i]))
                new_counts[i] += 1
                if new_counts[i] >= req.max_new or int(cur_tok[i]) == req.eos_id:
                    req.latency_s = time.time() - t_start[i]
                    done.append(req)
                    active[i] = None
                else:
                    cur_tok[i] = nxt[i]
        return done


def _slot_write(batch_t: torch.Tensor, one_t: torch.Tensor, slot: int
                ) -> None:
    """Write a one-slot state tensor into batch position ``slot``, in
    place, by the JAX package's rules: a scalar (a shared position) takes
    the one-slot value; a (1,) position vector goes in at ``slot``;
    (L, 1, ...) stacks (caches, their scales, recurrent states, conv
    buffers) go in at axis 1; anything else is left as it is."""
    if batch_t.dim() == 0:
        batch_t.copy_(one_t)
    elif batch_t.dim() == 1 and one_t.shape[0] == 1:
        batch_t[slot] = one_t[0]
    elif (batch_t.dim() >= 2 and one_t.shape[0] == batch_t.shape[0]
          and one_t.shape[1] == 1):
        batch_t[:, slot:slot + 1] = one_t

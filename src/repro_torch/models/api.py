"""Unified model API (port of ``repro.models.api``): one entry point over
the families the port runs.

``build(cfg)`` returns a ``ModelAPI`` whose members are plain functions of
(params, inputs).  The port runs the dense family: the training loss,
prefill (every layer's attention through the hand-written flash-attention
kernel on the card) and KV-cache decode.  The other families raise
``NotImplementedError``; they are ROADMAP Queue 1 #8.

Batch dict conventions:
  train:    {tokens (B,S) int, labels (B,S) int [, mask (B,S)]}
  prefill:  {tokens (B,S) int}
  decode:   token (B,) int + a ``transformer.DecodeState``
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.models import transformer
from repro_torch.models.arch_config import ArchConfig, ShapeCell
from repro_torch.models.common import is_decl, tree_leaves

class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor, without one (the JAX package's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


class ModelAPI(NamedTuple):
    cfg: ArchConfig
    decls: Any                                     # ParamDecl tree
    loss_fn: Callable[[Any, Dict], Any]            # (params, batch) -> (loss, metrics)
    prefill_fn: Callable[[Any, Dict], Any]         # (params, batch) -> logits
    decode_fn: Callable[[Any, torch.Tensor, Any], Any]  # (params, token, state)
    init_decode_state: Callable[..., Any]          # (params, batch, max_seq)
    input_specs: Callable[[ShapeCell], Dict[str, TensorSpec]]
    decode_state_specs: Callable[[ShapeCell], Any]
    model_flops: Callable[[ShapeCell], float]


def _decl_params(decls) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(decls) if is_decl(d))


def _flops(c: ArchConfig, cell: ShapeCell, decls=None) -> float:
    """MODEL_FLOPS: 6·N_active·tokens for train, 2·N_active·tokens for fwd,
    plus the attention score/value products."""
    if decls is not None and c.n_experts == 0:
        n_act = _decl_params(decls)        # exact for non-MoE
    else:
        n_act = c.active_params()
    toks = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    flops = mult * n_act * toks
    hq, hd = c.n_heads, c.hd
    if cell.kind == "train":
        flops += 6.0 * 2 * cell.global_batch * hq * hd * cell.seq_len ** 2 / 2 * c.n_layers
    elif cell.kind == "prefill":
        flops += 2.0 * 2 * cell.global_batch * hq * hd * cell.seq_len ** 2 / 2 * c.n_layers
    else:  # decode: q of len 1 against S keys
        flops += 2.0 * 2 * cell.global_batch * hq * hd * cell.seq_len * c.n_layers
    return flops


def build(c: ArchConfig) -> ModelAPI:
    decls = transformer.build_decls(c)       # raises for unported families

    def loss_fn(params, batch):
        return transformer.loss_fn(c, params, batch)

    def prefill_fn(params, batch):
        return transformer.forward(c, params, batch["tokens"])

    def decode_fn(params, token, state):
        return transformer.decode_step(c, params, token, state)

    def init_decode_state(params, batch_size, max_seq):
        device = params["embed"].device
        cache = transformer.init_cache(c, c.n_layers, batch_size, max_seq,
                                       device)
        return transformer.DecodeState(cache)

    def decode_state_specs(cell: ShapeCell):
        transformer._check_cache_dtype(c)
        b, s = cell.global_batch, cell.seq_len
        k = TensorSpec((c.n_layers, b, c.kv_eff, s, c.hd), torch.bfloat16)
        pos = TensorSpec((b,), torch.int32)             # per-slot positions
        return transformer.DecodeState(transformer.KVCache(k, k, pos))

    def input_specs(cell: ShapeCell):
        b, s = cell.global_batch, cell.seq_len
        if cell.kind == "decode":
            return {"token": TensorSpec((b,), torch.int32)}
        out = {"tokens": TensorSpec((b, s), torch.int32)}
        if cell.kind == "train":
            out["labels"] = TensorSpec((b, s), torch.int32)
        return out

    return ModelAPI(
        cfg=c,
        decls=decls,
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        init_decode_state=init_decode_state,
        input_specs=input_specs,
        decode_state_specs=decode_state_specs,
        model_flops=lambda cell: _flops(c, cell, decls),
    )

"""Unified model API (port of ``repro.models.api``): one entry point over
the families the port runs.

``build(cfg)`` returns a ``ModelAPI`` whose members are plain functions of
(params, inputs), dispatched by family as the JAX package's are:

* dense, MoE, VLM and audio (``models/transformer.py``): the training loss
  (with the MoE aux loss), prefill (every attention through the
  hand-written flash-attention kernel on the card) and KV-cache decode
  with a bf16 or int8 cache (the VLM's and the audio decoder's states
  also hold their cross-attention K/V, projected once by
  ``init_decode_state``);
* ``ssm`` (RWKV6, ``models/rwkv6.py``): the chunked WKV6 prefill and the
  O(1) recurrent decode on an ``RWKVState``;
* ``hybrid`` (Zamba2, ``models/ssm.py``): the chunked SSD prefill with the
  shared attention block through the flash kernel, and decode on a
  ``ZambaState`` (conv buffers, SSM states, the shared block's KV caches
  and one scalar position for every slot).

Batch dict conventions:
  train:    {tokens (B,S) int, labels (B,S) int [, mask (B,S)]
             [, img_embeds | enc_embeds]}
  prefill:  {tokens (B,S) int [, img_embeds | enc_embeds]}
  decode:   token (B,) int + the family's decode state
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.models import rwkv6, ssm, transformer
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


def _token_specs(c: ArchConfig, cell: ShapeCell, with_labels: bool) -> Dict:
    b, s = cell.global_batch, cell.seq_len
    out = {"tokens": TensorSpec((b, s), torch.int32)}
    if with_labels:
        out["labels"] = TensorSpec((b, s), torch.int32)
    if c.family == "vlm":
        out["img_embeds"] = TensorSpec((b, c.n_img_tokens, c.d_model),
                                       torch.bfloat16)
    if c.family == "audio":
        out["enc_embeds"] = TensorSpec((b, c.n_frames, c.d_model),
                                       torch.bfloat16)
    return out


def _decl_params(decls) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(decls) if is_decl(d))


def _flops(c: ArchConfig, cell: ShapeCell, decls=None) -> float:
    """MODEL_FLOPS: 6·N_active·tokens for train, 2·N_active·tokens for fwd,
    plus the attention score/value products of the full-attention families
    (dense, MoE, VLM, audio; Zamba2's shared block is not counted, as in
    the JAX package)."""
    if decls is not None and c.n_experts == 0:
        n_act = _decl_params(decls)        # exact for non-MoE
    else:
        n_act = c.active_params()
    toks = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    flops = mult * n_act * toks
    if c.family not in ("dense", "moe", "vlm", "audio"):
        return flops
    hq, hd = c.n_heads, c.hd
    if cell.kind == "train":
        flops += 6.0 * 2 * cell.global_batch * hq * hd * cell.seq_len ** 2 / 2 * c.n_layers
    elif cell.kind == "prefill":
        flops += 2.0 * 2 * cell.global_batch * hq * hd * cell.seq_len ** 2 / 2 * c.n_layers
    else:  # decode: q of len 1 against S keys
        flops += 2.0 * 2 * cell.global_batch * hq * hd * cell.seq_len * c.n_layers
    return flops


def _transformer(c: ArchConfig):
    """(decls, loss_fn, prefill_fn, decode_fn, init_decode_state,
    decode_state_specs) of the dense, MoE, VLM and audio families."""
    decls = transformer.build_decls(c)

    def loss_fn(params, batch):
        return transformer.loss_fn(c, params, batch)

    def prefill_fn(params, batch):
        logits, _ = transformer.forward(
            c, params, batch["tokens"], img_embeds=batch.get("img_embeds"),
            enc_embeds=batch.get("enc_embeds"))
        return logits

    def decode_fn(params, token, state):
        return transformer.decode_step(c, params, token, state)

    def init_decode_state(params, batch_size, max_seq, *, img_embeds=None,
                          enc_embeds=None):
        device = params["embed"].device
        cache = transformer.init_cache(c, c.n_layers, batch_size, max_seq,
                                       device)
        feats = transformer.features(c, img_embeds, enc_embeds)
        xk = xv = None
        if c.family == "vlm":
            xk, xv = transformer.precompute_cross_kv(c, params, feats,
                                                     "cross")
        if c.family == "audio":
            enc = transformer.encode_audio(c, params, feats)
            xk, xv = transformer.precompute_cross_kv(c, params, enc,
                                                     "dec_cross")
        return transformer.DecodeState(cache, xk, xv)

    def decode_state_specs(cell: ShapeCell):
        b, s = cell.global_batch, cell.seq_len
        shape = (c.n_layers, b, c.kv_eff, s, c.hd)
        pos = TensorSpec((b,), torch.int32)             # per-slot positions
        if c.kv_cache_dtype == "int8":
            k = TensorSpec(shape, torch.int8)
            sc = TensorSpec(shape[:-1] + (1,), torch.float32)
            cache = transformer.KVCache(k, k, sc, sc, pos)
        else:
            k = TensorSpec(shape, torch.bfloat16)
            cache = transformer.KVCache(k, k, None, None, pos)
        xk = None
        if c.family == "vlm":
            xk = TensorSpec((c.n_layers // c.cross_attn_every, b, c.kv_eff,
                             c.n_img_tokens, c.hd), torch.bfloat16)
        if c.family == "audio":
            xk = TensorSpec((c.n_layers, b, c.kv_eff, c.n_frames, c.hd),
                            torch.bfloat16)
        return transformer.DecodeState(cache, xk, xk)

    return (decls, loss_fn, prefill_fn, decode_fn, init_decode_state,
            decode_state_specs)


def _rwkv6(c: ArchConfig):
    """The same six members for the ``ssm`` family (RWKV6)."""

    def loss_fn(params, batch):
        return rwkv6.loss_fn(c, params, batch)

    def prefill_fn(params, batch):
        logits, _ = rwkv6.forward(c, params, batch["tokens"])
        return logits

    def decode_fn(params, token, state):
        return rwkv6.decode_step(c, params, token, state)

    def init_decode_state(params, batch_size, max_seq, **_):
        return rwkv6.init_state(c, batch_size, params["embed"].device)

    def decode_state_specs(cell: ShapeCell):
        b = cell.global_batch
        d = c.d_model
        H, N = d // c.rwkv_head_dim, c.rwkv_head_dim
        z = TensorSpec((c.n_layers, b, d), torch.bfloat16)
        return rwkv6.RWKVState(
            z, z, TensorSpec((c.n_layers, b, H, N, N), torch.float32),
            TensorSpec((), torch.int32))

    return (rwkv6.build_decls(c), loss_fn, prefill_fn, decode_fn,
            init_decode_state, decode_state_specs)


def _hybrid(c: ArchConfig):
    """The same six members for the ``hybrid`` family (Zamba2)."""

    def loss_fn(params, batch):
        return ssm.loss_fn(c, params, batch)

    def prefill_fn(params, batch):
        logits, _ = ssm.forward(c, params, batch["tokens"])
        return logits

    def decode_fn(params, token, state):
        return ssm.decode_step(c, params, token, state)

    def init_decode_state(params, batch_size, max_seq, **_):
        return ssm.init_state(c, batch_size, max_seq, params["embed"].device)

    def decode_state_specs(cell: ShapeCell):
        b, s = cell.global_batch, cell.seq_len
        d_in = c.ssm_expand * c.d_model
        H = d_in // c.ssm_head_dim
        conv_ch = d_in + 2 * c.ssm_state
        conv = TensorSpec((c.n_layers, b, c.conv_width - 1, conv_ch),
                          torch.bfloat16)
        ssm_st = TensorSpec((c.n_layers, b, H, c.ssm_state, c.ssm_head_dim),
                            torch.float32)
        pos = TensorSpec((), torch.int32)
        if c.shared_attn_every:
            kz = TensorSpec((ssm.n_shared_invocations(c), b, c.kv_eff, s,
                             c.hd), torch.bfloat16)
            return ssm.ZambaState(conv, ssm_st, kz, kz, pos)
        return ssm.ZambaState(conv, ssm_st, None, None, pos)

    return (ssm.build_decls(c), loss_fn, prefill_fn, decode_fn,
            init_decode_state, decode_state_specs)


_FAMILIES = {"dense": _transformer, "moe": _transformer, "vlm": _transformer,
             "audio": _transformer, "ssm": _rwkv6, "hybrid": _hybrid}


def build(c: ArchConfig) -> ModelAPI:
    if c.family not in _FAMILIES:
        raise ValueError(f"unknown family {c.family}")
    (decls, loss_fn, prefill_fn, decode_fn, init_decode_state,
     decode_state_specs) = _FAMILIES[c.family](c)

    def input_specs(cell: ShapeCell):
        if cell.kind == "decode":
            return {"token": TensorSpec((cell.global_batch,), torch.int32)}
        return _token_specs(c, cell, cell.kind == "train")

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

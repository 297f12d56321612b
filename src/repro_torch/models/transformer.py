"""Decoder-only transformer stack, dense family (port of
``repro.models.transformer``): qwen3-8b, qwen3-1.7b and
phi3-medium-14b.

* Layers are STACKED (leading L dim) as in the JAX package; its
  ``lax.scan`` over them becomes a loop over layers that slices layer l and
  casts the slice to bf16 (``cast_compute``), so the 1-D norm scales stay
  float32.  The sharding constraints have no counterpart on one device.
* Remat follows ``c.remat`` as the JAX package's ``jax.checkpoint``
  policy does, around each layer body (cast and block) when autograd
  records it (grad mode on and the layer's input or a parameter requiring
  grad; a prefill runs no checkpoint, as ``jax.checkpoint`` acts only
  under differentiation): ``"full"`` keeps only the layer's input
  (``torch.utils.checkpoint``), ``"dots"`` also the matrix products'
  outputs (a selective checkpoint), ``"none"`` everything.  It changes
  memory, not values.
* ``loss_fn``: the forward's logits through ``cross_entropy_loss``, plus
  the dense family's aux loss, 0.
* Every layer's full-sequence attention goes through
  ``attention.flash_attention``: the hand-written kernel on the card.
* KV caches live in (L, B, H_kv_eff, S, hd) stacked form, bf16, with a
  per-slot (B,) position vector; the int8 cache is not ported yet.
* Decode writes the new K/V into a layer's cache slice by a one-hot
  ``where`` (``_dus_per_slot``), as the JAX package does, and returns new
  cache tensors; the inputs are not written.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.common import (ParamDecl, apply_rope, cast_compute,
                                       cross_entropy_loss, rms_norm, swiglu,
                                       tree_leaves)

P = ParamDecl

_UNPORTED = "not ported yet (ROADMAP Queue 1 #8)"


def _check_dense(c: ArchConfig) -> None:
    """Raise for what the port does not run: only the dense family with
    RMS norm and SwiGLU.  ``build_decls`` calls it, so ``api.build``
    refuses the rest."""
    if c.family != "dense":
        raise NotImplementedError(f"family {c.family!r} is {_UNPORTED}")
    if c.norm != "rms" or c.activation != "swiglu":
        raise NotImplementedError(
            f"norm {c.norm!r} / activation {c.activation!r} is {_UNPORTED}")


# --------------------------------------------------------------- declarations


def _attn_decls(c: ArchConfig, L: int) -> Dict[str, P]:
    d = c.d_model
    hd, hq, hkv = c.hd, c.n_heads, c.n_kv_heads
    out: Dict[str, P] = {
        "wq": P((L, d, hq * hd), ("layers", "embed", "heads")),
        "wk": P((L, d, hkv * hd), ("layers", "embed", None)),
        "wv": P((L, d, hkv * hd), ("layers", "embed", None)),
        "wo": P((L, hq * hd, c.d_model), ("layers", "heads", "embed")),
    }
    if c.qk_norm:
        out["q_norm"] = P((L, hd), ("layers", None), init="zeros")
        out["k_norm"] = P((L, hd), ("layers", None), init="zeros")
    return out


def _ffn_decls(c: ArchConfig, L: int, d_ff: int) -> Dict[str, P]:
    d = c.d_model
    return {
        "w_gate": P((L, d, d_ff), ("layers", "embed", "mlp")),
        "w_up": P((L, d, d_ff), ("layers", "embed", "mlp")),
        "w_down": P((L, d_ff, d), ("layers", "mlp", "embed")),
    }


def _norm_decls(c: ArchConfig, L: int, names: Tuple[str, ...]
                ) -> Dict[str, P]:
    return {nm: P((L, c.d_model), ("layers", None), init="zeros")
            for nm in names}


def build_decls(c: ArchConfig) -> Dict[str, Any]:
    """Full parameter declaration tree of the dense family."""
    _check_dense(c)
    d, v = c.d_model, c.vocab_size
    out: Dict[str, Any] = {
        "embed": P((v, d), ("vocab", "embed"), init="embed"),
        "final_norm": P((d,), (None,), init="zeros"),
    }
    if not c.tie_embeddings:
        out["unembed"] = P((d, v), ("embed", "vocab"))
    layers = dict(_attn_decls(c, c.n_layers))
    layers.update(_norm_decls(c, c.n_layers, ("ln1", "ln2")))
    layers.update(_ffn_decls(c, c.n_layers, c.d_ff))
    out["layers"] = layers
    return out


def layer_slice(stacked: Dict[str, torch.Tensor], l: int
                ) -> Dict[str, torch.Tensor]:
    """Layer ``l`` of a stacked layer tree, cast for compute."""
    return cast_compute({k: t[l] for k, t in stacked.items()})


# --------------------------------------------------------------- layer bodies


def _norm(c: ArchConfig, p, x, name: str):
    return rms_norm(x, p[name])


def _project_qkv(c: ArchConfig, p, x, positions):
    """Project to (B,H,S,hd) with qk-norm + RoPE; KV repeated to kv_eff."""
    hd, hq, hkv = c.hd, c.n_heads, c.n_kv_heads
    b, s = x.shape[0], x.shape[1]
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if c.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = q.transpose(1, 2)  # (B,H,S,hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    q = apply_rope(q, positions, c.rope_theta)
    k = apply_rope(k, positions, c.rope_theta)
    reps = c.kv_eff // hkv
    return q, attn.repeat_kv(k, reps), attn.repeat_kv(v, reps)


def _self_attn(c: ArchConfig, p, x, positions, causal=True):
    q, k, v = _project_qkv(c, p, x, positions)
    o = attn.flash_attention(q, k, v, causal=causal,
                             chunk=min(1024, q.shape[2]))
    b, _, s, _ = q.shape
    o = o.transpose(1, 2).reshape(b, s, c.n_heads * c.hd)
    return o @ p["wo"]


def _ffn(c: ArchConfig, p, x):
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def _block(c: ArchConfig, p, x, positions, causal: bool = True):
    """Pre-norm transformer block."""
    x = x + _self_attn(c, p, _norm(c, p, x, "ln1"), positions, causal=causal)
    return x + _ffn(c, p, _norm(c, p, x, "ln2"))


def _logits(params, x):
    x = rms_norm(x, params["final_norm"])
    unembed = params["embed"].T if "unembed" not in params \
        else params["unembed"]
    return x @ unembed.to(x.dtype)


# --------------------------------------------------------------- remat

# the products whose outputs ``"dots"`` keeps (jax's ``checkpoint_dots``)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(c: ArchConfig, body, *args):
    """``body(*args)`` under ``c.remat``'s checkpoint when autograd records
    it (grad mode on and a tensor of ``args`` requiring grad); as it is
    otherwise."""
    if c.remat == "none" or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tree_leaves(args)):
        return body(*args)
    if c.remat == "full":
        return ckpt.checkpoint(body, *args, use_reentrant=False)
    if c.remat == "dots":
        return ckpt.checkpoint(
            body, *args, use_reentrant=False, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {c.remat!r}: want full, dots or none")


def _layer(c: ArchConfig, positions, x, p):
    return _block(c, cast_compute(p), x, positions)


# --------------------------------------------------------------- full forward


def forward(c: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Training/prefill forward: tokens (B, S) int -> logits (B, S, V)
    bf16.  The stacked layer tree is unbound once into per-layer views, so
    the gradient of a stacked leaf is one stack of its layers' gradients
    (a slice per layer would add a zero-filled stacked tensor per layer)."""
    x = params["embed"][tokens].to(torch.bfloat16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    layers = {k: t.unbind(0) for k, t in params["layers"].items()}
    body = functools.partial(_layer, c, positions)
    for l in range(c.n_layers):
        x = _remat(c, body, x, {k: t[l] for k, t in layers.items()})
    return _logits(params, x)


def loss_fn(c: ArchConfig, params, batch) -> Tuple[torch.Tensor,
                                                   Dict[str, torch.Tensor]]:
    """(loss, {"ce", "aux"}) of a batch {tokens, labels[, mask]}."""
    logits = forward(c, params, batch["tokens"])
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------- KV cache


class KVCache(NamedTuple):
    """The JAX package's KVCache without the int8 cache's scales."""
    k: torch.Tensor                 # (L, B, H_eff, S, hd) bf16
    v: torch.Tensor
    pos: torch.Tensor               # (B,) int32 — PER-SLOT filled length


def _check_cache_dtype(c: ArchConfig) -> None:
    if c.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"kv_cache_dtype={c.kv_cache_dtype!r} is {_UNPORTED}")


def init_cache(c: ArchConfig, n_layers: int, batch: int, max_seq: int,
               device) -> KVCache:
    _check_cache_dtype(c)
    shape = (n_layers, batch, c.kv_eff, max_seq, c.hd)
    z = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return KVCache(z, z.clone(),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def _dus_per_slot(cache, new, pos):
    """Per-slot write: cache (B,H,S,..), new (B,H,1,..), pos (B,) — a
    one-hot ``where`` in the cache dtype, as in the JAX package."""
    s = cache.shape[2]
    onehot = (torch.arange(s, dtype=torch.int32, device=cache.device)[None, :]
              == pos[:, None])                                   # (B,S)
    return torch.where(onehot[:, None, :, None], new.to(cache.dtype), cache)


def _cache_write(cache_k, cache_v, k_new, v_new, pos):
    """Write (B,H,1,hd) into per-layer cache slices at per-slot ``pos``."""
    return _dus_per_slot(cache_k, k_new, pos), _dus_per_slot(cache_v, v_new,
                                                             pos)


# --------------------------------------------------------------- decode


class DecodeState(NamedTuple):
    """The JAX package's DecodeState without the cross-attention K/V of
    the families the port does not run."""
    cache: KVCache


def _decode_self_attn(c: ArchConfig, p, x, ck, cv, pos):
    """Single-token self-attention against one layer's cache slice; ``pos``
    is the per-slot (B,) position vector."""
    q, k, v = _project_qkv(c, p, x, pos[:, None, None])
    ck, cv = _cache_write(ck, cv, k.to(ck.dtype), v.to(cv.dtype), pos)
    o = attn.decode_attention(q, ck, cv, pos + 1)
    b = x.shape[0]
    o = o.transpose(1, 2).reshape(b, 1, c.n_heads * c.hd)
    return o @ p["wo"], ck, cv


def _decode_block(c: ArchConfig, p, x, ck, cv, pos):
    a, ck, cv = _decode_self_attn(c, p, _norm(c, p, x, "ln1"), ck, cv, pos)
    x = x + a
    return x + _ffn(c, p, _norm(c, p, x, "ln2")), ck, cv


def decode_step(c: ArchConfig, params, token: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One-token decode: token (B,) int -> (logits (B, V), new state)."""
    cache = state.cache
    pos = cache.pos
    x = params["embed"][token][:, None, :].to(torch.bfloat16)   # (B,1,D)
    nk, nv = [], []
    for l in range(c.n_layers):
        x, ck, cv = _decode_block(c, layer_slice(params["layers"], l), x,
                                  cache.k[l], cache.v[l], pos)
        nk.append(ck)
        nv.append(cv)
    new_cache = KVCache(torch.stack(nk), torch.stack(nv), pos + 1)
    return _logits(params, x)[:, 0], DecodeState(new_cache)

"""Decoder-only transformer stack, dense and MoE families (port of
``repro.models.transformer``): qwen3-8b, qwen3-1.7b, phi3-medium-14b
(dense), qwen3-moe-30b-a3b and llama4-maverick-400b-a17b (moe).

* Layers are STACKED (leading L dim) as in the JAX package; its
  ``lax.scan`` over them becomes a loop over layers that slices layer l and
  casts the slice to bf16 (``cast_compute``), so the 1-D norm scales stay
  float32.  The sharding constraints have no counterpart on one device.
* MoE: ``moe_every == 1`` routes every layer's FFN through
  ``moe.moe_layer``; otherwise (llama4) the stack is ``n_layers // 2``
  pairs of a dense layer and a MoE layer (``dense_layers`` and
  ``moe_layers``), run dense first, with a shared expert's SwiGLU added
  to the routed output where ``shared_expert`` is set.
* Remat follows ``c.remat`` as the JAX package's ``jax.checkpoint``
  policy does, around each layer body (or pair body) when autograd
  records it (grad mode on and the layer's input or a parameter requiring
  grad; a prefill runs no checkpoint, as ``jax.checkpoint`` acts only
  under differentiation): ``"full"`` keeps only the layer's input
  (``torch.utils.checkpoint``), ``"dots"`` also the matrix products'
  outputs (a selective checkpoint), ``"none"`` everything.  It changes
  memory, not values.
* ``forward`` returns (logits, aux): the MoE layers' aux losses summed
  in float32 layer by layer (a pair adds its dense layer's 0 and then
  its MoE layer's), 0 for the dense family.  ``loss_fn`` is the logits'
  ``cross_entropy_loss`` plus aux.
* Every layer's full-sequence attention goes through
  ``attention.flash_attention``: the hand-written kernel on the card.
* KV caches live in (L, B, H_kv_eff, S, hd) stacked form, bf16 or int8,
  with a per-slot (B,) position vector.  The int8 cache keeps a float32
  scale per (layer, slot, head, position): the new K/V row's largest
  magnitude over 127, the row rounded half to even and clipped to
  [-127, 127]; a read is the int8 value times its scale in bf16.  The
  pair layout's cache is in layer order: pair i's dense layer at 2i, its
  MoE layer at 2i + 1.
* Decode writes the new K/V into a layer's cache slice by a one-hot
  ``where`` (``_dus_per_slot``), as the JAX package does, and returns new
  cache tensors; the inputs are not written.  The JAX package's decode
  casts the new K/V to the cache dtype before ``_quant``, so its int8
  cache quantizes K/V already truncated to integers (ROADMAP Queue 3);
  the port quantizes the bf16 K/V, as the bf16 cache stores them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.common import (ParamDecl, apply_rope, cast_compute,
                                       cross_entropy_loss, rms_norm, swiglu,
                                       tree_leaves)

P = ParamDecl


def _check_ported(c: ArchConfig) -> None:
    """Raise for what the port does not run: only the dense and MoE
    families with RMS norm and SwiGLU.  ``build_decls`` calls it, so
    ``api.build`` refuses the rest."""
    if c.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {c.family!r} is not ported yet (ROADMAP Queue 1 #4: "
            f"VLM, audio, RWKV6 and hybrid SSM)")
    if c.norm != "rms" or c.activation != "swiglu":
        raise NotImplementedError(
            f"norm {c.norm!r} / activation {c.activation!r} is not ported "
            f"yet (ROADMAP Queue 1 #3: squared_relu for nemotron; #4: layer "
            f"norm and GELU for whisper)")


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


def _ffn_decls(c: ArchConfig, L: int, d_ff: int, prefix: str = ""
               ) -> Dict[str, P]:
    d = c.d_model
    return {
        prefix + "w_gate": P((L, d, d_ff), ("layers", "embed", "mlp")),
        prefix + "w_up": P((L, d, d_ff), ("layers", "embed", "mlp")),
        prefix + "w_down": P((L, d_ff, d), ("layers", "mlp", "embed")),
    }


def _moe_decls(c: ArchConfig, L: int) -> Dict[str, P]:
    d, e, f = c.d_model, c.n_experts, c.d_ff_expert
    out = {
        "w_router": P((L, d, e), ("layers", "embed", None),
                      dtype=torch.float32),
        "we_gate": P((L, e, d, f), ("layers", "experts", "embed", None)),
        "we_up": P((L, e, d, f), ("layers", "experts", "embed", None)),
        "we_down": P((L, e, f, d), ("layers", "experts", None, "embed")),
    }
    if c.shared_expert:
        out.update(_ffn_decls(c, L, c.d_ff_shared, "shared_"))
    return out


def _norm_decls(c: ArchConfig, L: int, names: Tuple[str, ...]
                ) -> Dict[str, P]:
    return {nm: P((L, c.d_model), ("layers", None), init="zeros")
            for nm in names}


def _block_decls(c: ArchConfig, L: int, *, moe: bool) -> Dict[str, P]:
    out = dict(_attn_decls(c, L))
    out.update(_norm_decls(c, L, ("ln1", "ln2")))
    if moe:
        out.update(_moe_decls(c, L))
    else:
        out.update(_ffn_decls(c, L, c.d_ff))
    return out


def build_decls(c: ArchConfig) -> Dict[str, Any]:
    """Full parameter declaration tree of the dense and MoE families."""
    _check_ported(c)
    d, v = c.d_model, c.vocab_size
    out: Dict[str, Any] = {
        "embed": P((v, d), ("vocab", "embed"), init="embed"),
        "final_norm": P((d,), (None,), init="zeros"),
    }
    if not c.tie_embeddings:
        out["unembed"] = P((d, v), ("embed", "vocab"))
    if c.family == "dense":
        out["layers"] = _block_decls(c, c.n_layers, moe=False)
    elif c.moe_every == 1:
        out["layers"] = _block_decls(c, c.n_layers, moe=True)
    else:  # llama4: alternating dense / moe pairs
        n_pairs = c.n_layers // 2
        out["dense_layers"] = _block_decls(c, n_pairs, moe=False)
        out["moe_layers"] = _block_decls(c, n_pairs, moe=True)
    return out


def _pairs(c: ArchConfig) -> bool:
    """Whether the stack is llama4's dense / MoE pairs."""
    return c.family == "moe" and c.moe_every != 1


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


def _moe_ffn(c: ArchConfig, p, x):
    """Routed experts (plus the shared expert's SwiGLU): (y, aux)."""
    out = moe_lib.moe_layer(
        x, p["w_router"], p["we_gate"], p["we_up"], p["we_down"],
        top_k=c.top_k, capacity_factor=c.capacity_factor)
    y = out.y
    if c.shared_expert:
        y = y + swiglu(x, p["shared_w_gate"], p["shared_w_up"],
                       p["shared_w_down"])
    return y, out.aux_loss


def _block(c: ArchConfig, p, x, positions, *, moe: bool, causal: bool = True):
    """Pre-norm transformer block; returns (x, aux loss)."""
    x = x + _self_attn(c, p, _norm(c, p, x, "ln1"), positions, causal=causal)
    h = _norm(c, p, x, "ln2")
    if moe:
        y, aux = _moe_ffn(c, p, h)
    else:
        y = _ffn(c, p, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


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


def _layer(c: ArchConfig, positions, moe: bool, x, p):
    return _block(c, cast_compute(p), x, positions, moe=moe)


def _pair(c: ArchConfig, positions, x, p):
    """llama4's pair: the dense layer, then the MoE layer; (x, a1, a2)."""
    p = cast_compute(p)
    x, a1 = _block(c, p["dense"], x, positions, moe=False)
    x, a2 = _block(c, p["moe"], x, positions, moe=True)
    return x, a1, a2


# --------------------------------------------------------------- full forward


def forward(c: ArchConfig, params, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward: tokens (B, S) int -> (logits (B, S, V)
    bf16, aux loss float32).  Each stacked layer tree is unbound once
    into per-layer views, so the gradient of a stacked leaf is one stack
    of its layers' gradients (a slice per layer would add a zero-filled
    stacked tensor per layer)."""
    x = params["embed"][tokens].to(torch.bfloat16)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _pairs(c):
        stacks = {k: {n: t.unbind(0) for n, t in params[k + "_layers"].items()}
                  for k in ("dense", "moe")}
        body = functools.partial(_pair, c, positions)
        for i in range(c.n_layers // 2):
            x, a1, a2 = _remat(c, body, x, {
                k: {n: t[i] for n, t in st.items()}
                for k, st in stacks.items()})
            aux = aux + a1 + a2
    else:
        layers = {k: t.unbind(0) for k, t in params["layers"].items()}
        body = functools.partial(_layer, c, positions, c.family == "moe")
        for l in range(c.n_layers):
            x, a = _remat(c, body, x, {k: t[l] for k, t in layers.items()})
            aux = aux + a
    return _logits(params, x), aux


def loss_fn(c: ArchConfig, params, batch) -> Tuple[torch.Tensor,
                                                   Dict[str, torch.Tensor]]:
    """(ce + aux, {"ce", "aux"}) of a batch {tokens, labels[, mask]}."""
    logits, aux = forward(c, params, batch["tokens"])
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------- KV cache


class KVCache(NamedTuple):
    k: torch.Tensor                 # (L, B, H_eff, S, hd) int8 or bf16
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # (L, B, H_eff, S, 1) f32 when int8
    v_scale: Optional[torch.Tensor]
    pos: torch.Tensor               # (B,) int32 — PER-SLOT filled length


def init_cache(c: ArchConfig, n_layers: int, batch: int, max_seq: int,
               device) -> KVCache:
    """Zero caches, each its own tensor (the serving engine writes slots
    into them in place)."""
    shape = (n_layers, batch, c.kv_eff, max_seq, c.hd)
    pos0 = torch.zeros((batch,), dtype=torch.int32, device=device)
    if c.kv_cache_dtype == "int8":
        z8 = torch.zeros(shape, dtype=torch.int8, device=device)
        sc = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                         device=device)
        return KVCache(z8, z8.clone(), sc, sc.clone(), pos0)
    z = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return KVCache(z, z.clone(), None, None, pos0)


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8: (round(x / scale) clipped to ±127, scale), scale the
    row's largest |x| over 127 (at least 1e-8), rounded half to even.  The
    divisor is a tensor: CUDA turns a division by a Python number into a
    product with its reciprocal."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1, keepdim=True) / torch.full(
        (), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dus_per_slot(cache, new, pos):
    """Per-slot write: cache (B,H,S,..), new (B,H,1,..), pos (B,) — a
    one-hot ``where`` in the cache dtype, as in the JAX package."""
    s = cache.shape[2]
    onehot = (torch.arange(s, dtype=torch.int32, device=cache.device)[None, :]
              == pos[:, None])                                   # (B,S)
    return torch.where(onehot[:, None, :, None], new.to(cache.dtype), cache)


def _cache_write(cache_k, cache_v, sk, sv, k_new, v_new, pos):
    """Write (B,H,1,hd) into per-layer cache slices at per-slot ``pos``
    (B,), quantized with its scales where the cache is int8 (``sk`` not
    None): (cache_k, cache_v, sk, sv)."""
    if sk is not None:
        qk, sck = _quant(k_new)
        qv, scv = _quant(v_new)
        return (_dus_per_slot(cache_k, qk, pos), _dus_per_slot(cache_v, qv, pos),
                _dus_per_slot(sk, sck, pos), _dus_per_slot(sv, scv, pos))
    return (_dus_per_slot(cache_k, k_new, pos),
            _dus_per_slot(cache_v, v_new, pos), None, None)


def _cache_read(ck, cv, sk, sv):
    """The cache slices as bf16 K/V (int8 times its scale, in bf16)."""
    if sk is not None:
        return (ck.to(torch.bfloat16) * sk.to(torch.bfloat16),
                cv.to(torch.bfloat16) * sv.to(torch.bfloat16))
    return ck, cv


# --------------------------------------------------------------- decode


class DecodeState(NamedTuple):
    """The JAX package's DecodeState without the cross-attention K/V of
    the families the port does not run."""
    cache: KVCache


def _decode_self_attn(c: ArchConfig, p, x, cache_layer, pos):
    """Single-token self-attention against one layer's cache slice
    (ck, cv, sk, sv); ``pos`` is the per-slot (B,) position vector.  The
    new K/V are in the compute dtype (bf16) when they are written or
    quantized."""
    q, k, v = _project_qkv(c, p, x, pos[:, None, None])
    cache_layer = _cache_write(*cache_layer, k, v, pos)
    kk, vv = _cache_read(*cache_layer)
    o = attn.decode_attention(q, kk, vv, pos + 1)
    b = x.shape[0]
    o = o.transpose(1, 2).reshape(b, 1, c.n_heads * c.hd)
    return o @ p["wo"], cache_layer


def _decode_block(c: ArchConfig, p, x, cache_layer, pos, *, moe: bool):
    a, cache_layer = _decode_self_attn(c, p, _norm(c, p, x, "ln1"),
                                       cache_layer, pos)
    x = x + a
    h = _norm(c, p, x, "ln2")
    y = _moe_ffn(c, p, h)[0] if moe else _ffn(c, p, h)
    return x + y, cache_layer


def _decode_layers(c: ArchConfig, params) -> Iterator[Tuple[Dict, bool]]:
    """(layer parameters cast for compute, whether MoE), in the cache's
    layer order: the pair layout's dense layer of pair i at 2i and its MoE
    layer at 2i + 1."""
    if _pairs(c):
        for i in range(c.n_layers // 2):
            yield layer_slice(params["dense_layers"], i), False
            yield layer_slice(params["moe_layers"], i), True
    else:
        for l in range(c.n_layers):
            yield layer_slice(params["layers"], l), c.family == "moe"


def decode_step(c: ArchConfig, params, token: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One-token decode: token (B,) int -> (logits (B, V), new state)."""
    cache = state.cache
    pos = cache.pos
    int8 = cache.k_scale is not None
    x = params["embed"][token][:, None, :].to(torch.bfloat16)   # (B,1,D)
    new = []
    for l, (p, moe) in enumerate(_decode_layers(c, params)):
        layer = (cache.k[l], cache.v[l],
                 cache.k_scale[l] if int8 else None,
                 cache.v_scale[l] if int8 else None)
        x, layer = _decode_block(c, p, x, layer, pos, moe=moe)
        new.append(layer)
    ks, vs, sks, svs = zip(*new)
    new_cache = KVCache(torch.stack(ks), torch.stack(vs),
                        torch.stack(sks) if int8 else None,
                        torch.stack(svs) if int8 else None, pos + 1)
    return _logits(params, x)[:, 0], DecodeState(new_cache)

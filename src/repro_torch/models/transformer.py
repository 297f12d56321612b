"""Decoder-only and encoder-decoder transformer stacks (port of
``repro.models.transformer``): qwen3-8b, qwen3-1.7b, phi3-medium-14b,
nemotron-4-340b (dense), qwen3-moe-30b-a3b and llama4-maverick-400b-a17b
(moe), llama-3.2-vision-11b (vlm: gated cross-attention layers over stub
patch embeddings) and whisper-large-v3 (audio: an encoder over stub frame
embeddings and a causal decoder with cross-attention).

* Layers are STACKED (leading L dim) as in the JAX package; its
  ``lax.scan`` over them becomes a loop over layers that slices layer l and
  casts the slice to bf16 (``cast_compute``), so the 1-D norm scales stay
  float32.
* Tensor parallelism (every family, under an active mesh whose
  ``model`` axis has more than one rank; ``launch/train_step.py`` runs
  it).  The parameters come as each rank's blocks of ``param_specs``
  (gathered over ``data``).  The compute splits a dim over ``model`` only
  where the JAX package's sharding constraint at that point resolves to
  ``model`` for that shape, otherwise the weight is gathered over
  ``model`` first (``gather_from``):
  - the attention heads where q's ``heads_act`` resolves: each rank's q
    heads, the K/V heads they read from the replicated ``wk``/``wv``, the
    partial ``wo`` product summed over ``model``.  Self-attention (causal,
    and whisper's non-causal encoder) and cross-attention alike: the
    VLM's and whisper's ``x_`` blocks take K/V from the features (no
    RoPE, non-causal), which enter through ``copy_to``;
  - the FFN where its ``mlp`` dim is stored split: columns of
    ``w_gate``/``w_up``, rows of ``w_down``, then a sum.  This holds for
    the VLM's gated ``x_`` FFN and llama4's shared expert (its own
    ``d_ff_shared``) too.  Whisper's ``b_up`` is split with its columns;
    its ``b_down`` is added once, after the sum;
  - the experts where ``experts_act`` resolves (``models/moe.py``:
    expert parallelism, one sum over ``model`` a layer);
  - the vocabulary where ``vocab_act`` resolves: a masked local
    embedding lookup then a sum; local logit columns into the
    vocab-parallel ``cross_entropy_loss``.  Whisper's 51 866 divides by
    2 and not by 4, so at ``model`` 4 it stays replicated.
  The norms, the VLM's tanh gates and the residual stay replicated over
  ``model``: nemotron's ``shard_residual_embed`` (``embed_act`` ->
  ``model``) only moves its layout.  ``gather_model`` gathers a layer's
  stored-split leaves for the recurrent families (``rwkv6.py``,
  ``ssm.py``), whose JAX modules constrain only ``vocab_act``.
* Dense FFNs follow ``c.activation``: SwiGLU, nemotron's squared ReLU (no
  gate), or whisper's GELU MLP with biases.  Norms follow ``c.norm``: RMS,
  or whisper's layer norm (scale ``1 + p[name]`` and bias ``p[name_b]``).
* MoE: ``moe_every == 1`` routes every layer's FFN through
  ``moe.moe_layer``; otherwise (llama4) the stack is ``n_layers // 2``
  pairs of a dense layer and a MoE layer (``dense_layers`` and
  ``moe_layers``), run dense first, with a shared expert's SwiGLU added
  to the routed output where ``shared_expert`` is set.
* VLM: ``n_layers // cross_attn_every`` groups, each a gated
  cross-attention block (``cross``: attention over the image features
  with no RoPE, then its own FFN, each scaled by tanh of its gate) and
  then ``cross_attn_every`` self-attention layers.  The JAX package casts
  a group's stacked self layers at once, whose (every, d) norm scales are
  2-D, so its VLM rounds them to bf16; the port rounds them too.  The
  image features are cast to bf16 (the input specs' dtype): the JAX
  package takes float32 features as they come and promotes its residual
  stream to float32 after the first cross block.
* Audio: ``encode_audio`` (frames in bf16 plus sinusoid positions, the
  encoder's non-causal self-attention layers, a final layer norm), then
  ``n_layers`` decoder layers, each a causal self-attention block and a
  cross-attention block over the encoder output.
* Remat follows ``c.remat`` as the JAX package's ``jax.checkpoint``
  policy does, around each layer body (or pair, group or decoder layer)
  when autograd records it (grad mode on and the body's input or a
  parameter requiring grad; a prefill runs no checkpoint, as
  ``jax.checkpoint`` acts only under differentiation): ``"full"`` keeps
  only the body's inputs (``torch.utils.checkpoint``), ``"dots"`` also
  the matrix products' outputs (a selective checkpoint), ``"none"``
  everything.  It changes memory, not values.
* ``forward`` returns (logits, aux): the MoE layers' aux losses summed
  in float32 layer by layer (a pair adds its dense layer's 0 and then
  its MoE layer's), 0 for the other families.  ``loss_fn`` is the
  logits' ``cross_entropy_loss`` plus aux.
* Every full-sequence attention goes through ``attention.flash_attention``:
  the hand-written kernel on the card.  Self-attention is causal, the
  audio encoder's is not; cross-attention runs it non-causal with one
  chunk of all the keys, which on CPU tensors is ``full_attention``, the
  JAX package's own cross-attention path.
* KV caches live in (L, B, H_kv_eff, S, hd) stacked form, bf16 or int8,
  with a per-slot (B,) position vector.  The int8 cache keeps a float32
  scale per (layer, slot, head, position): the new K/V row's largest
  magnitude over 127, the row rounded half to even and clipped to
  [-127, 127]; a read is the int8 value times its scale in bf16.  The
  pair layout's cache is in layer order: pair i's dense layer at 2i, its
  MoE layer at 2i + 1.  The VLM and audio decode states also hold the
  cross-attention K/V, projected once from the features
  (``precompute_cross_kv``): (n_cross, B, H_kv_eff, n_features, hd).
* Decode writes the new K/V into a layer's cache slice by a one-hot
  ``where`` (``_dus_per_slot``), as the JAX package does, and returns new
  cache tensors; the inputs are not written.  The JAX package's decode
  casts the new K/V to the cache dtype before ``_quant``, so its int8
  cache quantizes K/V already truncated to integers (ROADMAP Queue 3);
  the port quantizes the bf16 K/V, as the bf16 cache stores them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.launch import collectives as coll
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.common import (ParamDecl, apply_rope, cast_compute,
                                       cross_entropy_loss, gelu_mlp,
                                       layer_norm, rms_norm, squared_relu_mlp,
                                       swiglu, tree_leaves, tree_map)

P = ParamDecl


def _check_family(c: ArchConfig) -> None:
    """Raise for a family this module does not build: the RWKV6 (``ssm``)
    and hybrid (``hybrid``) families are ``models/rwkv6.py`` and
    ``models/ssm.py``; anything else is unknown.  ``build_decls`` calls
    it."""
    if c.family not in ("dense", "moe", "vlm", "audio"):
        raise ValueError(f"family {c.family!r} is not a transformer family")


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
    if c.activation == "swiglu":
        return {
            prefix + "w_gate": P((L, d, d_ff), ("layers", "embed", "mlp")),
            prefix + "w_up": P((L, d, d_ff), ("layers", "embed", "mlp")),
            prefix + "w_down": P((L, d_ff, d), ("layers", "mlp", "embed")),
        }
    if c.activation == "squared_relu":
        return {
            prefix + "w_up": P((L, d, d_ff), ("layers", "embed", "mlp")),
            prefix + "w_down": P((L, d_ff, d), ("layers", "mlp", "embed")),
        }
    # gelu (whisper)
    return {
        prefix + "w_up": P((L, d, d_ff), ("layers", "embed", "mlp")),
        prefix + "b_up": P((L, d_ff), ("layers", "mlp"), init="zeros"),
        prefix + "w_down": P((L, d_ff, d), ("layers", "mlp", "embed")),
        prefix + "b_down": P((L, d), ("layers", "embed"), init="zeros"),
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
        out.update(_ffn_decls(c.replace(activation="swiglu"), L,
                              c.d_ff_shared, "shared_"))
    return out


def _norm_decls(c: ArchConfig, L: int, names: Tuple[str, ...]
                ) -> Dict[str, P]:
    out: Dict[str, P] = {}
    for nm in names:
        out[nm] = P((L, c.d_model), ("layers", None), init="zeros")
        if c.norm == "layer":
            out[nm + "_b"] = P((L, c.d_model), ("layers", None), init="zeros")
    return out


def _block_decls(c: ArchConfig, L: int, *, moe: bool) -> Dict[str, P]:
    out = dict(_attn_decls(c, L))
    out.update(_norm_decls(c, L, ("ln1", "ln2")))
    if moe:
        out.update(_moe_decls(c, L))
    else:
        out.update(_ffn_decls(c, L, c.d_ff))
    return out


def _cross_decls(c: ArchConfig, L: int) -> Dict[str, P]:
    """Cross-attention block (the VLM's gated variant, the whisper
    decoder's)."""
    out = {("x_" + k): v for k, v in _attn_decls(c, L).items()}
    out.update(_norm_decls(c, L, ("x_ln",)))
    if c.family == "vlm":
        # llama-3.2 style gated cross-attention and its own gated FFN
        out["x_attn_gate"] = P((L,), ("layers",), init="zeros")
        out["x_mlp_gate"] = P((L,), ("layers",), init="zeros")
        out.update({("x_" + k): v
                    for k, v in _ffn_decls(c, L, c.d_ff).items()})
        out.update(_norm_decls(c, L, ("x_ln_mlp",)))
    return out


def build_decls(c: ArchConfig) -> Dict[str, Any]:
    """Full parameter declaration tree of the dense, MoE, VLM and audio
    families."""
    _check_family(c)
    d, v = c.d_model, c.vocab_size
    out: Dict[str, Any] = {
        "embed": P((v, d), ("vocab", "embed"), init="embed"),
        "final_norm": P((d,), (None,), init="zeros"),
    }
    if c.norm == "layer":
        out["final_norm_b"] = P((d,), (None,), init="zeros")
    if not c.tie_embeddings:
        out["unembed"] = P((d, v), ("embed", "vocab"))
    if c.family == "dense":
        out["layers"] = _block_decls(c, c.n_layers, moe=False)
    elif c.family == "moe" and c.moe_every == 1:
        out["layers"] = _block_decls(c, c.n_layers, moe=True)
    elif c.family == "moe":  # llama4: alternating dense / moe pairs
        n_pairs = c.n_layers // 2
        out["dense_layers"] = _block_decls(c, n_pairs, moe=False)
        out["moe_layers"] = _block_decls(c, n_pairs, moe=True)
    elif c.family == "vlm":
        out["layers"] = _block_decls(c, c.n_layers, moe=False)
        out["cross"] = _cross_decls(c, c.n_layers // c.cross_attn_every)
    else:  # audio
        out["enc_layers"] = _block_decls(c, c.n_enc_layers, moe=False)
        out["dec_layers"] = _block_decls(c, c.n_layers, moe=False)
        out["dec_cross"] = _cross_decls(c, c.n_layers)
        out["enc_final_norm"] = P((d,), (None,), init="zeros")
        out["enc_final_norm_b"] = P((d,), (None,), init="zeros")
    return out


def _pairs(c: ArchConfig) -> bool:
    """Whether the stack is llama4's dense / MoE pairs."""
    return c.family == "moe" and c.moe_every != 1


def layer_slice(stacked: Dict[str, torch.Tensor], l: int
                ) -> Dict[str, torch.Tensor]:
    """Layer ``l`` of a stacked layer tree, cast for compute."""
    return cast_compute({k: t[l] for k, t in stacked.items()})


# --------------------------------------------------------------- tensor parallel


class TPPlan(NamedTuple):
    """Where the model axis splits the compute: q's heads (``heads``), the
    K/V heads as q's (``kv``: ``kv_eff`` divides too), ``wq``'s columns
    and ``wo``'s rows stored split (``qkv_stored``), the FFN's ``mlp`` dim,
    the vocabulary, the MoE experts and llama4's shared expert's ``mlp``
    dim (``d_ff_shared``)."""
    mesh: Mesh
    n: int
    m: int
    heads: bool
    kv: bool
    qkv_stored: bool
    mlp: bool
    vocab: bool
    experts: bool
    shared_mlp: bool


def tp_plan(c: ArchConfig) -> Optional[TPPlan]:
    """The active mesh's tensor-parallel plan for ``c``; None without a
    mesh or with one rank on ``model``."""
    mesh = shd.active_mesh()
    n = 1 if mesh is None else mesh.axis_size("model")
    if n == 1:
        return None

    def on_model(names, shape, dim):
        return shd.resolve_spec(names, shape).padded(len(shape))[dim] \
            == "model"

    act = ("batch", "heads_act", None, None)
    return TPPlan(
        mesh, n, mesh.coord("model"),
        heads=on_model(act, (1, c.n_heads, 1, c.hd), 1),
        kv=on_model(act, (1, c.kv_eff, 1, c.hd), 1),
        qkv_stored=on_model(("embed", "heads"),
                            (c.d_model, c.n_heads * c.hd), 1),
        mlp=on_model(("embed", "mlp"), (c.d_model, c.d_ff), 1),
        vocab=on_model(("batch", None, "vocab_act"),
                       (1, 1, c.vocab_size), 2),
        experts=on_model(("batch", "experts_act", None, None),
                         (1, c.n_experts, 1, 1), 1),
        shared_mlp=on_model(("embed", "mlp"), (c.d_model, c.d_ff_shared), 1))


def gather_model(tp: TPPlan, decls: Dict[str, P], p: Dict[str, torch.Tensor],
                 keep: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """``p`` (a layer slice, or an unstacked block) with every leaf whose
    stored spec (``decls``: its declarations, stacked ones with the
    leading layer dim) splits a dim over ``model`` gathered over it, but
    the leaves named in ``keep``, which the caller computes split."""
    out = dict(p)
    for k, t in p.items():
        if k in keep:
            continue
        d = decls[k]
        off = len(d.shape) - t.dim()
        spec = shd.resolve_spec(d.names, d.shape).padded(len(d.shape))
        for dim, part in enumerate(spec):
            if part == "model":
                out[k] = coll.gather_from(t, tp.mesh, "model", dim - off)
    return out


def _project_qkv_tp(c: ArchConfig, tp: TPPlan, p, x, positions,
                    prefix: str = "", rope: bool = True,
                    kv_from: Optional[torch.Tensor] = None):
    """``_project_qkv`` for this rank's q heads (``tp.heads``): q from its
    ``wq`` columns, K and V of the KV heads those q heads read (their
    own block where ``kv_eff`` splits too, else one per q head), from the
    replicated ``wk``/``wv`` whose gradients are summed over ``model``;
    ``kv_from`` the replicated features of cross-attention."""
    hd, hq = c.hd, c.n_heads
    mesh = tp.mesh
    b, s = x.shape[0], x.shape[1]
    hl = hq // tp.n
    x = coll.copy_to(x, mesh, "model")
    kv_src = x if kv_from is None else coll.copy_to(kv_from, mesh, "model")
    sk = kv_src.shape[1]
    q = (x @ p[prefix + "wq"]).reshape(b, s, hl, hd)
    # the eff KV head of each local q head, then its original head
    eff = torch.arange(tp.m * hl, (tp.m + 1) * hl) // (hq // c.kv_eff)
    if tp.kv:
        eff = eff[::hq // c.kv_eff]
    orig = eff // (c.kv_eff // c.n_kv_heads)
    lo, hi = int(orig[0]), int(orig[-1]) + 1
    cols = slice(lo * hd, hi * hd)
    k = (kv_src @ coll.copy_to(p[prefix + "wk"], mesh, "model")[:, cols]
         ).reshape(b, sk, hi - lo, hd)
    v = (kv_src @ coll.copy_to(p[prefix + "wv"], mesh, "model")[:, cols]
         ).reshape(b, sk, hi - lo, hd)
    if c.qk_norm:
        q = rms_norm(q, coll.copy_to(p[prefix + "q_norm"], mesh, "model"))
        k = rms_norm(k, coll.copy_to(p[prefix + "k_norm"], mesh, "model"))
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if rope:
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
    idx = (orig - lo).to(x.device)
    return q, k.index_select(1, idx), v.index_select(1, idx)


def _self_attn_tp(c: ArchConfig, tp: TPPlan, p, x, positions, causal):
    """Self-attention on the model axis: this rank's heads and the sum of
    the partial ``wo`` products, or, where q's heads do not split, the
    whole attention on every rank with ``wq``/``wo`` gathered."""
    if not tp.heads:
        return _self_attn(c, _gather_qo(tp, p), x, positions, causal,
                          tp=None)
    q, k, v = _project_qkv_tp(c, tp, p, x, positions)
    o = attn.flash_attention(q, k, v, causal=causal,
                             chunk=min(1024, q.shape[2]))
    b, hl, s, _ = q.shape
    o = o.transpose(1, 2).reshape(b, s, hl * c.hd)
    return coll.reduce_from(o @ p["wo"], tp.mesh, "model")


def _gather_qo(tp: TPPlan, p, prefix: str = ""):
    """``p`` with ``wq``'s columns and ``wo``'s rows gathered over
    ``model`` where they are stored split (q's heads do not split)."""
    if not tp.qkv_stored:
        return p
    return dict(p, **{
        prefix + "wq": coll.gather_from(p[prefix + "wq"], tp.mesh, "model", 1),
        prefix + "wo": coll.gather_from(p[prefix + "wo"], tp.mesh, "model",
                                        0)})


# --------------------------------------------------------------- layer bodies


def _norm(c: ArchConfig, p, x, name: str):
    if c.norm == "layer":
        return layer_norm(x, 1.0 + p[name], p[name + "_b"])
    return rms_norm(x, p[name])


def _project_qkv(c: ArchConfig, p, x, positions, prefix: str = "",
                 rope: bool = True, kv_from: Optional[torch.Tensor] = None):
    """Project to (B,H,S,hd) with qk-norm + RoPE; KV repeated to kv_eff.
    ``kv_from``: the features K and V are projected from (cross-attention,
    no RoPE) instead of ``x``."""
    hd, hq, hkv = c.hd, c.n_heads, c.n_kv_heads
    kv_src = x if kv_from is None else kv_from
    b, sq, sk = x.shape[0], x.shape[1], kv_src.shape[1]
    q = (x @ p[prefix + "wq"]).reshape(b, sq, hq, hd)
    k = (kv_src @ p[prefix + "wk"]).reshape(b, sk, hkv, hd)
    v = (kv_src @ p[prefix + "wv"]).reshape(b, sk, hkv, hd)
    if c.qk_norm:
        q = rms_norm(q, p[prefix + "q_norm"])
        k = rms_norm(k, p[prefix + "k_norm"])
    q = q.transpose(1, 2)  # (B,H,S,hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    if rope:
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
    reps = c.kv_eff // hkv
    return q, attn.repeat_kv(k, reps), attn.repeat_kv(v, reps)


def _self_attn(c: ArchConfig, p, x, positions, causal=True, *,
               tp: Optional[TPPlan] = None):
    if tp is not None:
        return _self_attn_tp(c, tp, p, x, positions, causal)
    q, k, v = _project_qkv(c, p, x, positions)
    o = attn.flash_attention(q, k, v, causal=causal,
                             chunk=min(1024, q.shape[2]))
    b, _, s, _ = q.shape
    o = o.transpose(1, 2).reshape(b, s, c.n_heads * c.hd)
    return o @ p["wo"]


def _ffn(c: ArchConfig, p, x, prefix: str = "", *,
         tp: Optional[TPPlan] = None):
    if tp is not None and (tp.shared_mlp if prefix == "shared_" else tp.mlp):
        # this rank's d_ff columns, then the sum of the partial products;
        # the output bias (whisper's b_down, replicated) once, after it
        bias = p.get(prefix + "b_down")
        if bias is not None:
            p = dict(p, **{prefix + "b_down": torch.zeros_like(bias)})
        y = _ffn(c, p, coll.copy_to(x, tp.mesh, "model"), prefix)
        y = coll.reduce_from(y, tp.mesh, "model")
        return y if bias is None else y + bias.to(y.dtype)
    if c.activation == "swiglu" or prefix == "shared_":
        return swiglu(x, p[prefix + "w_gate"], p[prefix + "w_up"],
                      p[prefix + "w_down"])
    if c.activation == "squared_relu":
        return squared_relu_mlp(x, p[prefix + "w_up"], p[prefix + "w_down"])
    return gelu_mlp(x, p[prefix + "w_up"], p[prefix + "b_up"],
                    p[prefix + "w_down"], p[prefix + "b_down"])


def _moe_ffn(c: ArchConfig, p, x, *, tp: Optional[TPPlan] = None):
    """Routed experts (plus the shared expert's SwiGLU): (y, aux); under
    ``tp`` the experts split over ``model`` where they are stored so."""
    out = moe_lib.moe_layer(
        x, p["w_router"], p["we_gate"], p["we_up"], p["we_down"],
        top_k=c.top_k, capacity_factor=c.capacity_factor,
        split=tp.mesh if tp is not None and tp.experts else None)
    y = out.y
    if c.shared_expert:
        y = y + _ffn(c, p, x, prefix="shared_", tp=tp)
    return y, out.aux_loss


def _block(c: ArchConfig, p, x, positions, *, moe: bool, causal: bool = True):
    """Pre-norm transformer block; returns (x, aux loss)."""
    tp = tp_plan(c)
    x = x + _self_attn(c, p, _norm(c, p, x, "ln1"), positions, causal=causal,
                       tp=tp)
    h = _norm(c, p, x, "ln2")
    if moe:
        y, aux = _moe_ffn(c, p, h, tp=tp)
    else:
        y = _ffn(c, p, h, tp=tp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _gated(c: ArchConfig, p, gate: str, x, y):
    """x + tanh(gate) y for the VLM (the gate's tanh in float32, cast to
    x's dtype), x + y otherwise."""
    if c.family == "vlm":
        return x + torch.tanh(p[gate]).to(x.dtype) * y
    return x + y


def _cross_attn(c: ArchConfig, p, h, kv_feats, tp: Optional[TPPlan]):
    """The ``x_`` attention over the features (no RoPE, non-causal, one
    chunk of all the keys): this rank's q heads and the sum of the
    partial ``x_wo`` products where q's heads split over ``model``."""
    if tp is not None and not tp.heads:
        p, tp = _gather_qo(tp, p, "x_"), None
    if tp is None:
        q, k, v = _project_qkv(c, p, h, None, prefix="x_", rope=False,
                               kv_from=kv_feats)
    else:
        q, k, v = _project_qkv_tp(c, tp, p, h, None, prefix="x_",
                                  rope=False, kv_from=kv_feats)
    o = attn.flash_attention(q, k, v, causal=False, chunk=k.shape[2])
    b, hl, s, _ = q.shape
    o = o.transpose(1, 2).reshape(b, s, hl * c.hd) @ p["x_wo"]
    return o if tp is None else coll.reduce_from(o, tp.mesh, "model")


def _cross_block(c: ArchConfig, p, x, kv_feats):
    """Cross-attention over precomputed features (no RoPE, every feature
    visible), plus the VLM's gated FFN."""
    tp = tp_plan(c)
    o = _cross_attn(c, p, _norm(c, p, x, "x_ln"), kv_feats, tp)
    x = _gated(c, p, "x_attn_gate", x, o)
    if c.family == "vlm":
        m = _ffn(c, p, _norm(c, p, x, "x_ln_mlp"), prefix="x_", tp=tp)
        x = _gated(c, p, "x_mlp_gate", x, m)
    return x


def _logits(c: ArchConfig, params, x):
    """The logits: this rank's vocabulary columns where the vocabulary
    splits over ``model``."""
    x = _norm(c, params, x, "final_norm")
    unembed = params["embed"].T if "unembed" not in params \
        else params["unembed"]
    tp = tp_plan(c)
    if tp is not None and tp.vocab:
        x = coll.copy_to(x, tp.mesh, "model")
    return x @ unembed.to(x.dtype)


def _embed(c: ArchConfig, params, tokens):
    """The token embeddings in bf16; where the vocabulary splits over
    ``model``, each rank looks up the tokens in its rows, zeros elsewhere,
    and the ranks' float32 rows are summed (one term is not zero)."""
    tp = tp_plan(c)
    if tp is None or not tp.vocab:
        return params["embed"][tokens].to(torch.bfloat16)
    table = params["embed"]
    rows = table.shape[0]
    local = tokens - tp.m * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)], 0.0)
    return coll.reduce_from(x, tp.mesh, "model").to(torch.bfloat16)


def _sinusoid(length: int, channels: int, device) -> torch.Tensor:
    """Whisper's sinusoid positions (length, channels), float32, in the
    JAX package's float32 order (its log and divisor as float32
    tensors)."""
    f32 = torch.float32
    pos = torch.arange(length, dtype=f32, device=device)[:, None]
    dim = torch.arange(channels // 2, dtype=f32, device=device)[None, :]
    log_base = torch.log(torch.tensor(10000.0, dtype=f32, device=device))
    inv = torch.exp(-log_base * dim / torch.tensor(
        float(max(1, channels // 2 - 1)), dtype=f32, device=device))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    # the recompute sees the mesh this forward saw, whichever thread runs it
    state, inner = shd.snapshot(), body

    def body(*a):
        with shd.restored(state):
            return inner(*a)

    if c.remat == "full":
        return ckpt.checkpoint(body, *args, use_reentrant=False)
    if c.remat == "dots":
        return ckpt.checkpoint(
            body, *args, use_reentrant=False, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat {c.remat!r}: want full, dots or none")


def _layer(c: ArchConfig, positions, moe: bool, x, p, causal: bool = True):
    return _block(c, cast_compute(p), x, positions, moe=moe, causal=causal)


def _pair(c: ArchConfig, positions, x, p):
    """llama4's pair: the dense layer, then the MoE layer; (x, a1, a2)."""
    p = cast_compute(p)
    x, a1 = _block(c, p["dense"], x, positions, moe=False)
    x, a2 = _block(c, p["moe"], x, positions, moe=True)
    return x, a1, a2


def _group_cast(p):
    """A VLM self layer's parameters cast as the JAX package casts a
    group's stacked layers: every float32 leaf, the (d,) norm scales too,
    to bf16."""
    return tree_map(lambda t: t.to(torch.bfloat16)
                    if t.dtype == torch.float32 and t.dim() >= 1 else t, p)


def _group(c: ArchConfig, positions, x, p, img):
    """A VLM group: the cross-attention block over the image features,
    then ``cross_attn_every`` self-attention layers."""
    x = _cross_block(c, cast_compute(p["cross"]), x, img)
    for lp in p["self"]:
        x, _ = _block(c, _group_cast(lp), x, positions, moe=False)
    return x


def _dec_layer(c: ArchConfig, positions, x, p, enc):
    """A whisper decoder layer: causal self-attention, then
    cross-attention over the encoder's output."""
    p = cast_compute(p)
    x, _ = _block(c, p["self"], x, positions, moe=False)
    return _cross_block(c, p["cross"], x, enc)


def _per_layer(stacked: Dict[str, torch.Tensor]) -> List[Dict]:
    """A stacked layer tree as per-layer views, unbound once: the
    gradient of a stacked leaf is then one stack of its layers' gradients
    (a slice per layer would add a zero-filled stacked tensor per
    layer)."""
    cols = {k: t.unbind(0) for k, t in stacked.items()}
    n = len(next(iter(cols.values())))
    return [{k: col[l] for k, col in cols.items()} for l in range(n)]


def features(c: ArchConfig, img_embeds, enc_embeds):
    """The VLM's image features in bf16, or the audio family's frames;
    raises when the family's are missing."""
    if c.family == "vlm":
        if img_embeds is None:
            raise ValueError("the vlm family needs img_embeds "
                             "(B, n_img_tokens, d_model)")
        return img_embeds.to(torch.bfloat16)
    if c.family == "audio" and enc_embeds is None:
        raise ValueError("the audio family needs enc_embeds "
                         "(B, n_frames, d_model)")
    return enc_embeds


# --------------------------------------------------------------- full forward


def forward(c: ArchConfig, params, tokens: torch.Tensor, *,
            img_embeds: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward: tokens (B, S) int -> (logits (B, S, V)
    bf16, aux loss float32).  ``img_embeds``: (B, n_img, D) for the VLM;
    ``enc_embeds``: (B, n_frames, D) stub frame embeddings for audio."""
    feats = features(c, img_embeds, enc_embeds)
    x = _embed(c, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _pairs(c):
        pairs = zip(_per_layer(params["dense_layers"]),
                    _per_layer(params["moe_layers"]))
        body = functools.partial(_pair, c, positions)
        for dense, moe in pairs:
            x, a1, a2 = _remat(c, body, x, {"dense": dense, "moe": moe})
            aux = aux + a1 + a2
    elif c.family == "vlm":
        every = c.cross_attn_every
        layers = _per_layer(params["layers"])
        body = functools.partial(_group, c, positions)
        for g, cross in enumerate(_per_layer(params["cross"])):
            x = _remat(c, body, x, {"cross": cross, "self": layers[
                g * every:(g + 1) * every]}, feats)
    elif c.family == "audio":
        enc = encode_audio(c, params, feats)
        body = functools.partial(_dec_layer, c, positions)
        for p in zip(_per_layer(params["dec_layers"]),
                     _per_layer(params["dec_cross"])):
            x = _remat(c, body, x, {"self": p[0], "cross": p[1]}, enc)
    else:
        body = functools.partial(_layer, c, positions, c.family == "moe")
        for p in _per_layer(params["layers"]):
            x, a = _remat(c, body, x, p)
            aux = aux + a
    return _logits(c, params, x), aux


def encode_audio(c: ArchConfig, params, enc_embeds: torch.Tensor
                 ) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings (B, n_frames, D): the
    frames in bf16 plus sinusoid positions, the non-causal encoder layers,
    a final layer norm.  Returns (B, n_frames, D) bf16."""
    s = enc_embeds.shape[1]
    dev = enc_embeds.device
    x = enc_embeds.to(torch.bfloat16) + _sinusoid(s, c.d_model, dev).to(
        torch.bfloat16)
    body = functools.partial(_layer, c, torch.arange(s, device=dev), False,
                             causal=False)
    for p in _per_layer(params["enc_layers"]):
        x, _ = _remat(c, body, x, p)
    return layer_norm(x, 1.0 + params["enc_final_norm"],
                      params["enc_final_norm_b"])


def loss_fn(c: ArchConfig, params, batch) -> Tuple[torch.Tensor,
                                                   Dict[str, torch.Tensor]]:
    """(ce + aux, {"ce", "aux"}) of a batch {tokens, labels[, mask]
    [, img_embeds | enc_embeds]}."""
    return lm_loss(c, forward(c, params, batch["tokens"],
                              img_embeds=batch.get("img_embeds"),
                              enc_embeds=batch.get("enc_embeds")), batch)


def lm_loss(c: ArchConfig, out, batch) -> Tuple[torch.Tensor,
                                                Dict[str, torch.Tensor]]:
    """(ce + aux, {"ce", "aux"}) of a forward's (logits, aux): the logits'
    ``cross_entropy_loss``, vocab-parallel where the vocabulary splits
    over ``model``."""
    logits, aux = out
    tp = tp_plan(c)
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"),
                            vocab_axis="model" if tp is not None and tp.vocab
                            else None)
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
    cache: KVCache
    # the VLM's and the audio decoder's cross-attention K/V,
    # (L_cross, B, H_kv_eff, n_features, hd) bf16; None for the others
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None


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


def _decode_cross_attn(c: ArchConfig, p, x, xk, xv):
    """The cross-attention block for one token (B, 1, D) against the
    precomputed K/V of its layer (every feature visible)."""
    q = _norm(c, p, x, "x_ln") @ p["x_wq"]
    b = x.shape[0]
    q = q.reshape(b, 1, c.n_heads, c.hd).transpose(1, 2)
    if c.qk_norm:
        q = rms_norm(q.transpose(1, 2), p["x_q_norm"]).transpose(1, 2)
    o = attn.decode_attention(q, xk, xv, xk.shape[2])
    o = o.transpose(1, 2).reshape(b, 1, c.n_heads * c.hd) @ p["x_wo"]
    x = _gated(c, p, "x_attn_gate", x, o)
    if c.family == "vlm":
        m = _ffn(c, p, _norm(c, p, x, "x_ln_mlp"), prefix="x_")
        x = _gated(c, p, "x_mlp_gate", x, m)
    return x


def _decode_block(c: ArchConfig, p, x, cache_layer, pos, *, moe: bool):
    a, cache_layer = _decode_self_attn(c, p, _norm(c, p, x, "ln1"),
                                       cache_layer, pos)
    x = x + a
    h = _norm(c, p, x, "ln2")
    y = _moe_ffn(c, p, h)[0] if moe else _ffn(c, p, h)
    return x + y, cache_layer


def precompute_cross_kv(c: ArchConfig, params, feats: torch.Tensor,
                        stack_key: str
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of every layer of ``params[stack_key]``,
    projected once from ``feats`` (B, S, D): (L, B, H_kv_eff, S, hd)
    each."""
    b, sk = feats.shape[0], feats.shape[1]
    reps = c.kv_eff // c.n_kv_heads
    ks, vs = [], []
    for l in range(next(iter(params[stack_key].values())).shape[0]):
        lp = layer_slice(params[stack_key], l)
        k = (feats @ lp["x_wk"]).reshape(b, sk, c.n_kv_heads, c.hd)
        v = (feats @ lp["x_wv"]).reshape(b, sk, c.n_kv_heads, c.hd)
        if c.qk_norm:
            k = rms_norm(k, lp["x_k_norm"])
        ks.append(attn.repeat_kv(k.transpose(1, 2), reps))
        vs.append(attn.repeat_kv(v.transpose(1, 2), reps))
    return torch.stack(ks), torch.stack(vs)


def _decode_layers(c: ArchConfig, params) -> Iterator[Tuple[Dict, bool]]:
    """(layer parameters cast for compute, whether MoE), in the cache's
    layer order: the pair layout's dense layer of pair i at 2i and its MoE
    layer at 2i + 1; the VLM's self layers cast as its groups are
    (``_group_cast``), the audio decoder's self layers."""
    if _pairs(c):
        for i in range(c.n_layers // 2):
            yield layer_slice(params["dense_layers"], i), False
            yield layer_slice(params["moe_layers"], i), True
    elif c.family == "vlm":
        for l in range(c.n_layers):
            yield _group_cast({k: t[l] for k, t in params["layers"].items()}
                              ), False
    else:
        stack = params["dec_layers" if c.family == "audio" else "layers"]
        for l in range(c.n_layers):
            yield layer_slice(stack, l), c.family == "moe"


def decode_step(c: ArchConfig, params, token: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One-token decode: token (B,) int -> (logits (B, V), new state).
    The VLM runs group g's cross-attention block before its first self
    layer, the audio decoder layer l's after its self-attention block."""
    cache = state.cache
    pos = cache.pos
    int8 = cache.k_scale is not None
    x = params["embed"][token][:, None, :].to(torch.bfloat16)   # (B,1,D)
    new = []
    for l, (p, moe) in enumerate(_decode_layers(c, params)):
        if c.family == "vlm" and l % c.cross_attn_every == 0:
            g = l // c.cross_attn_every
            x = _decode_cross_attn(c, layer_slice(params["cross"], g), x,
                                   state.cross_k[g], state.cross_v[g])
        layer = (cache.k[l], cache.v[l],
                 cache.k_scale[l] if int8 else None,
                 cache.v_scale[l] if int8 else None)
        x, layer = _decode_block(c, p, x, layer, pos, moe=moe)
        new.append(layer)
        if c.family == "audio":
            x = _decode_cross_attn(c, layer_slice(params["dec_cross"], l), x,
                                   state.cross_k[l], state.cross_v[l])
    ks, vs, sks, svs = zip(*new)
    new_cache = KVCache(torch.stack(ks), torch.stack(vs),
                        torch.stack(sks) if int8 else None,
                        torch.stack(svs) if int8 else None, pos + 1)
    return _logits(c, params, x)[:, 0], state._replace(cache=new_cache)

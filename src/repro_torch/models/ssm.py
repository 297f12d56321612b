"""Mamba2 (SSD) blocks + the Zamba2 hybrid (port of ``repro.models.ssm``;
arXiv:2411.15242).

Zamba2 = a backbone of Mamba2 layers with ONE shared full-attention
transformer block (weights tied across invocations) applied every
``shared_attn_every`` layers on concat(hidden, original embedding) — the
paper's "shared attn blocks".  ``x0`` is the bf16 embedding.

* Mamba2 SSD runs in the chunked parallel form (``_ssd_chunked``, plain
  PyTorch: the JAX module reaches no Pallas kernel): a per-head scalar
  decay a·dt, an intra-chunk masked (C x C) product and an inter-chunk
  (H, N, P) state carried from chunk to chunk.  As in ``rwkv6.py``, the
  intra-chunk weights exponentiate the masked differences of the
  cumulative log-decays (a (C, C) segment sum per head, masked to s <= t
  BEFORE the exp), where the JAX module's exp(lc) · exp(-lc) overflows
  float32 once a chunk's log-decay passes about -88 (ROADMAP Queue 3).
* The shared block's attention goes through ``attention.flash_attention``
  (the hand-written wgmma kernel on the card: causal, no GQA, head dim 64
  at full width); its decode path writes the cache with
  ``attention.update_cache`` at the state's SCALAR position and reads it
  with ``decode_attention``, as the JAX module does.
* Prefill convolves by K shifted adds from zeros (``_causal_conv``);
  decode convolves its rolling (K-1)-token buffer by an einsum, as the JAX
  module does.  Softplus is ``logaddexp(x, 0)`` (``jax.nn.softplus``'s).
* Each Mamba2 layer, and each group (the shared block and its
  ``shared_attn_every`` layers), runs under the full checkpoint when
  autograd records it, as the JAX module's ``nothing_saveable``
  checkpoints, whatever ``c.remat`` says.
* The model axis (a mesh's ``model`` extent above 1): the JAX module
  constrains only ``embed_act`` (replicated) and ``vocab_act``, so the
  port splits the vocabulary as ``models/transformer.py`` does and
  gathers every other stored-split leaf over ``model``
  (``transformer.gather_model``) before replicated compute.  The shared
  block's attention therefore runs every head on every rank:

    leaf                               stored over model   compute
    embed, unembed                     vocab               split
    shared w_gate, w_up (cols),        mlp                 gathered
      w_down (rows)
    shared wq (cols), wo (rows)        heads               gathered
    in_proj (packs z, x, B, C, dt)     mlp (cols)          gathered
    norm_y, out_proj (rows)            mlp                 gathered
    dt_bias, a_log, d_skip             heads               gathered
    ln, conv_w, conv_b, shared wk/wv,  (replicated)        replicated
      shared ln/ln_mlp, final_norm

  The shared SwiGLU's columns are independent, so it could split as the
  dense FFN does; split, its rounded partial sums moved ``shared/wk``'s
  gradient by 0.0295 of its largest magnitude from the unsharded step's
  at REDUCED size on (1, 2) (0.0187 gathered), too near the 2^-5 the
  tests hold.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.graph.structure import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import transformer
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.common import (ParamDecl, apply_rope, cast_compute,
                                       rms_norm)
from repro_torch.models.rwkv6 import checkpointed, pick_chunk

P = ParamDecl


def _dims(c: ArchConfig):
    d_in = c.ssm_expand * c.d_model
    H = d_in // c.ssm_head_dim
    N = c.ssm_state
    G = 1  # n_groups
    conv_ch = d_in + 2 * G * N
    return d_in, H, N, G, conv_ch


def build_decls(c: ArchConfig) -> Dict[str, Any]:
    d, L = c.d_model, c.n_layers
    d_in, H, N, G, conv_ch = _dims(c)
    proj_out = 2 * d_in + 2 * G * N + H
    lyr = {
        "ln": P((L, d), ("layers", None), init="zeros"),
        "in_proj": P((L, d, proj_out), ("layers", "embed", "mlp")),
        "conv_w": P((L, c.conv_width, conv_ch), ("layers", None, None), init="small"),
        "conv_b": P((L, conv_ch), ("layers", None), init="zeros"),
        "dt_bias": P((L, H), ("layers", "heads"), init="zeros"),
        "a_log": P((L, H), ("layers", "heads"), init="zeros"),
        "d_skip": P((L, H), ("layers", "heads"), init="ones"),
        "norm_y": P((L, d_in), ("layers", "mlp"), init="zeros"),
        "out_proj": P((L, d_in, d), ("layers", "mlp", "embed")),
    }
    out: Dict[str, Any] = {
        "embed": P((c.vocab_size, d), ("vocab", "embed"), init="embed"),
        "final_norm": P((d,), (None,), init="zeros"),
        "unembed": P((d, c.vocab_size), ("embed", "vocab")),
        "mamba_layers": lyr,
    }
    if c.shared_attn_every:
        hq = c.n_heads * c.hd
        out["shared"] = {
            "ln": P((2 * d,), (None,), init="zeros"),
            "wq": P((2 * d, hq), ("embed", "heads")),
            "wk": P((2 * d, c.n_kv_heads * c.hd), ("embed", None)),
            "wv": P((2 * d, c.n_kv_heads * c.hd), ("embed", None)),
            "wo": P((hq, d), ("heads", "embed")),
            "ln_mlp": P((2 * d,), (None,), init="zeros"),
            "w_gate": P((2 * d, c.d_ff), ("embed", "mlp")),
            "w_up": P((2 * d, c.d_ff), ("embed", "mlp")),
            "w_down": P((c.d_ff, d), ("mlp", "embed")),
        }
    return out


# ----------------------------------------------------------------- SSD math


def _ssd_chunked(x, dt, a, B, C, state, chunk: int):
    """Chunked SSD scan.

    x: (Bt,S,H,P); dt: (Bt,S,H) (post-softplus); a: (H,) (negative);
    B, C: (Bt,S,N) (one group); state: (Bt,H,N,P) f32.
    Returns (y (Bt,S,H,P) f32, new state).

    Within a chunk, M[t,s] = (C_t.B_s) exp(lc_t - lc_s) dt_s for s <= t:
    the (C, C) log-decay differences per head are masked to s <= t before
    the exp, so every argument is <= 0."""
    bt, s, h, p = x.shape
    n = B.shape[-1]
    assert s % chunk == 0
    nc = s // chunk
    xr = x.reshape(bt, nc, chunk, h, p).permute(1, 0, 3, 2, 4)   # (nc,Bt,H,C,P)
    dtr = dt.reshape(bt, nc, chunk, h).permute(1, 0, 3, 2)       # (nc,Bt,H,C)
    Br = B.reshape(bt, nc, chunk, n).permute(1, 0, 2, 3)         # (nc,Bt,C,N)
    Cr = C.reshape(bt, nc, chunk, n).permute(1, 0, 2, 3)
    t = torch.arange(chunk, device=x.device)
    tri = t[None, :] <= t[:, None]                               # incl diag
    S = state.float()
    ys = []
    for i in range(nc):
        xb32, dtb = xr[i].float(), dtr[i]
        Bb, Cb = Br[i].float(), Cr[i].float()
        lc = torch.cumsum(a[None, :, None] * dtb, dim=-1)         # (Bt,H,C) <=0
        cb = Cb @ Bb.transpose(-1, -2)                            # (Bt,C,C)
        seg = torch.where(tri, lc[..., :, None] - lc[..., None, :],
                          float("-inf"))
        M = cb[:, None] * (torch.exp(seg) * dtb[..., None, :])
        y = M @ xb32
        # inter: y[t] += C_t . (exp(lc_t) S)
        y = y + (Cb[:, None] @ S) * torch.exp(lc)[..., None]
        # state: S' = exp(lc_last) S + sum_s exp(lc_last - lc_s) dt_s B_s x_s
        lc_last = lc[..., -1:]
        w = torch.exp(lc_last - lc) * dtb                         # (Bt,H,C)
        S = torch.exp(lc_last)[..., None] * S + (
            Bb.transpose(-1, -2)[:, None] @ (xb32 * w[..., None]))
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(bt, s, h, p)
    return y, S


def _ssd_step(x, dt, a, B, C, state):
    """One-token SSD: x (Bt,H,P), dt (Bt,H), B/C (Bt,N), state (Bt,H,N,P)."""
    x32 = x.float()
    decay = torch.exp(a[None] * dt)                               # (Bt,H)
    upd = (B.float()[:, None, :, None] * x32[:, :, None, :]
           * dt[:, :, None, None])
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bn,bhnp->bhp", C.float(), state)
    return y, state


def _split_proj(c: ArchConfig, zxbcdt):
    d_in, H, N, G, _ = _dims(c)
    z, xc, B, C, dt = torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H],
                                  dim=-1)
    return z, xc, B, C, dt


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) at every x (``F.softplus``
    switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b):
    """Depthwise causal conv via K shifted adds, in order from zeros.
    x: (B,S,C); w: (K,C)."""
    k = w.shape[0]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, : x.shape[1]]
        y = y + xi.float() * w[i].float()
    return F.silu(y + b.float()).to(x.dtype)


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    """Mamba2 out-norm: rmsnorm(y * silu(z))."""
    y = y * F.silu(z.float()).to(y.dtype)
    return rms_norm(y, scale, eps)


def _mamba_block(c: ArchConfig, p, x, conv_state, ssm_state, *, chunk):
    """x: (B,S,D) normed input.  Returns (y, conv_tail, ssm_state)."""
    b, s, d = x.shape
    d_in, H, N, G, conv_ch = _dims(c)
    zxbcdt = x @ p["in_proj"]
    z, xc, B, C, dt = _split_proj(c, zxbcdt)
    xbc = torch.cat([xc, B, C], dim=-1)                          # (B,S,conv_ch)
    # prepend carried conv tail (K-1 tokens) for cross-segment correctness
    k = c.conv_width
    xbc_ext = torch.cat([conv_state, xbc], dim=1)                # (B,S+K-1,..)
    conv = _causal_conv(xbc_ext, p["conv_w"], p["conv_b"])[:, k - 1:]
    xc2, B2, C2 = torch.split(conv, [d_in, G * N, G * N], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    xh = xc2.reshape(b, s, H, c.ssm_head_dim)
    y, ssm_state = _ssd_chunked(xh, dt, a, B2, C2, ssm_state,
                                chunk=pick_chunk(s, chunk))
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_y"])
    out = y @ p["out_proj"]
    return out, xbc_ext[:, -(k - 1):], ssm_state


def _shared_attn_block(c: ArchConfig, p, x, x0, positions, cache=None,
                       pos=None):
    """Zamba2 shared block on concat(x, x0); returns (x, new kv slice).
    With ``cache`` (ck, cv), one decode step at the scalar ``pos``.  On
    the model axis its stored-split leaves are gathered first."""
    tp = transformer.tp_plan(c)
    if tp is not None:
        p = transformer.gather_model(tp, build_decls(c)["shared"], p)
    b = x.shape[0]
    h2 = rms_norm(torch.cat([x, x0], dim=-1), p["ln"])
    hd, hq, hkv = c.hd, c.n_heads, c.n_kv_heads
    sq = x.shape[1]
    q = (h2 @ p["wq"]).reshape(b, sq, hq, hd).transpose(1, 2)
    k = (h2 @ p["wk"]).reshape(b, sq, hkv, hd).transpose(1, 2)
    v = (h2 @ p["wv"]).reshape(b, sq, hkv, hd).transpose(1, 2)
    q = apply_rope(q, positions, c.rope_theta)
    k = apply_rope(k, positions, c.rope_theta)
    reps = c.kv_eff // hkv
    k = attn_lib.repeat_kv(k, reps)
    v = attn_lib.repeat_kv(v, reps)
    new_kv = None
    if cache is None:
        o = attn_lib.flash_attention(q, k, v, causal=True, chunk=min(1024, sq))
    else:
        ck, cv = cache
        ck, cv = attn_lib.update_cache(ck, cv, k, v, pos)
        o = attn_lib.decode_attention(q, ck, cv, pos + 1)
        new_kv = (ck, cv)
    o = o.transpose(1, 2).reshape(b, sq, hq * hd)
    x = x + o @ p["wo"]
    h2 = rms_norm(torch.cat([x, x0], dim=-1), p["ln_mlp"])
    g = h2 @ p["w_gate"]
    u = h2 @ p["w_up"]
    m = F.silu(g.float()).to(x.dtype) * u
    x = x + m @ p["w_down"]
    return x, new_kv


class ZambaState(NamedTuple):
    conv: torch.Tensor             # (L, B, K-1, conv_ch) bf16
    ssm: torch.Tensor              # (L, B, H, N, P) f32
    attn_k: Optional[torch.Tensor]  # (n_inv, B, H_eff, S_max, hd) bf16
    attn_v: Optional[torch.Tensor]
    pos: torch.Tensor              # () int32: one timeline for every slot


def n_shared_invocations(c: ArchConfig) -> int:
    return c.n_layers // c.shared_attn_every if c.shared_attn_every else 0


def init_state(c: ArchConfig, batch: int, max_seq: int,
               device=None) -> ZambaState:
    """Zero state, each leaf its own tensor (the serving engine writes
    slots into them in place), on ``device`` (the card unless the caller
    names another)."""
    dev = resolve_device(device)
    d_in, H, N, G, conv_ch = _dims(c)
    conv = torch.zeros((c.n_layers, batch, c.conv_width - 1, conv_ch),
                       dtype=torch.bfloat16, device=dev)
    ssm = torch.zeros((c.n_layers, batch, H, N, c.ssm_head_dim),
                      dtype=torch.float32, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    if c.shared_attn_every:
        ninv = n_shared_invocations(c)
        kz = torch.zeros((ninv, batch, c.kv_eff, max_seq, c.hd),
                         dtype=torch.bfloat16, device=dev)
        return ZambaState(conv, ssm, kz, kz.clone(), pos)
    return ZambaState(conv, ssm, None, None, pos)


def _mamba_layer(c: ArchConfig, h, lp):
    """One Mamba2 layer of the prefill, from zero conv and SSM states;
    on the model axis its stored-split leaves gathered first."""
    lp = cast_compute(lp)
    tp = transformer.tp_plan(c)
    if tp is not None:
        lp = transformer.gather_model(tp, build_decls(c)["mamba_layers"], lp)
    b = h.shape[0]
    d_in, H, N, G, conv_ch = _dims(c)
    zc = torch.zeros((b, c.conv_width - 1, conv_ch), dtype=torch.bfloat16,
                     device=h.device)
    zs = torch.zeros((b, H, N, c.ssm_head_dim), dtype=torch.float32,
                     device=h.device)
    y, _, _ = _mamba_block(c, lp, rms_norm(h, lp["ln"]), zc, zs,
                           chunk=c.chunk_size)
    return h + y


def _group(c: ArchConfig, positions, h, shared, layers, x0):
    """The shared block, then the group's Mamba2 layers."""
    h, _ = _shared_attn_block(c, shared, h, x0, positions)
    for lp in layers:
        h = checkpointed(c, functools.partial(_mamba_layer, c), h, lp)
    return h


def forward(c: ArchConfig, params, tokens):
    """Training/prefill forward -> (logits, aux)."""
    b, s = tokens.shape
    x0 = transformer._embed(c, params, tokens)
    x = x0
    positions = torch.arange(s, device=tokens.device)
    every = c.shared_attn_every or (c.n_layers + 1)
    n_groups = c.n_layers // every
    tail = c.n_layers - n_groups * every
    layers = transformer._per_layer(params["mamba_layers"])
    if n_groups:
        shared_c = cast_compute(params["shared"])
        body = functools.partial(_group, c, positions)
        for g in range(n_groups):
            x = checkpointed(c, body, x, shared_c,
                             layers[g * every:(g + 1) * every], x0)
    if tail:
        for lp in layers[-tail:]:
            x = checkpointed(c, functools.partial(_mamba_layer, c), x, lp)
    logits = transformer._logits(c, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(c: ArchConfig, params, batch):
    return transformer.lm_loss(c, forward(c, params, batch["tokens"]),
                               batch)


def _mamba_step(c: ArchConfig, h, lp, conv_st, ssm_st):
    """One Mamba2 layer of one decode step: its conv over the rolling
    buffer by an einsum, the one-token SSD."""
    b = h.shape[0]
    d_in, H, N, G, conv_ch = _dims(c)
    xin = rms_norm(h, lp["ln"])
    zxbcdt = xin @ lp["in_proj"]
    z, xc, B, C, dt = _split_proj(c, zxbcdt)
    xbc = torch.cat([xc, B, C], dim=-1)              # (B,1,conv_ch)
    xbc_ext = torch.cat([conv_st, xbc], dim=1)       # (B,K,conv_ch)
    conv = torch.einsum("bkc,kc->bc", xbc_ext.float(), lp["conv_w"].float())
    conv = F.silu(conv + lp["conv_b"].float()).to(h.dtype)
    xc2, B2, C2 = torch.split(conv, [d_in, G * N, G * N], dim=-1)
    dtv = _softplus(dt[:, 0].float() + lp["dt_bias"].float())
    a = -torch.exp(lp["a_log"].float())
    xh = xc2.reshape(b, H, c.ssm_head_dim)
    y, ssm_st = _ssd_step(xh, dtv, a, B2, C2, ssm_st)
    y = y + lp["d_skip"].float()[None, :, None] * xh.float()
    y = y.reshape(b, 1, d_in).to(h.dtype)
    y = _gated_rmsnorm(y, z, lp["norm_y"])
    h = h + y @ lp["out_proj"]
    return h, xbc_ext[:, 1:], ssm_st


def decode_step(c: ArchConfig, params, token, state: ZambaState):
    """One-token decode with conv/ssm/attn-cache state."""
    x0 = params["embed"][token].to(torch.bfloat16)[:, None]
    x = x0
    pos = state.pos
    every = c.shared_attn_every or (c.n_layers + 1)
    n_groups = c.n_layers // every
    new_conv, new_ssm, new_k, new_v = [], [], [], []

    def mamba(x, l):
        lp = transformer.layer_slice(params["mamba_layers"], l)
        x, cst, sst = _mamba_step(c, x, lp, state.conv[l], state.ssm[l])
        new_conv.append(cst)
        new_ssm.append(sst)
        return x

    for gi in range(n_groups):
        if state.attn_k is not None:
            x, (ck, cv) = _shared_attn_block(
                c, cast_compute(params["shared"]), x, x0, pos[None],
                cache=(state.attn_k[gi], state.attn_v[gi]), pos=pos)
            new_k.append(ck)
            new_v.append(cv)
        for l in range(gi * every, (gi + 1) * every):
            x = mamba(x, l)
    for l in range(n_groups * every, c.n_layers):
        x = mamba(x, l)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ params["unembed"].to(x.dtype))[:, 0]
    nk = torch.stack(new_k) if new_k else state.attn_k
    nv = torch.stack(new_v) if new_v else state.attn_v
    return logits, ZambaState(torch.stack(new_conv), torch.stack(new_ssm),
                              nk, nv, pos + 1)

"""RWKV6 "Finch" — attention-free LM with data-dependent decay (port of
``repro.models.rwkv6``; arXiv:2404.05892).

Structure per layer: time-mix (the WKV6 linear-attention form) + channel-mix.

* data-dependent token-shift (ddlerp): per-projection mix coefficients are
  a base mu plus a low-rank (LoRA) function of the shifted input;
* data-dependent decay: w_t = exp(-exp(w0 + lora_w(x_w,t))) per channel;
* bonus ``u`` ("time_faaaa") for the current token;
* per-head GroupNorm (population variance) and SiLU(g) output gating;
* channel-mix with squared-ReLU.

Layers are stacked (leading L dim) and sliced one at a time, each slice
cast for compute (``cast_compute``: 2-D leaves such as ``u`` and
``decay_w2`` to bf16, the 1-D mus, ``w0`` and norm scales stay float32).
Each layer runs under the full checkpoint when autograd records it, as
the JAX module's ``nothing_saveable`` checkpoint, whatever ``c.remat``
says.  Training/prefill use the chunked parallel form (``_wkv_chunked``,
plain PyTorch: the JAX module reaches no Pallas kernel); decode is the
O(1) recurrence (``_wkv_step``).

The chunked form is the one deviation from the JAX expressions: the JAX
module factorises the intra-chunk weight exp(cum_prev_t - cum_s) into
exp(cum_prev_t) · exp(-cum_s), whose second factor overflows float32 once
a chunk's cumulative log-decay passes about -88 (at init the log-decay is
about -1 a step, so the published chunk of 128 overflows; ROADMAP Queue
3).  The port exponentiates the masked differences themselves, so every
``exp`` argument is <= 0, as the JAX module's docstring intends.

The model axis (a mesh's ``model`` extent above 1): the JAX module
constrains only ``embed_act`` (replicated: the residual stays whole on
every rank) and ``vocab_act``; its ``heads``/``mlp`` names are those of
the stored parameters.  So the port splits the vocabulary as
``models/transformer.py`` does (``_embed``, ``_logits`` and the
vocab-parallel ``cross_entropy_loss``) and gathers every other
stored-split leaf over ``model`` (``transformer.gather_model``) before
replicated compute:

  leaf                              stored over model   compute
  embed, unembed                    vocab               split
  cm_wk (cols), cm_wv (rows)        mlp                 gathered
  wr, wk, wv, wg, wo, cm_wr         heads (cols)        gathered
  u                                 heads               gathered
  mus, tm_w1/w2, decay_w1/w2, w0,   (replicated)        replicated
  ln_x_*, ln1, ln2

The channel mix's columns are independent, so it could split as the
dense FFN does, but a split sums each rank's rounded bf16 partial
product, and the per-head group norm amplifies that: at REDUCED size on
(1, 2) it moved ``ln_x_bias``'s gradient by 0.39 of its largest
magnitude from the unsharded step's (0.020 gathered).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.graph.structure import resolve_device
from repro_torch.models import transformer
from repro_torch.models.arch_config import ArchConfig
from repro_torch.models.common import ParamDecl, cast_compute, rms_norm

P = ParamDecl
MIX = ("r", "k", "v", "g", "w")


def build_decls(c: ArchConfig) -> Dict[str, Any]:
    d, L, r = c.d_model, c.n_layers, c.rwkv_lora_rank
    H = d // c.rwkv_head_dim
    N = c.rwkv_head_dim
    lyr: Dict[str, P] = {
        # ddlerp: base mus + shared lora (x) + per-target loras
        "mu_x": P((L, d), ("layers", None), init="zeros"),
        "tm_w1": P((L, d, 5 * r), ("layers", "embed", None), init="small"),
        "tm_w2": P((L, 5, r, d), ("layers", None, None, "embed"), init="small"),
        "decay_w1": P((L, d, r), ("layers", "embed", None), init="small"),
        "decay_w2": P((L, r, d), ("layers", None, "embed"), init="small"),
        "w0": P((L, d), ("layers", None), init="zeros"),
        "u": P((L, H, N), ("layers", "heads", None), init="small"),
        "ln_x_scale": P((L, d), ("layers", None), init="ones"),
        "ln_x_bias": P((L, d), ("layers", None), init="zeros"),
        "ln1": P((L, d), ("layers", None), init="zeros"),
        "ln2": P((L, d), ("layers", None), init="zeros"),
        # channel mix
        "cm_mu_k": P((L, d), ("layers", None), init="zeros"),
        "cm_mu_r": P((L, d), ("layers", None), init="zeros"),
        "cm_wk": P((L, d, c.d_ff), ("layers", "embed", "mlp")),
        "cm_wv": P((L, c.d_ff, d), ("layers", "mlp", "embed")),
        "cm_wr": P((L, d, d), ("layers", "embed", "heads")),
    }
    for t in MIX:
        lyr[f"mu_{t}"] = P((L, d), ("layers", None), init="zeros")
    for t in ("r", "k", "v", "g", "o"):
        lyr[f"w{t}"] = P((L, d, d), ("layers", "embed", "heads"))
    return {
        "embed": P((c.vocab_size, d), ("vocab", "embed"), init="embed"),
        "final_norm": P((d,), (None,), init="zeros"),
        "unembed": P((d, c.vocab_size), ("embed", "vocab")),
        "layers": lyr,
    }


def checkpointed(c: ArchConfig, body, *args):
    """``body(*args)`` under the full checkpoint when autograd records it
    (the JAX modules' ``nothing_saveable`` checkpoint, whatever
    ``c.remat`` says), as it is otherwise."""
    return transformer._remat(c.replace(remat="full"), body, *args)


# ------------------------------------------------------------- time mix math


def _ddlerp(p, x, xprev):
    """Data-dependent lerp -> dict of mixed inputs for r,k,v,g,w."""
    dx = xprev - x
    xx = x + dx * p["mu_x"].to(x.dtype)
    lora = xx @ p["tm_w1"].to(x.dtype)
    lora = torch.tanh(lora.float()).to(x.dtype)
    b, s, _ = x.shape
    r5 = p["tm_w1"].shape[-1] // 5
    lora = lora.reshape(b, s, 5, r5)
    adj = torch.einsum("bstr,trd->bstd", lora, p["tm_w2"].to(x.dtype))
    out = {}
    for i, t in enumerate(MIX):
        mu = p[f"mu_{t}"].to(x.dtype) + adj[:, :, i]
        out[t] = x + dx * mu
    return out


def _decay(p, xw):
    """log-decay per channel: logw = -exp(w0 + lora_w(xw)) (<= 0)."""
    h = xw @ p["decay_w1"].to(xw.dtype)
    h = torch.tanh(h.float())
    h = h @ p["decay_w2"].float()
    return -torch.exp(torch.clamp(p["w0"].float() + h, -20.0, 8.0))


def _group_norm(x, scale, bias, n_heads, eps=64e-5):
    """Per-head LayerNorm over head_dim (RWKV ln_x), with the population
    variance (``jnp.var``'s)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, correction=0)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return y.reshape(b, s, d) * scale.float() + bias.float()


def pick_chunk(s: int, chunk: int) -> int:
    """Largest divisor of s that is <= chunk (chunked scans need s % c == 0)."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return max(1, c)


def _wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunked WKV6.

    r,k,v: (B,S,H,N); logw: (B,S,H,N) (<=0, f32); u: (H,N);
    state: (B,H,N,N) f32.  Returns (out (B,S,H,N) f32, new state).

    Within a chunk, A[t,s] = sum_n r[t,n] k[s,n] exp(cum_prev[t,n] -
    cum[s,n]) for s < t: the per-channel log-decay differences, a
    (B,H,C,C,N) float32 tensor a chunk (268 MB at rwkv6-1.6b's width, B =
    2, C = 128), are masked to s < t BEFORE the exp, so every argument is
    <= 0.  The inter-chunk term and the state update are the JAX module's
    (their arguments are already <= 0)."""
    b, s, h, n = r.shape
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    def chunks(a):                                   # (nc,B,H,C,N)
        return a.reshape(b, nc, chunk, h, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = (chunks(a) for a in (r, k, v, logw))
    t = torch.arange(chunk, device=r.device)
    strict = (t[None, :] < t[:, None])[:, :, None]   # (C_t, C_s, 1): s < t
    u32 = u.float()[None, :, None, :]
    S = state.float()
    outs = []
    for i in range(nc):
        rb, kb, vb = rc[i].float(), kc[i].float(), vc[i].float()
        wb = wc[i]
        cum = torch.cumsum(wb, dim=2)                # lw_t (inclusive)
        cum_prev = cum - wb                          # lw_{t-1} exclusive
        seg = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]
        dec = torch.exp(torch.where(strict, seg, float("-inf")))
        A = torch.matmul(dec * kb[:, :, None, :, :], rb[..., None])[..., 0]
        # diagonal (current-token) bonus term with u
        diag = torch.sum(rb * u32 * kb, dim=-1)
        out = A @ vb + diag[..., None] * vb
        # inter-chunk: r_t decayed to chunk start @ S
        out = out + (rb * torch.exp(cum_prev)) @ S
        # S' = diag(exp(cum_last)) S + sum_s exp(cum_last - cum_s) k_s v_s^T
        cum_last = cum[:, :, -1:, :]                 # (B,H,1,N)
        S = torch.exp(cum_last[:, :, 0, :, None]) * S + (
            kb * torch.exp(cum_last - cum)).transpose(-1, -2) @ vb
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, n)
    return out, S


def _wkv_step(r, k, v, logw, u, state):
    """One-token WKV6 recurrence. r..: (B,H,N); state (B,H,N,N) f32."""
    r32, k32, v32 = r.float(), k.float(), v.float()
    kv = k32[..., :, None] * v32[..., None, :]
    out = torch.einsum("bhn,bhnm->bhm", r32,
                       state + u.float()[None, :, :, None] * kv)
    state = torch.exp(logw.float())[..., None] * state + kv
    return out, state


# ------------------------------------------------------------- layer fwd


def _time_mix(c: ArchConfig, p, x, xprev_last, state, *, chunk):
    """x: (B,S,D). xprev_last: (B,D) carry (token S-1 of previous segment)."""
    b, s, d = x.shape
    H, N = d // c.rwkv_head_dim, c.rwkv_head_dim
    xprev = torch.cat([xprev_last[:, None], x[:, :-1]], dim=1)
    mixed = _ddlerp(p, x, xprev)
    r = (mixed["r"] @ p["wr"]).reshape(b, s, H, N)
    k = (mixed["k"] @ p["wk"]).reshape(b, s, H, N)
    v = (mixed["v"] @ p["wv"]).reshape(b, s, H, N)
    g = mixed["g"] @ p["wg"]
    logw = _decay(p, mixed["w"]).reshape(b, s, H, N)
    out, state = _wkv_chunked(r, k, v, logw, p["u"], state,
                              chunk=pick_chunk(s, chunk))
    out = _group_norm(out.reshape(b, s, d), p["ln_x_scale"], p["ln_x_bias"], H)
    out = out.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    y = out @ p["wo"]
    return y, x[:, -1], state


def _channel_mix(c, p, x, xprev_last):
    xprev = torch.cat([xprev_last[:, None], x[:, :-1]], dim=1)
    dx = xprev - x
    xk = x + dx * p["cm_mu_k"].to(x.dtype)
    xr = x + dx * p["cm_mu_r"].to(x.dtype)
    k = xk @ p["cm_wk"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    v = k @ p["cm_wv"]
    rg = torch.sigmoid((xr @ p["cm_wr"]).float()).to(x.dtype)
    return rg * v, x[:, -1]


class RWKVState(NamedTuple):
    tm_prev: torch.Tensor   # (L, B, D)  last token fed to time-mix
    cm_prev: torch.Tensor   # (L, B, D)
    wkv: torch.Tensor       # (L, B, H, N, N) f32
    pos: torch.Tensor       # () int32


def init_state(c: ArchConfig, batch: int, device=None) -> RWKVState:
    """Zero state, each leaf its own tensor (the serving engine writes
    slots into them in place), on ``device`` (the card unless the caller
    names another)."""
    dev = resolve_device(device)
    d = c.d_model
    H, N = d // c.rwkv_head_dim, c.rwkv_head_dim
    z = torch.zeros((c.n_layers, batch, d), dtype=torch.bfloat16, device=dev)
    return RWKVState(z, z.clone(),
                     torch.zeros((c.n_layers, batch, H, N, N),
                                 dtype=torch.float32, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev))


def _layer(c: ArchConfig, h, lp, tm_prev, cm_prev, wkv):
    lp = cast_compute(lp)
    tp = transformer.tp_plan(c)
    if tp is not None:
        lp = transformer.gather_model(tp, build_decls(c)["layers"], lp)
    y, tm_new, wkv = _time_mix(c, lp, rms_norm(h, lp["ln1"]), tm_prev, wkv,
                               chunk=c.chunk_size)
    h = h + y
    y, cm_new = _channel_mix(c, lp, rms_norm(h, lp["ln2"]), cm_prev)
    return h + y, tm_new, cm_new, wkv


def forward(c: ArchConfig, params, tokens, state: RWKVState | None = None,
            return_state: bool = False):
    """Training / prefill forward.  Returns (logits, aux[, state])."""
    b, s = tokens.shape
    if state is None:
        state = init_state(c, b, tokens.device)
    x = transformer._embed(c, params, tokens)
    body = functools.partial(_layer, c)
    tm, cm, wkv = [], [], []
    for l, lp in enumerate(transformer._per_layer(params["layers"])):
        x, t_new, c_new, w_new = checkpointed(
            c, body, x, lp, state.tm_prev[l], state.cm_prev[l], state.wkv[l])
        tm.append(t_new)
        cm.append(c_new)
        wkv.append(w_new)
    logits = transformer._logits(c, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_state:
        return logits, aux, RWKVState(torch.stack(tm), torch.stack(cm),
                                      torch.stack(wkv), state.pos + s)
    return logits, aux


def loss_fn(c: ArchConfig, params, batch):
    return transformer.lm_loss(c, forward(c, params, batch["tokens"]),
                               batch)


def decode_step(c: ArchConfig, params, token, state: RWKVState):
    """token: (B,) -> (logits (B,V), state).  O(1) per token."""
    b = token.shape[0]
    d = c.d_model
    H, N = d // c.rwkv_head_dim, c.rwkv_head_dim
    h = params["embed"][token].to(torch.bfloat16)[:, None]  # (B,1,D)
    tm, cm, wkvs = [], [], []
    for l in range(c.n_layers):
        lp = transformer.layer_slice(params["layers"], l)
        xin = rms_norm(h, lp["ln1"])
        mixed = _ddlerp(lp, xin, state.tm_prev[l][:, None])
        r = (mixed["r"] @ lp["wr"]).reshape(b, H, N)
        k = (mixed["k"] @ lp["wk"]).reshape(b, H, N)
        v = (mixed["v"] @ lp["wv"]).reshape(b, H, N)
        g = mixed["g"] @ lp["wg"]
        logw = _decay(lp, mixed["w"]).reshape(b, H, N)
        out, wkv = _wkv_step(r, k, v, logw, lp["u"], state.wkv[l])
        out = _group_norm(out.reshape(b, 1, d), lp["ln_x_scale"],
                          lp["ln_x_bias"], H)
        out = out.to(h.dtype) * F.silu(g.float()).to(h.dtype)
        h = h + out @ lp["wo"]
        y, cm_new = _channel_mix(c, lp, rms_norm(h, lp["ln2"]),
                                 state.cm_prev[l])
        h = h + y
        tm.append(xin[:, 0])
        cm.append(cm_new)
        wkvs.append(wkv)
    x = rms_norm(h, params["final_norm"])
    logits = (x @ params["unembed"].to(x.dtype))[:, 0]
    return logits, RWKVState(torch.stack(tm), torch.stack(cm),
                             torch.stack(wkvs), state.pos + 1)

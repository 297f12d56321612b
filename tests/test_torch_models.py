"""The port's language models ≡ the JAX package's, on the CPU.

The same numpy inputs (made from a seed) and the same weights go through
both packages at the configs' REDUCED sizes (2 to 8 layers, d_model 64 to
96): every registered config, the dense, MoE, VLM (llama-3.2-vision),
audio (whisper), RWKV6 and hybrid (zamba2) families.  The VLM and whisper
take their stub features in bf16, the input specs' dtype (``_side_inputs``); the VLM's tanh gates
are set to 0.5 in both packages (``_live_gates``), since at their init of
0 its cross-attention blocks add nothing.

* ``init_params`` draws the JAX package's weights bit for bit, leaf by leaf
  in the same (sorted-key) order; ``params_from_numpy`` carries a JAX tree
  across unchanged; configs round-trip through ``to_dict``/``from_dict``
  and count the same parameters and model FLOPs.
* Layers: ``repeat_kv`` and ``update_cache`` exactly; ``rms_norm``,
  ``apply_rope``, ``swiglu``, ``full_attention``, the chunked
  ``flash_attention`` and ``decode_attention`` in float32 within 1e-5
  (the frameworks reduce in different orders).  In bf16, ``rms_norm`` and
  ``apply_rope`` round their float32 result once, so they hold one bf16
  ulp of the larger result plus that 1e-5; the others round inside (bf16
  products, bf16 probabilities) and hold ``BF16_REL`` (one bf16 ulp, 2^-8)
  of the output's largest magnitude plus 2^-8 relative.
* The model: prefill logits at (2, 8) and at (1, 2048) (the chunked
  attention path), decode logits over 8 steps, each within ``LOGIT_REL``
  of the row's largest |logit| (eight bf16 ulps of it): a few bf16 ulps of
  disagreement in the hidden state, from bf16 matmuls that sum in other
  orders, spread into every logit at that scale.  The KV cache entries
  (qk-normed and rotated projections, one bf16 rounding in each step)
  hold ``CACHE_REL`` (2^-6) of the cache's largest magnitude plus 2^-6
  relative.
* The MoE configs (qwen3-moe-30b-a3b, llama4-maverick-400b-a17b) compare
  with the JAX package's expert ids forced into the port's routers
  (``tests/test_torch_moe.py``: a near-tie router decision flips on a
  bf16 ulp of input, which is a different expert, not a rounding); the
  port's own ids must equal them wherever decided.  Their logits hold
  ``MOE_LOGIT_REL`` (2^-4): the JAX package's jitted layer body rounds its
  bf16 intermediates otherwise than the op-by-op path the port mirrors,
  and the disagreement grows with depth — the dense configs land at
  0.021–0.026 of the row scale at (1, 2048) with 2 layers and at
  0.026–0.036 with 4 (measured on this CPU); the MoE ones, routed alike,
  at 0.033 (2 layers) and 0.045 (llama4's 4).  Their prefill for the
  decode ≡ prefill check runs at ``capacity_factor = n_experts / top_k``,
  whose capacity is the token count: a prefill at the configs' 1.25 drops
  assignments that a one-token decode step never drops.
* The recurrent families (rwkv6, zamba2) decode from their recurrent
  states, compared leaf by leaf after every step (``_state_close``).
  Their logits hold ``RECURRENT_Q99_REL`` (2^-4) at the 99th-percentile
  row and ``RECURRENT_LOGIT_REL`` (2^-2) at every row.  With random
  weights both are ill-conditioned: rwkv6's per-head group norm divides
  a head's WKV output by that head's own spread, and where the output is
  a cancelling sum the bf16 ulps of its inputs become a large share of
  it.  A 2^-9 relative perturbation of the embedding alone moves the
  port's own logits at (1, 2048) by up to 0.44 (rwkv6) and 0.14 (zamba2)
  of the row scale, 99th percentile 0.12 and 0.07; the port against the
  JAX package: at most 0.175 and 0.038, 99th percentile 0.039 and 0.028
  (measured on the CPU).
* llama4's int8 KV cache: the JAX package's decode casts the new K/V to
  the cache dtype before quantizing, which truncates them to integers
  (ROADMAP Queue 3); the port quantizes the bf16 K/V.  The comparison
  with the JAX package replaces its ``_decode_self_attn`` with one that
  keeps the K/V in bf16 (``_jax_decode_self_attn_bf16``: its own body with
  that cast changed), and the dequantized caches hold ``CACHE_REL`` plus
  one int8 step of their scale.  Against the port's own prefill, an int8
  cache's decode logits hold ``INT8_LOGIT_REL`` (2^-4): each cached row is
  rounded to half a step of its largest magnitude over 127, up to twice a
  bf16 rounding at that scale, in every element of the row.
* ``ServeEngine`` returns the JAX engine's greedy tokens on the same
  requests.  Per request, both packages' decode logits are recomputed on
  one slot along the JAX engine's tokens, giving each step's JAX top-2
  margin and the packages' logit difference d there (itself within
  ``LOGIT_REL``).  A token may differ only at a step whose margin is at
  most 2 d, where the difference can swap the two; the steps from there
  to the request's end are skipped (the two sequences no longer share a
  prefix), and the skipped steps must stay under 10 %.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_moe import (assert_decided_alike, force_port_routing,
                            moe_routers, record_jax_routing)
from repro import configs as j_configs
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import api as j_api
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tr
from repro_torch import configs as t_configs
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api as t_api
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models.arch_config import SHAPE_CELLS, ArchConfig

ARCHS = t_configs.ARCH_IDS
LOGIT_REL = 2.0 ** -5         # of the row's largest |logit|
BF16_REL = 2.0 ** -8          # one bf16 ulp, relative
CACHE_REL = 2.0 ** -6         # four bf16 ulps, relative
F32_TOL = 1e-5
MOE_LOGIT_REL = 2.0 ** -4     # MoE configs routed alike (docstring)
INT8_LOGIT_REL = 2.0 ** -4    # int8-cache decode against prefill
RECURRENT_LOGIT_REL = 2.0 ** -2  # rwkv6, zamba2: every row (docstring)
RECURRENT_Q99_REL = 2.0 ** -4    # rwkv6, zamba2: the 99th-percentile row


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    m = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(j_out, t_out, dtype, rounded_once=False):
    a, b = _np(j_out), _np(t_out)
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(b, a, atol=F32_TOL, rtol=F32_TOL)
    elif rounded_once:
        bound = bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + F32_TOL
        assert np.all(np.abs(a - b) <= bound)
    else:
        np.testing.assert_allclose(b, a, atol=BF16_REL * np.abs(a).max(),
                                   rtol=BF16_REL)


def _logits_close(j_logits, t_logits, rel=LOGIT_REL, q99=None):
    """Within ``rel`` of each row's largest |logit|, and with ``q99`` the
    99th percentile of the rows' shares within it; returns the per-row
    largest difference."""
    a, b = _np(j_logits), _np(t_logits)
    assert a.shape == b.shape and np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    scale = np.abs(a).max(axis=-1)
    assert np.all(diff <= rel * scale), (diff / scale).max()
    if q99 is not None:
        assert np.quantile(diff / scale, 0.99) <= q99
    return diff


def _logit_rel(c) -> float:
    return {"moe": MOE_LOGIT_REL, "hybrid": RECURRENT_LOGIT_REL,
            "ssm": RECURRENT_LOGIT_REL}.get(c.family, LOGIT_REL)


def _logit_q99(c):
    return RECURRENT_Q99_REL if c.family in ("ssm", "hybrid") else None


def _route_like_jax(c, monkeypatch, tp, per_step=False):
    """For a MoE config: the JAX package's expert ids recorded, and the
    port's routers forced to them (``per_step``: call n of a layer takes
    the JAX package's n-th call of that layer, one a decode step).
    Returns (JAX calls, port calls), both empty for a dense config."""
    if c.family != "moe":
        return [], []
    jcalls = record_jax_routing(monkeypatch)
    routers = moe_routers(tp)
    n_moe = len(routers)
    seen = force_port_routing(
        monkeypatch, routers,
        lambda layer, n: jcalls[(n if per_step else 0) * n_moe + layer])
    return jcalls, seen


def _jax_decode_self_attn_bf16(c, p, x, cache_layer, pos):
    """``repro.models.transformer._decode_self_attn`` with the new K/V
    kept in bf16 before ``_cache_write``: the JAX package's own casts them
    to the cache dtype, so its int8 cache quantizes K/V truncated to
    integers (ROADMAP Queue 3)."""
    ck, cv, sk, sv = cache_layer
    q, k, v = j_tr._project_qkv(c, p, x, pos[:, None, None])
    k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    ck, cv, sk, sv = j_tr._cache_write(ck, cv, sk, sv, k, v, pos)
    kk, vv = j_tr._cache_read(ck, cv, sk, sv)
    o = j_attn.decode_attention(q, kk, vv, pos + 1)
    b = x.shape[0]
    o = o.transpose(0, 2, 1, 3).reshape(b, 1, c.n_heads * c.hd)
    return jnp.einsum("bsh,hd->bsd", o, p["wo"]), (ck, cv, sk, sv)


def _cache_close(j_cache, t_cache):
    """K and V of two caches: bf16 within CACHE_REL of the largest
    magnitude plus CACHE_REL relative; int8 dequantized (value times its
    scale), with one int8 step of the larger scale more."""
    if t_cache.k_scale is None:
        pairs = [(j_cache.k, t_cache.k, 0.0), (j_cache.v, t_cache.v, 0.0)]
        assert t_cache.k.dtype == torch.bfloat16
    else:
        assert t_cache.k.dtype == torch.int8
        pairs = [(_np(j_q) * _np(j_s), _np(t_q) * _np(t_s),
                  np.maximum(_np(j_s), _np(t_s)))
                 for j_q, j_s, t_q, t_s in (
                     (j_cache.k, j_cache.k_scale, t_cache.k, t_cache.k_scale),
                     (j_cache.v, j_cache.v_scale, t_cache.v, t_cache.v_scale))]
    for a, b, step in pairs:
        a, b = _np(a), _np(b)
        bound = CACHE_REL * np.abs(a).max() + CACHE_REL * np.abs(a) + step
        assert np.all(np.abs(a - b) <= bound)


def _side_inputs(c, b, seed):
    """The VLM's image features or whisper's frames for a batch of ``b``,
    bf16 in both packages: (JAX kwargs, port kwargs), empty for the
    other families."""
    key = {"vlm": "img_embeds", "audio": "enc_embeds"}.get(c.family)
    if key is None:
        return {}, {}
    n = c.n_img_tokens if c.family == "vlm" else c.n_frames
    e = np.random.default_rng(seed).standard_normal(
        (b, n, c.d_model)).astype(np.float32)
    return ({key: jnp.asarray(e, jnp.bfloat16)},
            {key: torch.from_numpy(e).to(torch.bfloat16)})


def _live_gates(c, params, value=0.5):
    """The VLM's parameter tree (either package's) with its
    cross-attention gates at ``value`` (they start at 0, where the cross
    blocks add nothing); the tree as it is for the other families."""
    if c.family != "vlm":
        return params
    gates = ("x_attn_gate", "x_mlp_gate")
    cross = params["cross"]
    full = torch.full_like if torch.is_tensor(cross[gates[0]]) \
        else jnp.full_like
    return dict(params, cross={k: full(v, value) if k in gates else v
                               for k, v in cross.items()})


def _pair(arr, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX config, port config, JAX model, port model, JAX
    params, port params) at REDUCED with seed 0."""
    out = {}
    for arch in ARCHS:
        jc = j_configs.get(arch, reduced=True)
        tc = t_configs.get(arch, reduced=True)
        jm, tm = j_api.build(jc), t_api.build(tc)
        out[arch] = (jc, tc, jm, tm, j_common.init_params(jm.decls, seed=0),
                     t_common.init_params(tm.decls, seed=0, device="cpu"))
    return out


# ------------------------------------------------------------ config, init


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_round_trips_and_counts(arch, reduced):
    jc = j_configs.get(arch, reduced=reduced)
    tc = t_configs.get(arch, reduced=reduced)
    assert ArchConfig.from_dict(jc.to_dict()) == tc
    assert tc.to_dict() == jc.to_dict()
    assert (tc.hd, tc.kv_eff) == (jc.hd, jc.kv_eff)
    assert tc.total_params() == jc.total_params()
    assert tc.active_params() == jc.active_params()
    jm, tm = j_api.build(jc), t_api.build(tc)
    for cell in SHAPE_CELLS:
        assert tm.model_flops(cell) == jm.model_flops(cell)


def test_shape_cells_match():
    from repro.models.arch_config import SHAPE_CELLS as J_CELLS
    from repro.models.arch_config import cell_applicable as j_applicable
    from repro_torch.models.arch_config import cell_applicable
    assert [c.to_dict() for c in SHAPE_CELLS] == [c.to_dict() for c in J_CELLS]
    cfg = t_configs.get("qwen3-1.7b")
    jcfg = j_configs.get("qwen3-1.7b")
    for tc, jc in zip(SHAPE_CELLS, J_CELLS):
        assert cell_applicable(cfg, tc) == j_applicable(jcfg, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_bit_identical(arch, models):
    _, _, jm, tm, jp, tp = models[arch]
    j_leaves, _ = jax.tree.flatten(jp)
    t_leaves = t_common.tree_leaves(tp)
    j_paths = [jax.tree_util.keystr(p)
               for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    t_paths = []

    def walk(tree, prefix):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], f"{prefix}['{k}']")
            else:
                t_paths.append(f"{prefix}['{k}']")
    walk(tp, "")
    assert t_paths == j_paths
    for a, b in zip(j_leaves, t_leaves):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert t_common.param_count(tp) == sum(a.size for a in j_leaves)


def test_params_from_numpy_round_trips_a_jax_tree(models):
    _, _, _, _, jp, _ = models["qwen3-1.7b"]
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["extra_bf16"] = np.asarray(
        jnp.asarray(_randn(np.random.default_rng(1), 3, 5), jnp.bfloat16))
    out = t_common.params_from_numpy(tree, device="cpu")
    flat = jax.tree.leaves(tree)
    assert len(flat) == len(t_common.tree_leaves(out))
    for a, b in zip(flat, t_common.tree_leaves(out)):
        want = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        assert b.dtype == want
        np.testing.assert_array_equal(b.float().numpy(), a.astype(np.float32))


def test_cast_compute_keeps_1d_leaves_f32():
    tree = {"w": torch.zeros(3, 4), "n": torch.zeros(4),
            "i": torch.zeros(3, 4, dtype=torch.int32)}
    out = t_common.cast_compute(tree)
    assert out["w"].dtype == torch.bfloat16
    assert out["n"].dtype == torch.float32
    assert out["i"].dtype == torch.int32


def test_unported_parts_raise():
    """Every family of the JAX registry builds (the RWKV6 and hybrid SSM
    families too); an unknown family raises ``ValueError``, and so does
    the transformer module asked for another family's declarations;
    ``loss_fn`` is ported."""
    from repro_torch.models import transformer as t_tr

    for arch in ("rwkv6-1.6b", "zamba2-1.2b"):
        c = ArchConfig.from_dict(j_configs.get(arch, reduced=True).to_dict())
        assert t_api.build(c).decls
        with pytest.raises(ValueError, match="not a transformer family"):
            t_tr.build_decls(c)
    with pytest.raises(ValueError, match="unknown family"):
        t_api.build(t_configs.get("qwen3-1.7b", reduced=True).replace(
            family="mlp"))
    c = t_configs.get("qwen3-1.7b", reduced=True)
    m = t_api.build(c)
    # loss_fn is ported: a finite (loss, {"ce", "aux"})
    toks = torch.from_numpy(np.arange(16).reshape(2, 8))
    loss, metrics = m.loss_fn(
        t_common.init_params(m.decls, device="cpu"),
        {"tokens": toks, "labels": toks})
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert set(metrics) == {"ce", "aux"}


def _spec_leaves(tree) -> list:
    """The ``TensorSpec`` leaves of a state of specs, in field order."""
    if isinstance(tree, t_api.TensorSpec):
        return [tree]
    if tree is None:
        return []
    return [x for field in tree for x in _spec_leaves(field)]


def test_decode_state_specs_match(models):
    """Every leaf of the decode state's specs has the JAX package's shape,
    and a real state (``init_decode_state``) the spec's shape and dtype:
    the KV cache (per-slot positions), RWKV6's and Zamba2's recurrent
    states (one scalar position)."""
    cell = SHAPE_CELLS[2]
    small = cell.replace(seq_len=16, global_batch=2)
    for arch in ("qwen3-1.7b", "rwkv6-1.6b", "zamba2-1.2b"):
        _, _, jm, tm, _, tp = models[arch]
        j = jax.tree.leaves(jm.decode_state_specs(cell))
        t = _spec_leaves(tm.decode_state_specs(cell))
        assert [tuple(x.shape) for x in t] == [tuple(x.shape) for x in j]
        for a, b in zip(j, t):
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
        real = t_common.tree_leaves(tm.init_decode_state(tp, 2, 16))
        spec = _spec_leaves(tm.decode_state_specs(small))
        assert [(tuple(x.shape), x.dtype) for x in real] == [
            (tuple(x.shape), x.dtype) for x in spec]


# ------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_swiglu_match(dtype):
    rng = np.random.default_rng(7)
    xj, xt = _pair(_randn(rng, 2, 3, 5, 16), dtype)
    sj, st = _pair(_randn(rng, 16) * 0.1, "float32")
    _close(j_common.rms_norm(xj, sj), t_common.rms_norm(xt, st), dtype,
           rounded_once=True)
    pos = np.arange(5)
    _close(j_common.apply_rope(xj, jnp.asarray(pos), 1e6),
           t_common.apply_rope(xt, torch.from_numpy(pos), 1e6), dtype,
           rounded_once=True)
    dpos = np.array([3, 9])[:, None, None]
    _close(j_common.apply_rope(xj, jnp.asarray(dpos), 1e4),
           t_common.apply_rope(xt, torch.from_numpy(dpos), 1e4), dtype,
           rounded_once=True)
    x2j, x2t = _pair(_randn(rng, 2, 5, 16), dtype)
    ws = [_pair(_randn(rng, *s) * 0.25, dtype)
          for s in ((16, 32), (16, 32), (32, 16))]
    _close(j_common.swiglu(x2j, *[w[0] for w in ws]),
           t_common.swiglu(x2t, *[w[1] for w in ws]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repeat_kv_and_update_cache_are_exact(dtype):
    rng = np.random.default_rng(8)
    kj, kt = _pair(_randn(rng, 2, 3, 4, 8), dtype)
    for reps in (1, 2, 4):
        np.testing.assert_array_equal(_np(t_attn.repeat_kv(kt, reps)),
                                      _np(j_attn.repeat_kv(kj, reps)))
    cj, ct = _pair(_randn(rng, 2, 3, 10, 8), dtype)
    vj, vt = _pair(_randn(rng, 2, 3, 10, 8), dtype)
    for pos in (0, 4, 7, 9):                  # 9: clamped to fit
        a = j_attn.update_cache(cj, vj, kj, kj, jnp.int32(pos))
        b = t_attn.update_cache(ct, vt, kt, kt, pos)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(_np(y), _np(x))
    assert torch.equal(ct, torch.from_numpy(_np(cj)).to(ct.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_paths_match(dtype):
    rng = np.random.default_rng(9)
    b, hq, hk, d = 1, 4, 2, 16
    qj, qt = _pair(_randn(rng, b, hq, 2048, d), dtype)
    kj, kt = _pair(_randn(rng, b, hk, 2048, d), dtype)
    vj, vt = _pair(_randn(rng, b, hk, 2048, d), dtype)
    # the chunked online softmax (S = 2048, chunk 1024) and the dense path
    _close(j_attn.flash_attention(qj, kj, vj, causal=True, chunk=1024),
           t_attn.flash_attention(qt, kt, vt, causal=True, chunk=1024), dtype)
    s = 200
    _close(j_attn.full_attention(qj[:, :, :s], kj[:, :, :s], vj[:, :, :s],
                                 causal=True),
           t_attn.full_attention(qt[:, :, :s], kt[:, :, :s], vt[:, :, :s],
                                 causal=True), dtype)
    _close(j_attn.flash_attention(qj[:, :, :s], kj[:, :, :s], vj[:, :, :s],
                                  causal=False, chunk=1024),
           t_attn.flash_attention(qt[:, :, :s], kt[:, :, :s], vt[:, :, :s],
                                  causal=False, chunk=1024), dtype)
    # decode: one query against a partly filled cache, per-slot lengths
    q1j, q1t = _pair(_randn(rng, 2, hq, 1, d), dtype)
    cj, ct = _pair(_randn(rng, 2, hk, 64, d), dtype)
    for vl in (np.int32(17), np.array([5, 64], np.int32)):
        _close(j_attn.decode_attention(q1j, cj, cj, jnp.asarray(vl)),
               t_attn.decode_attention(q1t, ct, ct, torch.tensor(vl)),
               dtype)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bs", [(2, 8), (1, 2048)])
def test_prefill_logits_match(arch, bs, models, monkeypatch):
    jc, tc, jm, tm, jp, tp = models[arch]
    jp, tp = _live_gates(tc, jp), _live_gates(tc, tp)
    toks = np.random.default_rng(bs[1]).integers(0, jc.vocab_size, bs)
    jside, tside = _side_inputs(tc, bs[0], bs[1] + 1)
    jcalls, seen = _route_like_jax(tc, monkeypatch, tp)
    a = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32), **jside})
    b = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks), **tside})
    assert b.dtype == torch.bfloat16
    assert len(seen) == len(jcalls)
    assert_decided_alike(seen)
    _logits_close(a, b, _logit_rel(tc), _logit_q99(tc))


def _state_close(j_state, t_state):
    """Every leaf of two decode states (the RWKV6 and Zamba2 recurrent
    states: time-mix and channel-mix carries, WKV and SSM states, conv
    buffers, the shared block's caches): integers equal, floats within
    CACHE_REL of the leaf's largest magnitude plus CACHE_REL relative
    (the bf16 carries hold one rounding a step, the float32 states sum
    the bf16 projections' ulps)."""
    j_leaves = jax.tree.leaves(j_state)
    t_leaves = t_common.tree_leaves(t_state)
    assert len(j_leaves) == len(t_leaves)
    for a, t in zip(j_leaves, t_leaves):
        assert tuple(t.shape) == tuple(a.shape)
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        a, b = _np(a), _np(t)
        if not t.is_floating_point():
            np.testing.assert_array_equal(b, a)
        bound = CACHE_REL * np.abs(a).max() + CACHE_REL * np.abs(a)
        assert np.all(np.abs(a - b) <= bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_and_cache_match(arch, models, monkeypatch):
    """Eight decode steps: logits within the family's tolerance, and the
    state after every step: a KV cache (``_cache_close``, positions
    equal) or the recurrent families' state (``_state_close``, the scalar
    position equal)."""
    jc, tc, jm, tm, jp, tp = models[arch]
    jp, tp = _live_gates(tc, jp), _live_gates(tc, tp)
    B, S = 2, 8
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (B, S))
    jside, tside = _side_inputs(tc, B, 12)
    jcalls, seen = _route_like_jax(tc, monkeypatch, tp, per_step=True)
    if tc.kv_cache_dtype == "int8":
        monkeypatch.setattr(j_tr, "_decode_self_attn",
                            _jax_decode_self_attn_bf16)
    js = jm.init_decode_state(jp, B, 16, **jside)
    ts = tm.init_decode_state(tp, B, 16, **tside)
    recurrent = tc.family in ("ssm", "hybrid")
    if tside:       # the cross-attention K/V, projected once
        for a, b in ((js.cross_k, ts.cross_k), (js.cross_v, ts.cross_v)):
            assert b.dtype == torch.bfloat16 and b.shape == a.shape
            a, b = _np(a), _np(b)
            assert np.all(np.abs(a - b) <= CACHE_REL * np.abs(a).max()
                          + CACHE_REL * np.abs(a))
    elif not recurrent:
        assert ts.cross_k is None and ts.cross_v is None
    for t in range(S):
        jl, js = jm.decode_fn(jp, jnp.asarray(toks[:, t], jnp.int32), js)
        tl, ts = tm.decode_fn(tp, torch.from_numpy(toks[:, t]), ts)
        _logits_close(jl, tl, _logit_rel(tc), _logit_q99(tc))
        if recurrent:
            assert int(ts.pos) == int(js.pos) == t + 1
            _state_close(js, ts)
            continue
        np.testing.assert_array_equal(ts.cache.pos.numpy(),
                                      np.asarray(js.cache.pos))
        _cache_close(js.cache, ts.cache)
    assert len(seen) == len(jcalls)
    assert_decided_alike(seen)
    if tc.family == "hybrid":
        assert not ts.attn_k[:, :, :, S:].any()
    elif not recurrent:
        assert not ts.cache.k[:, :, :, S:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, models, monkeypatch):
    """Greedy next token from the decode path == argmax of the prefill
    logits (tests/test_models_smoke.py's check, on the port alone).  A
    MoE config's prefill runs at a capacity that drops nothing, and its
    decode steps take the prefill's expert ids (their own must equal
    them wherever decided)."""
    jc, tc, _, tm, _, _ = models[arch]
    params = t_common.init_params(tm.decls, seed=1, device="cpu")
    params = _live_gates(tc, params)
    B, S = 2, 8
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, tc.vocab_size, (B, S)))
    side = _side_inputs(tc, B, 6)[1]
    rel = LOGIT_REL
    if tc.family == "moe":
        routers = moe_routers(params)
        recorded = force_port_routing(monkeypatch, routers, None)
        prefill = t_api.build(tc.replace(
            capacity_factor=tc.n_experts / tc.top_k)).prefill_fn
        logits = prefill(params, {"tokens": toks, **side})
        ids = [own.reshape(B, S, -1) for _, own, _, _ in recorded]
        seen = force_port_routing(monkeypatch, routers,
                                  lambda layer, n: ids[layer][:, n])
        rel = MOE_LOGIT_REL
    else:
        logits = tm.prefill_fn(params, {"tokens": toks, **side})
        rel = _logit_rel(tc)
    if tc.kv_cache_dtype == "int8":
        rel = max(rel, INT8_LOGIT_REL)
    st = tm.init_decode_state(params, B, 16, **side)
    for t in range(S):
        dl, st = tm.decode_fn(params, toks[:, t], st)
    np.testing.assert_array_equal(torch.argmax(logits[:, -1], -1).numpy(),
                                  torch.argmax(dl, -1).numpy())
    _logits_close(logits[:, -1], dl, rel)
    if tc.family == "moe":
        assert len(seen) == len(ids) * S
        assert_decided_alike(seen)


def _step_logits(jax_decode, jm, jp, tm, tp, seq, max_seq):
    """Both packages' decode logits after each token of ``seq``, on one
    slot: [(JAX logits, port logits), ...]."""
    js, ts = jm.init_decode_state(jp, 1, max_seq), tm.init_decode_state(
        tp, 1, max_seq)
    out = []
    for t in seq:
        jl, js = jax_decode(jp, jnp.full((1,), t, jnp.int32), js)
        tl, ts = tm.decode_fn(tp, torch.full((1,), t), ts)
        out.append((_np(jl)[0], _np(tl)[0]))
    return out


def test_serve_engine_matches_jax(models):
    jc, tc, jm, tm, jp, tp = models["qwen3-1.7b"]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist()
               for n in (3, 6, 2, 9, 4, 5)]
    max_new, max_seq = 8, 32
    jdone = JServeEngine(jc, jp, batch_slots=2, max_seq=max_seq).run(
        [JRequest(prompt=p, max_new=max_new) for p in prompts])
    tdone = ServeEngine(tc, tp, batch_slots=2, max_seq=max_seq,
                        device="cpu").run(
        [Request(prompt=p, max_new=max_new) for p in prompts])
    assert len(tdone) == len(prompts)
    by_prompt = {tuple(r.prompt): r.output for r in jdone}
    jax_decode = jax.jit(jm.decode_fn)
    skipped = total = 0
    for r in tdone:
        assert len(r.output) == max_new
        want = by_prompt[tuple(r.prompt)]
        steps = _step_logits(jax_decode, jm, jp, tm, tp,
                             list(r.prompt) + want[:-1],
                             max_seq)[len(r.prompt) - 1:]
        total += len(steps)
        for j, (jl, tl) in enumerate(steps):
            d = float(_logits_close(jl, tl))
            top2 = np.sort(jl)[-2:]
            if r.output[j] == want[j]:
                continue
            if top2[1] - top2[0] > 2 * d:
                pytest.fail(f"prompt {r.prompt} step {j}: port token "
                            f"{r.output[j]}, JAX {want[j]} with margin "
                            f"{top2[1] - top2[0]} > 2 * {d}")
            skipped += len(steps) - j           # diverged at a near-tie
            break
    assert total == len(prompts) * max_new
    assert skipped <= 0.1 * total, (skipped, total)


def test_serve_engine_recycles_slots():
    c = t_configs.get("qwen3-1.7b", reduced=True)
    m = t_api.build(c)
    params = t_common.init_params(m.decls, seed=0, device="cpu")
    eng = ServeEngine(c, params, batch_slots=2, max_seq=64, device="cpu")
    done = eng.run([Request(prompt=[i + 1], max_new=2) for i in range(5)])
    assert len(done) == 5
    assert all(len(r.output) == 2 for r in done)
    single = ServeEngine(c, params, batch_slots=1, max_seq=64, device="cpu")
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    outs = [single.run([Request(prompt=p, max_new=6)])[0].output
            for p in prompts]
    multi = eng.run([Request(prompt=p, max_new=6) for p in prompts])
    assert sorted(r.output for r in multi) == sorted(outs)

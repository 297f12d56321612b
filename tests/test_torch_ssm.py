"""The port's RWKV6 and Zamba2 (Mamba2 + shared attention) ≡ the JAX
package's, on the CPU, at the configs' REDUCED sizes.

The same numpy inputs (made from a seed) go through both packages; the
JAX side runs on its CPU backend.  Tolerances, each test's own:

* ``F32_REL`` (1e-5 of the output's largest magnitude): float32 in, float32
  out (the chunked scans and their one-token steps at chunk 8, where the
  JAX chunked form is finite).  The port's intra-chunk weights are
  exp(cum_prev_t - cum_s) itself, the JAX module's exp(cum_prev_t) ·
  exp(-cum_s): the same function in another rounding.
* ``SCAN_REL`` (1e-4 of the output's largest magnitude): the port's
  chunked scans at the published chunk of 128, where the JAX chunked form
  overflows float32 (log-decay -1 a step; ROADMAP Queue 3), against the
  JAX one-token recurrence scanned token by token: the cumulative
  log-decays reach -128 a chunk, and their float32 differences carry
  about 128 · 2^-24 relative each.
* ``BF16_REL`` (2^-8, one bf16 ulp, of the largest magnitude plus
  relative): the layer functions on bf16 inputs and bf16 weights, whose
  bf16 products the two frameworks sum in other orders.  Functions that
  chain several bf16 products (``_time_mix``, ``_mamba_block``, the shared
  block) hold ``CHAIN_REL`` (2^-6): each product's rounding feeds the next.

The five properties of ``tests/test_sequence_models.py`` hold on the port
alone, with that file's tolerances: chunk-size invariance of both models,
decode as the exact recurrence, state carried across segments, and the
shared block tied.  ``ServeEngine`` gives the JAX ``ServeEngine``'s greedy
tokens for both models on three requests over two slots (a slot
recycles); Zamba2's scalar position is the JAX "shared timeline" (the
one-slot state's replaces the batch's at each prefill), mirrored.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import api as j_api
from repro.models import common as j_common
from repro.models import rwkv6 as j_rwkv
from repro.models import ssm as j_ssm
from repro_torch import configs as t_configs
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api as t_api
from repro_torch.models import common as t_common
from repro_torch.models import rwkv6 as t_rwkv
from repro_torch.models import ssm as t_ssm

F32_REL = 1e-5
SCAN_REL = 1e-4
BF16_REL = 2.0 ** -8
CHAIN_REL = 2.0 ** -6
RWKV, ZAMBA = "rwkv6-1.6b", "zamba2-1.2b"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per worker (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _near(j_out, t_out, rel):
    """Within ``rel`` of the JAX output's largest magnitude plus ``rel``
    relative, shapes equal and the port's output finite."""
    a, b = _np(j_out), _np(t_out)
    assert a.shape == b.shape and np.isfinite(b).all()
    err = np.abs(a - b)
    assert np.all(err <= rel * np.abs(a).max() + rel * np.abs(a)), (
        err.max() / np.abs(a).max())


def _pair(a, dtype="float32"):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a, jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _layer_params(decls, rng):
    """One layer of a stacked decl tree with every leaf drawn at random
    (the zero and one inits would leave the mixes and norms idle): a
    matrix at 1/sqrt(fan-in), a vector at 0.1 (``a_log`` and ``dt_bias``
    at 0.5, so the decay varies); (JAX tree, port tree), each cast for
    compute as the models cast a layer slice."""
    out = {}
    for k, d in decls.items():
        shape = d.shape[1:]
        scale = (1 / np.sqrt(shape[-2]) if len(shape) >= 2 else
                 0.5 if k in ("a_log", "dt_bias") else 0.1)
        out[k] = _randn(rng, *shape, scale=scale)
    j = j_common.cast_compute({k: jnp.asarray(v) for k, v in out.items()})
    t = t_common.cast_compute({k: torch.from_numpy(v) for k, v in out.items()})
    return j, t


def _configs(arch):
    return (j_configs.get(arch, reduced=True),
            t_configs.get(arch, reduced=True))


# ------------------------------------------------------------ the scans


def _wkv_inputs(rng, b, s, h, n, logw=None):
    r, k, v = (_randn(rng, b, s, h, n) for _ in range(3))
    if logw is None:
        logw = -np.exp(_randn(rng, b, s, h, n, scale=0.5))
    u = _randn(rng, h, n, scale=0.3)
    st = _randn(rng, b, h, n, n, scale=0.3)
    return r, k, v, logw.astype(np.float32), u, st


def _jax_wkv_steps(r, k, v, logw, u, st):
    """The JAX one-token WKV6 recurrence scanned token by token."""
    def body(state, xs):
        out, state = j_rwkv._wkv_step(*xs, u, state)
        return state, out

    xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (r, k, v, logw))
    state, out = jax.lax.scan(body, jnp.asarray(st), xs)
    return jnp.moveaxis(out, 0, 1), state


def _ssd_inputs(rng, b, s, h, p, n, dt=None, a=None):
    x = _randn(rng, b, s, h, p)
    if dt is None:
        dt = np.log1p(np.exp(_randn(rng, b, s, h)))
    if a is None:
        a = -np.exp(_randn(rng, h, scale=0.5))
    B, C = _randn(rng, b, s, n), _randn(rng, b, s, n)
    st = _randn(rng, b, h, n, p, scale=0.3)
    return x, dt.astype(np.float32), a.astype(np.float32), B, C, st


def _jax_ssd_steps(x, dt, a, B, C, st):
    """The JAX one-token SSD scanned token by token."""
    def body(state, xs):
        xt, dtt, Bt, Ct = xs
        y, state = j_ssm._ssd_step(xt, dtt, jnp.asarray(a), Bt, Ct, state)
        return state, y

    xs = tuple(jnp.moveaxis(jnp.asarray(z), 1, 0) for z in (x, dt, B, C))
    state, y = jax.lax.scan(body, jnp.asarray(st), xs)
    return jnp.moveaxis(y, 0, 1), state


def test_pick_chunk_matches():
    for s in (1, 7, 8, 12, 37, 64, 100, 128, 256, 4096):
        for chunk in (1, 4, 8, 128):
            assert t_rwkv.pick_chunk(s, chunk) == j_rwkv.pick_chunk(s, chunk)


@pytest.mark.parametrize("chunk", [4, 8])
def test_wkv_chunked_and_step_match(chunk):
    """``_wkv_chunked`` at chunk 4 and 8 and ``_wkv_step`` against the JAX
    package's (float32 in and out, F32_REL), and the chunked form against
    the port's own step scanned token by token."""
    rng = np.random.default_rng(20 + chunk)
    ins = _wkv_inputs(rng, 2, 32, 4, 16)
    jo, js = j_rwkv._wkv_chunked(*(jnp.asarray(a) for a in ins), chunk=chunk)
    to, ts = t_rwkv._wkv_chunked(*(torch.from_numpy(a) for a in ins),
                                 chunk=chunk)
    _near(jo, to, F32_REL)
    _near(js, ts, F32_REL)
    r, k, v, logw, u, st = (torch.from_numpy(a) for a in ins)
    state, outs = st, []
    for t in range(r.shape[1]):
        o, state = t_rwkv._wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t],
                                    u, state)
        outs.append(o)
    _near(jo, torch.stack(outs, 1), F32_REL)
    _near(js, state, F32_REL)
    jo1, js1 = j_rwkv._wkv_step(*(jnp.asarray(a[:, 0]) for a in ins[:4]),
                                jnp.asarray(ins[4]), jnp.asarray(ins[5]))
    to1, ts1 = t_rwkv._wkv_step(*(torch.from_numpy(a[:, 0]) for a in ins[:4]),
                                torch.from_numpy(ins[4]),
                                torch.from_numpy(ins[5]))
    _near(jo1, to1, F32_REL)
    _near(js1, ts1, F32_REL)


@pytest.mark.parametrize("chunk", [4, 8])
def test_ssd_chunked_and_step_match(chunk):
    """``_ssd_chunked`` at chunk 4 and 8 and ``_ssd_step`` against the JAX
    package's (F32_REL), and the chunked form against the JAX step
    scanned token by token."""
    rng = np.random.default_rng(30 + chunk)
    ins = _ssd_inputs(rng, 2, 32, 4, 8, 16)
    jy, js = j_ssm._ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=chunk)
    ty, ts = t_ssm._ssd_chunked(*(torch.from_numpy(a) for a in ins),
                                chunk=chunk)
    _near(jy, ty, F32_REL)
    _near(js, ts, F32_REL)
    sy, ss = _jax_ssd_steps(*ins)
    _near(sy, ty, F32_REL)
    _near(ss, ts, F32_REL)
    x, dt, a, B, C, st = ins
    jy1, js1 = j_ssm._ssd_step(*(jnp.asarray(z) for z in (
        x[:, 0], dt[:, 0], a, B[:, 0], C[:, 0], st)))
    ty1, ts1 = t_ssm._ssd_step(*(torch.from_numpy(np.ascontiguousarray(z))
                                 for z in (x[:, 0], dt[:, 0], a, B[:, 0],
                                           C[:, 0], st)))
    _near(jy1, ty1, F32_REL)
    _near(js1, ts1, F32_REL)


def test_chunked_scans_do_not_overflow_at_chunk_128():
    """The reference fault (ROADMAP Queue 3): with log-decay -1 a step
    (RWKV6 at init) and a·dt = -1 (Mamba2), the JAX chunked forms are not
    finite at their published chunk of 128 over 256 tokens.  The port's
    are finite there, and within SCAN_REL of the output's largest
    magnitude of the JAX recurrences scanned token by token (the states
    too)."""
    rng = np.random.default_rng(40)
    ins = _wkv_inputs(rng, 1, 256, 2, 16,
                      logw=-np.ones((1, 256, 2, 16), np.float32))
    jo, _ = j_rwkv._wkv_chunked(*(jnp.asarray(a) for a in ins), chunk=128)
    assert not np.isfinite(_np(jo)).all()
    to, ts = t_rwkv._wkv_chunked(*(torch.from_numpy(a) for a in ins),
                                 chunk=128)
    so, ss = _jax_wkv_steps(*ins)
    _near(so, to, SCAN_REL)
    _near(ss, ts, SCAN_REL)

    ins = _ssd_inputs(rng, 1, 256, 2, 8, 16,
                      dt=np.ones((1, 256, 2), np.float32),
                      a=-np.ones((2,), np.float32))
    jy, _ = j_ssm._ssd_chunked(*(jnp.asarray(a) for a in ins), chunk=128)
    assert not np.isfinite(_np(jy)).all()
    ty, ts = t_ssm._ssd_chunked(*(torch.from_numpy(a) for a in ins),
                                chunk=128)
    sy, ss = _jax_ssd_steps(*ins)
    _near(sy, ty, SCAN_REL)
    _near(ss, ts, SCAN_REL)


# ------------------------------------------------------------ RWKV6 layers


def test_rwkv_layer_functions_match():
    """``_ddlerp``, ``_decay``, ``_group_norm``, ``_time_mix`` (with a
    carried token and state, chunk 8) and ``_channel_mix`` on one random
    layer at REDUCED width, bf16 activations."""
    jc, tc = _configs(RWKV)
    rng = np.random.default_rng(50)
    jp, tp = _layer_params(t_rwkv.build_decls(tc)["layers"], rng)
    b, s, d = 2, 16, tc.d_model
    H, N = d // tc.rwkv_head_dim, tc.rwkv_head_dim
    xj, xt = _pair(_randn(rng, b, s, d), "bfloat16")
    pj, pt = _pair(_randn(rng, b, s, d), "bfloat16")
    jm, tm = j_rwkv._ddlerp(jp, xj, pj), t_rwkv._ddlerp(tp, xt, pt)
    assert list(tm) == list(jm)
    for key in jm:
        assert tm[key].dtype == torch.bfloat16
        _near(jm[key], tm[key], BF16_REL)
    _near(j_rwkv._decay(jp, xj), t_rwkv._decay(tp, xt), BF16_REL)
    gj, gt = _pair(_randn(rng, b, s, d, scale=3.0) + 1.0)
    _near(j_rwkv._group_norm(gj, jp["ln_x_scale"], jp["ln_x_bias"], H),
          t_rwkv._group_norm(gt, tp["ln_x_scale"], tp["ln_x_bias"], H),
          F32_REL)
    lj, lt = _pair(_randn(rng, b, d), "bfloat16")
    sj, st = _pair(_randn(rng, b, H, N, N, scale=0.3))
    jy, jl, js = j_rwkv._time_mix(jc, jp, xj, lj, sj, chunk=8)
    ty, tl, ts = t_rwkv._time_mix(tc, tp, xt, lt, st, chunk=8)
    assert ty.dtype == torch.bfloat16
    _near(jy, ty, CHAIN_REL)
    assert torch.equal(tl, xt[:, -1])
    _near(js, ts, CHAIN_REL)
    jy, jl = j_rwkv._channel_mix(jc, jp, xj, lj)
    ty, tl = t_rwkv._channel_mix(tc, tp, xt, lt)
    _near(jy, ty, CHAIN_REL)
    assert torch.equal(tl, xt[:, -1])


def test_rwkv_forward_with_state_and_init_state_match():
    """``init_state`` has the JAX state's shapes and dtypes (each leaf its
    own tensor); ``forward(..., state, return_state=True)`` from a state
    carried out of a first segment gives the JAX package's logits and
    state, and ``loss_fn`` its loss."""
    jc, tc = _configs(RWKV)
    jm, tm = j_api.build(jc), t_api.build(tc)
    jp = j_common.init_params(jm.decls, seed=4)
    tp = t_common.init_params(tm.decls, seed=4, device="cpu")
    js0, ts0 = j_rwkv.init_state(jc, 2), t_rwkv.init_state(tc, 2, "cpu")
    for a, b in zip(jax.tree.leaves(js0), ts0):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    assert ts0.tm_prev.data_ptr() != ts0.cm_prev.data_ptr()
    toks = np.random.default_rng(51).integers(0, jc.vocab_size, (2, 24))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    _, _, js = j_rwkv.forward(jc, jp, jt[:, :8], return_state=True)
    _, _, ts = t_rwkv.forward(tc, tp, tt[:, :8], return_state=True)
    jl, _, js = j_rwkv.forward(jc, jp, jt[:, 8:], state=js,
                               return_state=True)
    tl, aux, ts = t_rwkv.forward(tc, tp, tt[:, 8:], state=ts,
                                 return_state=True)
    assert float(aux) == 0.0 and int(ts.pos) == int(js.pos) == 24
    _near(jl, tl, 2.0 ** -5)
    for a, b in zip(jax.tree.leaves(js)[:3], ts[:3]):
        _near(a, b, CHAIN_REL)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss, _ = j_rwkv.loss_fn(jc, jp, {k: jnp.asarray(v) for k, v in
                                       batch.items()})
    tloss, met = t_rwkv.loss_fn(tc, tp, {k: torch.from_numpy(v) for k, v in
                                         batch.items()})
    assert set(met) == {"ce", "aux"}
    assert abs(float(tloss) - float(jloss)) <= 2.0 ** -8 * float(jloss)


# ------------------------------------------------------------ Mamba2 layers


def test_mamba_layer_functions_match():
    """``_dims``, ``_split_proj`` (exact), ``_causal_conv`` and
    ``_gated_rmsnorm`` (one bf16 rounding of a float32 result),
    ``_mamba_block`` with a carried conv tail and SSM state (chunk 8), on
    one random layer at REDUCED width."""
    jc, tc = _configs(ZAMBA)
    assert t_ssm._dims(tc) == j_ssm._dims(jc)
    d_in, H, N, G, conv_ch = t_ssm._dims(tc)
    rng = np.random.default_rng(60)
    jp, tp = _layer_params(t_ssm.build_decls(tc)["mamba_layers"], rng)
    b, s, d = 2, 16, tc.d_model
    zj, zt = _pair(_randn(rng, b, s, 2 * d_in + 2 * N + H), "bfloat16")
    for a, c in zip(j_ssm._split_proj(jc, zj), t_ssm._split_proj(tc, zt)):
        np.testing.assert_array_equal(_np(c), _np(a))
    cj, ct = _pair(_randn(rng, b, s, conv_ch), "bfloat16")
    _near(j_ssm._causal_conv(cj, jp["conv_w"], jp["conv_b"]),
          t_ssm._causal_conv(ct, tp["conv_w"], tp["conv_b"]), BF16_REL)
    yj, yt = _pair(_randn(rng, b, s, d_in), "bfloat16")
    gj, gt = _pair(_randn(rng, b, s, d_in), "bfloat16")
    _near(j_ssm._gated_rmsnorm(yj, gj, jp["norm_y"]),
          t_ssm._gated_rmsnorm(yt, gt, tp["norm_y"]), BF16_REL)
    xj, xt = _pair(_randn(rng, b, s, d), "bfloat16")
    cvj, cvt = _pair(_randn(rng, b, tc.conv_width - 1, conv_ch), "bfloat16")
    sj, st = _pair(_randn(rng, b, H, N, tc.ssm_head_dim, scale=0.3))
    jo, jcv, jss = j_ssm._mamba_block(jc, jp, xj, cvj, sj, chunk=8)
    to, tcv, tss = t_ssm._mamba_block(tc, tp, xt, cvt, st, chunk=8)
    assert to.dtype == torch.bfloat16
    _near(jo, to, CHAIN_REL)
    _near(jcv, tcv, CHAIN_REL)
    _near(jss, tss, CHAIN_REL)


def test_shared_attn_block_matches():
    """``_shared_attn_block`` on concat(x, x0): the prefill path (causal
    attention over the segment) and the decode path (``update_cache`` and
    ``decode_attention`` at a scalar position), the new cache slices
    included."""
    jc, tc = _configs(ZAMBA)
    rng = np.random.default_rng(70)
    decls = t_ssm.build_decls(tc)["shared"]
    raw = {k: _randn(rng, *d.shape, scale=1 / np.sqrt(d.shape[0])
                     if len(d.shape) == 2 else 0.1)
           for k, d in decls.items()}
    jp = j_common.cast_compute({k: jnp.asarray(v) for k, v in raw.items()})
    tp = t_common.cast_compute({k: torch.from_numpy(v) for k, v in
                                raw.items()})
    b, s, d = 2, 12, tc.d_model
    xj, xt = _pair(_randn(rng, b, s, d), "bfloat16")
    x0j, x0t = _pair(_randn(rng, b, s, d), "bfloat16")
    jy, jkv = j_ssm._shared_attn_block(jc, jp, xj, x0j, jnp.arange(s))
    ty, tkv = t_ssm._shared_attn_block(tc, tp, xt, x0t, torch.arange(s))
    assert jkv is None and tkv is None
    _near(jy, ty, CHAIN_REL)
    shape = (b, tc.kv_eff, 16, tc.hd)
    ckj, ckt = _pair(_randn(rng, *shape), "bfloat16")
    cvj, cvt = _pair(_randn(rng, *shape), "bfloat16")
    pos = 5
    jy, (jck, jcv) = j_ssm._shared_attn_block(
        jc, jp, xj[:, :1], x0j[:, :1], jnp.int32(pos)[None],
        cache=(ckj, cvj), pos=jnp.int32(pos))
    ty, (tck, tcv) = t_ssm._shared_attn_block(
        tc, tp, xt[:, :1], x0t[:, :1], torch.tensor(pos, dtype=torch.int32)[None],
        cache=(ckt, cvt), pos=torch.tensor(pos, dtype=torch.int32))
    _near(jy, ty, CHAIN_REL)
    for a, c in ((jck, tck), (jcv, tcv)):
        _near(a, c, CHAIN_REL)
        keep = np.arange(16) != pos
        np.testing.assert_array_equal(_np(c)[:, :, keep], _np(a)[:, :, keep])


def test_zamba_state_and_forward_match():
    """``init_state`` has the JAX state's shapes and dtypes (K and V their
    own tensors), ``n_shared_invocations`` its count, and ``forward`` /
    ``loss_fn`` the JAX package's logits and loss at (2, 24)."""
    jc, tc = _configs(ZAMBA)
    assert t_ssm.n_shared_invocations(tc) == j_ssm.n_shared_invocations(jc)
    js0, ts0 = j_ssm.init_state(jc, 2, 32), t_ssm.init_state(tc, 2, 32, "cpu")
    for a, b in zip(jax.tree.leaves(js0), ts0):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    assert ts0.attn_k.data_ptr() != ts0.attn_v.data_ptr()
    jm, tm = j_api.build(jc), t_api.build(tc)
    jp = j_common.init_params(jm.decls, seed=6)
    tp = t_common.init_params(tm.decls, seed=6, device="cpu")
    toks = np.random.default_rng(61).integers(0, jc.vocab_size, (2, 24))
    jl, _ = j_ssm.forward(jc, jp, jnp.asarray(toks, jnp.int32))
    tl, aux = t_ssm.forward(tc, tp, torch.from_numpy(toks))
    assert float(aux) == 0.0
    _near(jl, tl, 2.0 ** -4)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss, _ = j_ssm.loss_fn(jc, jp, {k: jnp.asarray(v) for k, v in
                                      batch.items()})
    tloss, _ = t_ssm.loss_fn(tc, tp, {k: torch.from_numpy(v) for k, v in
                                      batch.items()})
    assert abs(float(tloss) - float(jloss)) <= 2.0 ** -8 * float(jloss)


# ------------------------------------------------------------ properties


def _port(arch, seed, **replace):
    c = t_configs.get(arch, reduced=True).replace(**replace)
    m = t_api.build(c)
    return c, t_common.init_params(m.decls, seed=seed, device="cpu")


@pytest.mark.parametrize("chunks", [(2, 8), (4, 16)])
def test_rwkv_chunk_size_invariant(chunks, rng):
    """The chunked WKV6 factorization is exact: logits alike for any
    chunk size (``tests/test_sequence_models.py``'s tolerance)."""
    c1, c2 = chunks
    c, params = _port(RWKV, 0, chunk_size=c1)
    toks = torch.from_numpy(rng.integers(0, c.vocab_size, (2, 16)))
    l1, _ = t_rwkv.forward(c, params, toks)
    l2, _ = t_rwkv.forward(c.replace(chunk_size=c2), params, toks)
    np.testing.assert_allclose(_np(l1), _np(l2), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("chunks", [(2, 8), (4, 16)])
def test_mamba_chunk_size_invariant(chunks, rng):
    c1, c2 = chunks
    c, params = _port(ZAMBA, 0, chunk_size=c1)
    toks = torch.from_numpy(rng.integers(0, c.vocab_size, (2, 16)))
    l1, _ = t_ssm.forward(c, params, toks)
    l2, _ = t_ssm.forward(c.replace(chunk_size=c2), params, toks)
    np.testing.assert_allclose(_np(l1), _np(l2), atol=1e-2, rtol=1e-2)


def test_rwkv_decode_is_exact_recurrence(rng):
    """Sequential decode reproduces the chunked-parallel forward across
    the full layer stack."""
    c, params = _port(RWKV, 1)
    toks = torch.from_numpy(rng.integers(0, c.vocab_size, (1, 12)))
    logits, _ = t_rwkv.forward(c, params, toks)
    st = t_rwkv.init_state(c, 1, "cpu")
    for t in range(12):
        dl, st = t_rwkv.decode_step(c, params, toks[:, t], st)
    np.testing.assert_allclose(_np(dl), _np(logits[:, -1]), atol=5e-2,
                               rtol=5e-2)


def test_rwkv_state_carries_across_segments(rng):
    """forward(s1) then forward(s2, state) == forward(s1+s2)."""
    c, params = _port(RWKV, 2, chunk_size=4)
    toks = torch.from_numpy(rng.integers(0, c.vocab_size, (2, 16)))
    full, _ = t_rwkv.forward(c, params, toks)
    _, _, st = t_rwkv.forward(c, params, toks[:, :8], return_state=True)
    seg2, _, _ = t_rwkv.forward(c, params, toks[:, 8:], state=st,
                                return_state=True)
    np.testing.assert_allclose(_np(seg2), _np(full[:, 8:]), atol=2e-2,
                               rtol=2e-2)


def test_zamba_shared_block_is_tied(rng):
    """Zamba2's shared attention block is ONE set of weights: perturbing
    it changes the output."""
    c, params = _port(ZAMBA, 3)
    toks = torch.from_numpy(rng.integers(0, c.vocab_size, (1, 8)))
    l1, _ = t_ssm.forward(c, params, toks)
    params2 = dict(params)
    params2["shared"] = {k: v + 0.01 for k, v in params["shared"].items()}
    l2, _ = t_ssm.forward(c, params2, toks)
    assert float((l1.float() - l2.float()).abs().max()) > 1e-4


# ------------------------------------------------------------ serving


def _log_engine(eng, decode_attr, log):
    """Log ``eng``'s calls in order: ("prefill", slot) when a prompt's
    prefill starts, then (slot count, logits as float32 numpy) for every
    decode call; ``decode_attr`` names the engine's decode callable
    (the JAX engine's jitted ``_decode``, the port's model member)."""
    prefill = eng._prefill_into

    def logged_prefill(state, slot, prompt):
        log.append(("prefill", slot))
        return prefill(state, slot, prompt)

    eng._prefill_into = logged_prefill
    if decode_attr == "_decode":
        decode = eng._decode
    else:
        decode = eng.model.decode_fn

    def logged_decode(params, token, state):
        logits, state = decode(params, token, state)
        log.append((int(token.shape[0]), _np(logits)))
        return logits, state

    if decode_attr == "_decode":
        eng._decode = logged_decode
    else:
        eng.model = eng.model._replace(decode_fn=logged_decode)


def _decisions(log, max_new):
    """Each greedy decision of a run, in order: (slot, whether it is a
    request's first token, logits row).  A request's first token is its
    prefill's last logits; the next ``max_new - 1`` are its slot's rows of
    the batched steps."""
    out, left, prefill_slot, last = [], {}, None, None
    for entry in log:
        if entry[0] == "prefill":
            if last is not None:
                out.append((prefill_slot, True, last))
            prefill_slot, last = entry[1], None
            left[prefill_slot] = max_new - 1
            continue
        n, logits = entry
        if n == 1 and prefill_slot is not None:
            last = logits[0]
            continue
        if last is not None:
            out.append((prefill_slot, True, last))
            prefill_slot, last = None, None
        for slot in sorted(left):
            if left[slot] > 0:
                out.append((slot, False, logits[slot]))
                left[slot] -= 1
    return out


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_serve_engine_matches_jax(arch):
    """Three requests over two slots (the third recycles a slot): the
    port's engine makes the JAX engine's calls in the same order, and
    every greedy decision equals the JAX engine's, or is a near-tie: the
    JAX logits' top-2 margin at most twice the two packages' largest
    logit difference d there (itself within the family's logit
    tolerance, 2^-2 of the row scale), where a bf16 ulp picks another
    token (zamba2's third request meets an exact bf16 tie of the JAX
    logits at its first token).  After a near-tie the slot's later
    decisions are skipped (the two sequences part); the skipped ones stay
    under half, and every request whose decisions were all taken alike
    returns the JAX engine's tokens."""
    jc, tc = _configs(arch)
    jm, tm = j_api.build(jc), t_api.build(tc)
    jp = j_common.init_params(jm.decls, seed=0)
    tp = t_common.init_params(tm.decls, seed=0, device="cpu")
    rng = np.random.default_rng(80)
    prompts = [rng.integers(0, jc.vocab_size, n).tolist() for n in (5, 3, 7)]
    max_new = 6
    jeng = JServeEngine(jc, jp, batch_slots=2, max_seq=32)
    teng = ServeEngine(tc, tp, batch_slots=2, max_seq=32, device="cpu")
    jlog, tlog = [], []
    _log_engine(jeng, "_decode", jlog)
    _log_engine(teng, "decode_fn", tlog)
    jdone = jeng.run([JRequest(prompt=p, max_new=max_new) for p in prompts])
    tdone = teng.run([Request(prompt=p, max_new=max_new) for p in prompts])
    assert [r.prompt for r in tdone] == [r.prompt for r in jdone]
    assert [e[0] for e in tlog] == [e[0] for e in jlog]
    jdec, tdec = _decisions(jlog, max_new), _decisions(tlog, max_new)
    assert len(tdec) == len(jdec) == len(prompts) * max_new
    parted, skipped, ties = set(), 0, 0
    for (slot, first, jl), (_, _, tl) in zip(jdec, tdec):
        if first:                   # a new request in the slot
            parted.discard(slot)
        if slot in parted:
            skipped += 1
            continue
        d = np.abs(jl - tl).max()
        assert d <= 2.0 ** -2 * np.abs(jl).max()
        if np.argmax(jl) != np.argmax(tl):
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] <= 2 * d, (top2, d)
            parted.add(slot)
            ties += 1
    assert skipped < len(jdec) / 2
    same = [t.output == j.output for t, j in zip(tdone, jdone)]
    assert sum(same) >= len(prompts) - ties

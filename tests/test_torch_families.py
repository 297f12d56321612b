"""The port's VLM, audio and nemotron pieces ≡ the JAX package's, on the CPU.

The model-level cases of the three configs (init, prefill, decode, loss and
gradients) run in ``tests/test_torch_models.py`` and
``tests/test_torch_train.py`` with every other registered config; this file
holds their building blocks, with the same numpy inputs (made from a seed)
through both packages:

* ``layer_norm``, ``squared_relu_mlp`` and ``gelu_mlp`` (tanh GELU, with
  biases): in float32 within 1e-5 (the frameworks reduce and evaluate the
  tanh in other orders); in bf16, ``layer_norm`` rounds its float32 result
  once (one bf16 ulp of the larger result plus 1e-5), the MLPs round
  inside (bf16 products, the nonlinearity cast back) and hold ``BF16_REL``
  of the output's largest magnitude plus ``BF16_REL`` relative, as
  ``swiglu`` does in ``tests/test_torch_models.py``.
* whisper's sinusoid positions within 1e-5 plus one float32 ulp of the
  largest angle (the frequencies' ``exp`` rounds otherwise), its encoder
  output and the cross-attention K/V of both
  families within ``CACHE_REL`` of the largest magnitude plus
  ``CACHE_REL`` relative (bf16 projections after a few bf16 layers);
* the VLM's self layers round their norm scales to bf16 as the JAX
  package's group cast does, bit for bit; with scales that bf16 cannot
  hold, the prefill logits still hold ``LOGIT_REL``;
* the input and decode-state specs of both families, shapes and dtypes;
* the families refuse a prefill or decode state without their features,
  and ``ServeEngine`` serves nemotron (the int8 cache, no side inputs) as
  its one-slot runs do.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_models import (BF16_REL, CACHE_REL, F32_TOL, LOGIT_REL,
                               _logits_close, _np, _side_inputs, bf16_ulp)
from repro import configs as j_configs
from repro.models import api as j_api
from repro.models import common as j_common
from repro.models import transformer as j_tr
from repro_torch import configs as t_configs
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.models import api as t_api
from repro_torch.models import common as t_common
from repro_torch.models import transformer as t_tr
from repro_torch.models.arch_config import ShapeCell

from repro.models.arch_config import ShapeCell as JShapeCell

NEW_ARCHS = ("nemotron-4-340b", "llama-3.2-vision-11b", "whisper-large-v3")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per worker (the suite's workers share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(arr, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(a, b, dtype, rounded_once=False):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.isfinite(b).all()
    if dtype == "float32":
        np.testing.assert_allclose(b, a, atol=F32_TOL, rtol=F32_TOL)
    elif rounded_once:
        bound = bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + F32_TOL
        assert np.all(np.abs(a - b) <= bound)
    else:
        np.testing.assert_allclose(b, a, atol=BF16_REL * np.abs(a).max(),
                                   rtol=BF16_REL)


def _cache_rel_close(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and np.isfinite(b).all()
    assert np.all(np.abs(a - b) <= CACHE_REL * np.abs(a).max()
                  + CACHE_REL * np.abs(a))


def _models(arch, seed=0):
    jc = j_configs.get(arch, reduced=True)
    tc = t_configs.get(arch, reduced=True)
    jm, tm = j_api.build(jc), t_api.build(tc)
    return (jc, tc, jm, tm, j_common.init_params(jm.decls, seed=seed),
            t_common.init_params(tm.decls, seed=seed, device="cpu"))


# ------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_mlps_match(dtype):
    rng = np.random.default_rng(21)
    xj, xt = _pair(_randn(rng, 2, 5, 32), dtype)
    sj, st = _pair(1.0 + _randn(rng, 32, scale=0.1), "float32")
    bj, bt = _pair(_randn(rng, 32, scale=0.1), "float32")
    _close(j_common.layer_norm(xj, sj, bj), t_common.layer_norm(xt, st, bt),
           dtype, rounded_once=True)
    up = _pair(_randn(rng, 32, 64, scale=0.25), dtype)
    down = _pair(_randn(rng, 64, 32, scale=0.25), dtype)
    _close(j_common.squared_relu_mlp(xj, up[0], down[0]),
           t_common.squared_relu_mlp(xt, up[1], down[1]), dtype)
    b_up = _pair(_randn(rng, 64, scale=0.1), "float32")
    b_down = _pair(_randn(rng, 32, scale=0.1), "float32")
    _close(j_common.gelu_mlp(xj, up[0], b_up[0], down[0], b_down[0]),
           t_common.gelu_mlp(xt, up[1], b_up[1], down[1], b_down[1]), dtype)


def test_sinusoid_matches():
    """Within 1e-5 plus one float32 ulp of the largest angle: the two
    frameworks' float32 ``exp`` round 43 of whisper's 640 frequencies to
    the neighbouring float, and at an angle of 1 499 rad that ulp of the
    frequency moves the angle by an ulp (1.2e-4) and its sine by as
    much."""
    for length, channels in ((12, 64), (1500, 1280)):
        a = _np(j_tr._sinusoid(length, channels))
        b = _np(t_tr._sinusoid(length, channels, "cpu"))
        assert a.shape == b.shape == (length, channels)
        ulp = np.spacing(np.float32(length - 1))
        assert np.abs(a - b).max() <= F32_TOL + ulp


# ------------------------------------------------------------ features


def test_encoder_and_cross_kv_match():
    """whisper's encoder output, and both families' cross-attention K/V
    projected once for decoding."""
    jc, tc, jm, tm, jp, tp = _models("whisper-large-v3")
    jside, tside = _side_inputs(tc, 2, 3)
    enc_j = j_tr.encode_audio(jc, jp, jside["enc_embeds"])
    enc_t = t_tr.encode_audio(tc, tp, tside["enc_embeds"])
    assert enc_t.dtype == torch.bfloat16
    _cache_rel_close(enc_j, enc_t)
    for arch, key in (("whisper-large-v3", "dec_cross"),
                      ("llama-3.2-vision-11b", "cross")):
        jc, tc, jm, tm, jp, tp = _models(arch)
        jside, tside = _side_inputs(tc, 2, 4)
        js = jm.init_decode_state(jp, 2, 8, **jside)
        ts = tm.init_decode_state(tp, 2, 8, **tside)
        n = tp[key]["x_wk"].shape[0]
        n_feat = tc.n_img_tokens if tc.family == "vlm" else tc.n_frames
        assert ts.cross_k.shape == (n, 2, tc.kv_eff, n_feat, tc.hd)
        _cache_rel_close(js.cross_k, ts.cross_k)
        _cache_rel_close(js.cross_v, ts.cross_v)


def test_vlm_rounds_self_layer_norm_scales_as_jax():
    """The JAX package casts a VLM group's stacked self layers at once
    (``cast_compute`` of (every, ...) leaves), rounding their (every, d)
    norm scales to bf16; the port's forward and decode cast each self
    layer as that cast leaves it, bit for bit, and with scales that bf16
    cannot hold the prefill logits still hold ``LOGIT_REL``."""
    jc, tc, jm, tm, jp, tp = _models("llama-3.2-vision-11b")
    rng = np.random.default_rng(9)
    for name in ("ln1", "ln2"):
        scale = _randn(rng, *tp["layers"][name].shape, scale=0.3)
        jp = dict(jp, layers=dict(jp["layers"], **{name: jnp.asarray(scale)}))
        tp = dict(tp, layers=dict(tp["layers"],
                                  **{name: torch.from_numpy(scale)}))
    assert not np.array_equal(
        scale, scale.astype(jnp.bfloat16).astype(np.float32))
    every = tc.cross_attn_every
    decoded = [p for p, _ in t_tr._decode_layers(tc, tp)]
    for l in range(tc.n_layers):
        g, i = divmod(l, every)
        want = j_common.cast_compute({k: v[g * every:(g + 1) * every]
                                      for k, v in jp["layers"].items()})
        mine = t_tr._group_cast({k: t[l] for k, t in tp["layers"].items()})
        for k, v in want.items():
            for got in (mine[k], decoded[l][k]):
                assert str(got.dtype)[6:] == str(v.dtype), k
                np.testing.assert_array_equal(_np(got), _np(v[i]))
    toks = rng.integers(0, jc.vocab_size, (2, 16))
    jside, tside = _side_inputs(tc, 2, 10)
    a = jm.prefill_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32), **jside})
    b = tm.prefill_fn(tp, {"tokens": torch.from_numpy(toks), **tside})
    _logits_close(a, b, LOGIT_REL)


# ------------------------------------------------------------ the API


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_specs_match(arch):
    jc = j_configs.get(arch, reduced=True)
    tc = t_configs.get(arch, reduced=True)
    jm, tm = j_api.build(jc), t_api.build(tc)
    for kind, b, s in (("train", 4, 32), ("prefill", 2, 64),
                       ("decode", 3, 128)):
        j = jm.input_specs(JShapeCell("x", kind, s, b))
        t = tm.input_specs(ShapeCell("x", kind, s, b))
        assert list(t) == list(j)
        for key in j:
            assert t[key].shape == j[key].shape
            assert str(t[key].dtype)[6:] == str(j[key].dtype), key
    j = jm.decode_state_specs(JShapeCell("x", "decode", 128, 3))
    t = tm.decode_state_specs(ShapeCell("x", "decode", 128, 3))
    assert t.cache.k.shape == j.cache.k.shape
    assert str(t.cache.k.dtype)[6:] == str(j.cache.k.dtype)
    if tc.family in ("vlm", "audio"):
        assert t.cross_k.shape == j.cross_k.shape
        assert t.cross_k.dtype == torch.bfloat16
    else:
        assert t.cross_k is None and j.cross_k is None


@pytest.mark.parametrize("arch", NEW_ARCHS[1:])
def test_families_need_their_features(arch):
    _, tc, _, tm, _, tp = _models(arch)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="embeds"):
        tm.prefill_fn(tp, {"tokens": toks})
    with pytest.raises(ValueError, match="embeds"):
        tm.init_decode_state(tp, 1, 8)


def test_serve_engine_serves_nemotron():
    """nemotron (squared ReLU, head dim 24 at REDUCED, the int8 cache)
    needs no side input, so ``ServeEngine`` serves it: several requests
    over two slots answer as each does alone in one slot."""
    c = t_configs.get("nemotron-4-340b", reduced=True)
    m = t_api.build(c)
    params = t_common.init_params(m.decls, seed=0, device="cpu")
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5], [11, 12, 13, 14, 15]]
    single = ServeEngine(c, params, batch_slots=1, max_seq=32, device="cpu")
    alone = [single.run([Request(prompt=p, max_new=5)])[0].output
             for p in prompts]
    eng = ServeEngine(c, params, batch_slots=2, max_seq=32, device="cpu")
    done = eng.run([Request(prompt=p, max_new=5) for p in prompts])
    assert sorted(r.output for r in done) == sorted(alone)

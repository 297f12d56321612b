"""The port's flash-attention plain version ≡ the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through the JAX package's
``attention_ref`` and the port's, at the shapes of
``tests/test_kernels.py::test_flash_attention_matches_ref`` and at ragged
lengths.  The JAX Pallas kernel itself does not run under the installed
jax (its ``pl.load`` is gone), so its oracle stands in for it; the port's
CUDA kernel is held against the same plain version on the card
(``tests/test_torch_cuda.py``).  Tolerances: float32 outputs within 1e-6
(the two frameworks sum the products in different orders), bf16 outputs
within one bf16 ulp of the larger of the two plus that 1e-6 (the float32
results differ by that much, and each rounds by up to half an ulp).

On CPU tensors the port's entry point (``ops.flash_attention``) and the
kernel wrapper run the plain version itself — equal bit for bit, with no
launch counted — and the wrapper's shape checks raise before any dispatch.

The bf16 kernel (``csrc/flash_attention_fwd_wgmma.cu``) cannot run here, so
its arithmetic is emulated in float32 (``wgmma_recipe``: the f32 product of
bf16 q and k, scaled after it, an online softmax over 64-key tiles, P split
into bf16 terms for the P.V product, one rounding to bf16) and held against
the JAX package's ``attention_ref`` at the card tests' shapes and seeds,
within the card tests' bound.  Three terms (P's 24 bits) keep to it; two
(16 bits) do not.

The float32 kernel (``csrc/flash_attention_fwd.cu``) is emulated the same
way (``tf32_recipe``: q scaled first, every operand split into hi and lo
TF32 values rounded as ``cvt.rna.tf32.f32`` rounds, each product as three
TF32 products small terms first, the online softmax over 32-key tiles
(16 at D = 192),
each tile's P.V added to O * alpha in f32) and held to the JAX package's
float32 ``attention_ref`` within the card's rtol = atol = 1e-5 at the
card tests' shapes and seeds, 512 queries over 4096 keys, and scores up
to |s| of about 16; one TF32 product (hi.hi) misses it.  At |s| near 30
float32 itself stops resolving 1e-5, and the recipe is held against a
float64 truth instead.
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS, flash_attention_fwd_kernel)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import full_attention, repeat_kv

# (b, hq, hk, sq, sk, d, causal): tests/test_kernels.py's shapes, then
# ragged lengths and the model's head dim
SHAPES = [(2, 4, 2, 64, 64, 16, True), (1, 8, 8, 128, 128, 32, True),
          (2, 4, 1, 64, 128, 16, False), (1, 2, 2, 256, 256, 64, True)]
RAGGED = [(1, 4, 2, 100, 1000, 128, True), (1, 2, 1, 1000, 100, 128, False),
          (2, 2, 2, 100, 100, 32, True)]
# tests/test_torch_cuda.py's FLASH_SHAPES up to (1, 4, 2, 300, 300, 128)
CARD_SHAPES = [
    (2, 4, 2, 64, 64, 16, True), (1, 8, 8, 128, 128, 32, True),
    (2, 4, 1, 64, 128, 16, False), (1, 2, 2, 256, 256, 64, True),
    (1, 4, 2, 100, 1000, 128, True), (1, 4, 1, 1000, 100, 128, False),
    (2, 4, 4, 100, 100, 32, True), (1, 8, 2, 300, 77, 64, True),
    (1, 2, 1, 77, 300, 16, False), (1, 4, 2, 300, 300, 128, True)]
# tests/test_torch_cuda.py's HEAD_DIM_SHAPES: nemotron's head dims 192 and
# 24, GQA groups 1, 2 and 6, whisper's and the VLM's lengths
HEAD_DIM_SHAPES = [
    (1, 6, 1, 448, 448, 192, True), (1, 12, 2, 300, 1600, 192, False),
    (2, 4, 4, 130, 1500, 192, False), (1, 6, 3, 1500, 1500, 192, True),
    (1, 6, 1, 448, 448, 24, True), (2, 4, 2, 300, 1600, 24, False),
    (1, 4, 4, 1500, 1500, 24, False), (1, 12, 2, 77, 300, 24, True)]
# the kernels' arithmetic is emulated (below) at those head dims, groups
# and masks with shorter lengths, ragged edges kept: the CPU emulation of
# the full lengths takes minutes
RECIPE_HEAD_DIM_SHAPES = [
    (1, 6, 1, 200, 200, 192, True), (1, 4, 2, 100, 448, 192, False),
    (2, 4, 4, 130, 150, 192, True), (1, 6, 1, 448, 448, 24, True),
    (2, 4, 2, 100, 1600, 24, False), (1, 12, 2, 77, 300, 24, True)]


def _inputs(b, hq, hk, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


def _jax(arrs, dtype):
    return [jnp.asarray(a, jnp.float32 if dtype == "float32" else
                        jnp.bfloat16) for a in arrs]


def _torch(arrs, dtype):
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    return [torch.from_numpy(a).to(dt) for a in arrs]


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    m = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7)


def assert_matches(j_out, t_out, dtype):
    a = np.asarray(j_out.astype(jnp.float32))
    b = t_out.float().numpy()
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)
    else:
        bound = bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + 1e-6
        assert np.all(np.abs(a - b) <= bound)


@pytest.mark.parametrize("shape", SHAPES + RAGGED + HEAD_DIM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax(shape, dtype):
    b, hq, hk, sq, sk, d, causal = shape
    arrs = _inputs(b, hq, hk, sq, sk, d, seed=b * sq + sk)
    j_out = j_attention_ref(*_jax(arrs, dtype), causal=causal)
    t_out = attention_ref(*_torch(arrs, dtype), causal=causal)
    assert t_out.dtype == (torch.float32 if dtype == "float32"
                           else torch.bfloat16)
    assert_matches(j_out, t_out, dtype)


@pytest.mark.parametrize("shape", SHAPES + RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_point_on_cpu_is_the_plain_version(shape, dtype):
    b, hq, hk, sq, sk, d, causal = shape
    q, k, v = _torch(_inputs(b, hq, hk, sq, sk, d, seed=sq), dtype)
    launches = flash_attention_fwd_kernel.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(out, attention_ref(q, k, v, causal=causal))
    assert torch.equal(flash_attention_fwd_kernel(q, k, v, causal=causal),
                       out)
    assert flash_attention_fwd_kernel.launches == launches


def test_wrapper_rejects_shapes_the_kernel_lacks():
    q = torch.zeros(1, 4, 8, 40)
    with pytest.raises(ValueError, match="head dim 40"):
        flash_attention_fwd_kernel(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd_kernel(q, q[:, :3], q[:, :3])
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_fwd_kernel(q, q[:, :2], q[:, :2, :4])
    # every head dim of the registered configs, nemotron's 192 and 24 too
    assert HEAD_DIMS == (16, 24, 32, 64, 128, 192)


def test_plain_version_matches_model_path():
    """The kernel's plain version agrees with the model's full_attention
    over interleaved repeated KV heads (tests/test_kernels.py's check,
    2e-5)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
    out_m = full_attention(q, repeat_kv(k, 2), repeat_kv(v, 2), causal=True)
    out_k = attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out_m.numpy(), out_k.numpy(), atol=2e-5,
                               rtol=2e-5)


def wgmma_recipe(q, k, v, causal, terms=3, block_k=64):
    """The bf16 kernel's arithmetic in float32 on the CPU: S = q.k^T of the
    bf16 values summed in f32 and scaled by 1/sqrt(D) afterwards; an online
    softmax over ``block_k``-key tiles (m and l in f32, l summed from the
    f32 probabilities); P split into ``terms`` bf16 terms, each multiplied
    by V, the tile's products summed smallest term first and added to
    O * alpha in f32; O / max(l, 1e-30) rounded to bf16 once."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    scale = torch.tensor(1.0, dtype=torch.float32) / math.sqrt(d)
    m = torch.full((b, hq, sq, 1), -math.inf)
    l = torch.zeros(b, hq, sq, 1)
    acc = torch.zeros(b, hq, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[2], block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (q.float() @ kt.transpose(-1, -2)) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        parts, rest = [], p
        for _ in range(terms):
            parts.append(rest.bfloat16().float())
            rest = rest - parts[-1]
        pv = torch.zeros_like(acc)
        for part in reversed(parts):
            pv = pv + part @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).bfloat16()


def _beyond_bound(shape, terms):
    """How far the recipe lands from the JAX package's attention_ref on
    the card test's inputs: the largest |difference| over its bound, one
    bf16 ulp of the larger value plus 1e-6."""
    b, hq, hk, sq, sk, d, causal = shape
    arrs = _inputs(b, hq, hk, sq, sk, d, seed=sq * 7 + sk)
    j_out = np.asarray(j_attention_ref(*_jax(arrs, "bfloat16"),
                                       causal=causal).astype(jnp.float32))
    out = wgmma_recipe(*_torch(arrs, "bfloat16"), causal,
                       terms=terms).float().numpy()
    bound = bf16_ulp(np.maximum(np.abs(j_out), np.abs(out))) + 1e-6
    return float((np.abs(out - j_out) / bound).max())


@pytest.mark.parametrize("shape", CARD_SHAPES + RECIPE_HEAD_DIM_SHAPES)
def test_wgmma_recipe_matches_jax(shape):
    assert _beyond_bound(shape, terms=3) <= 1.0


def test_two_bf16_terms_of_p_miss_the_bound():
    """Why the kernel splits P into three terms: with two, an output near 0
    of this shape lands past one ulp + 1e-6 of attention_ref."""
    assert _beyond_bound((1, 8, 8, 128, 128, 32, True), terms=2) > 1.0


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, on the bits as ``cvt.rna.tf32.f32`` does: add half of
    the 13 dropped bits' unit to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """x as hi + lo, each a TF32 value: hi = rna(x), lo = rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_product(a: torch.Tensor, b: torch.Tensor, terms: int):
    """a @ b from TF32 terms in float32: with three, lo.hi and hi.lo first,
    hi.hi last; with one, hi.hi alone."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    if terms == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def tf32_recipe(q, k, v, causal, terms=3, block_k=32):
    """The float32 kernel's arithmetic in float32 on the CPU: q scaled by
    1/sqrt(D) before the product; S = q.k^T and each tile's P.V as
    ``terms`` TF32 products (``tf32_product``); an online softmax over
    ``block_k``-key tiles (m and l in f32, masked scores -1e30); each
    tile's P.V added to O * alpha in f32; O / max(l, 1e-30)."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kf = k.repeat_interleave(g, 1)
    vf = v.repeat_interleave(g, 1)
    qs = q / torch.tensor(float(d)).sqrt()
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros(b, hq, sq, 1)
    acc = torch.zeros(b, hq, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[2], block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = tf32_product(qs, kt.transpose(-1, -2), terms)
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + tf32_product(p, vt, terms)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


# the float32 card tests' cases beyond CARD_SHAPES, (shape, q scale): 512
# queries over 4096 keys (non-causal: causal masking is aligned top left),
# and scores up to |s| of about 16 (q times 3)
TF32_CASES = ([(shape, 1.0) for shape in CARD_SHAPES + RECIPE_HEAD_DIM_SHAPES]
              + [((1, 4, 2, 512, 4096, 128, False), 1.0),
                 ((1, 8, 4, 512, 512, 128, True), 3.0)])


def _tf32_vs(shape, q_scale, terms):
    """The recipe and the JAX package's float32 attention_ref on the card
    test's inputs (q times ``q_scale``)."""
    b, hq, hk, sq, sk, d, causal = shape
    arrs = _inputs(b, hq, hk, sq, sk, d, seed=sq * 7 + sk)
    arrs[0] = arrs[0] * np.float32(q_scale)
    j_out = np.asarray(j_attention_ref(*_jax(arrs, "float32"), causal=causal))
    # the kernel's key tile: 32 keys, 16 at D = 192 (its own geometry)
    out = tf32_recipe(*_torch(arrs, "float32"), causal, terms=terms,
                      block_k=16 if d > 128 else 32).numpy()
    return out, j_out


@pytest.mark.parametrize("shape,q_scale", TF32_CASES)
def test_tf32_recipe_matches_jax(shape, q_scale):
    out, j_out = _tf32_vs(shape, q_scale, terms=3)
    np.testing.assert_allclose(out, j_out, rtol=1e-5, atol=1e-5)


def test_one_tf32_term_misses_the_contract():
    """Why the kernel takes three TF32 products: hi.hi alone (11
    significant bits an operand) lands past rtol = atol = 1e-5."""
    out, j_out = _tf32_vs((1, 4, 2, 300, 300, 128, True), 1.0, terms=1)
    assert not np.allclose(out, j_out, rtol=1e-5, atol=1e-5)


def attention_f64(q, k, v, causal):
    """Attention in float64 (the truth the float32 versions round)."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kf = k.double().repeat_interleave(g, 1)
    vf = v.double().repeat_interleave(g, 1)
    s = q.double() @ kf.transpose(-1, -2) / math.sqrt(d)
    if causal:
        mask = torch.arange(k.shape[2])[None, :] <= torch.arange(sq)[:, None]
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=torch.float64))
    return torch.softmax(s, -1) @ vf


def test_tf32_recipe_at_scores_near_30():
    """At |s| near 30 (q times 6) a score's float32 ulp is 2e-6 and float32
    itself no longer resolves rtol = atol = 1e-5: attention_ref lands past
    it from the float64 truth, and a float32 softmax of exactly rounded
    scores lands past attention_ref.  The recipe stays within that
    tolerance of the truth beyond attention_ref's own largest distance
    from it."""
    b, hq, hk, sq, sk, d, causal = (1, 8, 4, 512, 512, 128, True)
    arrs = _inputs(b, hq, hk, sq, sk, d, seed=sq * 7 + sk)
    arrs[0] = arrs[0] * np.float32(6.0)
    q, k, v = _torch(arrs, "float32")
    truth = attention_f64(q, k, v, causal)
    ref_err = (attention_ref(q, k, v, causal=causal).double() - truth).abs()
    tol = 1e-5 + 1e-5 * truth.abs()
    assert bool((ref_err > tol).any())
    err = (tf32_recipe(q, k, v, causal).double() - truth).abs()
    assert bool((err <= tol + ref_err.max()).all())
    # nor does a float32 softmax of the exactly rounded scores keep 1e-5
    # of attention_ref: the float32 sums differ by more than that
    g = hq // hk
    s = (q.double() @ k.double().repeat_interleave(g, 1).transpose(-1, -2)
         / math.sqrt(d)).float()
    mask = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
    exact = torch.softmax(torch.where(mask, s, torch.tensor(-1e30)), -1) \
        @ v.repeat_interleave(g, 1)
    assert not torch.allclose(exact, attention_ref(q, k, v, causal=causal),
                              rtol=1e-5, atol=1e-5)

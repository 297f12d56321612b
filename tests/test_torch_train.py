"""The port's training path ≡ the JAX package's, on the CPU.

The same numpy inputs (made from a seed) and the same weights
(``params_from_numpy`` of the JAX package's tree) go through both
packages at the configs' REDUCED sizes.  Each test states its tolerance;
the shared ones:

* ``LOSS_REL`` (2^-8, one bf16 ulp): a loss is the mean of float32
  log-likelihoods of bf16 logits, which the two packages' bf16 matmuls
  (summed in other orders) make differ by a few bf16 ulps of the row scale
  here and there; their mean stays within one bf16 ulp of the loss.
* ``GRAD_REL`` (2^-5, eight bf16 ulps): every gradient leaf within that
  share of the leaf's largest magnitude.  The backward carries the
  logits' bf16 disagreement (``tests/test_torch_models.py``'s
  ``LOGIT_REL``, the same 2^-5) into every gradient at that scale.
* ``MOE_GRAD_REL`` (2^-4): the MoE configs' gradients, routed alike
  (``tests/test_torch_moe.py``).  Their logits hold twice ``LOGIT_REL``
  (``tests/test_torch_models.py``'s ``MOE_LOGIT_REL``: llama4 is 4 layers
  deep, and the disagreement grows with depth), and so do their
  gradients: measured 0.046 of the leaf's largest magnitude in
  qwen3-moe's layer-0 router and 0.047 in llama4's first ``ln2`` scale
  (sums over every token whose terms cancel), every other leaf at most
  0.032.
* ``GATE_GRAD_REL`` (2^-4): the VLM's cross-attention gates.  A gate's
  gradient is one bf16 scalar (both packages cast tanh(gate) to bf16
  before the product), the sum over every token and feature of the
  block's output times its cotangent, whose terms cancel: measured 0.044
  (``x_attn_gate``) and 0.039 (``x_mlp_gate``) of the gate's gradient at
  (2 x 64) tokens, every other VLM leaf within 0.023.
* ``HYBRID_GRAD_REL`` (2^-4): zamba2's gradients (8 Mamba2 layers and
  two shared-block calls, depth like llama4's): measured 0.034 of the
  leaf's largest magnitude in ``conv_w``, every other leaf within 0.028.
* ``RWKV_GRAD_REL`` (2^-3): rwkv6's gradients.  Its per-head group norm
  divides each head's WKV output by that head's own spread, and where a
  head's output is a cancelling sum the bf16 ulps of its inputs become a
  large share of it: a 2^-9 relative perturbation of the embedding alone
  moves the port's own gradients by up to 1.18 of a leaf's largest
  magnitude at (2 x 64) tokens, and its logits by up to 0.44 of the row
  scale at (1 x 2048).  Against the JAX package: measured 0.100
  (``ln2``), every other leaf within 0.095, the loss within 1.8e-4.
* ``OPT_RTOL`` (1e-6): the optimizers are float32 arithmetic in the JAX
  package's association on the same gradients; only their reductions
  (the global norm, Adafactor's means) and the transcendental functions
  (cos, pow, rsqrt) may round the last bit otherwise.

A train step that runs AdamW on the two packages' slightly different
gradients moves each parameter by the learning rate times nearly the
gradient's sign, so its parameters agree within ``2 · lr`` (a sign that
flips between the packages, where a gradient is near 0) plus OPT_RTOL.

Only a few JAX programs are compiled (one ``value_and_grad`` a config, one
train step a variant, the two optimizer updates): the JAX package's XLA
CPU compiler crashes a worker now and then when a process compiles many
(ROADMAP Queue 3).  Every test runs one torch thread (the suite's workers
share the cores).
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_torch_moe import (assert_decided_alike, force_port_routing,
                            moe_routers, record_jax_routing)
from repro import configs as j_configs
from repro.launch import train_step as j_train_step
from repro.models import api as j_api
from repro.models import common as j_common
from repro.models.arch_config import ShapeCell as JShapeCell
from repro.train import data as j_data
from repro.train import optim as j_optim
from repro.utils import tree as j_tree
from repro_torch import configs as t_configs
from repro_torch.launch import train_step as t_train_step
from repro_torch.models import api as t_api
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models.arch_config import ShapeCell
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import data as t_data
from repro_torch.train import optim as t_optim
from repro_torch.utils import prng as t_prng
from repro_torch.utils import tree as t_tree

ARCHS = t_configs.ARCH_IDS
LOSS_REL = 2.0 ** -8
GRAD_REL = 2.0 ** -5
MOE_GRAD_REL = 2.0 ** -4
HYBRID_GRAD_REL = 2.0 ** -4
RWKV_GRAD_REL = 2.0 ** -3
GATE_GRAD_REL = 2.0 ** -4
OPT_RTOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per worker: the suite runs files in parallel
    worker processes, and torch's default intra-op threads oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to_torch(tree):
    return t_common.params_from_numpy(jax.tree.map(np.asarray, tree),
                                      device="cpu")


def _pair_params(arch, seed=0, **replace):
    jc = j_configs.get(arch, reduced=True).replace(**replace)
    tc = t_configs.get(arch, reduced=True).replace(**replace)
    jm, tm = j_api.build(jc), t_api.build(tc)
    jp = j_common.init_params(jm.decls, seed=seed)
    return jc, tc, jm, tm, jp, _to_torch(jp)


def _batch(vocab, shape, seed, c=None):
    """Tokens and labels; with a VLM or audio config ``c`` also its stub
    features, which ``_jbatch`` and ``_tbatch`` hand both packages in
    bf16, the input specs' dtype."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
           "labels": rng.integers(0, vocab, shape).astype(np.int32)}
    if c is not None and c.family in ("vlm", "audio"):
        n = c.n_img_tokens if c.family == "vlm" else c.n_frames
        key = "img_embeds" if c.family == "vlm" else "enc_embeds"
        out[key] = rng.standard_normal(
            (shape[0], n, c.d_model)).astype(np.float32)
    return out


def _jbatch(b):
    return {k: jnp.asarray(v, jnp.bfloat16) if k.endswith("_embeds")
            else jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v).to(torch.bfloat16)
            if k.endswith("_embeds") else torch.from_numpy(v)
            for k, v in b.items()}


def _grads_close(j_grads, t_grads, rel=GRAD_REL, rel_of=None):
    """Every leaf within ``rel`` (or ``rel_of[key]``) of its largest
    magnitude; the keys equal."""
    jf, tf = j_tree.flatten_dict(j_grads), t_tree.flatten_dict(t_grads)
    assert list(jf) == list(tf)
    for key in jf:
        a, b = _np(jf[key]), _np(tf[key])
        assert a.shape == b.shape, key
        tol = (rel_of or {}).get(key, rel)
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), key


# ------------------------------------------------------------ the loss


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("vocab_valid", [None, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches(masked, vocab_valid, dtype):
    """Float32 logits within OPT_RTOL (both take a stable logsumexp in
    float32; only the reductions' order differs); bf16 logits are cast to
    float32 first, exactly, so the same holds."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 48)) * 4).astype(np.float32)
    labels = rng.integers(0, vocab_valid or 48, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    a = j_common.cross_entropy_loss(
        jnp.asarray(logits, jdt), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), vocab_valid=vocab_valid)
    b = t_common.cross_entropy_loss(
        torch.from_numpy(logits).to(tdt), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask),
        vocab_valid=vocab_valid)
    assert b.dtype == torch.float32 and b.dim() == 0
    np.testing.assert_allclose(float(b), float(a), rtol=OPT_RTOL)


def test_cross_entropy_is_stable_at_large_logits():
    """No overflow where exp(logit) does not fit float32."""
    logits = torch.tensor([[[1e4, 0.0, -1e4]]])
    out = t_common.cross_entropy_loss(logits, torch.tensor([[1]]))
    assert float(out) == pytest.approx(1e4)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, monkeypatch):
    """``loss_fn``'s loss within LOSS_REL and every gradient leaf within
    GRAD_REL (a MoE config: MOE_GRAD_REL; zamba2 HYBRID_GRAD_REL, rwkv6
    RWKV_GRAD_REL) of ``jax.value_and_grad``'s.
    The dense family's ``aux`` is 0 and ``ce`` the loss; a MoE config's
    ``aux`` (the routers' balance and z-losses, float32) is above 0 and
    within LOSS_REL of the JAX package's, and the loss is ``ce + aux``.
    A MoE config runs
    with the JAX package's expert ids forced into the port's routers (its
    forward's calls; the port's remat recompute takes the same ids), the
    port's own ids equal to them wherever decided
    (``tests/test_torch_moe.py``)."""
    jc, tc, jm, tm, jp, tp = _pair_params(arch)
    b = _batch(jc.vocab_size, (2, 64), 3, tc)
    moe = tc.family == "moe"
    if moe:
        jcalls = record_jax_routing(monkeypatch)
        routers = moe_routers(tp)
        seen = force_port_routing(monkeypatch, routers,
                                  lambda layer, n: jcalls[layer])
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, _jbatch(b))
    for t in t_tree.tree_leaves(tp):
        t.requires_grad_(True)
    tl, tmet = tm.loss_fn(tp, _tbatch(b))
    tl.backward()
    assert set(tmet) == {"ce", "aux"}
    aux, ce, loss = (float(t.detach()) for t in (tmet["aux"], tmet["ce"],
                                                 tl))
    if moe:
        assert_decided_alike(seen)
        assert aux > 0
        assert abs(aux - float(jmet["aux"])) <= LOSS_REL * float(jmet["aux"])
        assert loss == float((tmet["ce"] + tmet["aux"]).detach())
    else:
        assert aux == 0.0 and ce == loss
    assert abs(loss - float(jl)) <= LOSS_REL * abs(float(jl))
    gates = {f"cross/{g}": GATE_GRAD_REL
             for g in ("x_attn_gate", "x_mlp_gate")}
    rel = {"moe": MOE_GRAD_REL, "hybrid": HYBRID_GRAD_REL,
           "ssm": RWKV_GRAD_REL}.get(tc.family, GRAD_REL)
    _grads_close(jg, t_tree.tree_map(lambda t: t.grad, tp), rel, gates)


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops, self.mm = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.mm += func in (torch.ops.aten.mm.default,
                            torch.ops.aten.bmm.default)
        return func(*args, **(kwargs or {}))


def test_remat_changes_memory_not_values():
    """``remat`` full / dots / none give the same loss and gradients bit
    for bit, and differ in what the backward recomputes: ``"full"``
    re-runs each layer's products, ``"dots"`` keeps them (the same matrix
    products in its backward as ``"none"``) and re-runs only the other
    ops, ``"none"`` re-runs nothing."""
    out = {}
    for remat in ("full", "dots", "none"):
        c = t_configs.get("qwen3-1.7b", reduced=True).replace(remat=remat)
        m = t_api.build(c)
        params = t_common.init_params(m.decls, seed=0, device="cpu")
        for t in t_tree.tree_leaves(params):
            t.requires_grad_(True)
        loss, _ = m.loss_fn(params, _tbatch(_batch(c.vocab_size, (2, 32),
                                                   4)))
        counter = _OpCounter()
        with counter:
            loss.backward()
        out[remat] = (float(loss.detach()), [t.grad for t in
                                    t_tree.tree_leaves(params)], counter)
    for remat in ("dots", "none"):
        assert out[remat][0] == out["full"][0]
        for a, b in zip(out[remat][1], out["full"][1]):
            assert torch.equal(a, b)
    full, dots, none = (out[r][2] for r in ("full", "dots", "none"))
    assert full.mm > dots.mm == none.mm
    assert full.ops > dots.ops > none.ops


def test_checkpoint_only_where_autograd_records(monkeypatch):
    """A layer runs under ``torch.utils.checkpoint`` only when autograd
    records it, as ``jax.checkpoint`` acts only under differentiation:
    ``loss_fn`` on parameters that require grad checkpoints every layer;
    ``prefill_fn`` with grad mode on, on parameters that do not, runs
    none, and its logits equal those under ``torch.no_grad()`` bit for
    bit."""
    from repro_torch.models import transformer as t_transformer

    calls = []
    real = t_transformer.ckpt.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(t_transformer.ckpt, "checkpoint", counted)
    c = t_configs.get("qwen3-1.7b", reduced=True).replace(remat="full")
    m = t_api.build(c)
    params = t_common.init_params(m.decls, seed=0, device="cpu")
    b = _tbatch(_batch(c.vocab_size, (2, 16), 6))
    assert torch.is_grad_enabled()
    logits = m.prefill_fn(params, {"tokens": b["tokens"]})
    assert calls == [] and not logits.requires_grad
    with torch.no_grad():
        assert torch.equal(logits, m.prefill_fn(params,
                                                {"tokens": b["tokens"]}))
    for t in t_tree.tree_leaves(params):
        t.requires_grad_(True)
    m.loss_fn(params, b)[0].backward()
    assert len(calls) == c.n_layers


def test_flash_attention_fn_is_the_mirrors_gradient():
    """``FlashAttentionFn`` on CPU tensors (forward: the wrapper's plain
    version, ``attention_ref``; backward: the chunked mirror's gradient):
    its dq, dk, dv equal the mirror's own autograd bit for bit, at a
    chunked length (2048 keys, chunk 1024) and at a dense one."""
    rng = np.random.default_rng(5)
    for s, chunk in ((2048, 1024), (100, 1024)):
        q, k, v = (torch.from_numpy(rng.standard_normal((1, h, s, 16))
                                    .astype(np.float32)).bfloat16()
                   for h in (4, 2, 2))
        dout = torch.from_numpy(rng.standard_normal((1, 4, s, 16))
                                .astype(np.float32)).bfloat16()
        grads = []
        for fn in (lambda *a: t_attn.FlashAttentionFn.apply(*a, True, chunk),
                   lambda *a: t_attn._flash_attention_chunked(*a, True,
                                                              chunk)):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            fn(*xs).backward(dout)
            grads.append([x.grad for x in xs])
        for a, b in zip(*grads):
            assert torch.equal(a, b)


def test_cpu_attention_keeps_the_mirror():
    """On CPU tensors ``flash_attention`` is the chunked mirror itself,
    autograd through its ops, with no Function node."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    out = t_attn.flash_attention(q, q.detach(), q.detach())
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__


def test_input_specs_match():
    jm = j_api.build(j_configs.get("qwen3-1.7b"))
    tm = t_api.build(t_configs.get("qwen3-1.7b"))
    for kind, b, s in (("train", 8, 64), ("prefill", 2, 128),
                       ("decode", 4, 256)):
        j = jm.input_specs(JShapeCell("x", kind, s, b))
        t = tm.input_specs(ShapeCell("x", kind, s, b))
        assert list(t) == list(j)
        for key in j:
            assert t[key].shape == j[key].shape
            assert t[key].dtype == torch.int32


# ------------------------------------------------------------ optimizers


@pytest.mark.parametrize("cfg", [
    dict(), dict(warmup_steps=3, total_steps=10),
    dict(warmup_steps=0, total_steps=1, lr=1e-3)])
def test_lr_schedule_matches(cfg):
    """Float32 on an int32 step, as JAX computes it with x64 off: within
    OPT_RTOL (cos may round its last bit otherwise)."""
    jcfg, tcfg = j_optim.OptimConfig(**cfg), t_optim.OptimConfig(**cfg)
    for step in (0, 1, 2, 3, 5, 99, 100, 101, 5000, 9999, 10000, 20000):
        a = j_optim.lr_schedule(jcfg, jnp.int32(step))
        b = t_optim.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert b.dtype == torch.float32
        np.testing.assert_allclose(float(b), float(a), rtol=OPT_RTOL)


def _opt_tree(rng):
    """Leaves the Adafactor factors (both last dims >= 128, also under a
    leading dim) and leaves it does not."""
    shapes = {"w": (128, 160), "stack": (2, 130, 128), "b": (160,),
              "small": (4, 4), "tall": (200, 3)}
    return {"layer": {k: rng.standard_normal(s).astype(np.float32) * 0.5
                      for k, s in shapes.items() if k != "small"},
            "small": rng.standard_normal(shapes["small"]).astype(np.float32)}


def test_clip_by_global_norm_matches():
    """Global norm and clipped leaves within OPT_RTOL, below and above
    the clip."""
    tree = _opt_tree(np.random.default_rng(6))
    for max_norm in (1.0, 1e4):
        ja, jn = j_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                             max_norm)
        ta, tn = t_optim.clip_by_global_norm(_to_torch(tree), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
        for a, b in zip(jax.tree.leaves(ja), t_tree.tree_leaves(ta)):
            np.testing.assert_allclose(_np(b), _np(a), rtol=OPT_RTOL,
                                       atol=OPT_RTOL * np.abs(_np(a)).max())


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_three_optimizer_steps_match(name):
    """Three steps on the same numpy gradients (one of them large enough
    to be clipped): parameters, every state leaf, grad_norm and lr within
    OPT_RTOL after each, each leaf's values also within OPT_RTOL of its
    largest magnitude (a parameter near 0 is the difference of larger
    terms); Adafactor factors its large leaves and keeps a full second
    moment for the others."""
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    cfg = dict(warmup_steps=2, total_steps=10)
    jcfg = j_optim.OptimConfig(name=name, **cfg)
    tcfg = t_optim.OptimConfig(name=name, **cfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _to_torch(params)
    js = j_optim.init_opt(name, jp, jcfg)
    ts = t_optim.init_opt(name, tp, tcfg)
    assert list(t_tree.flatten_dict(ts)) == list(j_tree.flatten_dict(js))
    if name == "adafactor":
        assert set(ts.stats["layer"]["w"]) == {"vr", "vc"}
        assert set(ts.stats["layer"]["stack"]) == {"vr", "vc"}
        assert set(ts.stats["small"]) == {"v"}
        assert set(ts.stats["layer"]["tall"]) == {"v"}
    update = jax.jit(functools.partial(j_optim.apply_opt, name, jcfg))
    for i in range(3):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32)
            * (30.0 if i == 1 else 0.1), params)
        jp, js, jstats = update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tstats = t_optim.apply_opt(name, tcfg, _to_torch(grads), ts,
                                           tp)
        assert int(ts.step) == int(js.step) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[key]),
                                       float(jstats[key]), rtol=OPT_RTOL)
        for tree_j, tree_t in ((jp, tp), (js, ts)):
            jf, tf = j_tree.flatten_dict(tree_j), t_tree.flatten_dict(tree_t)
            assert list(jf) == list(tf)
            for key in jf:
                a, b = _np(jf[key]), _np(tf[key])
                np.testing.assert_allclose(
                    b, a, rtol=OPT_RTOL, atol=OPT_RTOL * np.abs(a).max(),
                    err_msg=f"step {i + 1} {key}")


def test_optimizer_states_survive_a_checkpoint(tmp_path):
    """``AdamWState`` and ``AdafactorState`` come back from ``save`` /
    ``restore`` with their type, field names and every leaf."""
    tp = _to_torch(_opt_tree(np.random.default_rng(8)))
    cfg = t_optim.OptimConfig()
    for i, name in enumerate(("adamw", "adafactor")):
        state = t_optim.init_opt(name, tp, cfg)
        grads = t_tree.tree_map(torch.ones_like, tp)
        _, state, _ = t_optim.apply_opt(name, cfg, grads, state, tp)
        t_ckpt.save(str(tmp_path), i + 1, {"opt": state})
        like = t_tree.tree_map(lambda t: torch.empty_like(t, device="meta"),
                               state)
        back = t_ckpt.restore(str(tmp_path), i + 1, {"opt": like},
                              device="cpu")["opt"]
        assert type(back) is type(state)
        assert back._fields == state._fields
        a, b = t_tree.flatten_dict(state), t_tree.flatten_dict(back)
        assert list(a) == list(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert torch.equal(a[key], b[key]), key


# ------------------------------------------------------------ data


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-8b",
                                  "llama-3.2-vision-11b", "whisper-large-v3"])
def test_make_batch_is_bit_identical(arch):
    jc, tc = j_configs.get(arch, reduced=True), t_configs.get(arch,
                                                             reduced=True)
    for seed, step, (s, b) in ((0, 0, (32, 2)), (5, 17, (64, 3)),
                               (123, 999, (16, 8))):
        a = j_data.make_batch(jc, JShapeCell("t", "train", s, b), step,
                              j_data.DataConfig(seed=seed))
        o = t_data.make_batch(tc, ShapeCell("t", "train", s, b), step,
                              t_data.DataConfig(seed=seed))
        assert list(o) == list(a)
        for key in a:
            assert o[key].dtype == a[key].dtype
            np.testing.assert_array_equal(o[key], a[key])


def test_data_pipeline_yields_the_same_sequence():
    jc = j_configs.get("qwen3-1.7b", reduced=True)
    tc = t_configs.get("qwen3-1.7b", reduced=True)
    jpipe = j_data.DataPipeline(jc, JShapeCell("t", "train", 16, 2),
                                start_step=3)
    tpipe = t_data.DataPipeline(tc, ShapeCell("t", "train", 16, 2),
                                start_step=3)
    try:
        for _ in range(4):
            a, b = next(jpipe), next(tpipe)
            np.testing.assert_array_equal(b["tokens"], a["tokens"])
            np.testing.assert_array_equal(b["labels"], a["labels"])
        assert tpipe.step == jpipe.step == 7
    finally:
        jpipe.close()
        tpipe.close()
    assert not tpipe._thread.is_alive()


# ------------------------------------------------------------ train step


@functools.lru_cache(maxsize=None)
def _jax_jit(fn, *static):
    """One compiled JAX program a function (and static arguments) for the
    whole module: each compile is a chance of the XLA worker crash."""
    return jax.jit(functools.partial(fn, *static))


def _leaves_close(ref, got, what):
    """``flatten_dict`` keys equal, every leaf within OPT_RTOL, and within
    OPT_RTOL of the leaf's largest magnitude (a value near 0 is the
    difference of larger terms)."""
    jf, tf = j_tree.flatten_dict(ref), t_tree.flatten_dict(got)
    assert list(jf) == list(tf), what
    for key in jf:
        a, b = _np(jf[key]), _np(tf[key])
        assert a.shape == b.shape, (what, key)
        np.testing.assert_allclose(b, a, rtol=OPT_RTOL,
                                   atol=OPT_RTOL * np.abs(a).max(),
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax(compress, monkeypatch):
    """One step of ``make_train_step`` with ``grad_accum = 2`` (and with
    int8 gradient compression), held three ways.

    * The gradients the step hands ``apply_opt``: without compression the
      mean of the two microbatches' ``loss_fn`` gradients, bit for bit
      (``test_grad_accum_averages_the_microbatches``'s sums and halving);
      with it, the JAX package's ``quantize_grads_int8`` of that same
      mean within OPT_RTOL.
    * The parameters, optimizer state and grad_norm the step returns: the
      JAX package's ``apply_opt`` on those same gradients within
      OPT_RTOL.  A step that skipped, reversed or misrouted the update
      lands a learning rate or more away.
    * End to end against the JAX step on its own gradients: loss and ce
      within LOSS_REL, grad_norm within GRAD_REL, lr within OPT_RTOL, and
      every parameter within ``2 · lr`` plus OPT_RTOL (see the module
      docstring)."""
    jc, tc, jm, tm, jp, tp = _pair_params("qwen3-1.7b", grad_accum=2)
    cell_j = JShapeCell("t", "train", 32, 4)
    cell_t = ShapeCell("t", "train", 32, 4)
    jcfg = j_optim.OptimConfig(name=jc.optimizer)
    tcfg = t_optim.OptimConfig(name=tc.optimizer)
    b = j_data.make_batch(jc, cell_j, 0)
    halves = []
    for i in (0, 1):
        p = _to_torch(jp)
        leaves = t_tree.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tm.loss_fn(p, _tbatch({k: v[2 * i:2 * i + 2]
                                         for k, v in b.items()}))
        loss.backward()
        halves.append([t.grad for t in leaves])
    mean = t_tree.tree_unflatten(tp, [(a + h) / 2 for a, h in zip(*halves)])

    seen = {}
    real = t_optim.apply_opt

    def capture(name, cfg, grads, state, params, specs=None):
        seen["grads"] = t_tree.tree_map(torch.clone, grads)
        return real(name, cfg, grads, state, params, specs)

    monkeypatch.setattr(t_optim, "apply_opt", capture)
    tstep = t_train_step.make_train_step(tm, tcfg, cell_t,
                                         compress_grads=compress)[0]
    tp2, ts2, tmet = tstep(tp, t_optim.init_opt(tc.optimizer, tp, tcfg),
                           _tbatch(b))
    assert int(ts2.step) == 1
    grads = seen["grads"]
    jgrads = jax.tree.map(jnp.asarray, t_tree.tree_map(
        lambda t: t.numpy(), grads))
    if compress:
        _leaves_close(_jax_jit(j_train_step.quantize_grads_int8)(
            jax.tree.map(jnp.asarray, t_tree.tree_map(lambda t: t.numpy(),
                                                      mean))),
                      grads, "compressed gradients")
    else:
        for a, g in zip(t_tree.tree_leaves(mean), t_tree.tree_leaves(grads)):
            assert torch.equal(a, g)
    jp3, js3, jstats = _jax_jit(j_optim.apply_opt, jc.optimizer, jcfg)(
        jgrads, j_optim.init_opt(jc.optimizer, jp, jcfg), jp)
    _leaves_close(jp3, tp2, "parameters")
    _leaves_close(js3, ts2, "optimizer state")
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jstats[key]),
                                   rtol=OPT_RTOL)

    jstep = jax.jit(j_train_step.make_train_step(
        jm, jcfg, cell_j, compress_grads=compress)[0])
    jp2, _, jmet = jstep(jp, j_optim.init_opt(jc.optimizer, jp, jcfg),
                         _jbatch(b))
    assert set(tmet) == set(jmet) == {"ce", "aux", "loss", "grad_norm", "lr"}
    for key in ("loss", "ce"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= \
            LOSS_REL * abs(float(jmet[key]))
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_REL * float(jmet["grad_norm"])
    lr = float(jmet["lr"])
    np.testing.assert_allclose(float(tmet["lr"]), lr, rtol=OPT_RTOL)
    for a, t in zip(jax.tree.leaves(jp2), t_tree.tree_leaves(tp2)):
        a, t = _np(a), _np(t)
        assert np.all(np.abs(a - t) <= 2 * lr + OPT_RTOL * np.abs(a))


def test_grad_accum_averages_the_microbatches(monkeypatch):
    """``grad_accum = 2`` on a batch of 4 hands the optimizer the mean of
    the two microbatches' gradients, and its loss is their losses' mean,
    bit for bit (the same sums and the same exact halving)."""
    c = t_configs.get("qwen3-1.7b", reduced=True).replace(grad_accum=2)
    m = t_api.build(c)
    b = _tbatch(_batch(c.vocab_size, (4, 16), 9))
    seen = {}

    def capture(name, cfg, grads, state, params, specs=None):
        seen["grads"] = grads
        return params, state, {"grad_norm": 0.0, "lr": 0.0}

    monkeypatch.setattr(t_optim, "apply_opt", capture)
    step = t_train_step.make_train_step(
        m, t_optim.OptimConfig(), ShapeCell("t", "train", 16, 4))[0]
    params = t_common.init_params(m.decls, seed=0, device="cpu")
    _, _, met = step(params, t_optim.adamw_init(params), b)
    halves = []
    for i in (0, 1):
        p = t_common.init_params(m.decls, seed=0, device="cpu")
        for t in t_tree.tree_leaves(p):
            t.requires_grad_(True)
        loss, _ = m.loss_fn(p, {k: v[2 * i:2 * i + 2] for k, v in b.items()})
        loss.backward()
        halves.append((loss.detach(), [t.grad for t in t_tree.tree_leaves(p)]))
    assert float(met["loss"]) == float((halves[0][0] + halves[1][0]) / 2)
    for g, a, h in zip(t_tree.tree_leaves(seen["grads"]), halves[0][1],
                       halves[1][1]):
        assert torch.equal(g, (a + h) / 2)


def test_meshes_and_serve_steps():
    """The mesh paths of the serve steps raise ``NotImplementedError``
    naming their ROADMAP item (the dry run's); a train step on a model
    axis above 1 builds for a family other than dense (RWKV6's
    vocabulary split over ``model``); the serve steps without a mesh are
    the model's functions."""
    from repro_torch.launch.mesh import Mesh

    c = t_configs.get("qwen3-1.7b", reduced=True)
    m = t_api.build(c)
    cell = ShapeCell("t", "train", 8, 2)
    mesh = Mesh((1, 2), ("data", "model"))
    for make in (lambda: t_train_step.make_prefill_step(m, cell, mesh),
                 lambda: t_train_step.make_decode_step(m, cell, mesh)):
        with pytest.raises(NotImplementedError, match="Queue 1 #6"):
            make()
    rwkv = t_api.build(t_configs.get("rwkv6-1.6b", reduced=True))
    _, (pspecs, _, _), _, _ = t_train_step.make_train_step(
        rwkv, t_optim.OptimConfig(), cell, mesh=mesh)
    assert pspecs["embed"][0] == pspecs["unembed"][1] == "model"
    params = t_common.init_params(m.decls, seed=0, device="cpu")
    toks = torch.from_numpy(np.arange(16).reshape(2, 8) % c.vocab_size)
    prefill = t_train_step.make_prefill_step(m, cell)[0]
    assert torch.equal(prefill(params, {"tokens": toks}),
                       m.prefill_fn(params, {"tokens": toks}))
    decode = t_train_step.make_decode_step(m, cell)[0]
    logits, _ = decode(params, toks[:, 0], m.init_decode_state(params, 2, 8))
    assert logits.shape == (2, c.vocab_size)


# ------------------------------------------------------------ utils


def test_tree_keys_and_counts_match():
    """``flatten_dict`` keys of a parameter tree and of both optimizer
    states equal the JAX package's; counts, bytes, casts and round
    trips."""
    jc, tc, jm, tm, jp, tp = _pair_params("qwen3-8b")
    cfg = dict(name="adafactor")
    for jt, tt in ((jp, tp),
                   (j_optim.adamw_init(jp), t_optim.adamw_init(tp)),
                   (j_optim.adafactor_init(jp, j_optim.OptimConfig(**cfg)),
                    t_optim.adafactor_init(tp, t_optim.OptimConfig(**cfg))),
                   ([jp, (jnp.zeros(2), None)],
                    [tp, (torch.zeros(2), None)])):
        assert list(t_tree.flatten_dict(tt)) == list(j_tree.flatten_dict(jt))
        assert t_tree.param_count(tt) == j_tree.param_count(jt)
        assert t_tree.param_bytes(tt) == j_tree.param_bytes(jt)
    bf = t_tree.cast_tree(tp, torch.bfloat16)
    assert t_tree.param_bytes(bf) == j_tree.param_bytes(
        j_tree.cast_tree(jp, jnp.bfloat16))
    flat = t_tree.flatten_dict(tp)
    back = t_tree.unflatten_like(tp, flat)
    assert list(back) == list(tp)
    assert all(a is b for a, b in zip(t_tree.tree_leaves(back),
                                      t_tree.tree_leaves(tp)))
    del flat["embed"]
    with pytest.raises(KeyError, match="embed"):
        t_tree.unflatten_like(tp, flat)
    zeros = t_tree.tree_zeros_like(tp)
    assert all(not z.any() for z in t_tree.tree_leaves(zeros))


def test_named_generators_are_stable_and_independent():
    """The same (seed, name, step) gives the same draws whatever else was
    drawn first; another name, step or seed gives others.  (JAX's
    threefry stream has no counterpart: the draws are not the JAX
    package's.)"""
    draw = lambda g: torch.rand(8, generator=g)
    a = draw(t_prng.named_generator(0, "init", device="cpu"))
    draw(t_prng.named_generator(0, "data", 3, device="cpu"))
    assert torch.equal(a, draw(t_prng.named_generator(0, "init",
                                                      device="cpu")))
    others = [draw(t_prng.named_generator(*k, device="cpu"))
              for k in ((0, "data"), (0, "init", 1), (1, "init"))]
    others += [draw(g) for g in t_prng.split_named(0, "init", 3,
                                                   device="cpu")]
    rows = [a] + others
    for i in range(len(rows)):
        for j in range(i):
            assert not torch.equal(rows[i], rows[j])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_prng.named_generator(0, "init")


# ------------------------------------------------------------ the launcher


ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           OMP_NUM_THREADS="1")
BASE = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "10",
        "--seq-len", "64", "--global-batch", "4", "--device", "cpu"]


def _run(args, check=True):
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + args, capture_output=True, text=True, env=ENV,
                       cwd=REPO, timeout=600)
    if check and p.returncode != 0:
        raise AssertionError(f"train failed rc={p.returncode}\n{p.stdout}\n"
                             f"{p.stderr}")
    return p


def test_launcher_loss_decreases():
    """Synthetic Zipf tokens: the learnable signal is the unigram skew, so
    60 steps give a modest but real decrease (the JAX launcher's test)."""
    p = _run(BASE + ["--steps", "60"])
    losses = [float(l.split("loss ")[1].split()[0])
              for l in p.stdout.splitlines() if "loss " in l and "step" in l]
    assert len(losses) == 6
    assert losses[-1] < losses[0] - 0.01, losses


def test_launcher_resumes_bit_identically(tmp_path):
    """Fail at step 6 (``os._exit(42)``), resume from the step-4
    checkpoint to 10: ``final_loss`` equals the uninterrupted run's bit
    for bit (counter-based data, float32 state saved exactly)."""
    ck_a, ck_b = str(tmp_path / "a"), str(tmp_path / "b")
    p = _run(BASE + ["--ckpt-dir", ck_a, "--ckpt-every", "4",
                     "--simulate-failure-at", "6"], check=False)
    assert p.returncode == 42 and "SIMULATED FAILURE at step 6" in p.stdout
    assert t_ckpt.latest_step(ck_a) == 4
    pa = _run(BASE + ["--ckpt-dir", ck_a, "--ckpt-every", "4"])
    assert "resuming from checkpoint step 4" in pa.stdout
    pb = _run(BASE + ["--ckpt-dir", ck_b, "--ckpt-every", "4"])
    la = json.loads(pa.stdout.strip().splitlines()[-1])
    lb = json.loads(pb.stdout.strip().splitlines()[-1])
    assert la["steps_run"] == 6 and lb["steps_run"] == 10
    assert la["final_loss"] == lb["final_loss"]


def test_launcher_refuses_meshes_and_a_missing_card():
    """``--model`` above 1 on a family other than dense trains (RWKV6 on
    two gloo ranks of the CPU); an ``nccl`` group without a card a rank
    raises before any rank starts; without a card and without ``--device
    cpu`` the launcher raises "no CUDA device"."""
    p = _run(["--arch", "rwkv6-1.6b"] + BASE[2:] + ["--model", "2",
                                                    "--steps", "2"])
    assert json.loads(p.stdout.strip().splitlines()[-1])["steps_run"] == 2
    p = _run(BASE + ["--data", "2", "--backend", "nccl"], check=False)
    assert p.returncode != 0
    if not torch.cuda.is_available():
        assert "the nccl backend needs the card" in p.stderr
        p = _run(BASE[:-2], check=False)
        assert p.returncode != 0 and "no CUDA device" in p.stderr


def test_launcher_moe_resumes_a_model_axis_run_unsharded(tmp_path):
    """qwen3-moe-30b-a3b on a (2, 2) mesh (its experts split over
    ``model``, its dispatch groups over ``data``) checkpoints at step 2.
    Resumed at (1, 1) to step 4, ``final_loss`` equals bit for bit that
    of an unsharded run in this process restored from a copy of the same
    checkpoint (``launch.train.train``, one thread as the launcher's
    ranks); resumed at (2, 1) from another copy, it runs the 2 steps."""
    import shutil

    from repro_torch.launch import train as t_launch

    moe = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--seq-len", "64",
           "--global-batch", "4", "--device", "cpu"]
    ck = tmp_path / "ck"
    _run(moe + ["--ckpt-dir", str(ck), "--ckpt-every", "2", "--steps", "2",
                "--data", "2", "--model", "2", "--backend", "gloo"])
    with open(ck / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["mesh_shape"] == {"data": 2, "model": 2}
    copies = [tmp_path / "b", tmp_path / "c"]
    for dst in copies:
        shutil.copytree(ck, dst)
    p = _run(moe + ["--ckpt-dir", str(ck), "--steps", "4"])
    one = json.loads(p.stdout.strip().splitlines()[-1])
    assert "resuming from checkpoint step 2" in p.stdout
    assert one["steps_run"] == 2
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, hist = t_launch.train(
            t_configs.get("qwen3-moe-30b-a3b", reduced=True),
            ShapeCell("cli", "train", 64, 4), steps=4,
            ckpt_dir=str(copies[0]), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert [h["step"] for h in hist] == [2, 3]
    assert hist[-1]["loss"] == one["final_loss"]
    p = _run(moe + ["--ckpt-dir", str(copies[1]), "--steps", "4",
                    "--data", "2", "--backend", "gloo"])
    assert "resuming from checkpoint step 2" in p.stdout
    assert json.loads(p.stdout.strip().splitlines()[-1])["steps_run"] == 2

"""Data- and model-parallel training in the port, held to the JAX package's
mesh step and to the port's own unsharded step, on the CPU.

One JAX subprocess on 4 emulated host devices runs the JAX package's mesh
train step (``make_host_mesh`` at (2, 1), (1, 2) and (2, 2), one step)
for qwen3-1.7b, phi3-medium-14b and nemotron-4-340b at REDUCED size
(qwen3-1.7b also at (1, 4), where its query heads split and its KV heads
do not), every other family's config at (2, 1) and (1, 2), and
qwen3-moe-30b-a3b and llama-3.2-vision-11b at (2, 2), and pickles the
metrics and parameters (the VLM's image features in bf16, the input
specs' dtype, as the port casts them).
Meanwhile the port runs the same steps in gloo groups of CPU ranks
(``launch.ranks.spawn_ranks``; each world size once, every case of it in
one group), from the same weights (``init_params`` draws the JAX
package's bit for bit) and the same batches (``make_batch`` is bit for
bit too).  Every case runs ``grad_accum = 2`` on a (4 x 32) batch, so
each data rank runs one row of each microbatch; the MoE config also runs
a (2 x 32) batch, whose microbatch of one row every data rank runs whole
(two dispatch groups of 16 tokens, the JAX package's halving rule).
Everything is computed once per session (``runs``).

Tolerances, from the distances measured on this setup:

* ``LOSS_REL`` (1e-3): the step's loss against the JAX mesh step's.
  Measured at most 2.5e-4 (phi3 at (2, 2)): the same function, its bf16
  products summed in other orders.
* ``GNORM_REL`` (2^-8, one bf16 ulp): the grad norm against the JAX mesh
  step's.  The JAX package's own mesh steps differ from each other by up
  to 1.75e-3 (phi3 at (1, 2) against (2, 2)), so 1e-3 is below the floor;
  the port measured at most 1.2e-3.
* ``GRAD_REL`` (2^-5, as ``tests/test_torch_train.py``): every gradient
  the mesh step hands the optimizer, gathered whole, within that share of
  the leaf's largest magnitude of the port's unsharded step's.  Measured
  at most 0.011 (phi3's replicated heads at (1, 2)): each rank rounds its
  partial bf16 products before the float32 sums over ranks.
* Parameters after the step within ``STEP_BOUND * lr`` plus ``OPT_RTOL``
  of the JAX mesh step's: a first step moves each weight by lr times a
  bounded update whose sign follows the gradient's, so where the two
  gradients' signs differ (near 0) the weights differ by twice that
  bound.  AdamW's update is at most 1 in magnitude (``2 * lr``, as
  ``tests/test_torch_train.py``), Adafactor's first one at most
  ``1 / sqrt(1 - beta2) = 2^0.4`` (beta2 = 1 - 2^-0.8 at step 1); measured
  1.9997 and 2.6391 lr.
* The data axis of the other families (MoE, VLM, audio, RWKV6, Zamba2):
  held to the JAX mesh step at (2, 1), loss within ``LOSS_REL`` and grad
  norm within ``GNORM_REL`` (measured 3.0e-4 and, rows whole, 1.2e-3 for
  MoE, 1.5e-3 for Zamba2).  Two grad norms are not functions of their
  inputs to that precision, and are held inside the span of the JAX
  package's own mesh steps, widened by ``GNORM_REL`` (``SPAN``):
  - RWKV6's per-head group norm turns bf16 rounding into a large share
    of the gradient (``tests/test_torch_train.py``, ``RWKV_GRAD_REL``):
    the JAX package's own steps give 131.56 unsharded and at (2, 1) but
    59.73 at (1, 2), the same loss to 1e-4;
  - the VLM's is 72 % its cross blocks' FFN gates (26.9 of 37.5 in the
    port's unsharded step): at their init of 0 each gate's gradient is
    one bf16 product of the block's output with the residual's
    cotangent, summed over every position and channel, whose rounding
    follows the layout: the JAX package's steps give 37.60, 37.07 and
    37.74 at (2, 1), (1, 2) and (2, 2).
  Against the port's unsharded step (MoE's with the JAX package's
  dispatch groups forced): loss within 1e-5 relative (measured 1e-7:
  only the mean over ranks' rows reorders a sum), gradients within
  ``GRAD_REL`` (measured at most 0.0046).
* The model axis of the other families, at (1, 2) for each and at
  (2, 2) for qwen3-moe and the VLM: against the JAX mesh step as the
  dense family's (loss, grad norm or ``SPAN``, parameters); against the
  port's unsharded step, gradients within ``GRAD_REL`` and every rank's
  metrics equal.  Split heads and split experts round their partial
  bf16 products before the sums over ``model``, which moves the MoE
  configs' hidden states by bf16 ulps, and a near-tie router decision
  flips on one: the (1, 2) step moved qwen3-moe's loss by 1.2e-3 and
  its router gradient by 0.089 of its largest magnitude.  So the MoE
  configs' gradients are held with the unsharded step's expert ids
  (``_routing``, as ``tests/test_torch_moe.py``'s
  ``force_port_routing``): the mesh step takes them, with its own
  probabilities at those ids, and its own ids must equal them wherever
  the top k + 1 probabilities' gaps exceed ``DECIDED_GAP``.
* A (1, 1) mesh: the unsharded step bit for bit.

This module imports no JAX: the spawned ranks import it to find their
function.
"""
import contextlib
import fcntl
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import sharding as shd
from repro_torch.launch import train_step as ts
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import api, common, moe, transformer
from repro_torch.models.arch_config import ShapeCell
from repro_torch.train import data, optim
from repro_torch.utils import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ("qwen3-1.7b", "phi3-medium-14b", "nemotron-4-340b")
MESHES = ((2, 1), (1, 2), (2, 2))
OTHERS = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b",
          "llama-3.2-vision-11b", "whisper-large-v3", "rwkv6-1.6b",
          "zamba2-1.2b")
MOE = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
# the model axis of the other families
MODEL_CASES = ([(a, (1, 2)) for a in OTHERS]
               + [(a, (2, 2)) for a in ("qwen3-moe-30b-a3b",
                                        "llama-3.2-vision-11b")])
# the grad norms held inside the span of the JAX package's mesh steps
SPAN = {"rwkv6-1.6b": ((2, 1), (1, 2)),
        "llama-3.2-vision-11b": ((2, 1), (1, 2), (2, 2))}
# a router decision whose top k + 1 probabilities' gaps all exceed this
# (``tests/test_torch_moe.py``'s) must not flip
DECIDED_GAP = 2.0 ** -6
# whisper-large-v3's vocabulary, which divides by 2 and not by 4
WHISPER_VOCAB = 51866
SEQ, BATCH, ACCUM = 32, 4, 2
LOSS_REL = 1e-3
GNORM_REL = 2.0 ** -8
GRAD_REL = 2.0 ** -5
OPT_RTOL = 1e-6
DATA_LOSS_REL = 1e-5
STEP_BOUND = {"adamw": 2.0, "adafactor": 2.0 * 2.0 ** 0.4}

# the dense cases against the JAX mesh step; at (1, 4) qwen3's 4 query
# heads split but its 2 KV heads do not (each rank takes its q head's)
DENSE_CASES = [(a, m) for a in DENSE for m in MESHES] + [("qwen3-1.7b",
                                                        (1, 4))]
# (arch, mesh, variant): variant "" the (4 x 32) batch, "whole" the MoE
# config's (2 x 32) batch, "factored" nemotron's Adafactor factoring
# every leaf of at least 16 x 16
CASES = ([(a, m, "") for a, m in DENSE_CASES]
         + [(a, (2, 1), "") for a in OTHERS]
         + [(a, m, "") for a, m in MODEL_CASES]
         + [("qwen3-moe-30b-a3b", (2, 1), "whole")]
         + [("nemotron-4-340b", m, "factored") for m in ((1, 2), (2, 2))]
         + [("whisper-large-v3", (1, 4), "vocab")])

ORACLE = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.launch import sharding as shd
from repro.launch.mesh import make_host_mesh
from repro.launch.train import build_trainer
from repro.models.arch_config import ShapeCell
from repro.train.data import make_batch

out = {}
for arch, shape, batch in %(jobs)r:
    c = configs.get(arch, reduced=True).replace(grad_accum=%(accum)d)
    cell = ShapeCell("t", "train", %(seq)d, batch)
    mesh = make_host_mesh(*shape)
    rules = {"embed_act": "model"} if c.shard_residual_embed else {}
    with shd.use_mesh(mesh, rules):
        model, step, init_fn = build_trainer(c, cell, mesh)
        params, opt = init_fn(0)
        b = {k: jnp.asarray(v) for k, v in make_batch(c, cell, 0).items()}
        if "img_embeds" in b:       # bf16, the input specs' dtype
            b["img_embeds"] = b["img_embeds"].astype(jnp.bfloat16)
        params, opt, m = step(params, opt, b)
        out[(arch, shape, batch)] = (
            {k: float(v) for k, v in m.items()},
            {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
             for path, x in jax.tree_util.tree_flatten_with_path(params)[0]})
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""
JAX_JOBS = ([(a, m, BATCH) for a, m in DENSE_CASES]
            + [(a, (2, 1), BATCH) for a in OTHERS]
            + [(a, m, BATCH) for a, m in MODEL_CASES]
            + [("qwen3-moe-30b-a3b", (2, 1), 2)])


def _case(arch, variant):
    c = configs.get(arch, reduced=True).replace(grad_accum=ACCUM)
    if variant == "vocab":
        c = c.replace(vocab_size=WHISPER_VOCAB)
    cfg = optim.OptimConfig(name=c.optimizer, **(
        {"factored_min_dim": 16} if variant == "factored" else {}))
    cell = ShapeCell("t", "train", SEQ, 2 if variant == "whole" else BATCH)
    return c, cfg, cell


def port_step(arch, shape, variant=""):
    """One step of the port's train step for a case, on ``shape``'s mesh
    (None: no mesh) in the calling rank: (metrics, the gradients handed to
    the optimizer, the parameters after), the trees gathered whole."""
    c, cfg, cell = _case(arch, variant)
    model = api.build(c)
    batch = {k: torch.from_numpy(v)
             for k, v in data.make_batch(c, cell, 0).items()}
    mesh = None if shape is None else make_host_mesh(*shape)
    step, specs, _, _ = ts.make_train_step(model, cfg, cell, mesh)
    full = common.init_params(model.decls, seed=0, device="cpu")
    opt = optim.init_opt(c.optimizer, full, cfg)
    if mesh is not None:
        block = lambda t, s: shd.local_shard(t, s, mesh).contiguous().clone()
        full = tree.tree_map(block, full, specs[0])
        opt = tree.tree_map(block, opt, specs[1])
    seen, real = {}, optim.apply_opt

    def capture(name, cfg, grads, state, params, specs=None):
        seen["grads"] = tree.tree_map(torch.clone, grads)
        return real(name, cfg, grads, state, params, specs)

    optim.apply_opt = capture
    try:
        params, _, met = step(full, opt, batch)
    finally:
        optim.apply_opt = real
    grads = seen["grads"]
    if mesh is not None:
        with shd.use_mesh(mesh):
            whole = lambda t, s: shd.full_leaf(t, s, mesh)
            grads = tree.tree_map(whole, grads, specs[0])
            params = tree.tree_map(whole, params, specs[0])
    flat = lambda t: {k: v.detach().float().numpy()
                      for k, v in tree.flatten_dict(t).items()}
    return ({k: float(v) for k, v in met.items()}, flat(grads),
            flat(params))


@contextlib.contextmanager
def _groups(n):
    """``moe._n_groups`` forced to ``n``: the JAX package's dispatch
    groups at a data extent of ``n``, for an unsharded step."""
    real = moe._n_groups
    moe._n_groups = lambda tokens: n
    try:
        yield
    finally:
        moe._n_groups = real


@contextlib.contextmanager
def _routing(calls, force=False):
    """``moe.route`` appends each call's expert ids to ``calls`` or, with
    ``force``, takes call n's from ``calls[n]`` (the groups of this
    rank's data coordinate where a data rank runs its share of them),
    weighted by its own probabilities at those ids, renormalised.
    Yields [(own ids, ids taken, probabilities), ...] of the calls."""
    real, seen = moe.route, []

    def route(xg, w_router, top_k):
        logits, probs, own, own_p = real(xg, w_router, top_k)
        if not force:
            calls.append(own)
            seen.append((own, own, probs.detach()))
            return logits, probs, own, own_p
        ids, g = calls[len(seen)], xg.shape[0]
        if ids.shape[0] != g:
            r = shd.active_mesh().coord("data")
            ids = ids[r * g:(r + 1) * g]
        seen.append((own, ids, probs.detach()))
        top_p = torch.gather(probs, -1, ids)
        return logits, probs, ids, top_p / top_p.sum(-1, keepdim=True)

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def _flips(seen):
    """(flips where decided, flips) of a forced run's calls: tokens whose
    own ids differ from those taken, where every gap among the top k + 1
    probabilities exceeds DECIDED_GAP, and anywhere."""
    decided_flips = flips = 0
    for own, ids, probs in seen:
        k = own.shape[-1]
        top = torch.sort(probs, -1, descending=True).values[..., :k + 1]
        decided = (top[..., :-1] - top[..., 1:]).min(-1).values > DECIDED_GAP
        differ = (own != ids).any(-1)
        decided_flips += int((differ & decided).sum())
        flips += int(differ.sum())
    return decided_flips, flips


def _moe_model_axis(arch, shape):
    """A MoE config's model-axis case: (the mesh step, the mesh step with
    the unsharded step's expert ids, that unsharded step (the JAX
    package's dispatch groups at ``shape``'s data extent), (flips where
    decided, flips))."""
    calls = []
    with _groups(shape[0]), _routing(calls):
        ref = port_step(arch, None)
    free = port_step(arch, shape)
    with _routing(calls, force=True) as seen:
        forced = port_step(arch, shape)
    return free, forced, ref, _flips(seen)


def _moe_layer_check(mesh, dev="cpu"):
    """qwen3-moe's REDUCED MoE layer at ``mesh``'s ``model`` extent
    against the unsharded layer on the same bf16 input, on ``dev``: the
    outputs, the
    aux losses, the gradients of the input, the router and this rank's
    experts, the expert counts the expert FFN ran on, and the forward's
    collectives ((kind, axis, shape) of each ``Mesh`` sum and gather)."""
    c = configs.get("qwen3-moe-30b-a3b", reduced=True)
    e, d, f = c.n_experts, c.d_model, c.d_ff_expert
    rng = np.random.default_rng(7)
    n, m = mesh.axis_size("model"), mesh.coord("model")

    def draw(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(dev, dtype)

    x = draw((2, SEQ, d), 1.0)
    router = draw((d, e), d ** -0.5, torch.float32)
    experts = [draw((e, d, f), d ** -0.5), draw((e, d, f), d ** -0.5),
               draw((e, f, d), f ** -0.5)]
    proj = draw((2, SEQ, d), 1.0, torch.float32)
    mine = slice(m * e // n, (m + 1) * e // n)
    out, real_ffn = {}, moe.expert_ffn
    raw_names = ("all_to_all", "all_to_all_single", "all_gather",
                 "all_gather_into_tensor", "all_reduce", "reduce_scatter",
                 "reduce_scatter_tensor", "broadcast", "send", "recv")
    raw_real = {k: getattr(torch.distributed, k) for k in raw_names}
    for split in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in
                  [x, router] + [w[mine] if split else w for w in experts]]
        ran, ops = [], []

        def ffn(buf, *w):
            ran.append(buf.shape[1])
            return real_ffn(buf, *w)

        sums, gathers = mesh.sum, mesh.all_gather
        mesh.sum = lambda t, a: ops.append(("sum", a, tuple(t.shape))) \
            or sums(t, a)
        mesh.all_gather = lambda t, a: ops.append(
            ("gather", a, tuple(t.shape))) or gathers(t, a)
        raw = []
        for k, fn in raw_real.items():
            setattr(torch.distributed, k, lambda *a, _k=k, _fn=fn, **kw:
                    raw.append(_k) or _fn(*a, **kw))
        moe.expert_ffn = ffn
        try:
            with shd.use_mesh(mesh):
                y, aux = moe.moe_layer(*leaves, top_k=c.top_k,
                                       capacity_factor=c.capacity_factor,
                                       split=mesh if split else None)
        finally:
            moe.expert_ffn = real_ffn
            del mesh.sum, mesh.all_gather
            for k, fn in raw_real.items():
                setattr(torch.distributed, k, fn)
        forward_ops = list(ops)
        with shd.use_mesh(mesh):
            ((y.float() * proj).sum() + aux).backward()
        out[split] = {"y": y.detach().float().cpu().numpy(),
                      "aux": float(aux.detach()),
                      "grads": [t.grad.float().cpu().numpy()
                                for t in leaves],
                      "experts_run": ran, "ops": forward_ops, "raw": raw}
    out["mine"] = (mine.start, mine.stop)
    return out


def _bias_check(mesh):
    """whisper's GELU MLP (REDUCED) at ``mesh``'s ``model`` extent, with
    a non-zero ``b_down``, against the unsharded MLP: (largest distance,
    largest |y|, largest |b_down|)."""
    c = configs.get("whisper-large-v3", reduced=True)
    d, f = c.d_model, c.d_ff
    rng = np.random.default_rng(11)
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             * sc).to(torch.bfloat16)
         for k, s, sc in (("w_up", (d, f), d ** -0.5),
                          ("b_up", (f,), 0.1),
                          ("w_down", (f, d), f ** -0.5),
                          ("b_down", (d,), 1.0))}
    x = torch.from_numpy(rng.standard_normal((2, SEQ, d)).astype(
        np.float32)).to(torch.bfloat16)
    with shd.use_mesh(mesh):
        tp = transformer.tp_plan(c)
        n, m = tp.n, tp.m
        cols = slice(m * f // n, (m + 1) * f // n)
        local = dict(p, w_up=p["w_up"][:, cols], b_up=p["b_up"][cols],
                     w_down=p["w_down"][cols])
        y_tp = transformer._ffn(c, local, x, tp=tp)
    y = transformer._ffn(c, p, x)
    return (float((y_tp.float() - y.float()).abs().max()),
            float(y.float().abs().max()),
            float(p["b_down"].float().abs().max()))


def _port_world(rank, world):
    """Every case of this world size (spawned): rank 0 returns each
    case's metrics and whole trees, the others their metrics.  A MoE
    config's model-axis case returns ``_moe_model_axis``'s four; the
    world of 2 also runs the layer checks."""
    out = {}
    for arch, shape, variant in CASES:
        if shape[0] * shape[1] != world:
            continue
        if arch in MOE and shape[1] > 1:
            res = _moe_model_axis(arch, shape)
            out[(arch, shape, variant)] = res if rank == 0 else (
                res[0][0], res[1][0], res[3])
        else:
            res = port_step(arch, shape, variant)
            out[(arch, shape, variant)] = res if rank == 0 else res[0]
    if world == 2:
        mesh = make_host_mesh(1, 2)
        out["moe_layer"] = _moe_layer_check(mesh)
        out["bias"] = _bias_check(mesh)
    return out


def _unsharded(arch, variant):
    """The port's unsharded step; for the MoE configs with the two
    dispatch groups a data extent of 2 gives."""
    with _groups(2) if arch in MOE else contextlib.nullcontext():
        return port_step(arch, None, variant)


def _compute(tmp):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(ORACLE) % dict(jobs=JAX_JOBS, accum=ACCUM,
                                          seq=SEQ)
    proc = subprocess.Popen([sys.executable, "-c", code,
                             str(tmp / "jax.pkl")], cwd=REPO, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        ranks = {w: spawn_ranks(_port_world, w, timeout_s=600)
                 for w in (2, 4)}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ref = {key: _unsharded(*key)
                   for key in dict.fromkeys((a, v) for a, _, v in CASES)}
        finally:
            torch.set_num_threads(threads)
    finally:
        log = proc.communicate(timeout=900)[0]
    assert proc.returncode == 0, log
    with open(tmp / "jax.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return {"jax": jax_out, "ranks": ranks, "ref": ref}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Computed once per test session; under xdist the first worker to
    take the lock computes it and pickles it for the others."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _compute(tmp_path_factory.mktemp("par"))
    shared = tmp_path_factory.getbasetemp().parent / "torch_par_runs.pkl"
    with open(f"{shared}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if shared.is_file():
            return pickle.loads(shared.read_bytes())
        result = _compute(tmp_path_factory.mktemp("par"))
        shared.write_bytes(pickle.dumps(result))
        return result


def _port(runs, arch, shape, variant=""):
    return runs["ranks"][shape[0] * shape[1]][0][(arch, shape, variant)]


def _jax_close(runs, arch, shape, met, params, batch=BATCH):
    """Loss within LOSS_REL and grad norm within GNORM_REL (or inside
    ``SPAN``) of the JAX mesh step's at ``shape``, lr within OPT_RTOL,
    every parameter within STEP_BOUND lr."""
    jmet, jparams = runs["jax"][(arch, shape, batch)]
    assert abs(met["loss"] - jmet["loss"]) <= LOSS_REL * abs(jmet["loss"])
    if arch in SPAN:
        norms = [runs["jax"][(arch, m, BATCH)][0]["grad_norm"]
                 for m in SPAN[arch]]
        assert min(norms) * (1 - GNORM_REL) <= met["grad_norm"] <= \
            max(norms) * (1 + GNORM_REL)
    else:
        assert abs(met["grad_norm"] - jmet["grad_norm"]) <= \
            GNORM_REL * jmet["grad_norm"]
    lr = jmet["lr"]
    assert met["lr"] == pytest.approx(lr, rel=OPT_RTOL)
    assert sorted(params) == sorted(jparams)
    bound = STEP_BOUND[configs.get(arch).optimizer] * lr
    for key, a in jparams.items():
        a = a.astype(np.float32)
        assert np.all(np.abs(a - params[key])
                      <= bound + OPT_RTOL * np.abs(a)), key


def _grads_close(got, want, rel):
    assert list(got) == list(want)
    for key in want:
        a, b = want[key], got[key]
        assert a.shape == b.shape, key
        assert np.abs(a - b).max() <= rel * np.abs(a).max(), key


@pytest.mark.parametrize("arch,shape", DENSE_CASES)
def test_mesh_step_matches_jax(runs, arch, shape):
    """Loss within LOSS_REL and grad norm within GNORM_REL of the JAX
    mesh step's, lr within OPT_RTOL, every parameter within STEP_BOUND
    lr."""
    met, _, params = _port(runs, arch, shape)
    _jax_close(runs, arch, shape, met, params)


@pytest.mark.parametrize("arch,shape", DENSE_CASES)
def test_mesh_gradients_match_the_unsharded_step(runs, arch, shape):
    """The gradients the mesh step hands the optimizer, gathered whole,
    within GRAD_REL of the unsharded step's; every rank reports the same
    loss and grad norm bit for bit."""
    met, grads, _ = _port(runs, arch, shape)
    rmet, rgrads, _ = runs["ref"][(arch, "")]
    _grads_close(grads, rgrads, GRAD_REL)
    assert abs(met["loss"] - rmet["loss"]) <= LOSS_REL * abs(rmet["loss"])
    for other in runs["ranks"][shape[0] * shape[1]][1:]:
        assert other[(arch, shape, "")] == met


@pytest.mark.parametrize("arch,variant", [(a, "") for a in OTHERS]
                         + [("qwen3-moe-30b-a3b", "whole")])
def test_data_axis_of_the_other_families(runs, arch, variant):
    """(2, 1) against the JAX mesh step: loss within LOSS_REL and grad
    norm within GNORM_REL (rwkv6 and the VLM: within ``SPAN``).  Against
    the port's unsharded step: loss and aux within DATA_LOSS_REL,
    gradients within GRAD_REL, parameters within STEP_BOUND lr.  The MoE
    configs run each data rank's rows as one of the JAX package's two
    dispatch groups (or, with rows whole, both groups on each rank)."""
    met, grads, params = _port(runs, arch, (2, 1), variant)
    rmet, rgrads, rparams = runs["ref"][(arch, variant)]
    for key in ("loss", "aux"):
        assert abs(met[key] - rmet[key]) <= DATA_LOSS_REL * abs(rmet[key])
    _grads_close(grads, rgrads, GRAD_REL)
    bound = STEP_BOUND[configs.get(arch).optimizer] * rmet["lr"]
    for key, a in rparams.items():
        assert np.all(np.abs(a - params[key]) <= bound + OPT_RTOL
                      * np.abs(a)), key
    _jax_close(runs, arch, (2, 1), met, params, 2 if variant else BATCH)
    if arch in MOE:
        assert met["aux"] > 0


@pytest.mark.parametrize("arch,shape", MODEL_CASES)
def test_model_axis_of_the_other_families(runs, arch, shape):
    """The model axis of the MoE, VLM, audio, RWKV6 and Zamba2 configs
    against the JAX mesh step (``_jax_close``) and, gradients within
    GRAD_REL, against the port's unsharded step (the MoE configs' with
    its expert ids and dispatch groups, no decided router flip); every
    rank reports the same metrics."""
    res = _port(runs, arch, shape)
    others = runs["ranks"][shape[0] * shape[1]][1:]
    if arch in MOE:
        (met, _, params), (fmet, grads, _), (rmet, rgrads, _), flips = res
        assert flips[0] == 0, flips
        assert abs(fmet["loss"] - rmet["loss"]) <= \
            LOSS_REL * abs(rmet["loss"])
        assert met["aux"] > 0
        for other in others:
            assert other[(arch, shape, "")] == (met, fmet, flips)
    else:
        met, grads, params = res
        rmet, rgrads, _ = runs["ref"][(arch, "")]
        for other in others:
            assert other[(arch, shape, "")] == met
    _jax_close(runs, arch, shape, met, params)
    _grads_close(grads, rgrads, GRAD_REL)


def test_moe_layer_splits_its_experts(runs):
    """The expert-parallel MoE layer at ``model`` 2 on the same input as
    the unsharded layer: its expert FFN runs on E/2 experts (the
    unsharded on E); its forward's one collective is one sum over
    ``model`` of the (G, Tg, D) output (one ``torch.distributed``
    ``all_gather`` of the ranks' partials), with no gather of rows and no
    all-to-all;
    the output within 2^-7 of its largest magnitude (each rank rounds its
    partial sum of bf16 adds) and the aux loss equal; the gradients of
    the input, of the router (whole on each rank: neither halved nor
    doubled) and of this rank's experts within 2^-6 of the unsharded
    layer's largest magnitude."""
    out = runs["ranks"][2][0]["moe_layer"]
    whole, split = out[False], out[True]
    e = configs.get("qwen3-moe-30b-a3b", reduced=True).n_experts
    assert whole["experts_run"] == [e] and split["experts_run"] == [e // 2]
    assert whole["ops"] == whole["raw"] == []
    assert split["ops"] == [("sum", "model", whole["y"].reshape(
        1, -1, whole["y"].shape[-1]).shape)]
    assert split["raw"] == ["all_gather"]
    scale = np.abs(whole["y"]).max()
    assert np.abs(split["y"] - whole["y"]).max() <= 2.0 ** -7 * scale
    assert split["aux"] == whole["aux"]
    lo, hi = out["mine"]
    for i, (g, w) in enumerate(zip(split["grads"], whole["grads"])):
        w = w[lo:hi] if i >= 2 else w
        assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max(), i


def test_whisper_output_bias_is_added_once(runs):
    """whisper's MLP at ``model`` 2 with a non-zero ``b_down``: within
    2^-7 of the unsharded MLP's largest magnitude, and the bias it would
    add a second time is far beyond that distance."""
    dist, scale, bias = runs["ranks"][2][0]["bias"]
    assert dist <= 2.0 ** -7 * scale
    assert bias > 16 * dist


def test_whisper_vocabulary_replicates_at_model_4(runs):
    """whisper-large-v3's vocabulary (51 866) splits over ``model`` 2 and
    not 4: there the embedding and the logits stay whole on every rank.
    A REDUCED whisper with that vocabulary at (1, 4) (heads and FFN split
    four ways, the vocabulary whole): loss within LOSS_REL and
    gradients within GRAD_REL of the port's unsharded step; every rank's
    metrics equal."""
    full = configs.get("whisper-large-v3")
    assert full.vocab_size == WHISPER_VOCAB
    for n, split in ((2, True), (4, False)):
        mesh = Mesh((1, n), ("data", "model"), coords={"data": 0,
                                                      "model": 0})
        with shd.use_mesh(mesh):
            assert transformer.tp_plan(full).vocab is split
            specs = shd.param_specs(api.build(full).decls)
        assert ("model" in specs["embed"]) is split
    met, grads, _ = _port(runs, "whisper-large-v3", (1, 4), "vocab")
    rmet, rgrads, _ = runs["ref"][("whisper-large-v3", "vocab")]
    assert abs(met["loss"] - rmet["loss"]) <= LOSS_REL * rmet["loss"]
    _grads_close(grads, rgrads, GRAD_REL)
    for other in runs["ranks"][4][1:]:
        assert other[("whisper-large-v3", (1, 4), "vocab")] == met


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_adafactor_factors_as_unsharded(runs, shape):
    """nemotron's Adafactor factoring every leaf of at least 16 x 16 (its
    REDUCED leaves are under the default 128): the statistics' row and
    column means over sharded leaves, the update RMS and the global norm
    taken across the ranks: gradients within GRAD_REL, grad norm within
    GNORM_REL and parameters within STEP_BOUND lr of the unsharded
    step's."""
    met, grads, params = _port(runs, "nemotron-4-340b", shape, "factored")
    rmet, rgrads, rparams = runs["ref"][("nemotron-4-340b", "factored")]
    _grads_close(grads, rgrads, GRAD_REL)
    assert abs(met["grad_norm"] - rmet["grad_norm"]) <= \
        GNORM_REL * rmet["grad_norm"]
    bound = STEP_BOUND["adafactor"] * rmet["lr"]
    for key, a in rparams.items():
        assert np.all(np.abs(a - params[key]) <= bound + OPT_RTOL
                      * np.abs(a)), key


def test_one_by_one_mesh_is_the_unsharded_step():
    """A (1, 1) mesh: metrics, gradients and parameters equal the
    unsharded step's bit for bit (no axis splits anything, so every
    reduction takes the unsharded code path)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a = port_step("qwen3-1.7b", None)
        b = port_step("qwen3-1.7b", (1, 1))
    finally:
        torch.set_num_threads(threads)
    assert a[0] == b[0]
    for x, y in ((a[1], b[1]), (a[2], b[2])):
        assert list(x) == list(y)
        for key in x:
            assert np.array_equal(x[key], y[key]), key


def test_specs_describe_the_state():
    """The step's in/out specs: parameters per ``param_specs``, AdamW's
    moments alike, Adafactor's factored statistics without the dim they
    average over, the batch over ``data``, the metrics replicated."""
    mesh = Mesh((2, 2), ("data", "model"))
    c, cfg, cell = _case("nemotron-4-340b", "factored")
    model = api.build(c)
    _, (pspecs, ospecs, bspecs), out, bspecs2 = ts.make_train_step(
        model, cfg, cell, mesh)
    assert bspecs == bspecs2 == {"tokens": ("data",), "labels": ("data",)}
    assert pspecs["layers"]["wq"] == (None, "data", "model")
    assert ospecs.stats["layers"]["wq"] == {"vr": (None, "data"),
                                            "vc": (None, "model")}
    assert out[2] == dict.fromkeys(("ce", "aux", "loss", "grad_norm", "lr"),
                                   ())
    c = configs.get("qwen3-1.7b", reduced=True)
    model = api.build(c)
    _, (pspecs, ospecs, _), _, _ = ts.make_train_step(
        model, optim.OptimConfig(), cell, mesh)
    assert ospecs.m == ospecs.v == pspecs and ospecs.step == ()


# ------------------------------------------------------------ the launcher


ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
           OMP_NUM_THREADS="1")
BASE = ["--arch", "qwen3-1.7b", "--reduced", "--seq-len", "64",
        "--global-batch", "4", "--device", "cpu"]
MESH = ["--data", "2", "--model", "2", "--backend", "gloo"]


def _launch(args, check=True):
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + BASE + args, capture_output=True, text=True,
                       env=ENV, cwd=REPO, timeout=600)
    if check and p.returncode != 0:
        raise AssertionError(f"train failed rc={p.returncode}\n{p.stdout}\n"
                             f"{p.stderr}")
    return p


def _last_json(p):
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1, p.stdout        # rank 0 alone prints it
    return json.loads(lines[0])


def test_launcher_resumes_on_another_mesh(tmp_path):
    """Save on one rank at step 5, resume with ``--data 2 --model 2``
    (elastic restart, as the JAX package's
    ``test_elastic_restore_different_device_count``): 3 steps run, from
    the unsharded checkpoint."""
    ck = str(tmp_path / "ck")
    _launch(["--ckpt-dir", ck, "--ckpt-every", "5", "--steps", "5"])
    p = _launch(["--ckpt-dir", ck, "--ckpt-every", "5", "--steps", "8"]
                + MESH)
    assert _last_json(p)["steps_run"] == 3
    assert "resuming from checkpoint step 5" in p.stdout


def test_launcher_mesh_run_resumes_bit_identically(tmp_path):
    """On a (2, 2) mesh: a simulated failure at step 6 exits 42 after the
    step-4 checkpoint (whole arrays, the mesh's shape in its manifest);
    resumed to 8, ``final_loss`` equals an uninterrupted run's bit for
    bit (rank-ordered sums, exact blocks of the saved arrays)."""
    ck_a, ck_b = str(tmp_path / "a"), str(tmp_path / "b")
    run = ["--steps", "8", "--ckpt-every", "4"] + MESH
    p = _launch(run + ["--ckpt-dir", ck_a, "--simulate-failure-at", "6"],
                check=False)
    assert p.returncode == 42, p.stderr
    assert "SIMULATED FAILURE at step 6" in p.stdout
    from repro_torch.train import checkpoint
    assert checkpoint.latest_step(ck_a) == 4
    with open(os.path.join(ck_a, "step_00000004", "manifest.json")) as f:
        assert json.load(f)["mesh_shape"] == {"data": 2, "model": 2}
    pa = _launch(run + ["--ckpt-dir", ck_a])
    pb = _launch(run + ["--ckpt-dir", ck_b])
    la, lb = _last_json(pa), _last_json(pb)
    assert la["steps_run"] == 4 and lb["steps_run"] == 8
    assert la["final_loss"] == lb["final_loss"]

"""Data- and model-parallel training in the port, held to the JAX package's
mesh step and to the port's own unsharded step, on the CPU.

One JAX subprocess on 4 emulated host devices runs the JAX package's mesh
train step (``make_host_mesh`` at (2, 1), (1, 2) and (2, 2), one step)
for qwen3-1.7b, phi3-medium-14b and nemotron-4-340b at REDUCED size
(qwen3-1.7b also at (1, 4), where its query heads split and its KV heads
do not), qwen3-moe-30b-a3b, rwkv6-1.6b and zamba2-1.2b at (2, 1) and
rwkv6-1.6b at (1, 2), and pickles the metrics and parameters.
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
* The data axis for MoE, RWKV6 and Zamba2 (the model axis is the dense
  family's alone): held to the JAX mesh step at (2, 1), loss within
  ``LOSS_REL`` and grad norm within ``GNORM_REL`` (measured 3.0e-4 and,
  rows whole, 1.2e-3 for MoE, 1.5e-3 for Zamba2).  RWKV6's grad norm is not a function of its
  inputs to that precision: its per-head group norm turns bf16 rounding
  into a large share of the gradient (``tests/test_torch_train.py``,
  ``RWKV_GRAD_REL``), and the JAX package's own steps on these inputs
  give 131.56 unsharded and at (2, 1) but 59.73 at (1, 2), the same loss
  to 1e-4.  So the port's (62.53) is held inside the span of those two
  JAX mesh steps, widened by ``GNORM_REL``.  Against the port's
  unsharded step (MoE's with the JAX package's two dispatch groups
  forced): loss within 1e-5 relative (measured 1e-7: only the mean over
  ranks' rows reorders a sum), gradients within ``GRAD_REL`` (measured
  at most 0.0046).
* A (1, 1) mesh: the unsharded step bit for bit.

This module imports no JAX: the spawned ranks import it to find their
function.
"""
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
from repro_torch.models import api, common, moe
from repro_torch.models.arch_config import ShapeCell
from repro_torch.train import data, optim
from repro_torch.utils import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ("qwen3-1.7b", "phi3-medium-14b", "nemotron-4-340b")
MESHES = ((2, 1), (1, 2), (2, 2))
OTHERS = ("qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-1.2b")
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
         + [("qwen3-moe-30b-a3b", (2, 1), "whole")]
         + [("nemotron-4-340b", m, "factored") for m in ((1, 2), (2, 2))])

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
            + [("qwen3-moe-30b-a3b", (2, 1), 2),
               ("rwkv6-1.6b", (1, 2), BATCH)])


def _case(arch, variant):
    c = configs.get(arch, reduced=True).replace(grad_accum=ACCUM)
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


def _port_world(rank, world):
    """Every case of this world size (spawned): rank 0 returns each
    case's metrics and whole trees, the others their metrics."""
    out = {}
    for arch, shape, variant in CASES:
        if shape[0] * shape[1] == world:
            res = port_step(arch, shape, variant)
            out[(arch, shape, variant)] = res if rank == 0 else res[0]
    return out


def _unsharded(arch, variant):
    """The port's unsharded step; for the MoE config with the two
    dispatch groups a data extent of 2 gives."""
    real = moe._n_groups
    if arch.startswith("qwen3-moe"):
        moe._n_groups = lambda tokens: 2
    try:
        return port_step(arch, None, variant)
    finally:
        moe._n_groups = real


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
            ref = {(a, v): _unsharded(a, v) for a, _, v in CASES}
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
    jmet, jparams = runs["jax"][(arch, shape, BATCH)]
    assert abs(met["loss"] - jmet["loss"]) <= LOSS_REL * abs(jmet["loss"])
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
    norm within GNORM_REL (rwkv6: within the span of the JAX package's
    own (2, 1) and (1, 2) steps', widened by GNORM_REL).  Against the port's unsharded step: loss and
    aux within DATA_LOSS_REL, gradients within GRAD_REL, parameters
    within STEP_BOUND lr.
    The MoE config runs each data rank's rows as one of the JAX package's
    two dispatch groups (or, with rows whole, both groups on each
    rank)."""
    met, grads, params = _port(runs, arch, (2, 1), variant)
    rmet, rgrads, rparams = runs["ref"][(arch, variant)]
    for key in ("loss", "aux"):
        assert abs(met[key] - rmet[key]) <= DATA_LOSS_REL * abs(rmet[key])
    _grads_close(grads, rgrads, GRAD_REL)
    bound = STEP_BOUND[configs.get(arch).optimizer] * rmet["lr"]
    for key, a in rparams.items():
        assert np.all(np.abs(a - params[key]) <= bound + OPT_RTOL
                      * np.abs(a)), key
    jmet = runs["jax"][(arch, (2, 1), 2 if variant else BATCH)][0]
    assert abs(met["loss"] - jmet["loss"]) <= LOSS_REL * jmet["loss"]
    if arch == "rwkv6-1.6b":
        norms = [runs["jax"][(arch, m, BATCH)][0]["grad_norm"]
                 for m in ((2, 1), (1, 2))]
        assert min(norms) * (1 - GNORM_REL) <= met["grad_norm"] <= \
            max(norms) * (1 + GNORM_REL)
    else:
        assert abs(met["grad_norm"] - jmet["grad_norm"]) <= \
            GNORM_REL * jmet["grad_norm"]
    if arch.startswith("qwen3-moe"):
        assert met["aux"] > 0


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


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if configs.get(a).family != "dense"])
def test_model_axis_raises_for_other_families(arch):
    """``model`` above 1 on a family other than dense raises, naming the
    ROADMAP item; the data axis alone builds."""
    c = configs.get(arch, reduced=True)
    model = api.build(c)
    cell = ShapeCell("t", "train", SEQ, BATCH)
    with pytest.raises(NotImplementedError, match="Queue 1 #2b"):
        ts.make_train_step(model, optim.OptimConfig(), cell,
                           Mesh((1, 2), ("data", "model")))
    ts.make_train_step(model, optim.OptimConfig(), cell,
                       Mesh((2, 1), ("data", "model")))


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

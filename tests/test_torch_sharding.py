"""The port's logical-axis sharding and meshes held to the JAX package's.

* ``resolve_spec`` over every parameter declaration, ``param_specs`` and
  ``spec_bytes_per_device`` equal the JAX package's for every config of
  ``ARCH_IDS``, at its published widths and at REDUCED size, on meshes
  (2, 4), (16, 16) and (2, 16, 16): one JAX subprocess on 512 emulated
  host devices (``XLA_FLAGS``, as ``tests/test_distributed.py``'s
  ``test_multipod_mesh_axes``) computes them once per session.  A spec
  compares as a tuple with its trailing Nones dropped (JAX's
  ``PartitionSpec`` keeps what it is given; the port's drops them).
* ``_batch_spec`` equals the JAX package's, and so do the rule cases of
  ``tests/test_distributed.py::test_sharding_rules_divisibility``.
* A host mesh of 4 gloo CPU ranks lies row-major (``rank = d * model +
  m``); its collectives return the ranks' values in coordinate order,
  sums fold in that order on every rank, blocks gather back whole, and
  the tensor-parallel collectives' gradients are the sums they stand for.
"""
import fcntl
import os
import pickle
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch import train_step as ts
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models import api
from repro_torch.models.arch_config import ShapeCell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULE_CASES = [(("embed", "mlp"), (64, 128)), (("vocab", "embed"), (51866, 64)),
              (("batch", None), (16, 7)), (("heads", "mlp"), (8, 8)),
              (("embed", "batch"), (32, 32)), (("experts", None), (6, 4)),
              (("layers", "embed", "heads"), (2, 96, 96)), ((None,), (3,))]
CELLS = [("train", 4096, 256), ("train", 64, 3), ("prefill", 128, 1)]
TOKENS = (1, 6, 24, 31, 32, 48, 4096)

ORACLE = """
import pickle, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.launch import sharding as shd
from repro.launch import train_step as ts
from repro.models import api
from repro.models.arch_config import ShapeCell
from repro.models import moe as jmoe
from repro.models.common import is_decl

def norm(spec):
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)

meshes = %(meshes)r
devices = np.array(jax.devices())
out = {"specs": {}, "bytes": {}, "rules": {}, "batch": {}, "groups": {}}
for name, (shape, axes) in meshes.items():
    n = int(np.prod(shape))
    mesh = Mesh(devices[:n].reshape(shape), axes)
    with shd.use_mesh(mesh):
        for arch in configs.ARCH_IDS:
            for reduced in (False, True):
                decls = api.build(configs.get(arch, reduced=reduced)).decls
                flat = jax.tree_util.tree_flatten_with_path(
                    decls, is_leaf=is_decl)[0]
                specs = jax.tree_util.tree_flatten_with_path(
                    shd.param_specs(decls),
                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
                out["specs"][(name, arch, reduced)] = [
                    (jax.tree_util.keystr(p), norm(shd.resolve_spec(d.names, d.shape)),
                     norm(s)) for (p, d), (_, s) in zip(flat, specs)]
                out["bytes"][(name, arch, reduced)] = shd.spec_bytes_per_device(decls)
        for names, shape in %(rules)r:
            out["rules"][(name, names, shape)] = norm(shd.resolve_spec(names, shape))
            out["rules"][(name, names, None)] = norm(shd.resolve_spec(names))
        n_data = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                              if a in mesh.shape]))
        for t in %(tokens)r:
            for tt in (t, t * n_data):
                out["groups"][(name, tt)] = jmoe._n_groups(tt)
        for kind, seq, batch in %(cells)r:
            for nd in (1, 2, 3):
                out["batch"][(name, kind, seq, batch, nd)] = norm(
                    ts._batch_spec(mesh, ShapeCell("c", kind, seq, batch), nd))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _compute(tmp):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    code = textwrap.dedent(ORACLE) % dict(meshes=MESHES, rules=RULE_CASES,
                                          cells=CELLS, tokens=TOKENS)
    p = subprocess.run([sys.executable, "-c", code, str(tmp / "specs.pkl")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stdout + p.stderr
    with open(tmp / "specs.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    """Computed once per test session; under xdist the first worker to
    take the lock computes it and pickles it for the others."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _compute(tmp_path_factory.mktemp("specs"))
    shared = tmp_path_factory.getbasetemp().parent / "torch_specs.pkl"
    with open(f"{shared}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if shared.is_file():
            return pickle.loads(shared.read_bytes())
        result = _compute(tmp_path_factory.mktemp("specs"))
        shared.write_bytes(pickle.dumps(result))
        return result


def _keystr(path):
    return "".join(f"[{k!r}]" for k in path)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_jax(jax_specs, arch):
    """Every declaration's ``resolve_spec``, its ``param_specs`` entry and
    the tree's ``spec_bytes_per_device``, at full and REDUCED size, on
    each mesh."""
    from repro_torch.utils.tree import tree_flatten_with_path
    for name, (shape, axes) in MESHES.items():
        with shd.use_mesh(Mesh(shape, axes)):
            for reduced in (False, True):
                decls = api.build(configs.get(arch, reduced=reduced)).decls
                specs = dict(tree_flatten_with_path(shd.param_specs(decls)))
                got = [(_keystr(p), tuple(shd.resolve_spec(d.names,
                                                           d.shape)),
                        tuple(specs[p]))
                       for p, d in tree_flatten_with_path(decls)]
                key = (name, arch, reduced)
                assert got == jax_specs["specs"][key], key
                assert shd.spec_bytes_per_device(decls) == \
                    jax_specs["bytes"][key], key


def test_rules_and_batch_specs_match_jax(jax_specs):
    """The divisibility rule cases (with and without a shape: an axis
    serves one dim, 'pod' drops off a mesh without it) and ``_batch_spec``
    of train and prefill cells."""
    for name, (shape, axes) in MESHES.items():
        mesh = Mesh(shape, axes)
        with shd.use_mesh(mesh):
            for names, dims in RULE_CASES:
                for d in (dims, None):
                    assert tuple(shd.resolve_spec(names, d)) == \
                        jax_specs["rules"][(name, names, d)]
        for kind, seq, batch in CELLS:
            for nd in (1, 2, 3):
                got = ts._batch_spec(mesh, ShapeCell("c", kind, seq, batch),
                                     nd)
                assert tuple(got) == \
                    jax_specs["batch"][(name, kind, seq, batch, nd)]
    assert shd.resolve_spec(("embed",), (4,)) == ()   # no active mesh


def test_moe_dispatch_groups_match_jax(jax_specs):
    """``moe._n_groups``: the data extent halved until it divides the
    tokens, as the JAX package's; with the rows split over the data axes
    each rank's share of tokens is one of those groups."""
    from repro_torch.models import moe

    for name, (shape, axes) in MESHES.items():
        mesh = Mesh(shape, axes)
        data = tuple(a for a in ("pod", "data") if a in axes)
        n = 1
        for a in data:
            n *= mesh.axis_size(a)
        with shd.use_mesh(mesh):
            for t in TOKENS:
                assert moe._n_groups(t) == jax_specs["groups"][(name, t)]
                if jax_specs["groups"][(name, t * n)] == n:
                    with shd.split_rows(data):
                        assert moe._n_groups(t) == 1
    assert moe._n_groups(31) == 1                    # no active mesh


def test_meshes_of_shape_only():
    """The production meshes' axes and shapes; a shape-only mesh runs no
    collective; ``constrain`` is the identity; the H100's constants."""
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert mesh_lib.mesh_axis_sizes(single) == {"data": 16, "model": 16}
    assert mesh_lib.mesh_axis_sizes(multi) == {"pod": 2, "data": 16,
                                               "model": 16}
    with pytest.raises(RuntimeError, match="shape only"):
        multi.all_gather(torch.zeros(2), "data")
    x = torch.arange(3.0)
    assert shd.constrain(x, ("batch",)) is x
    assert mesh_lib.PEAK_FLOPS_BF16 == 989e12
    assert mesh_lib.HBM_BW == 3.35e12 and mesh_lib.HBM_BYTES == 80 * 2**30
    one = make_host_mesh()
    assert one.shape == {"data": 1, "model": 1}
    assert one.all_gather(x, "model") == [x] and one.sum(x, "data") is x
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_host_mesh(2, 2)


def test_local_shards_tile_the_leaf():
    """``local_shard`` blocks of every rank of a (2, 2) mesh put back in
    coordinate order give the leaf; ``local_shape`` is their shape; a
    ('pod', 'data') dim orders pod major."""
    full = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = shd.PS(None, ("data",), "model")
    blocks = {}
    for d in range(2):
        for m in range(2):
            mesh = Mesh((2, 2), ("data", "model"),
                        coords={"data": d, "model": m})
            blocks[d, m] = shd.local_shard(full, spec, mesh)
            assert blocks[d, m].shape == shd.local_shape(full.shape, spec,
                                                         mesh) == (4, 3, 4)
    rows = [torch.cat([blocks[d, m] for m in range(2)], dim=2)
            for d in range(2)]
    assert torch.equal(torch.cat(rows, dim=1), full)
    mesh = Mesh((2, 3, 1), ("pod", "data", "model"),
                coords={"pod": 1, "data": 2, "model": 0})
    row = shd.local_shard(torch.arange(12), shd.PS(("pod", "data")), mesh)
    assert row.tolist() == [10, 11]            # block 1 * 3 + 2 of 6


def _mesh_rank(rank, world):
    """A (2, 2) host mesh's layout and collectives (spawned)."""
    mesh = make_host_mesh(2, 2)
    out = {"coords": dict(mesh.coords)}
    x = torch.tensor([float(rank)])
    out["gather"] = {a: [float(t) for t in mesh.all_gather(x, a)]
                     for a in ("data", "model")}
    # a sum whose order shows: 1 + 2^-24 + ... rounds by position
    y = torch.tensor([1.0 if rank % 2 == 0 else 2.0 ** -24])
    out["sum"] = float(mesh.sum(mesh.sum(y, "model"), "data"))
    out["max"] = float(mesh.max(x, "data"))
    spec = shd.PS(("data",), "model")
    full = torch.arange(16.0).reshape(4, 4)
    block = shd.local_shard(full, spec, mesh)
    out["whole"] = torch.equal(shd.full_leaf(block, spec, mesh), full)
    out["bytes"] = (mesh.bytes_gathered, mesh.bytes_summed)
    # the tensor-parallel collectives' gradients, against their sums
    w = torch.tensor([1.0 + rank, 2.0], requires_grad=True)
    z = coll.copy_to(w, mesh, "model") * (mesh.coord("model") + 1)
    coll.reduce_from(z, mesh, "model").sum().backward()
    out["copy_reduce_grad"] = w.grad.tolist()
    v = torch.tensor([float(rank)], requires_grad=True)
    g = coll.gather_from(v, mesh, "model", 0)
    (g * torch.tensor([1.0, 10.0])).sum().backward()
    out["gather_grad"] = v.grad.tolist()
    out["remat_threads"] = _remat_in_another_thread(mesh)
    return out


def _remat_in_another_thread(mesh):
    """The REDUCED qwen3-1.7b's tensor-parallel loss on this rank's
    ``model`` blocks, its backward (whose remat recomputes the layers)
    run once in this thread and once in another that has no mesh, as a
    CUDA backward runs in autograd's own thread: the gradients equal."""
    import threading

    from repro_torch.models import common
    from repro_torch.utils import tree

    c = configs.get("qwen3-1.7b", reduced=True)
    model = api.build(c)
    with shd.use_mesh(mesh):
        specs = shd.param_specs(model.decls)
    full = common.init_params(model.decls, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, c.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": toks, "labels": toks.roll(1, 1)}
    grads = []
    for other_thread in (False, True):
        params = tree.tree_map(lambda t, s: shd.local_shard(
            t, s, mesh, skip=("data",)).clone().requires_grad_(), full,
            specs)
        with shd.use_mesh(mesh):
            loss, _ = model.loss_fn(params, batch)
        if other_thread:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
        grads.append([p.grad for p in tree.tree_leaves(params)])
    return all(a is not None and b is not None and torch.equal(a, b)
               for a, b in zip(*grads))


def test_host_mesh_layout_and_collectives():
    """Four gloo CPU ranks: rank ``d * 2 + m`` at (d, m); gathers in
    coordinate order; a sum folded in the same order on every rank; a
    leaf's blocks gathered whole; ``copy_to``'s gradient the sum over
    the axis, ``reduce_from``'s the identity, ``gather_from``'s this
    rank's block; a tensor-parallel backward run in a thread without the
    mesh gives the gradients of one run in the forward's thread."""
    res = spawn_ranks(_mesh_rank, 4, timeout_s=300)
    for rank, r in enumerate(res):
        d, m = divmod(rank, 2)
        assert r["coords"] == {"data": d, "model": m}
        assert r["gather"]["data"] == [float(m), float(2 + m)]
        assert r["gather"]["model"] == [float(2 * d), float(2 * d + 1)]
        assert r["max"] == float(2 + m)
        assert r["whole"]
        assert r["copy_reduce_grad"] == [3.0, 3.0]     # 1 + 2
        assert r["gather_grad"] == [1.0 if m == 0 else 10.0]
        assert r["bytes"][0] > 0 and r["bytes"][1] > 0
        assert r["remat_threads"]
    assert len({r["sum"] for r in res}) == 1

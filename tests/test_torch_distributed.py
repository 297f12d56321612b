"""The distributed drivers of the port held to the JAX package's, on the CPU.

For each world size the oracle is one subprocess that runs the JAX
package's ``distributed_louvain``/``distributed_leiden``/
``distributed_plp`` on that many of 8 emulated host devices
(``XLA_FLAGS``, as ``tests/test_distributed.py`` runs them) and pickles
their outputs.  The port runs the same cases meanwhile in a gloo group of
that many ranks (``launch.ranks.spawn_ranks``: spawned CPU processes,
``file://`` rendezvous, one thread a rank).  Each world size is computed
once per session, the four oracles at once, and shared by the tests
(``runs``).

Contracts, each test stating its own:
  * integers equal bit for bit — labels, levels, communities, the sweep,
    community and ΔN histories, ``gathered_groups_per_level`` and every
    ``comm_stats`` entry, the partition and halo arrays;
  * floats on these unit-weight graphs: the ``partition_stats`` values
    bit for bit (the same host numpy on the same edges); Q and its
    history bit for bit between the port's own runs (every cross-rank sum
    is a sum of integers), and within ``rel=1e-6`` of the JAX package's,
    whose last reduction Σ(vol_c/vol)² adds in XLA's order
    (``core/modularity.py``).

This module imports no JAX at its top: the spawned ranks import it to find
their function.
"""
import fcntl
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.core.engine import EngineSpec, SweepEngine
from repro_torch.core.louvain import LouvainConfig, leiden, louvain
from repro_torch.graph.builders import from_numpy_edges
from repro_torch.graph.generators import ring_of_cliques, sbm
from repro_torch.graph.partition import (build_halo, owner_of_vertices,
                                         partition_edges_by_dst,
                                         partition_quality)
from repro_torch.kernels import common as kc
from repro_torch.launch.ranks import init_group, spawn_ranks
from repro_torch.utils import faultinject, telemetry
from repro_torch.utils.errors import ShardError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
MODES = ("shard_local", "replicated", "per_level")
SBM = dict(n=400, k=8, p_in=0.3, p_out=0.01, seed=2)
PLP_ITERS = 40

# the JAX package's runs at one world size, 8 emulated devices
ORACLE = """
import pickle, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.core.distributed import (distributed_leiden, distributed_louvain,
                                    distributed_plp)
from repro.graph.builders import from_numpy_edges
from repro.graph.generators import ring_of_cliques, sbm

def fields(r):
    return {"labels": np.asarray(r.labels), "n_communities": int(r.n_communities),
            "levels": int(r.levels), "modularity": float(r.modularity),
            "sweeps_per_level": list(r.sweeps_per_level),
            "n_comm_per_level": list(r.n_comm_per_level),
            "modularity_history": list(r.modularity_history),
            "delta_n_per_level": list(r.delta_n_per_level),
            "coarsening": r.coarsening, "comm_stats": r.comm_stats,
            "partition_stats": r.partition_stats,
            "degradations": [d["kind"] for d in r.run_report.degradations]}

nd = int(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:nd]).reshape(nd), ("data",))
out = {}
if nd == 8:
    u, v, w, _ = ring_of_cliques(8, 6)
    labels, hist = distributed_plp(from_numpy_edges(u, v, w), mesh,
                                   max_iterations=%(plp_iters)d)
    out["plp"] = (np.asarray(labels), list(hist))
    u, v, w, _ = ring_of_cliques(4, 5)
    g = from_numpy_edges(u, v, w)
    for mode in ("shard_local", "replicated"):
        out[("degenerate", mode)] = fields(distributed_louvain(
            g, mesh, coarsening=mode))
else:
    u, v, w, _ = sbm(%(n)d, %(k)d, p_in=%(p_in)r, p_out=%(p_out)r,
                     seed=%(seed)d)
    g = from_numpy_edges(u, v, w)
    for name, fn in (("louvain", distributed_louvain),
                     ("leiden", distributed_leiden)):
        for mode in ("shard_local", "replicated"):
            out[(nd, name, mode)] = fields(fn(g, mesh, coarsening=mode))
    out[(nd, "louvain", "per_level")] = fields(
        distributed_louvain(g, mesh, pipeline_fused=False))
    if nd == 4:
        out["halo8"] = fields(distributed_louvain(g, mesh, halo_cap=8))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % dict(SBM, plp_iters=PLP_ITERS)


def _fields(r):
    """A ``DistLouvainResult`` as the oracle pickles it (no timer)."""
    return {"labels": r.labels, "n_communities": r.n_communities,
            "levels": r.levels, "modularity": r.modularity,
            "sweeps_per_level": r.sweeps_per_level,
            "n_comm_per_level": r.n_comm_per_level,
            "modularity_history": r.modularity_history,
            "delta_n_per_level": r.delta_n_per_level,
            "coarsening": r.coarsening, "comm_stats": r.comm_stats,
            "partition_stats": r.partition_stats,
            "degradations": [d["kind"] for d in r.run_report.degradations]}


def _cpu_graph(u, v, w):
    return from_numpy_edges(u, v, w, device="cpu")


def _sbm_graph():
    return _cpu_graph(*sbm(SBM["n"], SBM["k"], p_in=SBM["p_in"],
                           p_out=SBM["p_out"], seed=SBM["seed"])[:3])


def _port_world(rank, world):
    """One rank's cases (spawned by ``spawn_ranks``): the fused pipeline in
    both coarsenings for Louvain and Leiden and the per-level driver on the
    SBM graph at worlds 1/2/4; at 4 also the halo-cap overflow and
    ``shard_drop``; at 8 PLP and the degenerate ring of cliques."""
    from repro_torch.core.distributed import (distributed_leiden,
                                              distributed_louvain,
                                              distributed_plp)
    out = {}
    if world == 8:
        g = _cpu_graph(*ring_of_cliques(8, 6)[:3])
        out["plp"] = distributed_plp(g, max_iterations=PLP_ITERS)
        g = _cpu_graph(*ring_of_cliques(4, 5)[:3])
        for mode in ("shard_local", "replicated"):
            out[("degenerate", mode)] = _fields(
                distributed_louvain(g, coarsening=mode))
        return out
    g = _sbm_graph()
    for name, fn in (("louvain", distributed_louvain),
                     ("leiden", distributed_leiden)):
        for mode in ("shard_local", "replicated"):
            out[(world, name, mode)] = _fields(fn(g, coarsening=mode))
    out[(world, "louvain", "per_level")] = _fields(
        distributed_louvain(g, pipeline_fused=False))
    if world == 4:
        out["halo8"] = _fields(distributed_louvain(g, halo_cap=8))
        before = telemetry.get("fault.shard_drop.injected")
        try:
            with faultinject.inject("shard_drop"):
                distributed_louvain(g)
            out["shard_drop"] = "no error"
        except ShardError as err:
            out["shard_drop"] = (type(err).__name__, telemetry.get(
                "fault.shard_drop.injected") - before)
    return out


ALL_WORLDS = WORLDS + (8,)


def _compute(tmp):
    """{world: (jax, ranks)}: the oracle's pickled outputs and every rank's
    results at each world size.  The four oracle subprocesses run at once,
    and the port's groups one after another meanwhile."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {world: subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(ORACLE),
         str(tmp / f"jax{world}.pkl"), str(world)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world in ALL_WORLDS}
    try:
        ranks = {world: spawn_ranks(_port_world, world, timeout_s=600)
                 for world in ALL_WORLDS}
    finally:
        logs = {world: p.communicate(timeout=900)[0]
                for world, p in procs.items()}
    out = {}
    for world, p in procs.items():
        assert p.returncode == 0, logs[world]
        with open(tmp / f"jax{world}.pkl", "rb") as f:
            out[world] = (pickle.load(f), ranks[world])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{world: (jax, ranks)}``, computed once per test session.  Under
    xdist the workers that get tests of this module share it: the first to
    take the lock computes it and pickles it beside the workers' temporary
    directories, the others read it."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _compute(tmp_path_factory.mktemp("dist"))
    shared = tmp_path_factory.getbasetemp().parent / "torch_dist_runs.pkl"
    with open(f"{shared}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if shared.is_file():
            return pickle.loads(shared.read_bytes())
        result = _compute(tmp_path_factory.mktemp("dist"))
        shared.write_bytes(pickle.dumps(result))
        return result


def _rank0(ranks, key):
    """Rank 0's result of ``key``, after checking every rank got the same
    one (the ranks of a group return one answer)."""
    mine = [r[key] for r in ranks]
    for other in mine[1:]:
        if isinstance(other, dict):
            _assert_equal(other, mine[0], exact_q=True)
        else:   # PLP's (labels, history)
            assert np.array_equal(other[0], mine[0][0])
            assert other[1] == mine[0][1]
    return mine[0]


def _assert_equal(got, want, *, exact_q: bool):
    """Every field equal; Q and its history bit for bit when ``exact_q``,
    else within rel=1e-6 (the JAX package's last reduction, see above)."""
    assert got.keys() == want.keys()
    for k in got:
        a, b = got[k], want[k]
        if k == "labels":
            assert np.array_equal(np.asarray(a), np.asarray(b)), k
        elif k in ("modularity", "modularity_history") and not exact_q:
            assert a == pytest.approx(b, rel=1e-6), k
        else:
            assert a == b, k


CASES = [(world, name, mode) for world in WORLDS
         for name in ("louvain", "leiden") for mode in MODES
         if not (name == "leiden" and mode == "per_level")]


@pytest.mark.parametrize("world,name,mode", CASES)
def test_port_equals_jax_field_by_field(runs, world, name, mode):
    """Every ``DistLouvainResult`` field of the port's run equals the JAX
    package's at the same world size; integers and ``partition_stats``
    bit for bit, Q within rel=1e-6."""
    jax_out, ranks = runs[world]
    _assert_equal(_rank0(ranks, (world, name, mode)),
                  jax_out[(world, name, mode)], exact_q=False)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["louvain", "leiden"])
def test_shard_local_equals_replicated_and_single_device(runs, world, name):
    """Shard-local ≡ replicated ≡ the port's single-device ``louvain()``/
    ``leiden()`` (default config, backend ``segment``), bit for bit in
    labels, Q and every per-level history, at every world size; the
    shard-local payload stays under the replicated gather's."""
    _, ranks = runs[world]
    rs = _rank0(ranks, (world, name, "shard_local"))
    rr = _rank0(ranks, (world, name, "replicated"))
    rl = (louvain if name == "louvain" else leiden)(_sbm_graph(),
                                                    LouvainConfig())
    for f in ("labels", "n_communities", "levels", "modularity",
              "sweeps_per_level", "n_comm_per_level", "modularity_history",
              "delta_n_per_level"):
        a, b, c = rs[f], rr[f], getattr(rl, f)
        if f == "labels":
            assert np.array_equal(a, b) and np.array_equal(a, c), f
        else:
            assert a == b == c, f
    assert rs["coarsening"] == "shard_local" and rs["degradations"] == []
    cs = rs["comm_stats"]
    rep = cs["bytes_per_level_model"]["replicated"]
    assert cs["actual_bytes_per_level"]
    assert all(b < rep for b in cs["actual_bytes_per_level"])
    assert all(p >= 0 for p in cs["gathered_groups_per_level"])
    assert rr["comm_stats"]["gathered_groups_per_level"] == [-1] * rr["levels"]


def test_halo_overflow_degrades_to_replicated(runs):
    """``halo_cap=8`` overflows on 4 ranks: the run is repeated replicated,
    the degradation recorded, the answer the replicated one bit for bit
    and the JAX package's field by field."""
    jax_out, ranks = runs[4]
    ro = _rank0(ranks, "halo8")
    rr = _rank0(ranks, (4, "louvain", "replicated"))
    assert ro["coarsening"] == "replicated"
    assert ro["degradations"] == ["halo_overflow"]
    for f in ("labels", "modularity", "modularity_history",
              "delta_n_per_level", "n_comm_per_level"):
        a, b = ro[f], rr[f]
        assert np.array_equal(a, b) if f == "labels" else a == b, f
    _assert_equal(ro, jax_out["halo8"], exact_q=False)


def test_distributed_plp_equals_jax(runs):
    """``distributed_plp`` on ``ring_of_cliques(8, 6)`` over 8 ranks: labels
    and ΔN history equal to the JAX package's on 8 devices."""
    jax_out, ranks = runs[8]
    labels, hist = _rank0(ranks, "plp")
    jl, jh = jax_out["plp"]
    assert np.array_equal(labels, jl)
    assert hist == jh


@pytest.mark.parametrize("mode", ["shard_local", "replicated"])
def test_degenerate_world_equals_jax(runs, mode):
    """20 vertices on 8 ranks leave ranks that own nothing: the two-phase
    contiguization and the halo merge survive them, field by field equal
    to the JAX package's and to the single-device run."""
    jax_out, ranks = runs[8]
    r = _rank0(ranks, ("degenerate", mode))
    _assert_equal(r, jax_out[("degenerate", mode)], exact_q=False)
    rl = louvain(_cpu_graph(*ring_of_cliques(4, 5)[:3]), LouvainConfig())
    assert np.array_equal(r["labels"], rl.labels)
    assert r["modularity"] == rl.modularity
    assert r["delta_n_per_level"] == rl.delta_n_per_level


def test_shard_drop_raises_on_every_rank(runs):
    """``shard_drop`` armed on 4 ranks: each rank's coverage guard raises
    ``ShardError`` before any compute, and each bumped the counter once."""
    _, ranks = runs[4]
    assert [r["shard_drop"] for r in ranks] == [("ShardError", 1)] * 4


# ------------------------------------------------------------ in process


def _jax_graph(u, v, w):
    from repro.graph.builders import from_numpy_edges as jax_from_numpy

    return jax_from_numpy(u, v, w)


PARTITION_CASES = [("sbm200", 1), ("sbm200", 4), ("sbm200", 8),
                   ("two_vertices", 8)]


@pytest.mark.parametrize("graph,world", PARTITION_CASES)
def test_partition_and_halo_equal_jax(graph, world):
    """``partition_edges_by_dst``, ``owner_of_vertices``, ``build_halo`` and
    ``partition_quality`` equal the JAX package's bit for bit (arrays,
    ``m_pad`` and the quality floats), on ``sbm(200, 4)`` and on a
    2-vertex graph split 8 ways (ranks with no edges)."""
    from repro.graph import partition as jp

    if graph == "sbm200":
        u, v, w, _ = sbm(200, 4, p_in=0.3, p_out=0.05, seed=7)
    else:
        u, v, w = np.array([0, 1]), np.array([1, 0]), np.ones(2)
    part = partition_edges_by_dst(_cpu_graph(u, v, w), world)
    jpart = jp.partition_edges_by_dst(_jax_graph(u, v, w), world)
    for f in ("vertex_bounds", "src", "dst", "w", "edge_mask"):
        assert np.array_equal(getattr(part, f), getattr(jpart, f)), f
    assert (part.m_pad, part.n_max, part.n_devices) == (
        jpart.m_pad, jpart.n_max, jpart.n_devices)
    assert np.array_equal(owner_of_vertices(part),
                          jp.owner_of_vertices(jpart))
    halo, jhalo = build_halo(part), jp.build_halo(jpart)
    for f in ("owner_of", "ghost_counts", "ghost_ids", "ghost_mask"):
        assert np.array_equal(getattr(halo, f), getattr(jhalo, f)), f
    assert halo.g_pad == jhalo.g_pad
    assert tuple(partition_quality(part, halo)) == tuple(
        jp.partition_quality(jpart, jhalo))
    if graph == "two_vertices":
        assert not part.edge_mask.all(axis=1).all()


def test_halo_cap_and_comm_model_equal_jax():
    """``pick_halo_cap`` and ``dist_comm_bytes_per_level`` equal the JAX
    package's on a grid of shard capacities and world sizes, and refuse
    the same non-positive inputs."""
    from repro.kernels import common as jc

    assert (kc.HALO_CAP_FLOOR, kc.EDGE_WIRE_BYTES, kc.LABEL_WIRE_BYTES) == (
        jc.HALO_CAP_FLOOR, jc.EDGE_WIRE_BYTES, jc.LABEL_WIRE_BYTES)
    for m_pad in (1, 8, 200, 256, 511, 512, 513, 4096, 10**6 + 3):
        for world in (1, 2, 3, 4, 8, 512):
            cap = kc.pick_halo_cap(m_pad, world)
            assert cap == jc.pick_halo_cap(m_pad, world)
            for n in (1, 20, 400, 317080):
                assert kc.dist_comm_bytes_per_level(n, m_pad, cap, world) == \
                    jc.dist_comm_bytes_per_level(n, m_pad, cap, world)
    for bad in ((0, 4), (8, 0), (-1, 1)):
        with pytest.raises(ValueError):
            kc.pick_halo_cap(*bad)
        with pytest.raises(ValueError):
            jc.pick_halo_cap(*bad)


def test_shard_drop_site_raises_and_counts():
    """The ``shard_drop`` site masks rank 0's shard after partitioning;
    the coverage guard raises ``ShardError`` and the counter moves once.
    Disarmed, the partition covers the graph."""
    g = _cpu_graph(*sbm(200, 4, p_in=0.3, p_out=0.05, seed=7)[:3])
    assert dist_mod._prepare_partition(g, 4).edge_mask.sum() == g.m_valid
    before = telemetry.get("fault.shard_drop.injected")
    with faultinject.inject("shard_drop"):
        with pytest.raises(ShardError, match="dropped or corrupted"):
            dist_mod._prepare_partition(g, 4)
    assert telemetry.get("fault.shard_drop.injected") == before + 1


def test_distributed_backend_has_no_sweep_engine():
    """``EngineSpec`` takes the ``distributed`` backend; ``SweepEngine``
    refuses it, as the JAX package's does."""
    g = _cpu_graph(*ring_of_cliques(4, 5)[:3])
    spec = EngineSpec(evaluator="louvain", backend="distributed")
    with pytest.raises(ValueError, match="distributed_phase"):
        SweepEngine(g, spec)


def test_drivers_need_an_initialized_group():
    """Without ``init_process_group`` the drivers raise before partitioning;
    ``init_group`` refuses an unknown backend."""
    g = _cpu_graph(*ring_of_cliques(4, 5)[:3])
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        dist_mod.distributed_louvain(g)
    with pytest.raises(RuntimeError, match="not initialized"):
        dist_mod.distributed_plp(g)
    with pytest.raises(ValueError, match="backend"):
        init_group("mpi", 0, 1, "file:///nonexistent")


@pytest.fixture(autouse=True)
def _one_thread_and_disarm():
    """One torch thread in this worker (the suite runs files in parallel
    processes, and these small graphs run many tiny ops), and no fault
    left armed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    faultinject.disarm()

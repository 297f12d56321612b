"""Port graph substrate ≡ the JAX package, bit for bit: ingest
(``from_numpy_edges``, ``canonicalize_edges``, the dataset stand-ins), the ELL
buckets and tail, the streamed layout's table windows, the segment
primitives, and both coarsening paths of the
aggregation (sort oracle ≡ binned, on a graph that overflows the bin gate
and one that passes it).  Inputs are made from a seed with numpy; JAX
graphs cross over as numpy arrays through ``graph_from_numpy``."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import aggregation as jagg
from repro.graph import builders as jbuilders
from repro.graph import datasets as jdatasets
from repro.graph import ell as jell
from repro.graph import segment as jseg
from repro.graph.generators import ring_of_cliques, sbm
from repro.graph.structure import Graph as JGraph
from repro_torch.core import aggregation as tagg
from repro_torch.graph import builders as tbuilders
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph import segment as tseg
from repro_torch.graph.ell import (build_ell, compute_windows,
                                   stream_block_rows, to_device)
from repro_torch.graph.structure import graph_from_numpy
from repro_torch.utils import telemetry
from repro_torch.utils.errors import InputValidationError

CPU = torch.device("cpu")
GRAPH_FIELDS = ("src", "dst", "w", "edge_mask")


def to_torch(jg: JGraph):
    """Carry a JAX Graph across as numpy arrays, padding included."""
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in GRAPH_FIELDS),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


def assert_graphs_equal(jg, tg):
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, f)),
                                      getattr(tg, f).numpy(), err_msg=f)
    assert (int(jg.n_valid), int(jg.m_valid), jg.n_max, jg.m_max,
            jg.sorted_by) == (tg.n_valid, tg.m_valid, tg.n_max, tg.m_max,
                              tg.sorted_by)


def _raw_edges(seed, n=60, m=400, weighted=True):
    """Undirected rows with duplicates, reverse duplicates and loops."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    j = rng.integers(0, m, m // 3)
    u[: m // 3], v[: m // 3] = v[j], u[j]          # reverse duplicates
    w = rng.uniform(0.5, 2.0, m) if weighted else np.ones(m)
    return u, v, w, n


@pytest.mark.parametrize("sort_by", ["src", "dst"])
@pytest.mark.parametrize("dedup", [True, False])
def test_from_numpy_edges_matches_jax(sort_by, dedup):
    u, v, w, n = _raw_edges(1)
    kw = dict(n=n, m_max=1000, dedup=dedup, sort_by=sort_by)
    jg = jbuilders.from_numpy_edges(u, v, w, **kw)
    tg = tbuilders.from_numpy_edges(u, v, w, device="cpu", validate=True, **kw)
    assert_graphs_equal(jg, tg)


def test_robust_ingest_matches_jax():
    rng = np.random.default_rng(4)
    u, v, w, n = _raw_edges(2, weighted=True)
    w[rng.integers(0, len(w), 5)] = np.nan
    w[rng.integers(0, len(w), 5)] = -1.0
    u[:3] = n + 5                                       # out-of-range ids
    kw = dict(n=n, self_loops="drop", bad_weights="zero", bad_ids="drop")
    *jarrays, jrep = jbuilders.canonicalize_edges(u, v, w, **kw)
    *tarrays, trep = tbuilders.canonicalize_edges(u, v, w, **kw)
    for j, t in zip(jarrays, tarrays):
        np.testing.assert_array_equal(j, t)
    assert dataclasses.asdict(jrep) == dataclasses.asdict(trep)
    assert not trep.clean
    jg = jbuilders.from_numpy_edges(*jarrays[:3], n=jarrays[3])
    tg = tbuilders.from_numpy_edges(*tarrays[:3], n=tarrays[3], device="cpu",
                                    validate=True)
    assert_graphs_equal(jg, tg)
    with pytest.raises(InputValidationError):
        tbuilders.canonicalize_edges(u, v, w, n=n)


def test_validate_graph_rejects_asymmetry():
    g = tbuilders.from_numpy_edges(np.array([0, 1]), np.array([1, 2]),
                                   device="cpu")
    tbuilders.validate_graph(g)
    bad = graph_from_numpy(np.array([0, 1], np.int32), np.array([1, 0]),
                           np.array([1.0, 2.0]), np.array([True, True]),
                           2, 2, 2, 2, sorted_by="src", device="cpu")
    with pytest.raises(InputValidationError, match="asymmetric"):
        tbuilders.validate_graph(bad)


@pytest.mark.parametrize("name,kw", [("ring-of-cliques", {}),
                                     ("sbm-small", {}),
                                     ("com-dblp", {"scale": 0.002}),
                                     ("as-skitter", {"scale": 0.001})])
def test_dataset_standins_match_jax(name, kw):
    jl = jdatasets.load(name, **kw)
    tl = tdatasets.load(name, device="cpu", **kw)
    assert_graphs_equal(jl.graph, tl.graph)
    assert jl.n == tl.n and jl.m_undirected == tl.m_undirected
    if jl.truth is not None:
        np.testing.assert_array_equal(jl.truth, tl.truth)


def _graph_with_hub(seed=5, hub_deg=1100):
    """An SBM plus one star vertex of degree > 1024 (the ELL tail)."""
    u, v, w, _ = sbm(1200, 12, p_in=0.05, p_out=0.002, seed=seed)
    hub = 1200
    leaves = np.random.default_rng(seed).choice(1200, hub_deg, replace=False)
    u = np.concatenate([u, np.full(hub_deg, hub)])
    v = np.concatenate([v, leaves])
    w = np.concatenate([w, np.ones(hub_deg)])
    # a self-loop on the hub: tail edges keep loops, tiles drop them
    return (np.append(u, hub), np.append(v, hub), np.append(w, 1.0), 1201)


@pytest.mark.parametrize("hub", [True, False])
def test_build_ell_matches_jax(hub):
    if hub:
        u, v, w, n = _graph_with_hub()
    else:
        u, v, w, _ = sbm(300, 6, p_in=0.3, p_out=0.03, seed=13)
        n = 300
    jg = jbuilders.from_numpy_edges(u, v, w, n=n)
    tg = to_torch(jg)
    je = jell.build_ell(jg)
    te = build_ell(tg)
    assert len(je.buckets) == len(te.buckets)
    for jb, tb in zip(je.buckets, te.buckets):
        assert jb.width == tb.width and jb.n_rows_valid == tb.n_rows_valid
        np.testing.assert_array_equal(jb.rows, tb.rows.numpy())
        np.testing.assert_array_equal(jb.nbr, tb.nbr.numpy())
        np.testing.assert_array_equal(jb.w, tb.w.numpy())
    np.testing.assert_array_equal(je.tail_vertices, te.tail_vertices.numpy())
    assert te.has_tail == hub
    moved = to_device(te, CPU)
    for a, b in zip(te.buckets, moved.buckets):
        assert torch.equal(a.nbr, b.nbr) and torch.equal(a.w, b.w)
    jd = jell.to_device(jg, je)
    for f in ("tail_src", "tail_dst", "tail_w", "is_tail"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, f)),
                                      getattr(te, f).numpy(), err_msg=f)


def _window_tiles(case, n=300, rows=60, width=16):
    """(rows, nbr) int32 tiles: random ids, locality-ordered (banded) ids,
    or banded ids whose last 20 rows are padding (all-padding blocks)."""
    rng = np.random.default_rng(7)
    if case == "random":
        r = rng.choice(n, rows, replace=False)
        nbr = rng.integers(0, n, (rows, width))
    else:
        r = np.sort(rng.choice(np.arange(20, n - 20), rows, replace=False))
        nbr = r[:, None] + rng.integers(-20, 21, (rows, width))
    nbr[rng.random((rows, width)) < 0.3] = n
    if case == "padding_tail":
        r[-20:], nbr[-20:] = n, n
    return r.astype(np.int32), nbr.astype(np.int32)


def _assert_windows_equal(jw, tw):
    np.testing.assert_array_equal(np.asarray(jw.win_blk), tw.win_blk.numpy())
    assert tw.win_blk.dtype == torch.int32
    assert (jw.slot, jw.block_rows, jw.n_slots) == (tw.slot, tw.block_rows,
                                                    tw.n_slots)


@pytest.mark.parametrize("block_rows", [8, 16, 24, 64, 1000])
@pytest.mark.parametrize("case", ["random", "banded", "padding_tail"])
def test_compute_windows_matches_jax(case, block_rows):
    """Same tiles, same ``win_blk``/``slot``/``n_slots``; 1000 rows per
    block makes a single-block bucket, and the padded tail gives
    all-padding blocks at 8 and 16 rows."""
    n = 300
    r, nbr = _window_tiles(case, n)
    jw = jell.compute_windows(r, nbr, n, block_rows)
    tw = compute_windows(torch.from_numpy(r), torch.from_numpy(nbr), n,
                         block_rows)
    _assert_windows_equal(jw, tw)
    if block_rows == 1000:
        assert tw.win_blk.numel() == 1
    if case == "padding_tail" and block_rows <= 16:
        nb = tw.win_blk.numel()
        blocks = np.concatenate(
            [r, np.full(nb * block_rows - len(r), n)]).reshape(nb, block_rows)
        empty = np.all(blocks == n, axis=1)
        assert empty.any() and not tw.win_blk.numpy()[empty].any()
    if case == "banded" and block_rows <= 24:
        assert tw.slot < n + 1        # a window narrower than the table


def test_build_ell_windows_match_jax():
    """The windows of every real bucket (default and explicit block rows)
    are the JAX package's windows of the same tiles."""
    u, v, w, _ = sbm(300, 6, p_in=0.3, p_out=0.03, seed=13)
    jg = jbuilders.from_numpy_edges(u, v, w, n=300)
    je, tg = jell.build_ell(jg), to_torch(jg)
    for block_rows in (None, 16):
        te = build_ell(tg, block_rows=block_rows)
        for jb, tb in zip(je.buckets, te.buckets):
            br = min(block_rows or stream_block_rows(tb.width),
                     tb.rows.shape[0])
            assert tb.windows.block_rows == br
            _assert_windows_equal(
                jell.compute_windows(jb.rows, jb.nbr, jg.n_max, br),
                tb.windows)
    moved = to_device(te, CPU)
    assert all(torch.equal(a.windows.win_blk, b.windows.win_blk)
               for a, b in zip(te.buckets, moved.buckets))


@pytest.mark.parametrize("seed", [0, 1])
def test_groupby_sum_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m, n = 500, 40
    k1 = rng.integers(0, n + 1, m).astype(np.int32)
    k2 = rng.integers(-1, n + 1, m).astype(np.int32)
    vals = rng.integers(0, 5, m).astype(np.float32)
    valid = rng.random(m) < 0.8
    jk, js, jv, jn = jseg.groupby_sum(
        (jnp.asarray(k1), jnp.asarray(k2)), jnp.asarray(vals),
        jnp.asarray(valid))
    tk, ts, tv, tn = tseg.groupby_sum(
        (torch.from_numpy(k1), torch.from_numpy(k2)), torch.from_numpy(vals),
        torch.from_numpy(valid), bound=n)
    ng = int(jn)
    assert ng == int(tn)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    for a, b in zip(jk, tk):
        np.testing.assert_array_equal(np.asarray(a)[:ng], b.numpy()[:ng])
    np.testing.assert_array_equal(np.asarray(js)[:ng], ts.numpy()[:ng])


def test_contiguize_compact_argmax_match_jax():
    rng = np.random.default_rng(3)
    size = 50
    keys = rng.integers(0, size, 200).astype(np.int32)
    valid = rng.random(200) < 0.7
    jt, jc = jseg.contiguize_ids(jnp.asarray(keys), jnp.asarray(valid), size)
    tt, tc = tseg.contiguize_ids(torch.from_numpy(keys),
                                 torch.from_numpy(valid), size)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    assert int(jc) == int(tc)

    mask = rng.random(300) < 0.4
    arr = rng.integers(0, 99, 300).astype(np.int32)
    (ja,), jn = jseg.compact(jnp.asarray(mask), (jnp.asarray(arr),))
    (ta,), tn = tseg.compact(torch.from_numpy(mask), (torch.from_numpy(arr),))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    assert int(jn) == int(tn)

    scores = rng.integers(0, 4, 300).astype(np.float32)
    cand = rng.integers(0, 30, 300).astype(np.int32)
    segs = rng.integers(0, 25, 300).astype(np.int32)
    jb, jcand = jseg.segment_argmax(jnp.asarray(scores), jnp.asarray(cand),
                                    jnp.asarray(segs), 30, jnp.asarray(mask))
    tb, tcand = tseg.segment_argmax(torch.from_numpy(scores),
                                    torch.from_numpy(cand),
                                    torch.from_numpy(segs), 30,
                                    torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jcand), tcand.numpy())


def _partition(seed, n_valid, n_max, groups):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, groups, n_valid),
                           rng.integers(0, n_max, n_max - n_valid)]
                          ).astype(np.int32)


@pytest.mark.parametrize("case", ["overflow", "binned"])
def test_coarsening_paths_match_jax(case):
    """sort oracle ≡ binned ≡ two-step, port ≡ JAX, on a partition whose
    source communities overflow the bin gate and on one that passes it."""
    if case == "overflow":
        u, v, w, _ = sbm(400, 4, p_in=0.2, p_out=0.01, seed=2)
        n, groups = 400, 8               # ~100 edges per community row
    else:
        u, v, w, _ = ring_of_cliques(20, 5)
        n, groups = 100, 60
    w = np.random.default_rng(0).integers(1, 4, len(u)).astype(np.float64)
    jg = jbuilders.from_numpy_edges(u, v, w, n=n, m_max=len(u) * 2 + 16)
    tg = to_torch(jg)
    com = _partition(1, n, n, groups)
    jnc, jn, jcg = jagg.remap_and_coarsen(jg, jnp.asarray(com))
    jbc, jbn, jbcg = jagg.remap_and_coarsen_binned(jg, jnp.asarray(com))
    assert_graphs_equal(jcg, to_torch(jbcg))       # JAX's own contract
    tcom = torch.from_numpy(com)
    fallbacks = telemetry.get("agg.sort_fallback")
    binned = telemetry.get("agg.binned")
    for impl in ("ref", "kernel"):
        nc, nn, cg = tagg.remap_and_coarsen_binned(tg, tcom, impl=impl)
        np.testing.assert_array_equal(np.asarray(jnc), nc.numpy())
        assert int(jn) == nn
        assert_graphs_equal(jcg, cg)
    took_fallback = telemetry.get("agg.sort_fallback") - fallbacks
    took_binned = telemetry.get("agg.binned") - binned
    assert (took_fallback, took_binned) == ((2, 0) if case == "overflow"
                                            else (0, 2))
    nc, nn, cg = tagg.remap_and_coarsen(tg, tcom)
    np.testing.assert_array_equal(np.asarray(jnc), nc.numpy())
    assert_graphs_equal(jcg, cg)
    with pytest.raises(ValueError):
        tagg.remap_and_coarsen_binned(tg, tcom, impl="auto")
    new_com, n_comm = tagg.remap_communities(tcom, tg.vertex_mask())
    assert_graphs_equal(jcg, tagg.coarsen_graph(tg, new_com, n_comm))

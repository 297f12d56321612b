"""Port kernels' plain versions ≡ the JAX package's oracles, bit for bit.

The same numpy inputs (made from a seed) go through the JAX function and
its ``repro_torch`` counterpart: the plain local_move scoring against
``local_move_plp_ref`` / ``local_move_louvain_tables_ref`` at every ELL
width, the streamed (windowed) layout against the JAX package's windowed
jnp oracle (``use_pallas=False, table_mode="streamed"``; its streamed
Pallas path does not run under this JAX), the resident-vs-streamed policy
against the JAX package's, the plain ``bin_rank`` against ``bin_rank_ref``,
and at one width the JAX Pallas kernels in interpret mode.  Weights are
small integers or all
equal (tie-rich): every float sum is then an exact integer in any order, so
outputs must match exactly.  The CUDA kernels themselves are held against
these plain versions on the card by ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import common as jcommon
from repro.kernels.aggregation.kernel import bin_rank_pallas
from repro.kernels.aggregation.ref import bin_rank_ref as j_bin_rank_ref
from repro.graph import ell as jell
from repro.graph.builders import from_numpy_edges as j_from_numpy_edges
from repro.kernels import common as jk
from repro.kernels.local_move import ops as j_lm_ops
from repro.kernels.local_move.ref import (
    compose_louvain_tables as j_compose,
    local_move_louvain_tables_ref as j_louvain_ref,
    local_move_plp_ref as j_plp_ref,
)
from repro_torch.core import common as tcommon
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph.builders import from_numpy_edges as t_from_numpy_edges
from repro_torch.graph.ell import build_ell, compute_windows
from repro_torch.graph.structure import graph_from_numpy
from repro_torch.kernels import common as tk
from repro_torch.kernels.aggregation.kernel import bin_rank_kernel
from repro_torch.kernels.aggregation.ref import bin_rank_ref
from repro_torch.kernels.local_move import ops as t_lm_ops
from repro_torch.kernels.local_move.kernel import (
    local_move_louvain_kernel, local_move_louvain_streamed_kernel,
    local_move_plp_kernel, local_move_plp_streamed_kernel)
from repro_torch.kernels.local_move.ref import (compose_louvain_tables,
                                                local_move_louvain_tables_ref,
                                                local_move_plp_ref)

WIDTHS = (16, 64, 256, 1024)


def _tiles(rows, width, n, seed, weights):
    """Random ELL tile + consistent tables (numpy).  ``weights``: "int"
    (1..4) or "equal" (all 1: every label-score tie is broken by noise)."""
    rng = np.random.default_rng(seed)
    r_ids = np.full(rows, n, np.int32)
    real = rng.random(rows) < 0.9
    r_ids[real] = rng.choice(n, size=int(real.sum()), replace=False)
    # few distinct labels/communities per row so candidate groups tie
    nbr = rng.integers(0, n, (rows, width)).astype(np.int32)
    pad = rng.random((rows, width)) < 0.25
    pad[~real] = True
    nbr[pad] = n
    w = (rng.integers(1, 5, (rows, width)) if weights == "int"
         else np.ones((rows, width)))
    w = np.where(pad, 0.0, w).astype(np.float32)
    labels = rng.integers(0, max(2, n // 8), n).astype(np.int32)
    tables = dict(
        labels_ext=np.concatenate([labels, [n]]).astype(np.int32),
        vol_ext=np.concatenate([rng.integers(1, 40, n), [0]]).astype(np.float32),
        size_ext=np.concatenate([rng.integers(1, 3, n), [0]]).astype(np.int32),
        deg_ext=np.concatenate([rng.integers(1, 9, n), [0]]).astype(np.float32),
    )
    return r_ids, nbr, w, tables


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("width", WIDTHS)
def test_plp_plain_matches_jax_ref(width, weights):
    n = 64
    rows = 8 if width >= 256 else 40
    r, nbr, w, tab = _tiles(rows, width, n, seed=width, weights=weights)
    seed = 7
    jb, jp = j_plp_ref(jnp.asarray(r), jnp.asarray(nbr), jnp.asarray(w),
                       jnp.asarray(tab["labels_ext"]), jnp.uint32(seed),
                       tie_eps=0.25, sentinel=n)
    tb, tp = local_move_plp_ref(_t(r), _t(nbr), _t(w), _t(tab["labels_ext"]),
                                seed, tie_eps=0.25, sentinel=n)
    _eq(jb, tb)
    _eq(jp, tp)
    assert tb.dtype == torch.int32 and tp.dtype == torch.bool


@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("singleton_rule", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_louvain_plain_matches_jax_ref(width, singleton_rule, weights):
    n = 64
    rows = 8 if width >= 256 else 40
    r, nbr, w, tab = _tiles(rows, width, n, seed=width + 1, weights=weights)
    inv_vol = np.float32(1.0) / np.float32(300.0)
    jtabs = j_compose(jnp.asarray(tab["labels_ext"]), jnp.asarray(tab["vol_ext"]),
                      jnp.asarray(tab["size_ext"]), jnp.asarray(tab["deg_ext"]), n)
    jb, jp = j_louvain_ref(jnp.asarray(r), jnp.asarray(nbr), jnp.asarray(w),
                           *jtabs, jnp.float32(inv_vol), sentinel=n,
                           singleton_rule=singleton_rule)
    ttabs = compose_louvain_tables(_t(tab["labels_ext"]), _t(tab["vol_ext"]),
                                   _t(tab["size_ext"]), _t(tab["deg_ext"]), n)
    for jt, tt in zip(jtabs, ttabs):
        _eq(jt, tt)
    tb, tp = local_move_louvain_tables_ref(
        _t(r), _t(nbr), _t(w), *ttabs, torch.tensor(inv_vol), sentinel=n,
        singleton_rule=singleton_rule)
    _eq(jb, tb)
    _eq(jp, tp)


@pytest.mark.parametrize("evaluator", ["plp", "louvain"])
def test_plain_matches_jax_pallas_interpret(evaluator):
    """At one width, the port's plain version against the JAX Pallas kernel
    itself (interpret mode, resident tables)."""
    n, width = 96, 64
    r, nbr, w, tab = _tiles(48, width, n, seed=3, weights="int")
    if evaluator == "plp":
        jb, jp = j_lm_ops.local_move_plp(
            jnp.asarray(r), jnp.asarray(nbr), jnp.asarray(w),
            jnp.asarray(tab["labels_ext"]), jnp.uint32(5), tie_eps=0.25,
            sentinel=n, use_pallas=True, interpret=True, table_mode="resident")
        tb, tp = t_lm_ops.local_move_plp(
            _t(r), _t(nbr), _t(w), _t(tab["labels_ext"]), 5, tie_eps=0.25,
            sentinel=n, use_pallas=True, table_mode="resident")
    else:
        kw = dict(sentinel=n, singleton_rule=True, use_pallas=True,
                  table_mode="resident")
        jb, jp = j_lm_ops.local_move_louvain(
            jnp.asarray(r), jnp.asarray(nbr), jnp.asarray(w),
            jnp.asarray(tab["labels_ext"]), jnp.asarray(tab["vol_ext"]),
            jnp.asarray(tab["size_ext"]), jnp.asarray(tab["deg_ext"]),
            jnp.float32(211.0), interpret=True, **kw)
        tb, tp = t_lm_ops.local_move_louvain(
            _t(r), _t(nbr), _t(w), _t(tab["labels_ext"]), _t(tab["vol_ext"]),
            _t(tab["size_ext"]), _t(tab["deg_ext"]), torch.tensor(211.0), **kw)
    _eq(jb, tb)
    _eq(jp, tp)


def _bin_table(seed, n, m, width):
    """A bin-key table as the probing insert leaves it: each row holds
    distinct keys < n in random slots, ``n`` (empty) elsewhere; the last
    row is the sink and stays empty."""
    rng = np.random.default_rng(seed)
    keys = np.full((n + 1, width), n, np.int32)
    for row in range(n):
        k = rng.integers(0, width + 1)
        slots = rng.choice(width, size=k, replace=False)
        keys[row, slots] = rng.choice(n, size=k, replace=False)
    cs = rng.integers(0, n + 1, m).astype(np.int32)   # n = masked → sink row
    cd = np.where(cs < n, rng.integers(0, n, m), n).astype(np.int32)
    return keys.reshape(-1), cs, cd


@pytest.mark.parametrize("width", [4, 16, 64, 256])
def test_bin_rank_plain_matches_jax_ref(width):
    n = 300
    keys, cs, cd = _bin_table(width, n, 2000, width)
    j = j_bin_rank_ref(jnp.asarray(keys), jnp.asarray(cs), jnp.asarray(cd),
                       width=width, empty=n)
    t = bin_rank_ref(_t(keys), _t(cs), _t(cd), width=width, empty=n)
    _eq(j, t)
    # masked edges route to the sink row and rank 0
    assert int(t[_t(cs) == n].abs().sum()) == 0


@pytest.mark.parametrize("order", ["grouped", "shuffled"])
@pytest.mark.parametrize("width", [4, 16])
def test_bin_rank_kernel_matches_jax_ref(width, order):
    """The wrapper (its plain version on the CPU) against the JAX
    ``bin_rank_ref`` on edges in runs of one row, as a src-sorted coarse
    graph gives them, and shuffled."""
    n = 300
    keys, cs, cd = _bin_table(width + 1, n, 2000, width)
    rng = np.random.default_rng(width)
    run_rows = np.repeat(rng.integers(0, n + 1, 2000), rng.integers(1, 41,
                                                                    2000))
    cs = run_rows[:2000].astype(np.int32)
    cd = np.where(cs < n, cd, n).astype(np.int32)
    if order == "shuffled":
        perm = rng.permutation(cs.size)
        cs, cd = cs[perm], cd[perm]
    j = j_bin_rank_ref(jnp.asarray(keys), jnp.asarray(cs), jnp.asarray(cd),
                       width=width, empty=n)
    t = bin_rank_kernel(_t(keys), _t(cs), _t(cd), width=width, empty=n)
    _eq(j, t)


def test_bin_rank_plain_matches_jax_pallas_interpret():
    n, width = 120, 64
    keys, cs, cd = _bin_table(9, n, 500, width)
    j = bin_rank_pallas(jnp.asarray(keys), jnp.asarray(cs), jnp.asarray(cd),
                        width=width, empty=n, interpret=True, row_block=64)
    t = bin_rank_kernel(_t(keys), _t(cs), _t(cd), width=width, empty=n)
    _eq(j, t)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    """On CPU tensors a wrapper returns its plain version's result and
    counts no launch."""
    n = 64
    r, nbr, w, tab = _tiles(32, 16, n, seed=2, weights="int")
    before = (local_move_plp_kernel.launches,
              local_move_louvain_kernel.launches, bin_rank_kernel.launches)
    a = local_move_plp_kernel(_t(r), _t(nbr), _t(w), _t(tab["labels_ext"]), 3,
                              tie_eps=0.25, sentinel=n)
    b = local_move_plp_ref(_t(r), _t(nbr), _t(w), _t(tab["labels_ext"]), 3,
                           tie_eps=0.25, sentinel=n)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    tabs = compose_louvain_tables(_t(tab["labels_ext"]), _t(tab["vol_ext"]),
                                  _t(tab["size_ext"]), _t(tab["deg_ext"]), n)
    inv = torch.tensor(0.01)
    a = local_move_louvain_kernel(_t(r), _t(nbr), _t(w), *tabs, inv,
                                  sentinel=n, singleton_rule=True)
    b = local_move_louvain_tables_ref(_t(r), _t(nbr), _t(w), *tabs, inv,
                                      sentinel=n, singleton_rule=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    keys, cs, cd = _bin_table(4, n, 100, 16)
    assert torch.equal(
        bin_rank_kernel(_t(keys), _t(cs), _t(cd), width=16, empty=n),
        bin_rank_ref(_t(keys), _t(cs), _t(cd), width=16, empty=n))
    assert before == (local_move_plp_kernel.launches,
                      local_move_louvain_kernel.launches,
                      bin_rank_kernel.launches)


def test_streamed_requires_windows():
    """Explicit ``streamed`` without window metadata raises ``ValueError``
    in both packages; ``auto`` without it stays resident."""
    n = 16
    r, nbr, w, tab = _tiles(8, 16, n, seed=1, weights="int")
    with pytest.raises(ValueError, match="window metadata"):
        j_lm_ops.local_move_plp(
            jnp.asarray(r), jnp.asarray(nbr), jnp.asarray(w),
            jnp.asarray(tab["labels_ext"]), jnp.uint32(0), tie_eps=0.25,
            sentinel=n, table_mode="streamed")
    for use_pallas in (False, True):
        with pytest.raises(ValueError, match="window metadata"):
            t_lm_ops.local_move_plp(
                _t(r), _t(nbr), _t(w), _t(tab["labels_ext"]), 0,
                tie_eps=0.25, sentinel=n, table_mode="streamed",
                use_pallas=use_pallas)
    assert t_lm_ops._resolve_mode("auto", None, 4, n, 1) == "resident"
    with pytest.raises(ValueError, match="table_mode"):
        t_lm_ops.check_table_mode("windowed")


# ------------------------------------------------------------ streamed layout


def _banded_tiles(rows, width, n, seed, weights, band=24):
    """Locality-ordered tiles (row ids ascending, neighbors within
    ``band`` ids), so blocks of rows get windows narrower than the table;
    few distinct labels, so candidate groups tie."""
    rng = np.random.default_rng(seed)
    r_ids = np.sort(rng.choice(np.arange(band, n - band), rows,
                               replace=False))
    nbr = r_ids[:, None] + rng.integers(-band, band + 1, (rows, width))
    pad = rng.random((rows, width)) < 0.25
    pad[rng.random(rows) < 0.1] = True
    nbr[pad] = n
    r_ids[np.all(pad, axis=1)] = n
    w = (rng.integers(1, 5, (rows, width)) if weights == "int"
         else np.ones((rows, width)))
    w = np.where(pad, 0.0, w).astype(np.float32)
    _, _, _, tables = _tiles(1, 16, n, seed, weights)
    return r_ids.astype(np.int32), nbr.astype(np.int32), w, tables


def _both_windows(r, nbr, n, block_rows):
    jw = jell.compute_windows(r, nbr, n, block_rows)
    tw = compute_windows(_t(r), _t(nbr), n, block_rows)
    np.testing.assert_array_equal(np.asarray(jw.win_blk), tw.win_blk.numpy())
    return jw, tw


def _streamed_cases():
    for layout in ("banded", "random"):
        for weights in ("int", "equal"):
            for width in WIDTHS:
                yield layout, weights, width


def _case_tiles(layout, weights, width, seed):
    n = 400 if layout == "banded" else 64
    rows = 12 if width >= 256 else 40
    make = _banded_tiles if layout == "banded" else _tiles
    return n, make(rows, width, n, seed, weights)


@pytest.mark.parametrize("layout,weights,width", list(_streamed_cases()))
def test_plp_streamed_matches_jax_windowed(layout, weights, width):
    """Port ``table_mode="streamed"`` (plain version, and the streamed
    kernel wrapper on CPU tensors) ≡ the JAX windowed oracle ≡ resident,
    on narrow windows over banded tiles and on whole-table windows over
    random ones, several blocks each."""
    n, (r, nbr, w, tab) = _case_tiles(layout, weights, width, width + 5)
    jw, tw = _both_windows(r, nbr, n, block_rows=4)
    if layout == "banded":
        assert tw.slot < n + 1
    kw = dict(tie_eps=0.25, sentinel=n)
    jb, jp = j_lm_ops.local_move_plp(
        jnp.asarray(r), jnp.asarray(nbr), jnp.asarray(w),
        jnp.asarray(tab["labels_ext"]), jnp.uint32(9), windows=jw,
        table_mode="streamed", **kw)
    for use_pallas in (False, True):
        tb, tp = t_lm_ops.local_move_plp(
            _t(r), _t(nbr), _t(w), _t(tab["labels_ext"]), 9, windows=tw,
            table_mode="streamed", use_pallas=use_pallas, **kw)
        _eq(jb, tb)
        _eq(jp, tp)
    rb, rp = local_move_plp_ref(_t(r), _t(nbr), _t(w), _t(tab["labels_ext"]),
                                9, **kw)
    assert torch.equal(rb, tb) and torch.equal(rp, tp)


@pytest.mark.parametrize("singleton_rule", [True, False])
@pytest.mark.parametrize("layout,weights,width", list(_streamed_cases()))
def test_louvain_streamed_matches_jax_windowed(layout, weights, width,
                                               singleton_rule):
    n, (r, nbr, w, tab) = _case_tiles(layout, weights, width, width + 6)
    jw, tw = _both_windows(r, nbr, n, block_rows=4)
    kw = dict(sentinel=n, singleton_rule=singleton_rule,
              table_mode="streamed")
    names = ("labels_ext", "vol_ext", "size_ext", "deg_ext")
    jb, jp = j_lm_ops.local_move_louvain(
        jnp.asarray(r), jnp.asarray(nbr), jnp.asarray(w),
        *(jnp.asarray(tab[k]) for k in names), jnp.float32(413.0),
        windows=jw, **kw)
    for use_pallas in (False, True):
        tb, tp = t_lm_ops.local_move_louvain(
            _t(r), _t(nbr), _t(w), *(_t(tab[k]) for k in names),
            torch.tensor(413.0), windows=tw, use_pallas=use_pallas, **kw)
        _eq(jb, tb)
        _eq(jp, tp)
    kw["table_mode"] = "resident"
    rb, rp = t_lm_ops.local_move_louvain(
        _t(r), _t(nbr), _t(w), *(_t(tab[k]) for k in names),
        torch.tensor(413.0), windows=tw, **kw)
    assert torch.equal(rb, tb) and torch.equal(rp, tp)


def _banded_edges(n, band=40, k=3, seed=5):
    """Undirected edges between ids at most ``band`` apart: the id
    locality the streamed layout relies on."""
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n), k)
    v = np.clip(u + rng.integers(1, band, size=n * k), 0, n - 1)
    keep = u != v
    u, v = u[keep], v[keep]
    return np.concatenate([u, v]), np.concatenate([v, u])


def _to_torch(jg):
    return graph_from_numpy(
        *(np.asarray(getattr(jg, f)) for f in ("src", "dst", "w", "edge_mask")),
        n_valid=int(jg.n_valid), m_valid=int(jg.m_valid), n_max=jg.n_max,
        m_max=jg.m_max, sorted_by=jg.sorted_by, device="cpu")


@pytest.mark.parametrize("evaluator", ["plp", "louvain"])
def test_streamed_narrow_windows_on_real_buckets(evaluator):
    """Locality-ordered buckets of a banded graph, each package with its own
    windows (JAX ``to_device``, port ``build_ell``): narrower than the
    table, and streamed ≡ resident ≡ JAX, bit for bit."""
    u, v = _banded_edges(1024)
    jg = j_from_numpy_edges(u, v, np.ones(u.size, np.float32))
    n = jg.n_max
    je = jell.to_device(jg, jell.build_ell(jg, widths=(16, 64)),
                        block_rows=64)
    te = build_ell(_to_torch(jg), widths=(16, 64), block_rows=64)
    rng = np.random.default_rng(3)
    tabs = [np.append(rng.integers(0, 97, n), n).astype(np.int32),
            np.append(rng.integers(1, 30, n), 0).astype(np.float32),
            np.append(rng.integers(1, 3, n), 0).astype(np.int32),
            np.append(rng.integers(1, 7, n), 0).astype(np.float32)]
    narrow = 0
    for jb, tb in zip(je.buckets, te.buckets):
        if tb.n_rows_valid == 0:
            continue
        narrow += int(tb.windows.slot < n + 1)
        jrows, jnbr, jw_ = jell.grid_view(jb)
        args_j = (jrows, jnbr, jw_)
        args_t = (tb.rows, tb.nbr, tb.w)
        if evaluator == "plp":
            jout = j_lm_ops.local_move_plp(
                *args_j, jnp.asarray(tabs[0]), jnp.uint32(3), tie_eps=0.25,
                sentinel=n, windows=jb.windows, table_mode="streamed")
            outs = [t_lm_ops.local_move_plp(
                *args_t, _t(tabs[0]), 3, tie_eps=0.25, sentinel=n,
                windows=tb.windows, table_mode=tm, use_pallas=up)
                for tm, up in (("streamed", False), ("streamed", True),
                               ("resident", False))]
        else:
            kw = dict(sentinel=n, singleton_rule=True)
            jout = j_lm_ops.local_move_louvain(
                *args_j, *(jnp.asarray(t) for t in tabs), jnp.float32(999.0),
                windows=jb.windows, table_mode="streamed", **kw)
            outs = [t_lm_ops.local_move_louvain(
                *args_t, *(_t(t) for t in tabs), torch.tensor(999.0),
                windows=tb.windows, table_mode=tm, use_pallas=up, **kw)
                for tm, up in (("streamed", False), ("streamed", True),
                               ("resident", False))]
        R = tb.rows.shape[0]
        for tb_, tp_ in outs:
            np.testing.assert_array_equal(np.asarray(jout[0])[:R], tb_.numpy())
            np.testing.assert_array_equal(np.asarray(jout[1])[:R], tp_.numpy())
    assert narrow > 0, "no bucket produced a sub-table window"


def test_streamed_wrappers_count_no_launch_on_cpu():
    n = 400
    r, nbr, w, tab = _banded_tiles(40, 16, n, seed=2, weights="int")
    _, tw = _both_windows(r, nbr, n, block_rows=8)
    before = (local_move_plp_streamed_kernel.launches,
              local_move_louvain_streamed_kernel.launches)
    local_move_plp_streamed_kernel(_t(r), _t(nbr), _t(w),
                                   _t(tab["labels_ext"]), 1, tie_eps=0.25,
                                   sentinel=n, windows=tw)
    tabs = compose_louvain_tables(_t(tab["labels_ext"]), _t(tab["vol_ext"]),
                                  _t(tab["size_ext"]), _t(tab["deg_ext"]), n)
    local_move_louvain_streamed_kernel(_t(r), _t(nbr), _t(w), *tabs,
                                       torch.tensor(0.01), sentinel=n,
                                       singleton_rule=True, windows=tw)
    assert before == (local_move_plp_streamed_kernel.launches,
                      local_move_louvain_streamed_kernel.launches)
    with pytest.raises(ValueError, match="window metadata mismatch"):
        local_move_plp_streamed_kernel(
            _t(r[:8]), _t(nbr[:8]), _t(w[:8]), _t(tab["labels_ext"]), 1,
            tie_eps=0.25, sentinel=n, windows=tw)


# ------------------------------------------------------------ table policy


@pytest.mark.parametrize("budget", [1024, 4096, 232_448, 16 << 20])
def test_resolve_table_mode_matches_jax(budget):
    """The same rule as the JAX package for the same budget: resident iff
    the tables fit half of it; explicit modes pass through."""
    for table_bytes in (0, budget // 2 - 1, budget // 2, budget // 2 + 1,
                        budget, 1 << 40):
        for mode in ("auto", "resident", "streamed"):
            assert (tk.resolve_table_mode(mode, table_bytes, budget)
                    == jk.resolve_table_mode(mode, table_bytes, budget))
    assert tk.resolve_table_mode("auto", tk.SMEM_BUDGET_BYTES // 2) == \
        "resident"
    assert tk.resolve_table_mode("auto", tk.SMEM_BUDGET_BYTES // 2 + 1) == \
        "streamed"
    with pytest.raises(ValueError, match="table_mode"):
        tk.resolve_table_mode("bogus", 1)


@pytest.mark.parametrize("layout", ["banded", "random"])
def test_resolve_mode_matches_jax(layout):
    """``_resolve_mode`` over a sweep of budgets, both table counts: the
    JAX package's decision, except where the windows' one buffer fits half
    the budget and the TPU pipeline's two buffers would not — the streamed
    kernel holds one, so the port streams there.  Degenerate (whole-table)
    windows never stream under ``auto``; explicit ``streamed`` is
    honored."""
    n = 2000
    make = _banded_tiles if layout == "banded" else _tiles
    r, nbr, _, _ = make(400, 16, n, 4, "int")
    jw, tw = _both_windows(r, nbr, n, block_rows=8)
    n_pad = -(-(n + 1) // 128) * 128
    seen = set()
    for n_tables in (1, 4):
        win1 = 4 * n_tables * 2 * tw.slot
        for budget in range(256, 4 * 4 * n_pad * n_tables, 256):
            t = t_lm_ops._resolve_mode("auto", tw, n_tables, n, budget)
            j = j_lm_ops._resolve_mode("auto", jw, n_tables, n, budget)
            one_buffer_only = win1 <= budget // 2 < 2 * win1
            if one_buffer_only and 4 * n_tables * n_pad > budget // 2 \
                    and 2 * tw.slot < n_pad:
                assert (t, j) == ("streamed", "resident")
            else:
                assert t == j
            seen.add((t, j))
        for mode in ("resident", "streamed"):
            assert (t_lm_ops._resolve_mode(mode, tw, n_tables, n, 1)
                    == j_lm_ops._resolve_mode(mode, jw, n_tables, n, 1)
                    == mode)
    if layout == "random":
        assert 2 * tw.slot >= n_pad
        assert seen == {("resident", "resident")}
    else:   # every branch of the rule was taken
        assert seen == {("resident", "resident"), ("streamed", "streamed"),
                        ("streamed", "resident")}


def test_default_budget_streams_banded_and_keeps_rmat_resident():
    """With the card's own budget, ``auto`` streams the locality-ordered
    buckets of a banded graph of 65 536 vertices (tables past half the
    budget, windows far narrower than the table) and keeps every bucket of
    an R-MAT graph (no id locality: windows span the table) resident."""
    u, v = _banded_edges(65_536)
    g = t_from_numpy_edges(u, v, np.ones(u.size, np.float32), device="cpu")
    modes = {(b.width, nt): t_lm_ops._resolve_mode("auto", b.windows, nt,
                                                   g.n_max, None)
             for b in build_ell(g).buckets if b.n_rows_valid
             for nt in (1, 4)}
    assert modes[(16, 1)] == modes[(16, 4)] == "streamed"
    rmat = tdatasets.load("as-skitter", scale=1 / 32, device="cpu").graph
    modes = {t_lm_ops._resolve_mode("auto", b.windows, nt, rmat.n_max, None)
             for b in build_ell(rmat).buckets if b.n_rows_valid
             for nt in (1, 4)}
    assert modes == {"resident"}


# ------------------------------------------------------------ uint32 hashing


def _u32_values(seed, size):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**31 + 1,
                     2**32 - 2, 2**32 - 1], np.uint64)
    vals = rng.integers(0, 2**32, size, dtype=np.uint64)
    return np.concatenate([edge, vals]).astype(np.uint32)


def test_hash_u32_full_range():
    x = _u32_values(0, 50_000)
    j = np.asarray(jcommon.hash_u32(jnp.asarray(x))).astype(np.int64)
    t = tcommon.hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("eps", [0.25, 1e-3])
def test_tie_noise_full_range(eps):
    a, b = _u32_values(1, 20_000), _u32_values(2, 20_000)
    for seed in (0, 12345, 2**32 - 1):
        j = np.asarray(jcommon.tie_noise(jnp.asarray(a), jnp.asarray(b),
                                         jnp.uint32(seed), eps))
        t = tcommon.tie_noise(torch.from_numpy(a.astype(np.int64)),
                              torch.from_numpy(b.astype(np.int64)), seed, eps)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("move_prob", [0.5, 0.75, 0.999])
def test_luby_move_gate_full_range(move_prob):
    n = 20_000
    for key, seed in ((0, 0), (1007, 3), (2**32 - 1, 2**32 - 1)):
        for mult, salt in ((0x85EBCA6B, 313), (0x9E3779B1, 101)):
            j = np.asarray(jcommon.luby_move_gate(
                n, jnp.uint32(key), jnp.uint32(seed), move_prob, mult, salt))
            t = tcommon.luby_move_gate(n, key, seed, move_prob, mult, salt,
                                       torch.device("cpu"))
            np.testing.assert_array_equal(j, t.numpy())


@pytest.mark.parametrize("n_cap,m_cap", [(100, 400), (2048, 60_000),
                                         (2**21, 28_451_140), (10, 10_000)])
def test_width_and_capacity_helpers_match_jax(n_cap, m_cap):
    from repro.kernels import common as jk
    from repro_torch.kernels import common as tk

    assert tk.pick_bin_width(n_cap, m_cap) == jk.pick_bin_width(n_cap, m_cap)
    w = tk.pick_bin_width(n_cap, m_cap)
    assert tk.bin_table_bytes(n_cap, w) == jk.bin_table_bytes(n_cap, w)
    assert (tk.accum_needs_promotion(m_cap)
            == jk.accum_needs_promotion(m_cap))

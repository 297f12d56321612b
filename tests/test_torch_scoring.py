"""The port's scored-tile functions ≡ the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through the JAX ops — with
``use_pallas=False`` (the jnp oracle) and ``use_pallas=True`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it) — and
through the port's ``label_argmax``, ``delta_q_argmax`` and
``sorted_segment_sum`` (on CPU tensors both ``use_pallas`` values run the
plain versions).  Labels, candidates and run starts must match exactly.
Float outputs on integer weights must match the JAX oracle bit for bit;
against the interpret-mode Pallas kernels, whose scores differ from their
own oracle in the last bit (the tie noise is added in another rounding),
and on uniform float32 weights, whose rows the two frameworks add in
different orders, they hold the JAX tests' own tolerances (``rtol=1e-6``
for label_argmax, ``1e-5`` for delta_q and the segment sum).

Then the two-step scoring path (gather the tiles, then score them), as
``benchmarks/perf_variants.py`` composes it, on the level-0 ELL buckets of
the ``sbm-small`` stand-in: the port's composition must equal the port's
fused plain versions (``local_move_*_ref``, bit for bit on any weights:
the same floats in the same order) and the JAX package's composition
(bit for bit on unit and integer weights).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import moves as j_moves
from repro.graph import datasets as j_datasets
from repro.graph.ell import build_device_ell, grid_view
from repro.kernels.delta_q import ops as j_dq_ops
from repro.kernels.label_argmax import ops as j_la_ops
from repro.kernels.segment_sum import ops as j_ss_ops
from repro.kernels.segment_sum.kernel import block_segment_sums_pallas
from repro_torch.core import moves as t_moves
from repro_torch.graph import datasets as t_datasets
from repro_torch.graph.ell import build_ell
from repro_torch.kernels.delta_q.ops import delta_q_argmax
from repro_torch.kernels.label_argmax.ops import label_argmax
from repro_torch.kernels.local_move.ref import (_gather,
                                                compose_louvain_tables,
                                                local_move_louvain_tables_ref,
                                                local_move_plp_ref)
from repro_torch.kernels.segment_sum.kernel import block_segment_sums_kernel
from repro_torch.kernels.segment_sum.ops import sorted_segment_sum


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(rng, shape, kind):
    return (rng.integers(1, 9, shape) if kind == "int"
            else rng.random(shape)).astype(np.float32)


def _close(j_out, t_out, exact, rtol):
    """``exact``: equal.  Otherwise the JAX tests' check (labels compared in
    float64 under the same rtol, so they must be equal too)."""
    for a, b in zip(j_out, t_out):
        a, b = np.asarray(a), b.numpy()
        if exact or not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=rtol,
                                       atol=rtol)


# ------------------------------------------------------------- label_argmax


# Wide rows that stress the CUDA kernels' warp paths (csrc/tile_scoring.cuh),
# as cases of the tests below: ``one_run`` — every slot one label;
# ``all_distinct`` — every slot a different label; ``padding_rows`` —
# every other row with no valid slot; ``sentinel_key`` — every other row
# keyed by the sentinel with its labels valid; ``collide`` — labels equal
# modulo 2P, P = pow2_ceil(width) (a table of 2P buckets indexed by the
# label's low bits would put them all in one).  Their sentinel is 2^20.
WIDE_SETS = ("one_run", "all_distinct", "padding_rows", "sentinel_key",
             "collide")
WIDE_SENTINEL = 1 << 20


def _wide_labels(rng, kind, rows, width):
    """(labels with the sentinel where padded, padding mask, rows keyed by
    the sentinel) of a ``WIDE_SETS`` case."""
    pad = np.zeros((rows, width), bool)
    keyless = np.zeros(rows, bool)
    if kind == "one_run":
        lab = np.full((rows, width), 7)
    elif kind == "all_distinct":
        lab = (np.argsort(rng.random((rows, width)), axis=1) * 977
               + rng.integers(0, 977, (rows, 1)))
    elif kind == "collide":
        lab = 5 + 2 * width * rng.integers(0, WIDE_SENTINEL // (2 * width)
                                           - 1, (rows, width))
    else:
        lab = rng.integers(0, 9, (rows, width))
        if kind == "padding_rows":
            pad[::2] = True
        else:
            keyless[::2] = True
    pad |= rng.random((rows, width)) < 0.1
    return np.where(pad, WIDE_SENTINEL, lab).astype(np.int32), pad, keyless


def _cases(narrow):
    """The tests' (rows, width, kind) cases: the narrow random ones under
    their old ids, then every ``WIDE_SETS`` case at widths 256 and 1024."""
    return ([pytest.param(r, w, "random", id=f"{r}-{w}") for r, w in narrow]
            + [pytest.param(4, w, k, id=f"4-{w}-{k}")
               for w in (256, 1024) for k in WIDE_SETS])


@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("weights", ["int", "f32"])
@pytest.mark.parametrize("rows,width,kind", _cases(
    [(8, 8), (16, 32), (64, 16), (128, 128), (33, 8), (40, 64)]))
def test_label_argmax_matches_jax(rows, width, kind, weights, jax_pallas):
    rng = np.random.default_rng(rows * 1000 + width)
    if kind == "random":
        sentinel = 1000
        lab = rng.integers(0, 7, (rows, width)).astype(np.int32)
        pad = rng.random((rows, width)) < 0.2
        lab = np.where(pad, sentinel, lab).astype(np.int32)
        keyless = np.zeros(rows, bool)
    else:
        sentinel = WIDE_SENTINEL
        lab, pad, keyless = _wide_labels(rng, kind, rows, width)
    w = np.where(pad, 0.0, _weights(rng, (rows, width), weights))
    w = w.astype(np.float32)
    if kind == "random":
        cur = rng.integers(0, 7, rows).astype(np.int32)
    else:       # a slot's label, or one absent from the row
        cur = np.where(rng.random(rows) < 0.5, lab[:, 1], 11).astype(
            np.int32)
    keys = np.where(keyless, sentinel, np.arange(rows)).astype(np.int32)
    kw = dict(tie_eps=0.1, sentinel=sentinel)
    j_out = j_la_ops.label_argmax(
        jnp.asarray(lab), jnp.asarray(w), jnp.asarray(cur), jnp.asarray(keys),
        jnp.uint32(5), use_pallas=jax_pallas, **kw)
    for use_pallas in (False, True):
        t_out = label_argmax(_t(lab), _t(w), _t(cur), _t(keys), 5,
                             use_pallas=use_pallas, **kw)
        assert [t.dtype for t in t_out] == [torch.int32, torch.float32,
                                            torch.float32]
        _close(j_out, t_out, weights == "int" and not jax_pallas, 1e-6)


# ------------------------------------------------------------------ delta_q


@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("weights", ["int", "f32"])
@pytest.mark.parametrize("singleton_rule", [True, False])
@pytest.mark.parametrize("rows,width,kind", _cases(
    [(8, 8), (32, 64), (65, 16), (16, 128), (24, 32)]))
def test_delta_q_matches_jax(rows, width, kind, singleton_rule, weights,
                             jax_pallas):
    rng = np.random.default_rng(rows + width)
    if kind == "random":
        sentinel = 997
        cand = rng.integers(0, 9, (rows, width)).astype(np.int32)
        pad = rng.random((rows, width)) < 0.15
        cand = np.where(pad, sentinel, cand).astype(np.int32)
    else:
        sentinel = WIDE_SENTINEL
        cand, pad, _ = _wide_labels(rng, kind, rows, width)
    w = np.where(pad, 0.0, _weights(rng, (rows, width), weights))
    w = w.astype(np.float32)
    if kind == "random":
        cur = rng.integers(0, 9, rows).astype(np.int32)
    else:       # a slot's community, or one absent from the row
        cur = np.where(rng.random(rows) < 0.5, cand[:, 1], 11).astype(
            np.int32)
    if weights == "int":
        deg = rng.integers(1, 9, rows).astype(np.float32)
        volc = rng.integers(1, 40, (rows, width)).astype(np.float32)
        volcur = rng.integers(1, 40, rows).astype(np.float32)
    else:
        deg = rng.random(rows).astype(np.float32) + 0.1
        volc = rng.random((rows, width)).astype(np.float32) * 5
        volcur = rng.random(rows).astype(np.float32) * 5
    szc = rng.integers(1, 3, (rows, width)).astype(np.int32)
    szcur = rng.integers(1, 3, rows).astype(np.int32)
    arrays = (cand, w, cur, deg, volc, volcur, szc, szcur)
    kw = dict(sentinel=sentinel, singleton_rule=singleton_rule)
    j_out = j_dq_ops.delta_q_argmax(*(jnp.asarray(a) for a in arrays),
                                    jnp.float32(377.0),
                                    use_pallas=jax_pallas, **kw)
    for use_pallas in (False, True):
        t_out = delta_q_argmax(*(_t(a) for a in arrays),
                               torch.tensor(377.0, dtype=torch.float32),
                               use_pallas=use_pallas, **kw)
        assert [t.dtype for t in t_out] == [torch.int32, torch.float32]
        _close(j_out, t_out, weights == "int" and not jax_pallas, 1e-5)


# ------------------------------------------------------------- segment_sum


@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("weights", ["int", "f32"])
@pytest.mark.parametrize("m,block", [(64, 16), (512, 128), (1000, 256),
                                     (3000, 512), (1500, 64)])
def test_sorted_segment_sum_matches_jax(m, block, weights, jax_pallas):
    """Sorted keys with short runs and one run of 2·block + 5 keys, which
    crosses two block edges and exercises the spine fix-up."""
    rng = np.random.default_rng(m + block)
    lengths = rng.integers(1, 6, m)
    lengths[2] = 2 * block + 5
    keys = np.repeat(np.arange(m), lengths)[:m].astype(np.int32)
    vals = (rng.integers(-8, 9, m) if weights == "int"
            else rng.standard_normal(m)).astype(np.float32)
    j_out = j_ss_ops.sorted_segment_sum(jnp.asarray(keys), jnp.asarray(vals),
                                        block=block, use_pallas=jax_pallas)
    for use_pallas in (False, True):
        t_out = sorted_segment_sum(_t(keys), _t(vals), block=block,
                                   use_pallas=use_pallas)
        _close(j_out, t_out, weights == "int", 1e-5)


@pytest.mark.parametrize("block", [1, 16, 33, 100, 128, 512])
def test_block_segment_sums_matches_jax_pallas(block):
    """The block pass alone: the port's wrapper (its plain version on the
    CPU) against the JAX Pallas kernel in interpret mode, bit for bit on
    integer values, padding with INT32_MAX included; block sizes that are
    not a multiple of 4 or of 32 too."""
    rng = np.random.default_rng(block)
    m = 6 * block
    keys = np.sort(rng.integers(0, max(1, 3 * block // 4), m)).astype(
        np.int32)
    keys[-block // 2:] = 2**31 - 1
    vals = rng.integers(-8, 9, m).astype(np.float32)
    j_out = block_segment_sums_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                      block=block, interpret=True)
    t_out = block_segment_sums_kernel(_t(keys), _t(vals), block=block)
    np.testing.assert_array_equal(np.asarray(j_out), t_out.numpy())


# ------------------------------------------------- the two-step composition


def plp_two_step(rows, nbr, w, labels_ext, seed, n):
    """perf_variants.py's plp_two_step on the port: gather, then score."""
    best, bs, cs = label_argmax(
        _gather(labels_ext, nbr, n, n), w, _gather(labels_ext, rows, n, n),
        torch.where(rows < n, rows, n), seed, tie_eps=0.25, sentinel=n,
        use_pallas=True)
    return best, (best >= 0) & (bs > cs)


def louvain_two_step(rows, nbr, w, composed, vol_total, n):
    """perf_variants.py's louvain_two_step on the port, gathering from the
    composed per-vertex tables (volcom_v[v] = vol_ext[com_ext[v]] etc.)."""
    com, vol, size, deg = composed
    best, gain = delta_q_argmax(
        _gather(com, nbr, n, n), w, _gather(com, rows, n, n),
        _gather(deg, rows, n, 0.0), _gather(vol, nbr, n, 0.0),
        _gather(vol, rows, n, 0.0), _gather(size, nbr, n, 0),
        _gather(size, rows, n, 0), vol_total, sentinel=n,
        singleton_rule=True, use_pallas=True)
    return best, (best >= 0) & (gain > 0.0)


def j_plp_two_step(r_, nb, w_, labels_ext, seed, n):
    """benchmarks/perf_variants.py:352-359, expression for expression."""
    nbr_lab = jnp.where(nb < n, labels_ext[jnp.clip(nb, 0, n)], n)
    cur_lab = labels_ext[jnp.clip(r_, 0, n)]
    best, bs, cs = j_la_ops.label_argmax(
        nbr_lab, w_, cur_lab, jnp.where(r_ < n, r_, n), seed,
        tie_eps=0.25, sentinel=n, use_pallas=True)
    return best, (best >= 0) & (bs > cs)


def j_louvain_two_step(r_, nb, w_, com_ext, vol_ext, size_ext, deg_ext,
                       vol_v, n):
    """benchmarks/perf_variants.py:361-373, expression for expression."""
    rows_c = jnp.clip(r_, 0, n)
    cand = jnp.where(nb < n, com_ext[jnp.clip(nb, 0, n)], n)
    best, gain = j_dq_ops.delta_q_argmax(
        cand_com=cand, nbr_w=w_, cur_com=com_ext[rows_c],
        deg_v=deg_ext[rows_c],
        vol_cand=vol_ext[jnp.clip(cand, 0, n)],
        vol_cur=vol_ext[jnp.clip(com_ext[rows_c], 0, n)],
        size_cand=size_ext[jnp.clip(cand, 0, n)],
        size_cur=size_ext[jnp.clip(com_ext[rows_c], 0, n)],
        vol_total=vol_v, sentinel=n, singleton_rule=True,
        use_pallas=True)
    return best, (best >= 0) & (gain > 0.0)


@pytest.fixture(scope="module")
def sbm_small():
    jg = j_datasets.load("sbm-small").graph
    tg = t_datasets.load("sbm-small", device="cpu").graph
    np.testing.assert_array_equal(np.asarray(jg.src), tg.src.numpy())
    np.testing.assert_array_equal(np.asarray(jg.dst), tg.dst.numpy())
    return jg, tg, build_device_ell(jg), build_ell(tg)


def _state(n, labels_kind):
    """Community per vertex: singletons (perf_variants.py's sweep state) or
    a seeded assignment to n // 8 communities (a later sweep's)."""
    if labels_kind == "singleton":
        return np.arange(n, dtype=np.int32)
    return np.random.default_rng(4).integers(0, n // 8, n).astype(np.int32)


@pytest.mark.parametrize("weights", ["unit", "int", "f32"])
@pytest.mark.parametrize("labels_kind", ["singleton", "seeded"])
@pytest.mark.parametrize("evaluator", ["plp", "louvain"])
def test_two_step_matches_fused_and_jax_on_real_buckets(sbm_small, evaluator,
                                                        labels_kind, weights):
    jg, tg, je, te = sbm_small
    n = jg.n_max
    labels = _state(n, labels_kind)
    labels_ext = np.append(labels, n).astype(np.int32)
    # the Louvain sweep state, as perf_variants.py builds it
    j_deg = jg.weighted_degrees()
    j_vol_com, j_size_com = j_moves.community_aux(
        jnp.asarray(labels), j_deg, jg.vertex_mask(), n)
    j_tabs = (jnp.asarray(labels_ext),
              jnp.append(j_vol_com, jnp.zeros((1,), j_vol_com.dtype)),
              jnp.append(j_size_com, jnp.zeros((1,), j_size_com.dtype)),
              jnp.append(j_deg, jnp.zeros((1,), j_deg.dtype)))
    t_deg = tg.weighted_degrees()
    t_vol_com, t_size_com = t_moves.community_aux(_t(labels), t_deg,
                                                  tg.vertex_mask(), n)
    composed = compose_louvain_tables(
        _t(labels_ext), torch.cat([t_vol_com, t_vol_com.new_zeros(1)]),
        torch.cat([t_size_com, t_size_com.new_zeros(1)]).to(torch.int32),
        torch.cat([t_deg, t_deg.new_zeros(1)]), n)
    t_vol_total = tg.total_volume()
    rng = np.random.default_rng(7)
    checked = 0
    for jb, tb in zip(je.buckets, te.buckets):
        if tb.n_rows_valid == 0:
            continue
        rows, nbr, w = tb.rows, tb.nbr, tb.w
        if weights != "unit":
            w = torch.where(w != 0, _t(_weights(rng, tuple(w.shape),
                                                weights)), w)
        if evaluator == "plp":
            two = plp_two_step(rows, nbr, w, _t(labels_ext), 3, n)
            fused = local_move_plp_ref(rows, nbr, w, _t(labels_ext), 3,
                                       tie_eps=0.25, sentinel=n)
        else:
            two = louvain_two_step(rows, nbr, w, composed, t_vol_total, n)
            fused = local_move_louvain_tables_ref(
                rows, nbr, w, *composed,
                (1.0 / t_vol_total).to(torch.float32), sentinel=n,
                singleton_rule=True)
        assert torch.equal(two[0], fused[0]) and torch.equal(two[1], fused[1])
        if weights != "f32":
            R = rows.shape[0]
            jr, jn, jw = grid_view(jb)
            jw = jnp.asarray(np.pad(w.numpy(), ((0, jr.shape[0] - R), (0, 0))))
            if evaluator == "plp":
                j_out = j_plp_two_step(jr, jn, jw, j_tabs[0], jnp.uint32(3),
                                       n)
            else:
                j_out = j_louvain_two_step(jr, jn, jw, *j_tabs,
                                           jg.total_volume(), n)
            for a, b in zip(j_out, two):
                np.testing.assert_array_equal(np.asarray(a)[:R], b.numpy())
        checked += 1
    assert checked >= 2


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; the entry points' casts and width checks are those of the card
    path's callers."""
    from repro_torch.kernels.delta_q.kernel import delta_q_kernel
    from repro_torch.kernels.label_argmax.kernel import label_argmax_kernel
    from repro_torch.kernels.label_argmax.ref import label_argmax_chunked

    counters = (label_argmax_kernel, delta_q_kernel,
                block_segment_sums_kernel)
    before = [c.launches for c in counters]
    lab = torch.randint(0, 5, (10, 8), dtype=torch.int32)
    w = torch.ones(10, 8)
    cur = torch.zeros(10, dtype=torch.int32)
    keys = torch.arange(10, dtype=torch.int32)
    out = label_argmax(lab.long(), w.double(), cur, keys, 1, tie_eps=0.1,
                       sentinel=100, use_pallas=True)
    for a, b in zip(out, label_argmax_chunked(lab, w, cur, keys, 1, 0.1,
                                              100)):
        assert torch.equal(a, b)
    delta_q_argmax(lab, w, cur, w[:, 0], w, w[:, 0], lab, cur, 50.0,
                   sentinel=100, use_pallas=True)
    sorted_segment_sum(keys.repeat_interleave(3), w.reshape(-1)[:30],
                       block=16, use_pallas=True)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="divide"):
        block_segment_sums_kernel(keys, w[:, 0], block=16)

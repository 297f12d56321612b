"""Port kernels' plain versions ≡ the JAX package's oracles, bit for bit.

The same numpy inputs (made from a seed) go through the JAX function and
its ``repro_torch`` counterpart: the plain local_move scoring against
``local_move_plp_ref`` / ``local_move_louvain_tables_ref`` at every ELL
width, the plain ``bin_rank`` against ``bin_rank_ref``, and at one width the
JAX Pallas kernels in interpret mode.  Weights are small integers or all
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
from repro.kernels.local_move import ops as j_lm_ops
from repro.kernels.local_move.ref import (
    compose_louvain_tables as j_compose,
    local_move_louvain_tables_ref as j_louvain_ref,
    local_move_plp_ref as j_plp_ref,
)
from repro_torch.core import common as tcommon
from repro_torch.kernels.aggregation.kernel import bin_rank_kernel
from repro_torch.kernels.aggregation.ref import bin_rank_ref
from repro_torch.kernels.local_move import ops as t_lm_ops
from repro_torch.kernels.local_move.kernel import (local_move_louvain_kernel,
                                                   local_move_plp_kernel)
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


@pytest.mark.parametrize("width", [16, 64, 256])
def test_bin_rank_plain_matches_jax_ref(width):
    n = 300
    keys, cs, cd = _bin_table(width, n, 2000, width)
    j = j_bin_rank_ref(jnp.asarray(keys), jnp.asarray(cs), jnp.asarray(cd),
                       width=width, empty=n)
    t = bin_rank_ref(_t(keys), _t(cs), _t(cd), width=width, empty=n)
    _eq(j, t)
    # masked edges route to the sink row and rank 0
    assert int(t[_t(cs) == n].abs().sum()) == 0


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


def test_streamed_table_mode_is_not_ported():
    n = 16
    r, nbr, w, tab = _tiles(8, 16, n, seed=1, weights="int")
    with pytest.raises(NotImplementedError, match="Queue 2 #4"):
        t_lm_ops.local_move_plp(_t(r), _t(nbr), _t(w), _t(tab["labels_ext"]),
                                0, tie_eps=0.25, sentinel=n,
                                table_mode="streamed")


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

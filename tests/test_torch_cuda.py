"""CUDA kernels ≡ their plain PyTorch versions, bit for bit, on the card.

Marked ``cuda``; a fixture skips them where no card is present.  This file
imports only ``torch`` and ``repro_torch`` (the card's machine has no JAX),
so on the card run it without the repo's conftest, which imports the JAX
package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made from a seed with numpy at small shapes: every ELL width,
integer and all-equal (tie-rich) weights, both singleton-rule settings.
The streamed kernels run on locality-ordered tiles (windows narrower than
the table, several blocks) and on random ones (whole-table windows).
"""
import numpy as np
import pytest
import torch

from repro_torch.graph.ell import compute_windows
from repro_torch.kernels.aggregation.kernel import bin_rank_kernel
from repro_torch.kernels.aggregation.ref import bin_rank_ref
from repro_torch.kernels.local_move.kernel import (
    local_move_louvain_kernel, local_move_louvain_streamed_kernel,
    local_move_plp_kernel, local_move_plp_streamed_kernel)
from repro_torch.kernels.local_move.ref import (
    compose_louvain_tables, local_move_louvain_tables_ref,
    local_move_louvain_windowed_ref, local_move_plp_ref,
    local_move_plp_windowed_ref)
from repro_torch.utils.errors import KernelError

WIDTHS = (16, 64, 256, 1024)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _tiles(rows, width, n, seed, weights, dev, band=None):
    """Random tiles, or with ``band`` locality-ordered ones: row ids
    ascending, neighbors within ``band`` ids of their row."""
    rng = np.random.default_rng(seed)
    r_ids = np.full(rows, n, np.int32)
    real = rng.random(rows) < 0.9
    if band is None:
        r_ids[real] = rng.choice(n, size=int(real.sum()), replace=False)
        nbr = rng.integers(0, n, (rows, width)).astype(np.int32)
    else:
        ids = np.sort(rng.choice(np.arange(band, n - band), rows,
                                 replace=False))
        r_ids[real] = ids[real]
        nbr = (ids[:, None] + rng.integers(-band, band + 1, (rows, width))
               ).astype(np.int32)
    pad = rng.random((rows, width)) < 0.25
    pad[~real] = True
    nbr[pad] = n
    w = (rng.integers(1, 5, (rows, width)) if weights == "int"
         else np.ones((rows, width)))
    w = np.where(pad, 0.0, w).astype(np.float32)
    labels = rng.integers(0, max(2, n // 8), n)
    tabs = [np.concatenate([labels, [n]]).astype(np.int32),
            np.concatenate([rng.integers(1, 40, n), [0]]).astype(np.float32),
            np.concatenate([rng.integers(1, 3, n), [0]]).astype(np.int32),
            np.concatenate([rng.integers(1, 9, n), [0]]).astype(np.float32)]
    return [_card(x, dev) for x in (r_ids, nbr, w)], [_card(t, dev)
                                                      for t in tabs]


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("width", WIDTHS)
def test_local_move_plp_kernel_matches_plain(cuda_device, width, weights):
    n = 512
    tiles, tabs = _tiles(300, width, n, width, weights, cuda_device)
    launches = local_move_plp_kernel.launches
    k = local_move_plp_kernel(*tiles, tabs[0], 11, tie_eps=0.25, sentinel=n)
    p = local_move_plp_ref(*tiles, tabs[0], 11, tie_eps=0.25, sentinel=n)
    assert local_move_plp_kernel.launches == launches + 1
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("singleton_rule", [True, False])
@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("width", WIDTHS)
def test_local_move_louvain_kernel_matches_plain(cuda_device, width, weights,
                                                 singleton_rule):
    n = 512
    tiles, tabs = _tiles(300, width, n, width + 1, weights, cuda_device)
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=cuda_device)
    k = local_move_louvain_kernel(*tiles, *composed, inv, sentinel=n,
                                  singleton_rule=singleton_rule)
    p = local_move_louvain_tables_ref(*tiles, *composed, inv, sentinel=n,
                                      singleton_rule=singleton_rule)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def _streamed_case(width, weights, layout, seed, dev):
    n = 4000 if layout == "banded" else 1024
    rows = 64 if width >= 256 else 600
    tiles, tabs = _tiles(rows, width, n, seed, weights, dev,
                         band=40 if layout == "banded" else None)
    windows = compute_windows(tiles[0], tiles[1], n, 8 if width >= 256 else 64)
    if layout == "banded":
        assert windows.slot < n + 1 and windows.win_blk.numel() > 1
    return n, tiles, tabs, windows


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["banded", "random"])
@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("width", WIDTHS)
def test_local_move_plp_streamed_kernel_matches_plain(cuda_device, width,
                                                      weights, layout):
    n, tiles, tabs, win = _streamed_case(width, weights, layout, width + 2,
                                         cuda_device)
    kw = dict(tie_eps=0.25, sentinel=n)
    k = local_move_plp_streamed_kernel(*tiles, tabs[0], 13, windows=win, **kw)
    p = local_move_plp_windowed_ref(*tiles, tabs[0], 13, windows=win, **kw)
    r = local_move_plp_ref(*tiles, tabs[0], 13, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])


@pytest.mark.cuda
@pytest.mark.parametrize("singleton_rule", [True, False])
@pytest.mark.parametrize("layout", ["banded", "random"])
@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("width", WIDTHS)
def test_local_move_louvain_streamed_kernel_matches_plain(
        cuda_device, width, weights, layout, singleton_rule):
    n, tiles, tabs, win = _streamed_case(width, weights, layout, width + 3,
                                         cuda_device)
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=cuda_device)
    kw = dict(sentinel=n, singleton_rule=singleton_rule)
    k = local_move_louvain_streamed_kernel(*tiles, *composed, inv,
                                           windows=win, **kw)
    p = local_move_louvain_windowed_ref(*tiles, *composed, inv, windows=win,
                                        **kw)
    r = local_move_louvain_tables_ref(*tiles, *composed, inv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])


@pytest.mark.cuda
def test_streamed_window_over_shared_memory_raises(cuda_device):
    """Random ids over 100 000 vertices: every block's window spans the
    table, 800 KB for PLP — more than a block's shared memory.  The wrapper
    raises, naming the bytes, and launches nothing."""
    n = 100_000
    tiles, tabs = _tiles(64, 16, n, 5, "int", cuda_device)
    win = compute_windows(tiles[0], tiles[1], n, 16)
    launches = local_move_plp_streamed_kernel.launches
    with pytest.raises(KernelError, match=f"{4 * 2 * win.slot} bytes"):
        local_move_plp_streamed_kernel(*tiles, tabs[0], 0, tie_eps=0.25,
                                       sentinel=n, windows=win)
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1e-3, dtype=torch.float32, device=cuda_device)
    with pytest.raises(KernelError, match=f"{16 * 2 * win.slot} bytes"):
        local_move_louvain_streamed_kernel(*tiles, *composed, inv,
                                           sentinel=n, singleton_rule=True,
                                           windows=win)
    assert local_move_plp_streamed_kernel.launches == launches


@pytest.mark.cuda
def test_launch_counters_count_their_own_kernel(cuda_device):
    n, tiles, tabs, win = _streamed_case(16, "int", "banded", 1, cuda_device)
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1e-3, dtype=torch.float32, device=cuda_device)
    counters = (local_move_plp_kernel, local_move_louvain_kernel,
                local_move_plp_streamed_kernel,
                local_move_louvain_streamed_kernel)
    calls = (
        lambda: local_move_plp_kernel(*tiles, tabs[0], 0, tie_eps=0.25,
                                      sentinel=n),
        lambda: local_move_louvain_kernel(*tiles, *composed, inv, sentinel=n,
                                          singleton_rule=True),
        lambda: local_move_plp_streamed_kernel(*tiles, tabs[0], 0,
                                               tie_eps=0.25, sentinel=n,
                                               windows=win),
        lambda: local_move_louvain_streamed_kernel(
            *tiles, *composed, inv, sentinel=n, singleton_rule=True,
            windows=win))
    for i, call in enumerate(calls):
        before = [c.launches for c in counters]
        call()
        after = [c.launches for c in counters]
        assert [a - b for a, b in zip(after, before)] == [
            int(j == i) for j in range(len(counters))]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [16, 64, 256])
def test_bin_rank_kernel_matches_plain(cuda_device, width):
    n, m = 700, 5000
    rng = np.random.default_rng(width)
    keys = np.full((n + 1, width), n, np.int32)
    for row in range(n):
        k = rng.integers(0, width + 1)
        keys[row, rng.choice(width, size=k, replace=False)] = rng.choice(
            n, size=k, replace=False)
    cs = rng.integers(0, n + 1, m).astype(np.int32)
    cd = np.where(cs < n, rng.integers(0, n, m), n).astype(np.int32)
    args = [_card(x, cuda_device) for x in (keys.reshape(-1), cs, cd)]
    assert torch.equal(bin_rank_kernel(*args, width=width, empty=n),
                       bin_rank_ref(*args, width=width, empty=n))


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    n = 64
    tiles, tabs = _tiles(8, 16, n, 0, "int", cuda_device)
    with pytest.raises(TypeError):
        local_move_plp_kernel(tiles[0], tiles[1], tiles[2].double(), tabs[0],
                              0, tie_eps=0.25, sentinel=n)
    with pytest.raises(ValueError, match="width"):
        local_move_plp_kernel(tiles[0], tiles[1][:, :8].contiguous(),
                              tiles[2][:, :8].contiguous(), tabs[0], 0,
                              tie_eps=0.25, sentinel=n)

"""CUDA kernels ≡ their plain PyTorch versions, bit for bit, on the card.

Marked ``cuda``; a fixture skips them where no card is present.  This file
imports only ``torch`` and ``repro_torch`` (the card's machine has no JAX),
so on the card run it without the repo's conftest, which imports the JAX
package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made from a seed with numpy at small shapes: every ELL width,
integer and all-equal (tie-rich) weights, both singleton-rule settings.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.aggregation.kernel import bin_rank_kernel
from repro_torch.kernels.aggregation.ref import bin_rank_ref
from repro_torch.kernels.local_move.kernel import (local_move_louvain_kernel,
                                                   local_move_plp_kernel)
from repro_torch.kernels.local_move.ref import (compose_louvain_tables,
                                                local_move_louvain_tables_ref,
                                                local_move_plp_ref)

WIDTHS = (16, 64, 256, 1024)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _tiles(rows, width, n, seed, weights, dev):
    rng = np.random.default_rng(seed)
    r_ids = np.full(rows, n, np.int32)
    real = rng.random(rows) < 0.9
    r_ids[real] = rng.choice(n, size=int(real.sum()), replace=False)
    nbr = rng.integers(0, n, (rows, width)).astype(np.int32)
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

"""CUDA kernels ≡ their plain PyTorch versions, bit for bit, on the card.

Marked ``cuda``; a fixture skips them where no card is present.  This file
imports only ``torch`` and ``repro_torch`` (the card's machine has no JAX),
so on the card run it without the repo's conftest, which imports the JAX
package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made from a seed with numpy at small shapes: every ELL width,
integer and all-equal (tie-rich) weights, both singleton-rule settings.
The streamed kernels run on locality-ordered tiles (windows narrower than
the table, several blocks) and on random ones (whole-table windows); their
W = 16 path (a lane a row) also meets exact ties, whole dead blocks,
ids clipped at both window edges, labels just under the sentinel, float32
weights (bit for bit against the resident kernel) and every block size of
``chip_smoke.py``'s sweep, with a last block of one row.  The
scored-tile kernels (``label_argmax``, ``delta_q``) also run at widths
that are not ELL widths, and the two-step path (gather the tiles, then
score them) must equal the fused kernels bit for bit on float32 weights
too; ``sorted_segment_sum`` runs with runs longer than two blocks and
lengths that are not a block multiple, and its block pass must give, on
float32 values, the left fold of each run in position order bit for bit
at every block size from 1 to 1024.  ``bin_rank`` meets edges grouped by
row and shuffled, all on the sink row, full rows, fewer than a warp and
600 000, at W = 4 to 1024.

The sort-and-run scoring of the wide rows meets adversarial rows — one
run of W, W runs of one, mostly padding, exact ties — at every width and
at the scored-tile kernels' widest (4096, 2048): bit for bit on integer
weights, the weight-mass contract on uniform(0.5, 1.5) weights.  A
``pallas`` cascade on a 6144-vertex graph equals the ``ell`` and
``segment`` runs, ``cascade_stages`` included.  On an 8192-vertex banded
graph that streams its W = 16 bucket and cascades, ``leiden(pallas)``
equals ``leiden(ell)``; ``vmem_starve`` and ``binned_overflow`` give the
clean run's answer on ``pallas``; and a ``pallas`` run killed at its first
stage boundary and rerun resumes and equals the uninterrupted run.  On
ego-net stand-ins ``louvain_batch`` / ``plp_batch`` on ``pallas`` launch
the resident ``local_move`` kernels and ``bin_rank`` and equal the
single-graph ``pallas`` runs and the ``ell`` batch, and the service's
clean flush on the card equals its requests' single-graph runs.
Two gloo ranks on cuda:0 take a (2, 1) mesh train step of the REDUCED
qwen3-1.7b that holds against the one-rank step on the card, and a (1, 2)
expert-parallel step of the REDUCED qwen3-moe, its MoE layer held against
the unsharded layer on the card.
Shard-local ``distributed_louvain`` in two gloo ranks spawned on cuda:0
and in a one-rank NCCL group equals the single-device ``segment``
``louvain()`` bit for bit on unit and integer weights, ``bin_rank``
launching in every rank and every collective seeing card tensors.

The resident Louvain kernel relies on the tile contract (``graph/ell.py``:
a sentinel row holds only sentinels of weight 0): it meets traced tiles
that the port builds from coarse graphs at W = 16, 64 and 256 under unit,
integer and uniform float32 weights (bit for bit against the plain version
on the first two; on float32 bit for bit against the two-step path, whose
``delta_q`` kernel holds the weight-mass contract), and layouts that
stress the one-warp-a-row path: dense rows among dead ones in one warp's
group and one block, an all-dead tile, a masked loop in the middle of
every live row, live rows holding only their masked loop, rows of one
label, and labels past 2^26 (64-bit sort keys at W = 64).

The flash-attention kernels run against their plain version at every head
dim they take, GQA groups 1, 2 and 4, causal and not, Sq != Sk and ragged
lengths: float32 inputs through the split-TF32 tensor-core kernel within
1e-5, bf16 inputs through the wgmma kernel within one bf16 ulp of the
larger value plus 1e-6 (both keep the probabilities to float32 precision
and round once), each launch counted by its own kernel, against
``attention_ref`` in full float32 (``allow_tf32`` asserted off); both
kernels also at the model's head dim and lengths, the float32 one up to
4096 keys a query, at scores up to |s| of about 16 and, where float32
itself stops resolving 1e-5 (|s| near 30), against a float64 truth, and
on k and v that are not 16-byte aligned; and the dense model's
``prefill_fn`` at its
REDUCED size on the card, every layer's attention through the wgmma kernel,
against the same model on the CPU within 2^-5 of each logit row's largest
magnitude (bf16 matmuls on the card sum in another order, and the CPU path
rounds its probabilities to bf16).  That prefill check covers every
registered config, nemotron (head dim 24), llama-3.2-vision (cross
attention, gates at 0.5) and whisper (its encoder over the frames, its
decoder's cross attention) with their bf16 features, every attention call
launching the wgmma kernel; those three also decode on the card against
the CPU.  Both flash kernels also run at the head dims 24 and 192, GQA
groups 1, 2 and 6 and the new families' lengths (448, 1 500, 1 600).

Training: ``FlashAttentionFn`` (the kernel forward, the chunked mirror's
gradient) on card tensors, bf16 and float32: its output within the
kernel's contract of ``attention_ref``, its dq, dk, dv within
``GRAD_REF_REL`` of autograd through the float32 ``attention_ref`` and
within one ulp of the working type of the mirror's own autograd, each at
the gradient's largest magnitude; and the REDUCED ``loss_fn`` gradients
and one ``make_train_step`` (``grad_accum = 2``) on the card against the
CPU: every gradient leaf, the step's own included, within 2^-5 of its
largest magnitude, and the step's parameters and optimizer state within
1e-6 of the CPU optimizer run on the card step's gradients.

MoE: ``moe_layer`` at REDUCED and at qwen3-moe's full expert widths on
the card against itself on the CPU on the same bf16 input — expert ids
equal at every token whose adjacent top-(k+1) probabilities differ by
more than 1e-5, slot and keep bit for bit given equal ids, ``y`` within
2^-5 of each row's largest magnitude on the tokens routed alike (the
dense prefill's bound: at the full expert widths the two devices' bf16
products, summed in other orders over 2048 and 768 terms, land up to
2.75 bf16 ulps of the row scale apart on an H100), aux within 1e-5
relative, and a repeated card run bit for bit; the int8 KV cache's ``_quant``/``_cache_write``/``_cache_read``
on the card equal to the CPU's bit for bit.  The MoE configs' prefill
check routes the card's layers as the CPU's run routed them (a near-tie
flips on a bf16 ulp of input; the card's own ids must equal them wherever
the adjacent gaps exceed 2^-6) and holds 2^-4 of each logit row's
largest magnitude (llama4 is 4 layers deep; ``tests/test_torch_models.py``
``MOE_LOGIT_REL``).

RWKV6 and Zamba2: both chunked scans (``_wkv_chunked``, ``_ssd_chunked``)
at the published chunk of 128 on the card against the CPU, with
log-decays of -1 a step (where the JAX package's chunked forms overflow):
finite and within 1e-4 of the output's largest magnitude.  Their REDUCED
prefills run in the registered-config prefill check (zamba2's two shared
blocks through the wgmma kernel, rwkv6 launching none), at the families'
tolerance of ``tests/test_torch_models.py`` (2^-4 of each row's largest
magnitude at the 99th-percentile row and 2^-2 at every row: with random
weights a 2^-9 perturbation of the embedding moves their logits by up to
0.44 and 0.14 of the row scale), and both decode on the card against the
CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.graph.ell import TableWindows, compute_windows
from repro_torch.kernels.aggregation.kernel import bin_rank_kernel
from repro_torch.kernels.aggregation.ref import bin_rank_ref
from repro_torch.kernels.delta_q.kernel import delta_q_kernel
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_fwd_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.delta_q.ops import delta_q_argmax
from repro_torch.kernels.delta_q.ref import delta_q_chunked
from repro_torch.kernels.label_argmax.kernel import label_argmax_kernel
from repro_torch.kernels.label_argmax.ops import label_argmax
from repro_torch.kernels.label_argmax.ref import label_argmax_chunked
from repro_torch.kernels.local_move.kernel import (
    local_move_louvain_kernel, local_move_louvain_streamed_kernel,
    local_move_plp_kernel, local_move_plp_streamed_kernel)
from repro_torch.kernels.local_move.ref import (
    _gather, compose_louvain_tables, local_move_louvain_tables_ref,
    local_move_louvain_windowed_ref, local_move_plp_ref,
    local_move_plp_windowed_ref)
from repro_torch.kernels.segment_sum.kernel import block_segment_sums_kernel
from repro_torch.kernels.segment_sum.ops import sorted_segment_sum
from repro_torch.kernels.segment_sum.ref import (block_segment_sums_ref,
                                                 sorted_segment_sum_ref)
from repro_torch.models import api as model_api
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.models.common import init_params
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
    w = {"int": lambda: rng.integers(1, 5, (rows, width)),
         "equal": lambda: np.ones((rows, width)),
         "f32": lambda: rng.random((rows, width))}[weights]()
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


W16_KINDS = ("int", "ties", "all_dead_blocks", "clipped", "top_labels")
# chip_smoke.py's STREAM_BLOCK_ROWS_SWEEP, and two sizes that leave a
# block's last warp part empty (100) or a block one row (1)
W16_BLOCK_ROWS = (64, 128, 256, 512, 1024, 2048, 100, 1)


def _w16_case(kind, seed, dev, weights="int"):
    """Banded W = 16 tiles for the streamed kernels' lane-a-row path: 1 537
    rows (12 blocks of 128 and a block of one row) holding ascending ids of
    4 096 vertices, each neighbour within 64 ids of its row, 25 % padding
    slots, 10 % dead rows; ``weights`` int (1..4) or f32 (uniform(0.5,
    1.5)).  ``ties``: every live row holds two neighbours of other labels
    on alternate slots, weight 1, and the volumes and sizes are equal, so
    both moves score alike and the smaller id must win; ``all_dead_blocks``:
    blocks 2, 3 and 7 (of 128 rows) dead; ``top_labels``: every label and
    community among sentinel − 3 .. sentinel − 1.  (``clipped`` moves ids
    off their windows once the test has computed them:
    ``_clip_off_windows``.)  Returns n, the tiles and the four tables."""
    rng = np.random.default_rng(seed)
    n, R, W = 4096, 1537, 16
    r_ids = np.sort(rng.choice(np.arange(64, n - 64), R, replace=False))
    nbr = (r_ids[:, None] + rng.integers(-64, 65, (R, W))).astype(np.int32)
    labels = rng.integers(0, n // 8, n)
    vol, size = rng.integers(1, 40, n), rng.integers(1, 3, n)
    pad = rng.random((R, W)) < 0.25
    if kind == "ties":
        x = r_ids + rng.integers(1, 64, R)
        y = r_ids - rng.integers(1, 64, R)
        nbr[:, 0::2], nbr[:, 1::2] = x[:, None], y[:, None]
        labels = rng.permutation(n)                  # every label distinct
        vol, size = np.full(n, 20), np.full(n, 2)
        pad[:] = False
    elif kind == "top_labels":
        labels = rng.integers(n - 3, n, n)
    dead = rng.random(R) < 0.1
    if kind == "all_dead_blocks":
        for b in (2, 3, 7):
            dead[b * 128:(b + 1) * 128] = True
    r_ids = np.where(dead, n, r_ids).astype(np.int32)
    pad |= dead[:, None]
    nbr[pad] = n
    w = (np.ones((R, W)) if kind == "ties" else
         rng.uniform(0.5, 1.5, (R, W)) if weights == "f32" else
         rng.integers(1, 5, (R, W)))
    w = np.where(pad, 0.0, w).astype(np.float32)
    tabs = [np.append(labels, n).astype(np.int32),
            np.append(vol, 0).astype(np.float32),
            np.append(size, 0).astype(np.int32),
            np.append(rng.integers(1, 9, n), 0).astype(np.float32)]
    return n, [_card(x, dev) for x in (r_ids, nbr, w)], [_card(t, dev)
                                                         for t in tabs]


def _clip_off_windows(tiles, win, n, seed):
    """The tiles with 5 % of the real slots moved below or above their
    block's window, on both sides (the clamp both versions apply)."""
    rng = np.random.default_rng(seed)
    nbr = tiles[1].cpu().numpy()
    R = nbr.shape[0]
    lo = (win.win_blk.cpu().numpy().astype(np.int64) * win.slot).repeat(
        win.block_rows)[:R, None]
    below = rng.random(nbr.shape) < 0.5
    moved = np.where(below, lo - rng.integers(1, 40, nbr.shape),
                     lo + 2 * win.slot - 1 + rng.integers(1, 40, nbr.shape))
    pick = ((nbr < n) & (rng.random(nbr.shape) < 0.05) & (moved >= 0)
            & (moved < n))
    assert bool((pick & below).any()) and bool((pick & ~below).any())
    nbr[pick] = moved[pick]
    return [tiles[0], _card(nbr, tiles[1].device), tiles[2]]


def _w16_runs(tiles, tabs, n, win, tie_eps):
    """(kernel, plain) outputs of the PLP and both Louvain moves."""
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32,
                       device=tiles[0].device)
    kw = dict(tie_eps=tie_eps, sentinel=n, windows=win)
    out = [(local_move_plp_streamed_kernel(*tiles, tabs[0], 9, **kw),
            local_move_plp_windowed_ref(*tiles, tabs[0], 9, **kw))]
    for rule in (True, False):
        kw = dict(sentinel=n, singleton_rule=rule, windows=win)
        out.append((local_move_louvain_streamed_kernel(*tiles, *composed,
                                                       inv, **kw),
                    local_move_louvain_windowed_ref(*tiles, *composed, inv,
                                                    **kw)))
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", [128, 512])
@pytest.mark.parametrize("kind", W16_KINDS)
def test_streamed_w16_path_matches_plain(cuda_device, kind, block_rows):
    """The streamed kernels' W = 16 path (a lane a row) ≡ the windowed
    plain versions, bit for bit, at a row a thread and at four rows a
    thread a block (512 rows): exact ties (broken to the smaller id,
    tie_eps = 0), whole dead blocks, ids clipped at both window edges,
    labels just under the sentinel; a last block of one row."""
    n, tiles, tabs = _w16_case(kind, 31, cuda_device)
    win = compute_windows(tiles[0], tiles[1], n, block_rows)
    assert win.win_blk.numel() == -(-1537 // block_rows) and 2 * win.slot < n
    if kind == "clipped":
        tiles = _clip_off_windows(tiles, win, n, 32)
    launches = (local_move_plp_streamed_kernel.launches,
                local_move_louvain_streamed_kernel.launches)
    runs = _w16_runs(tiles, tabs, n, win, 0.0 if kind == "ties" else 0.25)
    assert (local_move_plp_streamed_kernel.launches,
            local_move_louvain_streamed_kernel.launches) == (
                launches[0] + 1, launches[1] + 2)
    dead = tiles[0] == n
    for k, p in runs:
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert bool((k[0][dead] == -1).all()) and not bool(k[1][dead].any())
        assert bool(k[1].any())
    if kind == "ties":       # both moves score alike: the smaller id wins
        nbr = tiles[1][~dead].long()
        lab = tabs[0][nbr[:, :2]]
        assert torch.equal(runs[0][0][0][~dead], lab.amin(dim=1))
    if kind == "top_labels":
        assert int(runs[0][0][0].max()) == n - 1


@pytest.mark.cuda
def test_streamed_w16_path_on_f32_weights(cuda_device):
    """On uniform(0.5, 1.5) weights the W = 16 path equals the resident
    kernel bit for bit (its block path sums the same weights in the same
    order; every real id lies in its window, so both read the same
    entries)."""
    n, tiles, tabs = _w16_case("int", 33, cuda_device, weights="f32")
    win = compute_windows(tiles[0], tiles[1], n, 128)
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=cuda_device)
    k = local_move_plp_streamed_kernel(*tiles, tabs[0], 9, tie_eps=0.25,
                                       sentinel=n, windows=win)
    r = local_move_plp_kernel(*tiles, tabs[0], 9, tie_eps=0.25, sentinel=n)
    assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])
    for rule in (True, False):
        k = local_move_louvain_streamed_kernel(
            *tiles, *composed, inv, sentinel=n, singleton_rule=rule,
            windows=win)
        r = local_move_louvain_kernel(*tiles, *composed, inv, sentinel=n,
                                      singleton_rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(k[0], r[0]) and torch.equal(k[1], r[1])
        assert bool(k[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("block_rows", W16_BLOCK_ROWS)
def test_streamed_w16_path_at_every_block_size(cuda_device, block_rows):
    """Every block size gives the plain version's outputs: from a block of
    one row (one thread) to 2 048 rows (16 rows a thread), and 100 rows (a
    last warp partly idle)."""
    n, tiles, tabs = _w16_case("int", 35, cuda_device)
    win = compute_windows(tiles[0], tiles[1], n, block_rows)
    for k, p in _w16_runs(tiles, tabs, n, win, 0.25):
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


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


def _bin_case(kind, width, seed):
    """(keys, cs, cd, n) of one ``bin_rank`` layout: a table of n + 1 rows
    (the last the sink, empty unless ``sink_holds_keys``), live rows with
    1..W distinct keys (W in ``full_rows``), edges in runs of 1-40 on one
    row (a src-sorted coarse graph's order), 5 % of the runs masked onto
    the sink, half the keys taken from the edge's row and half anywhere
    in [0, n]."""
    rng = np.random.default_rng([seed, width])
    n = max(700, 2 * width)
    keys = np.full((n + 1, width), n, np.int32)
    occ = (np.full(n, width) if kind == "full_rows"
           else rng.integers(1, width + 1, n))
    for row in range(n):
        keys[row, rng.choice(width, occ[row], replace=False)] = rng.choice(
            n, occ[row], replace=False)
    if kind == "sink_holds_keys":
        keys[n, ::2] = rng.choice(n, width // 2, replace=False)
    m = {"below_a_warp": 7, "many_edges": 600_000}.get(kind, 5000)
    lengths = rng.integers(1, 41, m)
    rows = np.where(rng.random(m) < 0.05, n, rng.integers(0, n, m))
    if kind in ("all_sink", "sink_holds_keys"):
        rows[:] = n
    cs = np.repeat(rows, lengths)[:m]
    held = keys[cs, rng.integers(0, width, m)]
    cd = np.where(rng.random(m) < 0.5, held, rng.integers(0, n + 1, m))
    cd = np.where((cs == n) & (kind != "sink_holds_keys"), n, cd)
    if kind == "shuffled":
        order = rng.permutation(m)
        cs, cd = cs[order], cd[order]
    return keys.reshape(-1), cs.astype(np.int32), cd.astype(np.int32), n


BIN_KINDS = ("grouped", "shuffled", "all_sink", "sink_holds_keys",
             "full_rows", "below_a_warp", "many_edges")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", BIN_KINDS)
@pytest.mark.parametrize("width", [4, 16, 64, 256, 1024])
def test_bin_rank_kernel_on_grouped_and_edge_layouts(cuda_device, width,
                                                     kind):
    """Edges grouped by row as a src-sorted coarse graph gives them and
    shuffled, every edge on the sink row (empty, or holding keys), full
    rows, fewer edges than a warp and more than the card runs at once
    (600 000); bit for bit against the plain version."""
    keys, cs, cd, n = _bin_case(kind, width, 7)
    args = [_card(x, cuda_device) for x in (keys, cs, cd)]
    launches = bin_rank_kernel.launches
    out = bin_rank_kernel(*args, width=width, empty=n)
    assert bin_rank_kernel.launches == launches + 1
    assert torch.equal(out, bin_rank_ref(*args, width=width, empty=n))


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


# ------------------------------------------------ scored tiles, segment sum

# Every ELL width, and widths that are not one (they run in the next wider
# instantiation), up to the widest each kernel takes: a lane a row up to
# 16, a warp a row up to 1024 (csrc/tile_scoring.cuh).
TILE_WIDTHS = (1, 8, 16, 17, 40, 64, 100, 128, 256, 300, 1000, 1024)


def _plp_tiles(tiles, tabs, n):
    """The two-step path's gather for PLP (the tiles the scoring kernel
    reads): neighbour labels, current labels, noise keys."""
    rows, nbr, _ = tiles
    return (_gather(tabs[0], nbr, n, n), _gather(tabs[0], rows, n, n),
            torch.where(rows < n, rows, n))


def _louvain_tiles(tiles, composed, n):
    """The two-step path's gather for Louvain on the composed tables:
    (cand, cur, deg, vol_cand, vol_cur, size_cand, size_cur)."""
    rows, nbr, _ = tiles
    com, vol, size, deg = composed
    return (_gather(com, nbr, n, n), _gather(com, rows, n, n),
            _gather(deg, rows, n, 0.0), _gather(vol, nbr, n, 0.0),
            _gather(vol, rows, n, 0.0), _gather(size, nbr, n, 0),
            _gather(size, rows, n, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("width", TILE_WIDTHS + (4096,))
def test_label_argmax_kernel_matches_plain(cuda_device, width, weights):
    n = 512
    tiles, tabs = _tiles(8 if width >= 1000 else 300, width, n, width,
                         weights, cuda_device)
    lab, cur, keys = _plp_tiles(tiles, tabs, n)
    args = (lab, tiles[2], cur, keys, 11)
    kw = dict(tie_eps=0.25, sentinel=n)
    k = label_argmax_kernel(*args, **kw)
    p = label_argmax_chunked(*args, 0.25, n)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("singleton_rule", [True, False])
@pytest.mark.parametrize("weights", ["int", "equal"])
@pytest.mark.parametrize("width", TILE_WIDTHS + (2048,))
def test_delta_q_kernel_matches_plain(cuda_device, width, weights,
                                      singleton_rule):
    n = 512
    tiles, tabs = _tiles(8 if width >= 1000 else 300, width, n, width + 1,
                         weights, cuda_device)
    cand, cur, deg, volc, volcur, sizec, sizecur = _louvain_tiles(
        tiles, compose_louvain_tables(*tabs, n), n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=cuda_device)
    args = (cand, tiles[2], cur, deg, volc, volcur, sizec, sizecur, inv)
    k = delta_q_kernel(*args, sentinel=n, singleton_rule=singleton_rule)
    p = delta_q_chunked(*args, n, singleton_rule)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)


# The scored-tile sets that keep the tile contract (a sentinel row holds
# no valid slot), which the fused kernels rely on: ``random`` is
# ``_tiles``, the others ``_scored_set``'s.
TWO_STEP_SETS = ("random", "one_run", "all_distinct", "mostly_padding",
                 "empty_rows", "ties", "near_sentinel", "collide_mod",
                 "collide_hash")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TWO_STEP_SETS)
@pytest.mark.parametrize("width", (16, 40, 64, 256, 1024))
def test_two_step_equals_fused_on_f32_weights(cuda_device, width, kind):
    """Gather + scoring kernel ≡ the fused kernel, bit for bit, on uniform
    float32 weights: both add the same floats in the same order.  A width
    that is no ELL width (40) is scored as it is and padded with the
    sentinel to the next ELL width for the fused kernels."""
    if kind == "random":
        n = 512
        tiles, tabs = _tiles(300, width, n, width + 5, "f32", cuda_device)
    else:
        n = SCORED_N
        tiles, tabs = _lifted_set(kind, 120, width, width + 5, cuda_device)
    ell = next(e for e in WIDTHS if e >= width)
    pad = ell - width
    fused_tiles = [tiles[0],
                   torch.nn.functional.pad(tiles[1], (0, pad), value=n),
                   torch.nn.functional.pad(tiles[2], (0, pad))]
    tie_eps = 0.0 if kind == "ties" else 0.25
    lab, cur, keys = _plp_tiles(tiles, tabs, n)
    best, bs, cs = label_argmax(lab, tiles[2], cur, keys, 3, tie_eps=tie_eps,
                                sentinel=n, use_pallas=True)
    fused = local_move_plp_kernel(*fused_tiles, tabs[0], 3, tie_eps=tie_eps,
                                  sentinel=n)
    assert torch.equal(best, fused[0])
    assert torch.equal((best >= 0) & (bs > cs), fused[1])

    composed = compose_louvain_tables(*tabs, n)
    vol_total = torch.tensor(977.0, device=cuda_device)
    cand, cur, deg, volc, volcur, sizec, sizecur = _louvain_tiles(
        tiles, composed, n)
    for rule in (True, False):
        best, gain = delta_q_argmax(cand, tiles[2], cur, deg, volc, volcur,
                                    sizec, sizecur, vol_total, sentinel=n,
                                    singleton_rule=rule, use_pallas=True)
        fused = local_move_louvain_kernel(
            *fused_tiles, *composed, (1.0 / vol_total).to(torch.float32),
            sentinel=n, singleton_rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(best, fused[0])
        assert torch.equal((best >= 0) & (gain > 0.0), fused[1])


ADVERSARIAL = ("one_label", "distinct", "sentinels", "ties")


def _adversarial(kind, rows, width, n, seed, weights, dev):
    """Rows that stress the sort-and-run scoring: ``one_label`` — every
    slot valid and one label (a single run of W); ``distinct`` — every
    slot a different label (runs of one); ``sentinels`` — 95 % padding
    slots anywhere in the row; ``ties`` — two labels on alternating slots
    with equal weight sums (exact score ties, broken by the smaller id).
    Neighbour ids lie in [0, n/2), row ids in [n/2, n), so a row's own
    label is never its neighbours' and moves are proposed.  ``weights``:
    ``int`` (1..4; 1 for ``ties``) or ``f32`` (uniform(0.5, 1.5)).
    Returns the (rows, nbr, w) tiles and the four per-vertex tables."""
    rng = np.random.default_rng(seed)
    half = n // 2
    r_ids = rng.choice(np.arange(half, n), rows, replace=False).astype(
        np.int32)
    if kind == "distinct":
        nbr = np.stack([rng.permutation(half)[:width] for _ in range(rows)])
    else:
        nbr = rng.integers(0, half, (rows, width))
    nbr = nbr.astype(np.int32)
    if kind == "sentinels":
        nbr[rng.random((rows, width)) < 0.95] = n
    labels = np.arange(n)
    if kind == "one_label":
        labels[:half] = 7
    elif kind == "ties":
        labels[:half] = 11
        nbr[:, 1::2] = nbr[:, 1::2] % 2 * 2 + 1     # odd ids 1, 3 ...
        nbr[:, 0::2] = nbr[:, 0::2] % 2 * 2         # ... even ids 0, 2
        labels[[0, 2]] = 5
        labels[[1, 3]] = 3
    if weights == "f32":
        w = rng.uniform(0.5, 1.5, (rows, width))
    else:
        w = np.ones((rows, width)) if kind == "ties" \
            else rng.integers(1, 5, (rows, width))
    w = np.where(nbr < n, w, 0.0).astype(np.float32)
    tabs = [np.concatenate([labels, [n]]).astype(np.int32),
            np.concatenate([rng.integers(1, 40, n), [0]]).astype(np.float32),
            np.concatenate([rng.integers(1, 3, n), [0]]).astype(np.int32),
            np.concatenate([rng.integers(1, 9, n), [0]]).astype(np.float32)]
    if kind == "ties":      # equal candidate volumes: equal gains
        tabs[1][:half] = 20.0
    return [_card(x, dev) for x in (r_ids, nbr, w)], [_card(t, dev)
                                                      for t in tabs]


@pytest.mark.cuda
@pytest.mark.parametrize("tie_eps", [0.25, 0.0])
@pytest.mark.parametrize("kind", ADVERSARIAL)
@pytest.mark.parametrize("width", WIDTHS)
def test_local_move_kernels_on_adversarial_rows(cuda_device, width, kind,
                                                tie_eps):
    """The fused kernels ≡ their plain versions, bit for bit, on rows of
    one run, of W runs, mostly padding, and of exact ties (tie_eps = 0
    leaves PLP's ties to the smaller label), integer weights."""
    n = 4096
    tiles, tabs = _adversarial(kind, 40, width, n, width + 7, "int",
                               cuda_device)
    kw = dict(tie_eps=tie_eps, sentinel=n)
    k = local_move_plp_kernel(*tiles, tabs[0], 5, **kw)
    p = local_move_plp_ref(*tiles, tabs[0], 5, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert bool(k[1].any())
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=cuda_device)
    for rule in (True, False):
        k = local_move_louvain_kernel(*tiles, *composed, inv, sentinel=n,
                                      singleton_rule=rule)
        p = local_move_louvain_tables_ref(*tiles, *composed, inv, sentinel=n,
                                          singleton_rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["distinct", "sentinels"])
@pytest.mark.parametrize("width", [256, 1024])
def test_local_move_kernels_with_wide_sort_keys(cuda_device, width, kind):
    """A sentinel past 2^(32 - log2 W) (a graph of 16 M vertices) puts the
    sort on its 64-bit keys: bit for bit against the plain versions."""
    n = (1 << 24) + 5
    tiles, tabs = _adversarial(kind, 40, width, n, width, "int", cuda_device)
    k = local_move_plp_kernel(*tiles, tabs[0], 5, tie_eps=0.25, sentinel=n)
    p = local_move_plp_ref(*tiles, tabs[0], 5, tie_eps=0.25, sentinel=n)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert int(k[0].max()) >= 1 << 22      # past the 32-bit keys' labels
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=cuda_device)
    k = local_move_louvain_kernel(*tiles, *composed, inv, sentinel=n,
                                  singleton_rule=True)
    p = local_move_louvain_tables_ref(*tiles, *composed, inv, sentinel=n,
                                      singleton_rule=True)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def _mass_contract(kernel_out, plain_out, plain, args, sentinel, mass,
                   keep_cur=None):
    """The float32 contract of the scored-tile kernels (chip_smoke.py,
    ``check_tiles_f32``): scores within 1e-5 of the row's weight mass M,
    labels equal wherever the plain version's top two scores are more than
    2e-5·M apart (the runner-up: the plain best with the best label's
    slots masked out)."""
    for a, b in zip(kernel_out[1:], plain_out[1:]):
        diff = torch.where(a == b, 0.0, (a - b).abs())
        assert bool((diff <= 1e-5 * mass).all())
    best = plain_out[0]
    masked = torch.where(args[0] == best[:, None], sentinel, args[0])
    second = plain(masked, *args[1:])[1]
    decided = (best < 0) | ((plain_out[1] - second).abs() > 2e-5 * mass)
    assert torch.equal(kernel_out[0][decided], best[decided])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ADVERSARIAL)
@pytest.mark.parametrize("width", WIDTHS)
def test_sort_and_run_on_f32_weights(cuda_device, width, kind):
    """uniform(0.5, 1.5) weights on the adversarial rows: the scored-tile
    kernels hold the weight-mass contract against their plain versions,
    and the fused kernels equal the two-step path bit for bit."""
    n = 4096
    tiles, tabs = _adversarial(kind, 40, width, n, width + 9, "f32",
                               cuda_device)
    mass = tiles[2].abs().sum(dim=1).clamp_min(1.0)
    lab, cur, keys = _plp_tiles(tiles, tabs, n)
    args = (lab, tiles[2], cur, keys, 5)
    k = label_argmax_kernel(*args, tie_eps=0.25, sentinel=n)
    p = label_argmax_chunked(*args, 0.25, n)
    _mass_contract(k, p, lambda *a: label_argmax_chunked(*a, 0.25, n), args,
                   n, mass)
    fused = local_move_plp_kernel(*tiles, tabs[0], 5, tie_eps=0.25,
                                  sentinel=n)
    assert torch.equal(k[0], fused[0])
    assert torch.equal((k[0] >= 0) & (k[1] > k[2]), fused[1])

    composed = compose_louvain_tables(*tabs, n)
    vol_total = torch.tensor(977.0, device=cuda_device)
    tiles_q = _louvain_tiles(tiles, composed, n)
    best, gain = delta_q_argmax(*tiles_q[:1], tiles[2], *tiles_q[1:],
                                vol_total, sentinel=n, singleton_rule=True,
                                use_pallas=True)
    fused = local_move_louvain_kernel(*tiles, *composed,
                                      (1.0 / vol_total).to(torch.float32),
                                      sentinel=n, singleton_rule=True)
    torch.cuda.synchronize()
    assert torch.equal(best, fused[0])
    assert torch.equal((best >= 0) & (gain > 0.0), fused[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ADVERSARIAL)
@pytest.mark.parametrize("weights", ["int", "f32"])
def test_scored_tiles_at_their_widest_widths(cuda_device, weights, kind):
    """label_argmax at 4096 and delta_q at 2048 (their widest rows, past
    every ELL width) on the adversarial rows: bit for bit on integer
    weights, the weight-mass contract on float32 weights."""
    n = 2 * 4096 + 64
    for name, width in (("label_argmax", 4096), ("delta_q", 2048)):
        tiles, tabs = _adversarial(kind, 6, width, n, width, weights,
                                   cuda_device)
        if name == "label_argmax":
            lab, cur, keys = _plp_tiles(tiles, tabs, n)
            args = (lab, tiles[2], cur, keys, 3)
            k = label_argmax_kernel(*args, tie_eps=0.25, sentinel=n)

            def plain(*a):
                return label_argmax_chunked(*a, 0.25, n)
        else:
            cand, cur, deg, volc, volcur, sizec, sizecur = _louvain_tiles(
                tiles, compose_louvain_tables(*tabs, n), n)
            inv = torch.tensor(1.0 / 977.0, dtype=torch.float32,
                               device=cuda_device)
            args = (cand, tiles[2], cur, deg, volc, volcur, sizec, sizecur,
                    inv)
            k = delta_q_kernel(*args, sentinel=n, singleton_rule=True)

            def plain(*a):
                return delta_q_chunked(*a, n, True)
        p = plain(*args)
        torch.cuda.synchronize()
        if weights == "int":
            assert all(torch.equal(a, b) for a, b in zip(k, p)), name
        else:
            _mass_contract(k, p, plain, args, n,
                           tiles[2].abs().sum(dim=1).clamp_min(1.0))


# Adversarial tiles of the scored-tile kernels' own paths (label space).
SCORED_SETS = ("one_run", "all_distinct", "mostly_padding", "empty_rows",
               "sentinel_keys", "ties", "near_sentinel", "collide_mod",
               "collide_hash")
SCORED_WIDTHS = (1, 8, 16, 17, 40, 64, 100, 256, 300, 1000, 1024, 2048,
                 4096)
SCORED_N = 1 << 20                  # the sentinel of the scored sets


def _hash_home(lab, width):
    """The bucket where a label's probe starts in the warp-a-row path's
    table at this width (csrc/tile_scoring.cuh ``SumTable::home``: a
    Fibonacci hash into the 2W buckets of the instantiation W)."""
    inst = next((w for w in (64, 256, 1024) if width <= w), 1024)
    bits = int(np.log2(2 * inst))
    return ((lab.astype(np.uint64) * 0x9E3779B1) % (1 << 32)) >> (32 - bits)


def _scored_set(kind, rows, width, seed, weights):
    """Tiles in label space, sentinel ``SCORED_N``: ``one_run`` — every
    slot one label; ``all_distinct`` — every slot a different label;
    ``mostly_padding`` — 95 % padding anywhere in the row, labels from 64;
    ``empty_rows`` — prefixes of 1..W slots, every other row with no valid
    slot under a real key; ``sentinel_keys`` — a third of the rows under
    the sentinel key with valid labels, a third under it with none;
    ``ties`` — two labels on alternating slots, equal weights and volumes
    (exact ties: run it with tie_eps = 0); ``near_sentinel`` — labels
    sentinel - 1 .. sentinel - 3; ``collide_mod`` — labels equal modulo
    2P, P = pow2_ceil(W); ``collide_hash`` — labels whose probes all start
    at one bucket of the warp path's table.  The current label is a
    random slot's (present unless that slot is padding).  ``weights``:
    ``int`` (1..4; 1 for ``ties``), ``equal`` or ``f32``
    (uniform(0.5, 1.5)).  Returns numpy (lab, w, cur, keys) and the
    delta_q terms (vol, size per slot; deg, vol_cur, size_cur)."""
    rng = np.random.default_rng(seed)
    n, R, W = SCORED_N, rows, width
    keys = rng.choice(n, R, replace=False)
    pad = np.zeros((R, W), bool)
    lab = rng.integers(0, 64, (R, W))
    if kind == "one_run":
        lab[:] = 7
    elif kind == "all_distinct":
        stride = (n - 1) // W
        lab = (np.argsort(rng.random((R, W)), axis=1) * stride
               + rng.integers(0, stride, (R, 1)))
    elif kind == "mostly_padding":
        pad = rng.random((R, W)) < 0.95
    elif kind == "empty_rows":
        pad = np.arange(W)[None, :] >= rng.integers(1, W + 1, R)[:, None]
        pad[::2] = True
    elif kind == "sentinel_keys":
        keys[::3] = n
        keys[1::3] = n
        pad[1::3] = True
    elif kind == "ties":
        lab[:, 0::2], lab[:, 1::2] = 5, 3
    elif kind == "near_sentinel":
        lab = n - 1 - rng.integers(0, 3, (R, W))
    elif kind == "collide_mod":
        step = 2 * (1 << int(np.ceil(np.log2(W)))) if W > 1 else 2
        lab = 5 + step * rng.integers(0, (n - 6) // step, (R, W))
    elif kind == "collide_hash":
        pool = np.arange(n - 1)
        pool = pool[_hash_home(pool, W) == 0]
        lab = rng.choice(pool, (R, W))
    cur = lab[np.arange(R), rng.integers(0, W, R)]
    cur = np.where(pad[np.arange(R), 0] & (keys == n), n, cur)
    lab = np.where(pad, n, lab)
    w = {"int": lambda: rng.integers(1, 5, (R, W)),
         "equal": lambda: np.ones((R, W)),
         "f32": lambda: rng.uniform(0.5, 1.5, (R, W))}[weights]()
    if kind == "ties" and weights == "int":
        w = np.ones((R, W))
    w = np.where(pad, 0.0, w)
    vol = np.full((R, W), 20) if kind == "ties" else rng.integers(1, 40,
                                                                  (R, W))
    size = rng.integers(1, 3, (R, W))
    terms = (rng.integers(1, 9, R).astype(np.float32),
             rng.integers(1, 40, R).astype(np.float32),
             rng.integers(1, 3, R).astype(np.int32))
    return ((lab.astype(np.int32), w.astype(np.float32), cur.astype(np.int32),
             keys.astype(np.int32)),
            (np.where(pad, 0, vol).astype(np.float32),
             np.where(pad, 0, size).astype(np.int32)) + terms)


def _lifted_set(kind, rows, width, seed, dev):
    """A ``_scored_set`` (float32 weights) as the fused kernels take it:
    slot (r, k) holds vertex r·W + k (the sentinel where padded), row r is
    vertex R·W + r (the sentinel where its key is), and the label table
    gives each vertex its label; community volumes, sizes and degrees are
    random.  Returns the (rows, nbr, w) tiles and the four tables."""
    (lab, w, cur, keys), _ = _scored_set(kind, rows, width, seed, "f32")
    rng = np.random.default_rng(seed + 1)
    n, R, W = SCORED_N, rows, width
    nbr = np.where(lab < n, np.arange(R * W).reshape(R, W), n)
    row_ids = np.where(keys < n, R * W + np.arange(R), n)
    labels = np.full(n + 1, n)
    labels[:R * W] = lab.ravel()
    labels[R * W:R * W + R] = cur
    labels[n] = n
    tabs = [labels.astype(np.int32),
            np.append(rng.integers(1, 40, n), 0).astype(np.float32),
            np.append(rng.integers(1, 3, n), 0).astype(np.int32),
            np.append(rng.integers(1, 9, n), 0).astype(np.float32)]
    return ([_card(x.astype(t), dev) for x, t in
             ((row_ids, np.int32), (nbr, np.int32), (w, np.float32))],
            [_card(t, dev) for t in tabs])


def _scored_kernels(kind, rows, width, seed, weights, dev):
    """Both scored-tile kernels (delta_q under both singleton rules, up to
    its widest width, 2048) and their plain versions on one
    ``_scored_set``: yields (kernel output, plain output, plain function,
    its arguments)."""
    n = SCORED_N
    (lab, w, cur, keys), dq = _scored_set(kind, rows, width, seed, weights)
    lab, w, cur, keys = (_card(x, dev) for x in (lab, w, cur, keys))
    vol, size, deg, vol_cur, size_cur = (_card(x, dev) for x in dq)
    tie_eps = 0.0 if kind == "ties" else 0.25
    args = (lab, w, cur, keys, 13)
    k = label_argmax_kernel(*args, tie_eps=tie_eps, sentinel=n)

    def plain_la(*a):
        return label_argmax_chunked(*a, tie_eps, n)
    yield k, plain_la(*args), plain_la, args
    if width > 2048:
        return
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=dev)
    args = (lab, w, cur, deg, vol, vol_cur, size, size_cur, inv)
    for rule in (True, False):
        k = delta_q_kernel(*args, sentinel=n, singleton_rule=rule)

        def plain_dq(*a, rule=rule):
            return delta_q_chunked(*a, n, rule)
        yield k, plain_dq(*args), plain_dq, args


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["int", "equal", "f32"])
@pytest.mark.parametrize("kind", SCORED_SETS)
@pytest.mark.parametrize("width", SCORED_WIDTHS)
def test_scored_tile_paths_on_adversarial_sets(cuda_device, width, kind,
                                               weights):
    """label_argmax and delta_q (a lane a row up to 16, a warp a row up to
    1024, the block path above) against their plain versions on the
    adversarial sets: bit for bit on integer and equal weights, the
    weight-mass contract on float32."""
    rows = 200 if width <= 100 else 40 if width <= 1024 else 8
    for k, p, plain, args in _scored_kernels(kind, rows, width, width + 11,
                                             weights, cuda_device):
        torch.cuda.synchronize()
        if weights == "f32":
            _mass_contract(k, p, plain, args, SCORED_N,
                           args[1].abs().sum(dim=1).clamp_min(1.0))
        else:
            for a, b in zip(k, p):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all_distinct", "one_run", "collide_hash",
                                  "sentinel_keys"])
@pytest.mark.parametrize("width", [40, 256, 1024])
def test_scored_tile_warps_reuse_their_tables(cuda_device, width, kind):
    """More rows than twice the warps of the warp-a-row path's grid (64 an
    SM: ``warp_blocks`` in csrc/tile_scoring.cuh), so every warp scores at
    least two rows in one table, emptied between them: bit for bit against
    the plain versions on integer weights."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    rows = 2 * 64 * sms + 5
    for k, p, _, _ in _scored_kernels(kind, rows, width, width, "int",
                                      cuda_device):
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a, b)


def _traced_case(width, weights, seed, dev):
    """A traced tile of a coarse graph built by the port on the CPU (a
    banded graph of 6 000 vertices with two hubs, coarsened by runs of
    three vertices: 2 000 live rows of 6 000, hub rows in the tail at
    W = 16 and 64), moved to the card, with composed tables of a random
    partition of the coarse vertices and weights ``unit``, ``int``
    (1..8) or ``f32`` (uniform(0.5, 1.5))."""
    from repro_torch.core.aggregation import remap_and_coarsen
    from repro_torch.graph.builders import from_numpy_edges
    from repro_torch.graph.ell import traced_ell_tile

    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(6000), 4)
    v = np.clip(u + rng.integers(1, 60, u.size), 0, 5999)
    hubs = [np.full(150, 100), rng.choice(6000, 150, replace=False),
            np.full(400, 3000), rng.choice(6000, 400, replace=False)]
    u = np.concatenate([u, hubs[0], hubs[2]])
    v = np.concatenate([v, hubs[1], hubs[3]])
    keep = u != v
    g = from_numpy_edges(u[keep], v[keep], device="cpu")
    cg = remap_and_coarsen(
        g, torch.arange(g.n_max, dtype=torch.int32) // 3)[2]
    rows, nbr, w, _ = traced_ell_tile(cg, width)
    n = cg.n_max
    real = (nbr < n).numpy()
    if weights == "int":
        w = torch.from_numpy(np.where(real, rng.integers(1, 9, real.shape),
                                      0).astype(np.float32))
    elif weights == "f32":
        w = torch.from_numpy(np.where(real, rng.uniform(0.5, 1.5,
                                                        real.shape),
                                      0).astype(np.float32))
    labels = rng.integers(0, n // 4, n)
    tabs = [np.concatenate([labels, [n]]).astype(np.int32),
            np.concatenate([rng.integers(1, 40, n), [0]]).astype(np.float32),
            np.concatenate([rng.integers(1, 3, n), [0]]).astype(np.int32),
            np.concatenate([rng.integers(1, 9, n), [0]]).astype(np.float32)]
    return ([t.to(dev) for t in (rows, nbr, w)],
            [_card(t, dev) for t in tabs], n)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["unit", "int", "f32"])
@pytest.mark.parametrize("width", [16, 64, 256])
def test_louvain_kernel_on_traced_tiles(cuda_device, width, weights):
    """The resident Louvain kernel on the port's own traced tiles: bit for
    bit against the plain version on unit and integer weights; on float32
    weights bit for bit against the two-step path, whose scoring kernel
    holds the weight-mass contract against its plain version.  Dead rows
    give (-1, no move)."""
    tiles, tabs, n = _traced_case(width, weights, width, cuda_device)
    assert bool((tiles[0] == n).any()) and bool((tiles[0] < n).any())
    composed = compose_louvain_tables(*tabs, n)
    vol_total = torch.tensor(977.0, device=cuda_device)
    inv = (1.0 / vol_total).to(torch.float32)
    for rule in (True, False):
        k = local_move_louvain_kernel(*tiles, *composed, inv, sentinel=n,
                                      singleton_rule=rule)
        dead = tiles[0] == n
        assert bool((k[0][dead] == -1).all()) and not bool(k[1][dead].any())
        assert bool(k[1].any())
        if weights != "f32":
            p = local_move_louvain_tables_ref(*tiles, *composed, inv,
                                              sentinel=n, singleton_rule=rule)
            torch.cuda.synchronize()
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
            continue
        cand, cur, deg, volc, volcur, sizec, sizecur = _louvain_tiles(
            tiles, composed, n)
        args = (cand, tiles[2], cur, deg, volc, volcur, sizec, sizecur, inv)
        best, gain = delta_q_kernel(*args, sentinel=n, singleton_rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(best, k[0])
        assert torch.equal((best >= 0) & (gain > 0.0), k[1])

        def plain(*a):
            return delta_q_chunked(*a, n, rule)
        _mass_contract((best, gain), plain(*args), plain, args, n,
                       tiles[2].abs().sum(dim=1).clamp_min(1.0))


CONTRACT_LAYOUTS = ("dense_among_dead", "all_dead", "loop_mid_row",
                    "loop_only", "one_label", "wide_keys")


def _contract_layout(kind, width, seed, dev):
    """300 rows under the tile contract that stress the one-warp-a-row
    path (module docstring): ``dense_among_dead`` — rows 5 and 37 (two
    warps' row groups of one block) and 290 full, every other row dead;
    ``all_dead``; ``loop_mid_row`` — 60 % of the rows live with a prefix
    of 2..W real slots and a masked loop (a sentinel slot) in its middle;
    ``loop_only`` — the same, but four live rows in five hold nothing but
    their masked loop, as most rows of a late coarse level do;
    ``one_label`` — the same prefixes, every neighbour of one community;
    ``wide_keys`` — the same prefixes on a graph of 2^27 + 5 vertices,
    each neighbour its own community, so half the labels pass 2^26 and
    the sort takes 64-bit keys at W >= 64.  Integer
    weights 1..4.  Returns the tiles, the four tables and the sentinel."""
    rng = np.random.default_rng(seed)
    R = 300
    n = (1 << 27) + 5 if kind == "wide_keys" else 4096
    half = n // 2
    rows = np.full(R, n, np.int32)
    nbr = np.full((R, width), n, np.int32)
    if kind == "dense_among_dead":
        live, deg = np.array([5, 37, 290]), np.full(3, width)
    elif kind == "all_dead":
        live, deg = np.array([], np.int64), np.array([], np.int64)
    else:
        live = np.flatnonzero(rng.random(R) < 0.6)
        deg = rng.integers(2, width + 1, live.size)
        if kind == "loop_only":
            deg[rng.random(live.size) < 0.8] = 1
    rows[live] = rng.choice(np.arange(half, n), live.size, replace=False)
    for r, d in zip(live, deg):
        nbr[r, :d] = rng.integers(0, half if kind != "wide_keys" else n, d)
        if kind != "dense_among_dead":
            nbr[r, d // 2] = n                       # the masked loop
    w = np.where(nbr < n, rng.integers(1, 5, nbr.shape), 0).astype(
        np.float32)
    if kind == "wide_keys":
        labels = np.arange(n)
    else:
        labels = rng.integers(0, n // 8, n)
        if kind == "one_label":
            labels[:half] = 7
    tabs = [np.concatenate([labels, [n]]).astype(np.int32),
            np.concatenate([rng.integers(1, 40, n), [0]]).astype(np.float32),
            np.concatenate([rng.integers(1, 3, n), [0]]).astype(np.int32),
            np.concatenate([rng.integers(1, 9, n), [0]]).astype(np.float32)]
    return ([_card(x, dev) for x in (rows, nbr, w)],
            [_card(t, dev) for t in tabs], n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CONTRACT_LAYOUTS)
@pytest.mark.parametrize("width", [16, 64, 256])
def test_louvain_kernel_on_contract_layouts(cuda_device, width, kind):
    """The resident Louvain kernel ≡ its plain version, bit for bit, on
    the contract layouts, both singleton-rule settings; dead rows give
    (-1, no move) and the live rows propose moves."""
    tiles, tabs, n = _contract_layout(kind, width, width + 3, cuda_device)
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1.0 / 977.0, dtype=torch.float32, device=cuda_device)
    dead = tiles[0] == n
    for rule in (True, False):
        k = local_move_louvain_kernel(*tiles, *composed, inv, sentinel=n,
                                      singleton_rule=rule)
        p = local_move_louvain_tables_ref(*tiles, *composed, inv, sentinel=n,
                                          singleton_rule=rule)
        torch.cuda.synchronize()
        assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
        assert bool((k[0][dead] == -1).all()) and not bool(k[1][dead].any())
        assert bool(k[1].any()) == (kind != "all_dead")
    if kind == "wide_keys":
        assert int(k[0].max()) >= 1 << 26     # past the 32-bit keys' labels


@pytest.mark.cuda
def test_cascade_on_the_card_agrees_across_backends(cuda_device):
    """Louvain's default config on a 6144-vertex banded graph on the card:
    the cascade descends >= 2 capacities, its coarse levels launch the
    resident local_move kernel on the traced tiles (more launches than
    the single-capacity run, whose coarse levels run the segment
    evaluator), and the ``pallas``, ``ell`` and ``segment`` runs and the
    single-capacity run agree in every field, stages apart for the last."""
    from repro_torch.core.louvain import LouvainConfig, louvain
    from repro_torch.graph.builders import from_numpy_edges

    rng = np.random.default_rng(5)
    u = np.repeat(np.arange(6144), 6)
    v = np.clip(u + rng.integers(1, 40, size=u.size), 0, 6143)
    g = from_numpy_edges(u[u != v], v[u != v], device=cuda_device)
    launches = {}
    runs = {}
    for b, sched in (("pallas", "auto"), ("pallas", "none"), ("ell", "auto"),
                     ("segment", "auto")):
        before = local_move_louvain_kernel.launches
        runs[b, sched] = louvain(g, LouvainConfig(backend=b,
                                                  capacity_schedule=sched))
        launches[b, sched] = local_move_louvain_kernel.launches - before
    ref = runs["pallas", "auto"]
    assert len(ref.cascade_stages) >= 2
    assert launches["pallas", "auto"] > launches["pallas", "none"] > 0
    assert launches["ell", "auto"] == launches["segment", "auto"] == 0
    fields = ("n_communities", "levels", "modularity", "modularity_history",
              "sweeps_per_level", "n_comm_per_level", "delta_n_per_level")
    for key, res in runs.items():
        np.testing.assert_array_equal(res.labels, ref.labels)
        for f in fields + (("cascade_stages",) if key[1] == "auto" else ()):
            assert getattr(res, f) == getattr(ref, f), (key, f)


def _banded_on_card(dev, n=8192):
    """A banded graph whose Louvain tables pass half the shared-memory
    budget (level 0's W = 16 bucket streams under ``auto``) and whose
    cascade descends two capacities."""
    from repro_torch.graph.builders import from_numpy_edges

    rng = np.random.default_rng(5)
    u = np.repeat(np.arange(n), 3)
    v = np.clip(u + rng.integers(1, 40, size=u.size), 0, n - 1)
    u, v = u[u != v], v[u != v]
    return from_numpy_edges(np.concatenate([u, v]), np.concatenate([v, u]),
                            n=n, device=dev)


LEIDEN_FIELDS = ("n_communities", "levels", "modularity",
                 "modularity_history", "sweeps_per_level", "n_comm_per_level",
                 "delta_n_per_level", "aggregation_per_level",
                 "cascade_stages")


def _assert_runs_equal(a, b, fields=LEIDEN_FIELDS):
    np.testing.assert_array_equal(a.labels, b.labels)
    for f in fields:
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.cuda
def test_leiden_on_the_card_pallas_equals_ell(cuda_device):
    """``leiden(pallas)`` ≡ ``leiden(ell)`` on the card, every field; the
    kernels run at level 0 (the streamed one too) and on the coarse
    levels, ``bin_rank`` once per binned (refined) coarsening."""
    from repro_torch.core.louvain import LouvainConfig, leiden

    g = _banded_on_card(cuda_device)
    kernels = (local_move_louvain_kernel, local_move_louvain_streamed_kernel,
               bin_rank_kernel)
    before = [k.launches for k in kernels]
    res = leiden(g, LouvainConfig(backend="pallas"))
    lv, lv_s, br = (k.launches - b for k, b in zip(kernels, before))
    ref = leiden(g, LouvainConfig(backend="ell"))
    _assert_runs_equal(res, ref)
    assert len(res.cascade_stages) >= 2
    # every level-0 sweep launches the streamed kernel once per streamed
    # bucket
    assert lv > 0 and lv_s > 0 and lv_s % res.sweeps_per_level[0] == 0
    assert br == res.aggregation_per_level.count("binned") > 0
    assert "refinement" in res.timer.totals


@pytest.mark.cuda
@pytest.mark.parametrize("fault,counter", [
    ("vmem_starve", "fault.vmem_starve.budget_clamped"),
    ("binned_overflow", "fault.binned_overflow.forced")])
def test_faults_on_the_card_equal_the_clean_run(cuda_device, fault, counter):
    """On ``pallas`` each fault gives the clean labels and Q, and its
    counter moves; under ``vmem_starve`` the W = 16 bucket that streams
    when clean stays resident (the 1 KB budget fits no window)."""
    from repro_torch.core.louvain import LouvainConfig, louvain
    from repro_torch.utils import faultinject, telemetry

    g = _banded_on_card(cuda_device)
    cfg = LouvainConfig(backend="pallas")
    streamed = local_move_louvain_streamed_kernel.launches
    clean = louvain(g, cfg)
    assert local_move_louvain_streamed_kernel.launches > streamed
    moved, streamed = (telemetry.get(counter),
                       local_move_louvain_streamed_kernel.launches)
    with faultinject.inject(fault):
        res = louvain(g, cfg)
    np.testing.assert_array_equal(res.labels, clean.labels)
    assert res.modularity == clean.modularity
    assert res.n_comm_per_level == clean.n_comm_per_level
    assert telemetry.get(counter) > moved
    assert res.run_report.faults == [fault]
    if fault == "vmem_starve":
        assert local_move_louvain_streamed_kernel.launches == streamed
    else:
        assert set(res.aggregation_per_level) == {"sort_fallback"}


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [False, True])
def test_kill_and_resume_on_the_card(cuda_device, tmp_path, refine):
    """A ``pallas`` cascade killed by ``preempt_stage`` right after its
    first boundary committed, then rerun, resumes once (onto the card)
    and equals the uninterrupted run; nothing is left behind."""
    from repro_torch.core.louvain import LouvainConfig, louvain
    from repro_torch.utils import faultinject, telemetry
    from repro_torch.utils.resilience import Preempted

    g = _banded_on_card(cuda_device)
    cfg = LouvainConfig(backend="pallas", refine=refine)
    clean = louvain(g, cfg)
    assert len(clean.cascade_stages) >= 2
    cfg_ck = cfg.replace(checkpoint_dir=str(tmp_path))
    with pytest.raises(Preempted):
        with faultinject.inject("preempt_stage"):
            louvain(g, cfg_ck)
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000001"]
    resumes = telemetry.get("louvain.ckpt_resume")
    res = louvain(g, cfg_ck)
    assert telemetry.get("louvain.ckpt_resume") == resumes + 1
    _assert_runs_equal(res, clean)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.cuda
@pytest.mark.parametrize("m,block", [(512, 512), (5000, 512), (3001, 256),
                                     (4096, 1024), (77, 16)])
def test_sorted_segment_sum_kernel_matches_plain(cuda_device, m, block):
    """Short runs, runs up to a block long, and one run of 2·block + 37
    keys (crossing two block edges where m allows); integer values, so the
    sums are exact in any order."""
    rng = np.random.default_rng(m)
    lengths = np.where(rng.random(m) < 0.1, rng.integers(1, block + 1, m),
                       rng.integers(1, 4, m))
    lengths[3] = 2 * block + 37
    keys = np.repeat(np.arange(m), lengths)[:m].astype(np.int32)
    vals = rng.integers(-8, 9, m).astype(np.float32)
    k_t, v_t = _card(keys, cuda_device), _card(vals, cuda_device)
    sums, starts = sorted_segment_sum(k_t, v_t, block=block, use_pallas=True)
    ref_sums, ref_starts = sorted_segment_sum_ref(k_t, v_t)
    torch.cuda.synchronize()
    assert torch.equal(starts, ref_starts) and torch.equal(sums, ref_sums)
    pad = (-m) % block
    kp = torch.cat([k_t, k_t.new_full((pad,), 2**31 - 1)])
    vp = torch.cat([v_t, v_t.new_zeros(pad)])
    assert torch.equal(block_segment_sums_kernel(kp, vp, block=block),
                       block_segment_sums_ref(kp, vp, block))


def _left_folds(keys, vals, block):
    """Per position, the float32 left fold of its run inside its block:
    the last element of ``np.cumsum(run, dtype=np.float32)``, which numpy
    adds in position order."""
    out = np.empty_like(vals)
    for b0 in range(0, keys.size, block):
        k = keys[b0:b0 + block]
        heads = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
        for s, e in zip(heads, np.r_[heads[1:], k.size]):
            out[b0 + s:b0 + e] = np.cumsum(vals[b0 + s:b0 + e],
                                           dtype=np.float32)[-1]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 16, 33, 100, 128, 256, 512, 1024])
def test_block_segment_sums_kernel_left_folds_float_runs(cuda_device, block):
    """The block pass on float32 values, bit for bit against the left fold
    of each run in position order from 0.0: runs of one, runs across
    32-position rows, hub runs over whole blocks, INT32_MAX padding, and
    values of both signs over six decades, at every block size the
    wrapper takes a shape of (not a multiple of 4 or of 32 included)."""
    rng = np.random.default_rng(block)
    m = block * max(8, 6000 // block)
    kind = rng.random(m)
    lengths = np.where(kind < 0.3, 1, np.where(
        kind < 0.95, rng.integers(2, 71, m), rng.integers(1, 3 * block + 1,
                                                         m)))
    lengths[3] = 2 * block + 37                    # whole blocks of one run
    keys = np.repeat(np.arange(m), lengths)[:m].astype(np.int32)
    keys[m - max(1, block // 3):] = 2**31 - 1       # the entry's padding
    vals = (rng.standard_normal(m) * 10.0 ** rng.uniform(-3, 3, m)).astype(
        np.float32)
    k_t, v_t = _card(keys, cuda_device), _card(vals, cuda_device)
    out = block_segment_sums_kernel(k_t, v_t, block=block).cpu().numpy()
    assert out.tobytes() == _left_folds(keys, vals, block).tobytes()


@pytest.mark.cuda
def test_block_segment_sums_kernel_on_unaligned_inputs(cuda_device):
    """Keys and values that start 4 bytes past a 16-byte boundary take
    the kernel's 4-byte staging: the same bits as aligned ones."""
    rng = np.random.default_rng(3)
    m, block = 512 * 40, 512
    keys = np.sort(rng.integers(0, 300, m)).astype(np.int32)
    vals = rng.standard_normal(m).astype(np.float32)
    k_t = _card(np.r_[np.int32(0), keys], cuda_device)[1:]
    v_t = _card(np.r_[np.float32(0), vals], cuda_device)[1:]
    assert k_t.data_ptr() % 16 and v_t.data_ptr() % 16
    out = block_segment_sums_kernel(k_t, v_t, block=block).cpu().numpy()
    assert out.tobytes() == _left_folds(keys, vals, block).tobytes()


@pytest.mark.cuda
def test_scored_tile_launch_counters_count_their_own_kernel(cuda_device):
    n = 512
    tiles, tabs = _tiles(40, 16, n, 9, "int", cuda_device)
    lab, cur, keys = _plp_tiles(tiles, tabs, n)
    cand, ccur, deg, volc, volcur, sizec, sizecur = _louvain_tiles(
        tiles, compose_louvain_tables(*tabs, n), n)
    inv = torch.tensor(1e-3, dtype=torch.float32, device=cuda_device)
    seg = _card(np.repeat(np.arange(40), 30).astype(np.int32), cuda_device)
    counters = (label_argmax_kernel, delta_q_kernel,
                block_segment_sums_kernel, local_move_plp_kernel)
    calls = (
        lambda: label_argmax_kernel(lab, tiles[2], cur, keys, 0,
                                    tie_eps=0.25, sentinel=n),
        lambda: delta_q_kernel(cand, tiles[2], ccur, deg, volc, volcur,
                               sizec, sizecur, inv, sentinel=n,
                               singleton_rule=True),
        lambda: sorted_segment_sum(seg, seg.float(), use_pallas=True),
        lambda: local_move_plp_kernel(*tiles, tabs[0], 0, tie_eps=0.25,
                                      sentinel=n))
    for i, call in enumerate(calls):
        before = [c.launches for c in counters]
        call()
        after = [c.launches for c in counters]
        assert [a - b for a, b in zip(after, before)] == [
            int(j == i) for j in range(len(counters))]
    before = [c.launches for c in counters]
    sorted_segment_sum(seg, seg.float(), use_pallas=False)
    label_argmax(lab, tiles[2], cur, keys, 0, tie_eps=0.25, sentinel=n)
    assert [c.launches for c in counters] == before
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_empty_inputs_launch_nothing(cuda_device):
    """Every wrapper given no rows returns empty outputs and counts no
    launch: its counter counts kernels that ran."""
    n = 64
    tiles, tabs = _tiles(8, 16, n, 3, "int", cuda_device)
    rows, nbr, w = (t[:0] for t in tiles)
    composed = compose_louvain_tables(*tabs, n)
    inv = torch.tensor(1e-3, dtype=torch.float32, device=cuda_device)
    win = TableWindows(win_blk=rows, slot=128, block_rows=8, n_slots=1)
    table = torch.full((4 * 16,), n, dtype=torch.int32, device=cuda_device)
    counters = (local_move_plp_kernel, local_move_louvain_kernel,
                local_move_plp_streamed_kernel,
                local_move_louvain_streamed_kernel, bin_rank_kernel,
                label_argmax_kernel, delta_q_kernel,
                block_segment_sums_kernel)
    calls = (
        lambda: local_move_plp_kernel(rows, nbr, w, tabs[0], 0,
                                      tie_eps=0.25, sentinel=n),
        lambda: local_move_louvain_kernel(rows, nbr, w, *composed, inv,
                                          sentinel=n, singleton_rule=True),
        lambda: local_move_plp_streamed_kernel(rows, nbr, w, tabs[0], 0,
                                               tie_eps=0.25, sentinel=n,
                                               windows=win),
        lambda: local_move_louvain_streamed_kernel(
            rows, nbr, w, *composed, inv, sentinel=n, singleton_rule=True,
            windows=win),
        lambda: (bin_rank_kernel(table, rows, rows, width=16, empty=n),),
        lambda: label_argmax_kernel(nbr, w, rows, rows, 0, tie_eps=0.25,
                                    sentinel=n),
        lambda: delta_q_kernel(nbr, w, rows, w[:, 0], w, w[:, 0], nbr, rows,
                               inv, sentinel=n, singleton_rule=True),
        lambda: (block_segment_sums_kernel(rows, w[:, 0]),))
    before = [c.launches for c in counters]
    for call in calls:
        assert all(o.shape[0] == 0 for o in call())
    assert [c.launches for c in counters] == before


@pytest.mark.cuda
def test_scored_tile_wrappers_reject_bad_inputs(cuda_device):
    n = 64
    tiles, tabs = _tiles(8, 16, n, 0, "int", cuda_device)
    lab, cur, keys = _plp_tiles(tiles, tabs, n)
    launches = label_argmax_kernel.launches
    with pytest.raises(TypeError):
        label_argmax_kernel(lab, tiles[2].double(), cur, keys, 0,
                            tie_eps=0.25, sentinel=n)
    with pytest.raises(ValueError, match="contiguous"):
        label_argmax_kernel(lab.t(), tiles[2].t(), cur.new_zeros(16),
                            keys.new_zeros(16), 0, tie_eps=0.25, sentinel=n)
    with pytest.raises(ValueError, match="4096"):
        wide = torch.full((2, 4097), n, dtype=torch.int32, device=cuda_device)
        label_argmax_kernel(wide, wide.float(), cur[:2], keys[:2], 0,
                            tie_eps=0.25, sentinel=n)
    assert label_argmax_kernel.launches == launches

    cand, ccur, deg, volc, volcur, sizec, sizecur = _louvain_tiles(
        tiles, compose_louvain_tables(*tabs, n), n)
    inv = torch.tensor(1e-3, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        delta_q_kernel(cand, tiles[2], ccur[:4], deg, volc, volcur, sizec,
                       sizecur, inv, sentinel=n, singleton_rule=True)
    with pytest.raises(ValueError, match="2048"):
        wide = torch.full((2, 2049), n, dtype=torch.int32, device=cuda_device)
        delta_q_kernel(wide, wide.float(), ccur[:2], deg[:2], wide.float(),
                       volcur[:2], wide, sizecur[:2], inv, sentinel=n,
                       singleton_rule=True)
    seg = torch.zeros(1000, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="divide"):
        block_segment_sums_kernel(seg, seg.float(), block=512)
    with pytest.raises(ValueError, match="1024"):
        block_segment_sums_kernel(seg, seg.float(), block=2000)


# ------------------------------------------------------------ flash attention

# (b, hq, hk, sq, sk, d, causal)
FLASH_SHAPES = [
    (2, 4, 2, 64, 64, 16, True), (1, 8, 8, 128, 128, 32, True),
    (2, 4, 1, 64, 128, 16, False), (1, 2, 2, 256, 256, 64, True),
    (1, 4, 2, 100, 1000, 128, True), (1, 4, 1, 1000, 100, 128, False),
    (2, 4, 4, 100, 100, 32, True), (1, 8, 2, 300, 77, 64, True),
    (1, 2, 1, 77, 300, 16, False), (2, 16, 16, 1024, 1024, 128, True)]


def _qkv(b, hq, hk, sq, sk, d, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [_card(rng.standard_normal(s).astype(np.float32), dev).to(dtype)
            for s in ((b, hq, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, shape, dtype):
    b, hq, hk, sq, sk, d, causal = shape
    q, k, v = _qkv(*shape[:6], dtype, cuda_device, seed=sq * 7 + sk)
    launches = flash_attention_fwd_kernel.launches
    wgmma = flash_attention_fwd_kernel.wgmma_launches
    out = flash_attention_fwd_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd_kernel.launches == launches + 1
    # bf16 goes to the wgmma kernel, float32 to the split-TF32 one
    assert flash_attention_fwd_kernel.wgmma_launches == \
        wgmma + (dtype == torch.bfloat16)
    _assert_attention_close(out, _ref(q, k, v, causal), dtype)


def _ref(q, k, v, causal):
    """``attention_ref`` in full float32: with ``allow_tf32`` set, a
    float32 matmul on the card would itself run in TF32."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return attention_ref(q, k, v, causal=causal)


def _assert_attention_close(out, ref, dtype):
    assert out.dtype == dtype and out.shape == ref.shape
    a, r = out.float(), ref.float()
    if dtype == torch.float32:
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)
    else:
        # both compute in float32 and round to bf16 once: at most one bf16
        # ulp of the larger value apart (frexp: |x| in [2^(e-1), 2^e))
        e = torch.frexp(torch.maximum(a.abs(), r.abs())).exponent
        bound = torch.ldexp(torch.ones_like(a), e - 8) + 1e-6
        assert bool(((a - r).abs() <= bound).all()), \
            float((a - r).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 16, 1024, 1024, 128, True),
                                   (1, 16, 8, 1000, 1300, 128, True)])
def test_wgmma_flash_kernel_at_the_model_head_dim(cuda_device, shape):
    """The wgmma kernel at qwen3's head dim and 16 query heads: a full
    1024-token square, and a ragged GQA case (8 KV heads, Sq != Sk, neither
    a multiple of the 128-row query tile or the 64-key tile)."""
    q, k, v = _qkv(*shape[:6], torch.bfloat16, cuda_device, seed=shape[3])
    wgmma = flash_attention_fwd_kernel.wgmma_launches
    out = flash_attention_fwd_kernel(q, k, v, causal=shape[6])
    torch.cuda.synchronize()
    assert flash_attention_fwd_kernel.wgmma_launches == wgmma + 1
    _assert_attention_close(out, _ref(q, k, v, shape[6]), torch.bfloat16)


def _float32_launch(q, k, v, causal):
    """The float32 kernel's output; exactly one launch, none of wgmma."""
    launches = flash_attention_fwd_kernel.launches
    wgmma = flash_attention_fwd_kernel.wgmma_launches
    out = flash_attention_fwd_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd_kernel.launches == launches + 1
    assert flash_attention_fwd_kernel.wgmma_launches == wgmma
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,q_scale", [
    ((2, 16, 16, 1024, 1024, 128, True), 1.0),
    ((1, 16, 8, 1000, 1300, 128, True), 1.0),
    ((1, 16, 8, 512, 4096, 128, False), 1.0),
    ((1, 4, 2, 4096, 4096, 128, True), 1.0),
    ((1, 8, 4, 512, 512, 128, True), 3.0)])
def test_float32_flash_kernel_at_the_model_head_dim(cuda_device, shape,
                                                    q_scale):
    """The split-TF32 kernel at qwen3's head dim: the wgmma test's shapes,
    then up to 4096 keys a query (where truncated accumulation on the
    tensor cores would show), and scores up to |s| of about 16 (q times
    3); tests/test_torch_flash_attention.py runs the same inputs through
    the kernel's arithmetic on the CPU (tf32_recipe)."""
    q, k, v = _qkv(*shape[:6], torch.float32, cuda_device,
                   seed=shape[3] * 7 + shape[4])
    q = q * q_scale
    out = _float32_launch(q, k, v, shape[6])
    _assert_attention_close(out, _ref(q, k, v, shape[6]), torch.float32)


@pytest.mark.cuda
def test_float32_flash_kernel_at_scores_near_30(cuda_device):
    """q times 6 (|s| near 30): float32 no longer resolves 1e-5 there
    (attention_ref lands past it from the float64 truth), so the kernel is
    held within that tolerance of the truth beyond attention_ref's own
    largest distance from it, as tf32_recipe is on the CPU."""
    shape = (1, 8, 4, 512, 512, 128, True)
    q, k, v = _qkv(*shape[:6], torch.float32, cuda_device,
                   seed=shape[3] * 7 + shape[4])
    q = q * 6.0
    out = _float32_launch(q, k, v, True)
    g = q.shape[1] // k.shape[1]
    s = (q.double() @ k.double().repeat_interleave(g, 1).transpose(-1, -2)
         / 128 ** 0.5)
    mask = torch.ones(512, 512, dtype=torch.bool,
                      device=cuda_device).tril()
    truth = torch.softmax(s.masked_fill(~mask, -1e30), -1) \
        @ v.double().repeat_interleave(g, 1)
    ref_err = (_ref(q, k, v, True).double() - truth).abs()
    tol = 1e-5 + 1e-5 * truth.abs()
    err = (out.double() - truth).abs()
    assert bool((err <= tol + ref_err.max()).all()), \
        (float((err - tol).max()), float(ref_err.max()))


@pytest.mark.cuda
def test_float32_flash_kernel_on_unaligned_kv(cuda_device):
    """k and v that start 4 bytes past a 16-byte boundary take the
    kernel's 4-byte copies; the result holds the same contract."""
    shape = (1, 4, 2, 300, 333, 64, True)
    q, k, v = _qkv(*shape[:6], torch.float32, cuda_device, seed=5)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=cuda_device)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y
    k, v = shifted(k), shifted(v)
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    out = _float32_launch(q, k, v, True)
    _assert_attention_close(out, _ref(q, k, v, True), torch.float32)


# nemotron-4-340b's head dim 192 and its REDUCED config's 24, causal and
# not, GQA groups 1, 2 and 6, at the new families' ragged lengths: whisper's
# 448-token decoder and 1 500 frames, the VLM's 1 600 image tokens
HEAD_DIM_SHAPES = [
    (1, 6, 1, 448, 448, 192, True), (1, 12, 2, 300, 1600, 192, False),
    (2, 4, 4, 130, 1500, 192, False), (1, 6, 3, 1500, 1500, 192, True),
    (1, 6, 1, 448, 448, 24, True), (2, 4, 2, 300, 1600, 24, False),
    (1, 4, 4, 1500, 1500, 24, False), (1, 12, 2, 77, 300, 24, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HEAD_DIM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_head_dims_24_and_192(cuda_device, shape, dtype):
    """Both kernels at the head dims nemotron brings, each launch its own
    kernel's, under the contracts of the other head dims."""
    b, hq, hk, sq, sk, d, causal = shape
    q, k, v = _qkv(*shape[:6], dtype, cuda_device, seed=sq * 7 + sk)
    launches = flash_attention_fwd_kernel.launches
    wgmma = flash_attention_fwd_kernel.wgmma_launches
    out = flash_attention_fwd_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd_kernel.launches == launches + 1
    assert flash_attention_fwd_kernel.wgmma_launches == \
        wgmma + (dtype == torch.bfloat16)
    _assert_attention_close(out, _ref(q, k, v, causal), dtype)


@pytest.mark.cuda
def test_flash_attention_wrapper_rejects_bad_inputs(cuda_device):
    q, k, v = _qkv(1, 4, 2, 64, 64, 16, torch.float32, cuda_device, seed=1)
    launches = flash_attention_fwd_kernel.launches
    with pytest.raises(ValueError, match="head dim 48"):
        q48 = torch.zeros(1, 4, 64, 48, device=cuda_device)
        flash_attention_fwd_kernel(q48, q48[:, :2], q48[:, :2])
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd_kernel(q, q[:, :3], q[:, :3])
    with pytest.raises(TypeError):
        flash_attention_fwd_kernel(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        flash_attention_fwd_kernel(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd_kernel(q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), k, v)
    assert flash_attention_fwd_kernel.launches == launches


def _egonets_on_card(dev, count, seed):
    """``chip_smoke.py``'s ego-net stand-ins: SBM graphs of 25, 35 or 45
    vertices, 3 to 5 blocks, p_in 0.35, p_out 0.03, per-graph seed
    ``seed + 7919·i``."""
    from repro_torch.graph.builders import from_numpy_edges
    from repro_torch.graph.generators import sbm

    out = []
    for i in range(count):
        n = (25, 35, 45)[i % 3]
        u, v, _w, _t = sbm(n, 3 + i % 3, p_in=0.35, p_out=0.03,
                           seed=seed + 7919 * i)
        out.append(from_numpy_edges(u, v, n=n, device=dev))
    return out


BATCH_FIELDS = ("n_communities", "levels", "modularity",
                "modularity_history", "sweeps_per_level", "n_comm_per_level",
                "delta_n_per_level")


@pytest.mark.cuda
def test_batch_on_the_card_equals_single_graph_runs(cuda_device):
    """``louvain_batch`` / ``plp_batch`` on ``pallas`` launch the resident
    ``local_move`` kernels on the lanes' traced tiles (never a streamed
    one) and ``bin_rank`` once per binned coarsening, and every lane
    equals the single-graph ``pallas`` run and the ``ell`` batch."""
    from repro_torch.core.batch import louvain_batch, plp_batch
    from repro_torch.core.louvain import LouvainConfig, louvain
    from repro_torch.core.plp import PLPConfig, plp

    gs = _egonets_on_card(cuda_device, 20, 3)
    kernels = (local_move_louvain_kernel, local_move_plp_kernel,
               bin_rank_kernel, local_move_louvain_streamed_kernel,
               local_move_plp_streamed_kernel)
    before = [k.launches for k in kernels]
    lv = louvain_batch(gs, LouvainConfig(backend="pallas"))
    pl = plp_batch(gs, PLPConfig(backend="pallas"))
    lm, lp, br, s1, s2 = (k.launches - b for k, b in zip(kernels, before))
    assert lm > 0 and lp > 0 and s1 == s2 == 0
    assert br == sum(r.aggregation_per_level.count("binned") for r in lv)
    lv_ell = louvain_batch(gs, LouvainConfig(backend="ell"))
    pl_ell = plp_batch(gs, PLPConfig(backend="ell"))
    for i, g in enumerate(gs):
        for ref in (louvain(g, LouvainConfig(backend="pallas")), lv_ell[i]):
            _assert_runs_equal(lv[i], ref, BATCH_FIELDS)
        for ref in (plp(g, PLPConfig(backend="pallas")), pl_ell[i]):
            np.testing.assert_array_equal(pl[i].labels, ref.labels)
            for f in ("iterations", "delta_n_history", "active_history"):
                assert getattr(pl[i], f) == getattr(ref, f), f


@pytest.mark.cuda
def test_service_clean_flush_on_the_card(cuda_device):
    """The service on the card, ``pallas`` configs, the smoke's traffic
    (two signatures): every request answered ``ok``, equal to its
    single-graph run, and the sequential ladder never taken."""
    from repro_torch.core.louvain import LouvainConfig, louvain
    from repro_torch.core.plp import PLPConfig, plp
    from repro_torch.graph.builders import from_numpy_edges
    from repro_torch.launch.community_serve import (CommunityServeEngine,
                                                    smoke_requests)
    from repro_torch.utils import telemetry

    lcfg, pcfg = LouvainConfig(backend="pallas"), PLPConfig(backend="pallas")
    eng = CommunityServeEngine(lcfg, pcfg, max_batch=8, device=cuda_device)
    assert eng.device.type == "cuda"
    counters = ("serve.batch_fallback_sequential",
                "serve.breaker_routed_sequential")
    before = [telemetry.get(c) for c in counters]
    reqs = smoke_requests(12, 60000.0)
    for r in reqs:
        assert eng.submit(r) is None
    resp = eng.flush()
    assert [telemetry.get(c) for c in counters] == before
    for req, r in zip(reqs, resp):
        assert r.ok and r.request_id == req.request_id
        g = from_numpy_edges(req.u, req.v, n=req.n, device=cuda_device)
        ref = louvain(g, lcfg) if req.algo == "louvain" else plp(g, pcfg)
        np.testing.assert_array_equal(r.labels, ref.labels)
        if req.algo == "louvain":
            _assert_runs_equal(r.result, ref, BATCH_FIELDS)


def _routes(monkeypatch):
    """The port's router records its own expert ids, call by call, until
    ``force()``; from then on call i takes the i-th recorded ids (a
    prefill calls its MoE layers in order).  Returns (recorded, the
    forced calls' (own ids, ids taken, probabilities), force)."""
    real = moe_lib.route
    calls, seen, forcing = [], [], []

    def forced(xg, w_router, top_k):
        logits, probs, own, own_p = real(xg, w_router, top_k)
        if not forcing:
            calls.append(own.cpu())
            return logits, probs, own, own_p
        ids = calls[len(seen)].to(own.device)
        seen.append((own.cpu(), ids.cpu(), probs.cpu()))
        top_p = torch.gather(probs, -1, ids)
        return logits, probs, ids, top_p / top_p.sum(-1, keepdim=True)

    monkeypatch.setattr(moe_lib, "route", forced)
    return calls, seen, lambda: forcing.append(True)


def _decided(probs, k, gap):
    top = torch.sort(probs, -1, descending=True).values[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).min(-1).values > gap


def _side_inputs(c, b, seed, dev):
    """The VLM's image features or whisper's frames for a batch of ``b``,
    bf16 (the input specs' dtype), on ``dev``; empty for the others."""
    key = {"vlm": "img_embeds", "audio": "enc_embeds"}.get(c.family)
    if key is None:
        return {}
    n = c.n_img_tokens if c.family == "vlm" else c.n_frames
    e = np.random.default_rng(seed).standard_normal(
        (b, n, c.d_model)).astype(np.float32)
    return {key: _card(e, dev).to(torch.bfloat16)}


def _live_gates(c, params):
    """The VLM's cross-attention gates at 0.5 (at their init of 0 the
    cross blocks add nothing)."""
    if c.family != "vlm":
        return params
    cross = {k: torch.full_like(v, 0.5) if k in ("x_attn_gate", "x_mlp_gate")
             else v for k, v in params["cross"].items()}
    return dict(params, cross=cross)


def _attention_calls(c):
    """Full-sequence attention calls of one prefill: every self layer,
    plus the VLM's cross blocks, plus whisper's encoder layers and its
    decoder's cross blocks; Zamba2's shared-block calls, none in RWKV6."""
    if c.family == "ssm":
        return 0
    if c.family == "hybrid":
        return ssm_lib.n_shared_invocations(c)
    if c.family == "vlm":
        return c.n_layers + c.n_layers // c.cross_attn_every
    if c.family == "audio":
        return c.n_enc_layers + 2 * c.n_layers
    return c.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("bs", [(2, 8), (1, 2048)])
def test_prefill_on_the_card_matches_the_cpu(cuda_device, arch, bs,
                                             monkeypatch):
    c = configs.get(arch, reduced=True)
    m = model_api.build(c)
    toks = np.random.default_rng(bs[1]).integers(0, c.vocab_size, bs)
    cpu_params = _live_gates(c, init_params(m.decls, seed=0, device="cpu"))
    moe = c.family == "moe"
    if moe:       # the card's layers routed as the CPU's run routes them
        ids, seen, force = _routes(monkeypatch)
    side = _side_inputs(c, bs[0], bs[1] + 1, "cpu")
    cpu = m.prefill_fn(cpu_params, {"tokens": torch.from_numpy(toks), **side})
    if moe:
        force()
    params = _live_gates(c, init_params(m.decls, seed=0, device=cuda_device))
    side = {k: v.to(cuda_device) for k, v in side.items()}
    launches = flash_attention_fwd_kernel.launches
    wgmma = flash_attention_fwd_kernel.wgmma_launches
    card = m.prefill_fn(params, {"tokens": _card(toks, cuda_device), **side})
    torch.cuda.synchronize()
    # every attention call through the wgmma kernel, none through the
    # float32 one
    calls = _attention_calls(c)
    assert flash_attention_fwd_kernel.wgmma_launches == wgmma + calls
    assert flash_attention_fwd_kernel.launches == launches + calls
    if moe:
        assert len(seen) == len(ids)
        for own, taken, probs in seen:
            d = _decided(probs, c.top_k, 2.0 ** -6)
            assert torch.equal(own[d], taken[d])
    a, b = cpu.float().numpy(), card.float().cpu().numpy()
    assert np.isfinite(b).all()
    share = np.abs(a - b).max(axis=-1) / np.abs(a).max(axis=-1)
    rel = {"moe": 2.0 ** -4, "hybrid": 2.0 ** -2,
           "ssm": 2.0 ** -2}.get(c.family, 2.0 ** -5)
    assert np.all(share <= rel)
    if c.family in ("ssm", "hybrid"):
        assert np.quantile(share, 0.99) <= 2.0 ** -4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["nemotron-4-340b", "llama-3.2-vision-11b",
                                  "whisper-large-v3", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
def test_decode_on_the_card_matches_the_cpu(cuda_device, arch):
    """Nemotron, the VLM, whisper, RWKV6 and Zamba2 decode on the card as
    on the CPU: 8 steps over (2, 8) tokens from the same weights and
    features,
    each step's logits within 2^-5 of the row's largest magnitude (the
    prefill's bound; nemotron's int8 cache rounds the same bf16 K/V on
    both devices), the cross-attention K/V within 2^-6 of their largest
    magnitude plus 2^-6 relative (tests/test_torch_models.py's
    CACHE_REL)."""
    c = configs.get(arch, reduced=True)
    m = model_api.build(c)
    toks = np.random.default_rng(11).integers(0, c.vocab_size, (2, 8))
    runs = []
    for dev in ("cpu", cuda_device):
        params = _live_gates(c, init_params(m.decls, seed=0, device=dev))
        st = m.init_decode_state(params, 2, 16,
                                 **_side_inputs(c, 2, 12, dev))
        steps = []
        for t in range(8):
            logits, st = m.decode_fn(params, _card(toks[:, t], dev), st)
            steps.append(logits.float().cpu().numpy())
        runs.append((steps, st))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert np.isfinite(b).all()
        assert np.all(np.abs(a - b).max(-1) <= 2.0 ** -5 * np.abs(a).max(-1))
    host, card = runs[0][1], runs[1][1]
    if c.family in ("vlm", "audio"):
        for a, b in ((host.cross_k, card.cross_k),
                     (host.cross_v, card.cross_v)):
            a, b = a.float().numpy(), b.float().cpu().numpy()
            assert np.all(np.abs(a - b) <= 2.0 ** -6 * np.abs(a).max()
                          + 2.0 ** -6 * np.abs(a))


@pytest.mark.cuda
def test_chunked_scans_at_chunk_128_on_the_card(cuda_device):
    """``_wkv_chunked`` and ``_ssd_chunked`` at the published chunk of 128
    over 256 tokens, log-decay -1 a step (RWKV6 at init) and a·dt = -1:
    finite on the card and within 1e-4 of the output's largest magnitude
    of the same scan on the CPU (float32 products, TF32 off), states
    too."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(90)
    b, s, h, n, p = 2, 256, 4, 64, 32

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    wkv = [f32(b, s, h, n), f32(b, s, h, n), f32(b, s, h, n),
           -np.ones((b, s, h, n), np.float32), f32(h, n, scale=0.3),
           f32(b, h, n, n, scale=0.3)]
    ssd = [f32(b, s, h, p), np.ones((b, s, h), np.float32),
           -np.ones((h,), np.float32), f32(b, s, n), f32(b, s, n),
           f32(b, h, n, p, scale=0.3)]
    for fn, ins in ((rwkv_lib._wkv_chunked, wkv), (ssm_lib._ssd_chunked, ssd)):
        host = fn(*(torch.from_numpy(x) for x in ins), chunk=128)
        card = fn(*(_card(x, cuda_device) for x in ins), chunk=128)
        for a, c in zip(host, card):
            a, c = a.numpy(), c.cpu().numpy()
            assert np.isfinite(c).all()
            assert np.abs(a - c).max() <= 1e-4 * np.abs(a).max()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (tokens, d_model, experts, top_k, expert d_ff, capacity factor)
    (256, 64, 8, 2, 32, 1.25),
    (512, 64, 8, 2, 32, 0.5),
    (1024, 2048, 128, 8, 768, 1.25),     # qwen3-moe-30b-a3b's widths
])
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, shape,
                                               monkeypatch):
    t, d, e, k, f, cf = shape
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((1, t, d)).astype(
        np.float32)).to(torch.bfloat16)
    ws = [torch.from_numpy((rng.standard_normal(sh) / np.sqrt(sh[-2]))
                           .astype(np.float32))
          for sh in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    ws = [w.to(torch.bfloat16) for w in ws]
    rec = {}
    real_route, real_disp = moe_lib.route, moe_lib.dispatch

    def route(*a):
        out = real_route(*a)
        rec["probs"], rec["ids"] = out[1], out[2]
        return out

    def disp(*a):
        out = real_disp(*a)
        rec["slot"], rec["keep"] = out[1], out[2]
        return out

    monkeypatch.setattr(moe_lib, "route", route)
    monkeypatch.setattr(moe_lib, "dispatch", disp)

    def run(dev):
        out = moe_lib.moe_layer(x.to(dev), *[w.to(dev) for w in ws],
                                top_k=k, capacity_factor=cf)
        return {"y": out.y.cpu(), "aux": out.aux_loss.cpu(),
                **{n: v.cpu() for n, v in rec.items()}}

    host = run("cpu")
    card = run(cuda_device)
    again = run(cuda_device)
    for n in card:
        assert torch.equal(card[n], again[n]), n
    if cf < 1:
        assert not host["keep"].all()
    same = (card["ids"] == host["ids"]).all(-1)
    assert same[_decided(host["probs"], k, 1e-5)].all()
    if same.all():
        assert torch.equal(card["slot"], host["slot"])
        assert torch.equal(card["keep"], host["keep"])
    alike = same[0] & (card["keep"] == host["keep"]).reshape(t, k).all(-1)
    a, b = host["y"].float()[0][alike], card["y"].float()[0][alike]
    assert ((a - b).abs().amax(-1) <= 2.0 ** -5 * a.abs().amax(-1)).all()
    assert abs(float(card["aux"]) - float(host["aux"])) <= \
        1e-5 * abs(float(host["aux"]))


@pytest.mark.cuda
def test_int8_cache_on_the_card_matches_the_cpu(cuda_device):
    rng = np.random.default_rng(4)
    B, H, S, hd = 4, 8, 64, 128
    k_new, v_new = (torch.from_numpy((rng.standard_normal((B, H, 1, hd))
                                      * 3).astype(np.float32))
                    .to(torch.bfloat16) for _ in range(2))
    pos = torch.from_numpy(np.array([0, 5, 63, 17], np.int32))
    outs = []
    for dev in ("cpu", cuda_device):
        cache = [torch.zeros((B, H, S, hd), dtype=torch.int8, device=dev)
                 for _ in range(2)] + [
            torch.zeros((B, H, S, 1), device=dev) for _ in range(2)]
        cache = transformer._cache_write(*cache, k_new.to(dev),
                                         v_new.to(dev), pos.to(dev))
        outs.append([t.cpu() for t in cache + transformer._cache_read(*cache)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# training on the card: the loss within one bf16 ulp, every gradient leaf
# within eight bf16 ulps of its largest magnitude (tests/test_torch_train.py's
# LOSS_REL and GRAD_REL: the kernel forward keeps float32 probabilities, the
# CPU mirror rounds them to bf16, and the backward carries that bf16
# difference into every gradient at the leaf's scale)
TRAIN_LOSS_REL = 2.0 ** -8
TRAIN_GRAD_REL = 2.0 ** -5
# the optimizer on the same gradients: float32 in one association on both
# devices (tests/test_torch_train.py's OPT_RTOL)
TRAIN_OPT_RTOL = 1e-6
# one ulp of the working type, relative to the gradient's largest magnitude
GRAD_ULP = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -23}
# the mirror's gradient against autograd of the float32 ``attention_ref``,
# relative to the gradient's largest magnitude.  bf16: the mirror rounds
# its probabilities, the products dO.V^T and dS.K / dS^T.Q / P^T.dO and
# the gradients themselves to bf16, four roundings of 2^-9 in a chain,
# and dq / dk are sums of terms of both signs over up to S keys, whose
# cancellation lifts the error against the largest magnitude (two bf16
# ulps at these shapes): eight bf16 ulps, 2^-5, the TRAIN_GRAD_REL the
# model's gradients are held to.  float32: the chunked online softmax and
# the dense one sum up to S = 1024 products in other orders, S float32
# ulps, 2^-14.
GRAD_REF_REL = {torch.bfloat16: 2.0 ** -5, torch.float32: 2.0 ** -14}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 16, 16, 1024, 128, 256),
                                   (1, 4, 2, 100, 64, 1024)])
def test_flash_attention_fn_gradients(cuda_device, shape, dtype):
    """``FlashAttentionFn`` (the kernel forward, the plain chunked
    mirror's gradient), causal, held three ways on the same card tensors.

    * Its output: the kernel's, against the float32 ``attention_ref``
      within the kernel's contract (``_assert_attention_close``: one bf16
      ulp of the larger value plus 1e-6; float32 1e-5).
    * Its dq, dk, dv against autograd of the float32 ``attention_ref`` on
      q, k, v cast up, each within ``GRAD_REF_REL`` of that gradient's
      largest magnitude: an independent reference.
    * Its dq, dk, dv against the mirror's own autograd within ``GRAD_ULP``
      of the largest magnitude: the backward recomputes the mirror from
      the saved q, k, v, the same computation, so they should agree to
      the bit (one ulp of the working type is allowed).

    The forward launches its kernel once; the backward launches none.
    Shapes (B, Hq, Hkv, S, D, chunk): the model's heads at a chunked
    length, and a GQA group of 2 at a ragged, dense one."""
    from repro_torch.models.attention import (FlashAttentionFn,
                                              _flash_attention_chunked)
    b, hq, hk, s, d, chunk = shape
    rng = np.random.default_rng(s)
    q, k, v, dout = (_card(rng.standard_normal(sh).astype(np.float32),
                           cuda_device).to(dtype)
                     for sh in ((b, hq, s, d), (b, hk, s, d), (b, hk, s, d),
                                (b, hq, s, d)))
    grads, fwd, outs = [], [], []
    for fn in (lambda *a: FlashAttentionFn.apply(*a, True, chunk),
               lambda *a: _flash_attention_chunked(*a, True, chunk)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        launches = flash_attention_fwd_kernel.launches
        out = fn(*xs)
        fwd.append(flash_attention_fwd_kernel.launches - launches)
        out.backward(dout)
        torch.cuda.synchronize()
        assert flash_attention_fwd_kernel.launches == launches + fwd[-1]
        grads.append([x.grad.float() for x in xs])
        outs.append(out.detach())
    assert fwd == [1, 0]
    _assert_attention_close(outs[0], _ref(q, k, v, True), dtype)
    xs = [x.float().requires_grad_() for x in (q, k, v)]
    _ref(*xs, True).backward(dout.float())
    for name, a, g, r in zip("qkv", *grads, (x.grad for x in xs)):
        assert torch.isfinite(a).all(), name
        err = float((a - g).abs().max())
        assert err <= GRAD_ULP[dtype] * float(g.abs().max()), (name, err)
        err = float((a - r).abs().max())
        assert err <= GRAD_REF_REL[dtype] * float(r.abs().max()), (name, err)


@pytest.mark.cuda
def test_flash_attention_fn_launches_once_a_forward(cuda_device):
    from repro_torch.models.attention import FlashAttentionFn
    q = torch.randn(1, 2, 64, 16, device=cuda_device,
                    dtype=torch.bfloat16, requires_grad=True)
    launches = flash_attention_fwd_kernel.wgmma_launches
    FlashAttentionFn.apply(q, q, q, True, 1024).sum().backward()
    torch.cuda.synchronize()
    assert flash_attention_fwd_kernel.wgmma_launches == launches + 1
    assert q.grad is not None and torch.isfinite(q.grad).all()


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """The REDUCED qwen3-1.7b with ``grad_accum = 2``, on the card and on
    the CPU.

    * ``loss_fn``'s gradients on the card (every layer's attention
      through the wgmma kernel, forward and remat recompute) against the
      CPU's (the chunked mirror): each leaf within TRAIN_GRAD_REL of its
      largest magnitude, the loss within TRAIN_LOSS_REL.
    * One ``make_train_step`` on each.  The gradients the card's step
      hands ``apply_opt`` (the mean of its two microbatches') against the
      CPU's full-batch ``loss_fn`` gradients within TRAIN_GRAD_REL, leaf
      by leaf in tree order.  The parameters, optimizer state and
      grad_norm the card's step returns against the CPU's ``apply_opt``
      run on those same gradients within TRAIN_OPT_RTOL: a step that
      skipped, reversed or misrouted its update lands a learning rate or
      more away.
    * End to end against the CPU's step: loss within TRAIN_LOSS_REL,
      grad norm within TRAIN_GRAD_REL, and every parameter within 2·lr
      (AdamW's first step moves a parameter by lr times nearly its
      gradient's sign, which may flip where a gradient is near 0) plus
      1e-6 of its magnitude."""
    from repro_torch.launch.train_step import make_train_step
    from repro_torch.models.arch_config import ShapeCell
    from repro_torch.train import optim
    from repro_torch.train.data import make_batch
    from repro_torch.utils.tree import tree_leaves, tree_map

    c = configs.get("qwen3-1.7b", reduced=True).replace(grad_accum=2)
    m = model_api.build(c)
    cell = ShapeCell("t", "train", 64, 4)
    batch = make_batch(c, cell, 0)
    cfg = optim.OptimConfig(name=c.optimizer)
    seen = {}
    real = optim.apply_opt

    def capture(name, opt_cfg, grads, state, params, specs=None):
        seen["grads"] = tree_map(lambda t: t.detach().cpu(), grads)
        return real(name, opt_cfg, grads, state, params, specs)

    monkeypatch.setattr(optim, "apply_opt", capture)
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        b = {k: _card(v, dev) for k, v in batch.items()}
        params = init_params(m.decls, seed=0, device=dev)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        launches = flash_attention_fwd_kernel.wgmma_launches
        loss, _ = m.loss_fn(params, b)
        loss.backward()
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert flash_attention_fwd_kernel.wgmma_launches == \
                launches + 2 * c.n_layers
        grads = [t.grad.cpu() for t in tree_leaves(params)]
        step = make_train_step(m, cfg, cell)[0]
        params, state, met = step(params, optim.init_opt(c.optimizer,
                                                         params, cfg), b)
        runs[dev.type] = (float(loss.detach()), grads,
                          {k: float(v) for k, v in met.items()},
                          [t.detach().cpu() for t in tree_leaves(params)],
                          seen.pop("grads"),
                          [t.cpu() for t in tree_leaves(state)])
    (l_gpu, g_gpu, m_gpu, p_gpu, step_g_gpu, s_gpu), \
        (l_cpu, g_cpu, m_cpu, p_cpu, _, _) = runs["cuda"], runs["cpu"]
    assert abs(l_gpu - l_cpu) <= TRAIN_LOSS_REL * abs(l_cpu)
    for a, g, sg in zip(g_cpu, g_gpu, tree_leaves(step_g_gpu)):
        for x in (g, sg):
            assert torch.isfinite(x).all()
            assert float((a - x).abs().max()) <= \
                TRAIN_GRAD_REL * float(a.abs().max())

    # the CPU's optimizer on the card step's own gradients
    params = init_params(m.decls, seed=0, device="cpu")
    ref_p, ref_s, ref_stats = real(c.optimizer, cfg, step_g_gpu,
                                   optim.init_opt(c.optimizer, params, cfg),
                                   params)
    for a, g in list(zip(tree_leaves(ref_p), p_gpu)) + list(
            zip(tree_leaves(ref_s), s_gpu)):
        a = a.detach().float()
        g = g.float()
        assert a.shape == g.shape
        torch.testing.assert_close(
            g, a, rtol=TRAIN_OPT_RTOL,
            atol=TRAIN_OPT_RTOL * float(a.abs().max()))
    for key in ("grad_norm", "lr"):
        assert m_gpu[key] == pytest.approx(float(ref_stats[key]),
                                           rel=TRAIN_OPT_RTOL)

    for key in ("loss", "ce"):
        assert abs(m_gpu[key] - m_cpu[key]) <= TRAIN_LOSS_REL * abs(m_cpu[key])
    assert abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) <= \
        TRAIN_GRAD_REL * m_cpu["grad_norm"]
    lr = m_cpu["lr"]
    assert m_gpu["lr"] == pytest.approx(lr, rel=TRAIN_OPT_RTOL)
    for a, g in zip(p_cpu, p_gpu):
        assert bool(((a - g).abs() <= 2 * lr + 1e-6 * a.abs()).all())


def _par_step(mesh_shape, dev, arch="qwen3-1.7b"):
    """One ``make_train_step`` of the REDUCED ``arch`` (``grad_accum``
    2, a (4 x 64) batch) on ``dev``, on ``mesh_shape``'s mesh or none:
    (metrics, the optimizer's gradients and the parameters after, whole
    and on the host, the wgmma launches of the step)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train_step import make_train_step
    from repro_torch.models.arch_config import ShapeCell
    from repro_torch.train import optim
    from repro_torch.train.data import make_batch
    from repro_torch.utils.tree import tree_leaves, tree_map

    c = configs.get(arch, reduced=True).replace(grad_accum=2)
    m = model_api.build(c)
    cell = ShapeCell("t", "train", 64, 4)
    batch = {k: _card(v, dev) for k, v in make_batch(c, cell, 0).items()}
    cfg = optim.OptimConfig(name=c.optimizer)
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape)
    step, specs, _, _ = make_train_step(m, cfg, cell, mesh)
    params = init_params(m.decls, seed=0, device=dev)
    opt = optim.init_opt(c.optimizer, params, cfg)
    if mesh is not None:
        block = lambda t, s: shd.local_shard(t, s, mesh).contiguous().clone()
        params = tree_map(block, params, specs[0])
        opt = tree_map(block, opt, specs[1])
    seen, real = {}, optim.apply_opt

    def capture(name, opt_cfg, grads, state, params, specs=None):
        seen["grads"] = tree_map(torch.clone, grads)
        return real(name, opt_cfg, grads, state, params, specs)

    optim.apply_opt = capture
    launches = flash_attention_fwd_kernel.wgmma_launches
    try:
        params, _, met = step(params, opt, batch)
    finally:
        optim.apply_opt = real
    torch.cuda.synchronize()
    launches = flash_attention_fwd_kernel.wgmma_launches - launches
    grads = seen["grads"]
    if mesh is not None:
        with shd.use_mesh(mesh):
            whole = lambda t, s: shd.full_leaf(t, s, mesh)
            grads = tree_map(whole, grads, specs[0])
            params = tree_map(whole, params, specs[0])
    host = lambda t: [x.detach().float().cpu() for x in tree_leaves(t)]
    return ({k: float(v) for k, v in met.items()}, host(grads),
            host(params), launches)


def _par_card_rank(rank, world, shape):
    """One rank of a two-rank gloo mesh on cuda:0 (spawned)."""
    return _par_step(shape, torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_data_parallel_step_of_two_gloo_ranks_on_one_card(cuda_device,
                                                          shape):
    """Two gloo ranks on cuda:0 take one mesh step of the REDUCED
    qwen3-1.7b: at (2, 1) each its row of each microbatch, at (1, 2) its
    heads, FFN columns and vocabulary (the remat recompute in the card's
    autograd thread): every rank's attention through the wgmma kernel
    (forward and remat recompute, 2 x 2 layers x 2 microbatches), the
    loss within TRAIN_LOSS_REL and every gradient within TRAIN_GRAD_REL
    of the one-rank step on the card, the parameters within 2 lr, and the
    ranks' metrics equal."""
    from repro_torch.launch.ranks import spawn_ranks

    ranks = spawn_ranks(_par_card_rank, 2, backend="gloo", args=(shape,),
                        timeout_s=300)
    met, grads, params, launches = _par_step(None, cuda_device)
    assert launches == 8
    for r_met, r_grads, r_params, r_launches in ranks:
        assert r_launches == 8 and r_met == ranks[0][0]
        assert abs(r_met["loss"] - met["loss"]) <= \
            TRAIN_LOSS_REL * abs(met["loss"])
        for a, g in zip(grads, r_grads):
            assert torch.isfinite(g).all()
            assert float((a - g).abs().max()) <= \
                TRAIN_GRAD_REL * float(a.abs().max())
        lr = met["lr"]
        for a, p in zip(params, r_params):
            assert bool(((a - p).abs() <= 2 * lr + 1e-6 * a.abs()).all())


def _moe_card_rank(rank, world):
    """One rank of a (1, 2) gloo mesh on cuda:0 (spawned): the MoE layer
    check of ``tests/test_torch_parallel_train.py`` on the card, then the
    REDUCED qwen3-moe's unsharded step on the card recording its expert
    ids and the mesh step taking them, with the (q, KV) heads of every
    attention call of the mesh step."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention
    from test_torch_parallel_train import _flips, _moe_layer_check, _routing

    dev = torch.device("cuda", 0)
    layer = _moe_layer_check(make_host_mesh(1, 2), dev)
    calls, heads, entry = [], [], attention.flash_attention
    with _routing(calls):
        ref = _par_step(None, dev, "qwen3-moe-30b-a3b")

    def counted(q, k, v, causal=True, chunk=1024):
        heads.append((q.shape[1], k.shape[1]))
        return entry(q, k, v, causal, chunk)

    attention.flash_attention = counted
    try:
        with _routing(calls, force=True) as seen:
            got = _par_step((1, 2), dev, "qwen3-moe-30b-a3b")
    finally:
        attention.flash_attention = entry
    return layer, ref, got, _flips(seen), sorted(set(heads)), len(heads)


@pytest.mark.cuda
def test_expert_parallel_moe_of_two_gloo_ranks_on_one_card(cuda_device):
    """Two gloo ranks on cuda:0 at (1, 2), the REDUCED qwen3-moe's 8
    experts split 4 a rank.  The MoE layer on the card: its expert FFN
    on 4 experts, one sum over ``model`` in its forward, the output
    within 2^-7 and the gradients (input, router, this rank's experts)
    within 2^-6 of the unsharded layer's largest magnitude.  The mesh
    step with the unsharded step's expert ids (no decided flip): every
    attention call through the wgmma kernel at the local heads (2 query
    over 1 KV head of 4 over 2), 2 x 2 layers x 2 microbatches of them,
    the loss within TRAIN_LOSS_REL and every gradient within
    TRAIN_GRAD_REL of the unsharded step on the card, the ranks'
    metrics equal."""
    from repro_torch.launch.ranks import spawn_ranks

    ranks = spawn_ranks(_moe_card_rank, 2, backend="gloo", timeout_s=300)
    for layer, ref, got, flips, heads, calls in ranks:
        whole, split = layer[False], layer[True]
        assert whole["experts_run"] == [8] and split["experts_run"] == [4]
        assert [op[:2] for op in split["ops"]] == [("sum", "model")]
        scale = np.abs(whole["y"]).max()
        assert np.abs(split["y"] - whole["y"]).max() <= 2.0 ** -7 * scale
        lo, hi = layer["mine"]
        for i, (g, w) in enumerate(zip(split["grads"], whole["grads"])):
            w = w[lo:hi] if i >= 2 else w
            assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max(), i
        met, grads, _, _ = ref
        r_met, r_grads, _, launches = got
        assert flips[0] == 0, flips
        assert launches == calls == 8 and heads == [(2, 1)]
        assert r_met == ranks[0][2][0]
        assert abs(r_met["loss"] - met["loss"]) <= \
            TRAIN_LOSS_REL * abs(met["loss"])
        for a, g in zip(grads, r_grads):
            assert torch.isfinite(g).all()
            assert float((a - g).abs().max()) <= \
                TRAIN_GRAD_REL * float(a.abs().max())


DIST_FIELDS = ("labels", "n_communities", "levels", "modularity",
               "sweeps_per_level", "n_comm_per_level", "modularity_history",
               "delta_n_per_level")


def _dist_graph(weights, dev):
    """A seeded SBM on ``dev``, unit weights or integers 1..8."""
    from repro_torch.graph.builders import from_numpy_edges
    from repro_torch.graph.generators import sbm

    u, v, w, _ = sbm(600, 8, p_in=0.3, p_out=0.01, seed=5)
    if weights == "int":
        w = np.random.default_rng(5).integers(1, 9, u.shape[0]).astype(
            np.float64)
    return from_numpy_edges(u, v, w, device=dev)


def _dist_report(res, launches, g):
    return {f: getattr(res, f) for f in DIST_FIELDS} | {
        "bin_rank": launches, "device": str(g.device),
        "coarsening": res.coarsening}


def _dist_card_rank(rank, world, weights):
    """One rank of the gloo group on cuda:0 (spawned)."""
    from repro_torch.core.distributed import distributed_louvain

    g = _dist_graph(weights, torch.device("cuda"))
    before = bin_rank_kernel.launches
    res = distributed_louvain(g)
    return _dist_report(res, bin_rank_kernel.launches - before, g)


def _assert_dist_equal(rep, ref):
    for f in DIST_FIELDS:
        if f == "labels":
            np.testing.assert_array_equal(rep[f], ref.labels)
        else:
            assert rep[f] == getattr(ref, f), f


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["unit", "int"])
def test_distributed_louvain_two_gloo_ranks_on_one_card(cuda_device,
                                                        weights):
    """Two gloo ranks, both on cuda:0: shard-local ``distributed_louvain``
    equals the single-device ``segment`` ``louvain()`` bit for bit (labels,
    Q, every history) on unit and on integer weights, and ``bin_rank``
    launched in every rank."""
    from repro_torch.core.louvain import LouvainConfig, louvain
    from repro_torch.launch.ranks import spawn_ranks

    ranks = spawn_ranks(_dist_card_rank, 2, backend="gloo",
                        args=(weights,), timeout_s=300)
    ref = louvain(_dist_graph(weights, cuda_device), LouvainConfig())
    for rep in ranks:
        assert rep["device"] == "cuda:0" and rep["coarsening"] == "shard_local"
        assert rep["bin_rank"] > 0
        _assert_dist_equal(rep, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["unit", "int"])
def test_distributed_louvain_one_nccl_rank(cuda_device, weights, tmp_path,
                                           monkeypatch):
    """A one-rank NCCL group in this process: shard-local
    ``distributed_louvain`` equals the single-device ``segment``
    ``louvain()`` bit for bit, launches ``bin_rank``, and every collective
    sees tensors on the card."""
    import torch.distributed as dist

    from repro_torch.core.distributed import distributed_louvain
    from repro_torch.core.louvain import LouvainConfig, louvain
    from repro_torch.launch.ranks import init_group

    g = _dist_graph(weights, cuda_device)
    ref = louvain(g, LouvainConfig())
    seen = set()
    real = {k: getattr(dist, k) for k in ("all_reduce", "all_gather")}

    def spy(name):
        def wrapped(*a, **kw):
            for x in a:
                for t in (x if isinstance(x, list) else [x]):
                    if isinstance(t, torch.Tensor):
                        seen.add(t.device.type)
            return real[name](*a, **kw)
        return wrapped

    init_group("nccl", 0, 1, f"file://{tmp_path}/rendezvous")
    try:
        for k in real:
            monkeypatch.setattr(dist, k, spy(k))
        before = bin_rank_kernel.launches
        res = distributed_louvain(g)
        launches = bin_rank_kernel.launches - before
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()
    assert seen == {"cuda"}
    assert launches > 0 and res.coarsening == "shard_local"
    _assert_dist_equal(_dist_report(res, launches, g), ref)

"""Degree-bucketed ELL (padded neighbor-list) layout for the local_move
kernels (port of ``repro.graph.ell``).

Vertices are grouped by (non-loop) degree into buckets of fixed width
W ∈ BUCKET_WIDTHS; within a bucket, neighbor ids/weights are dense flat
(R, W) tiles.  Vertices with degree > max(W) are the "tail", evaluated by
the sort+segment path over their pre-extracted edges.

The build runs on the graph's own device with tensor ops only.  The JAX
package fills the tiles with a Python loop over every row, which at a
2-million-vertex graph is millions of interpreter iterations; here the
rows' edges are located by ``repeat_interleave`` arithmetic and written
with one scatter per bucket.  The resulting buckets — row order included —
are identical to the JAX package's ``build_ell``.  The JAX package's
``(n_chunks, rows, W)`` stacking serves the TPU grid and has no counterpart:
a bucket stays one flat tile.  Each bucket carries the window metadata of
the streamed table layout (``TableWindows``), computed on the device.

``traced_ell_tile`` is the layout of the capacity cascade's coarse
levels: one vertex-aligned ``(n_max, W)`` tile per level, built on the
device from the coarse graph's CSR row pointers, with the vertices wider
than W left to the tail evaluator.

Tile contract — what ``build_ell`` and ``traced_ell_tile`` both guarantee
and the local_move kernels may rely on (``tile_contract`` checks it):

1. a row whose id is the sentinel (``n_max``) holds only sentinel slots,
   of weight 0, so its move is (-1, none) whatever the tables hold; the
   resident Louvain kernel at W = 64 and the streamed kernels at W = 16
   settle such a row from its id alone;
2. every sentinel slot has weight 0.

Both builders also lay a live row's real slots out in ``[0, deg)``, in
edge order, with at most one sentinel among them: none in a ``build_ell``
bucket (self-loops stay out), the masked self-loop in a traced tile of a
graph with one self-loop a vertex at most, as every coarse graph has (its
parallel edges merged).  No kernel relies on this layout: they stay exact
with padding anywhere in a row.  ``tile_contract`` counts the rows that
break it, and the tests hold both builders to none.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.graph.structure import Graph
from repro_torch.kernels.common import TABLE_LANE, cdiv

BUCKET_WIDTHS = (16, 64, 256, 1024)
ROW_PAD = 8  # rows per bucket are padded to a multiple of this

# Tile entries per block of the streamed layout.  One CUDA block of the
# streamed kernels stages its window and scores block_rows = 2048 / W rows
# (128 at W = 16, 32 at W = 64, 8 at W >= 256) one row group after another.
# On the com-dblp stand-in (scale 1.0, W = 16: 316 776 rows) that is 2 475
# blocks with a 2 KB (PLP) or 8 KB (Louvain) window each.  Timed on an
# NVIDIA H100 (700 W; chip_smoke.py's sweep), the W = 16 kernels (a lane a
# row) take, PLP / Louvain: 64 rows a block 0.0265 / 0.0239 ms, 128 rows
# 0.0269 / 0.0247, 256 rows 0.0300 / 0.0267, 2048 rows 0.0522 / 0.0594.
# 64 rows gain 1.5-3 % there but lose up to 4 % on Louvain in
# tools/ab_kernels.py local_move_streamed, so 128 stays: more rows a block
# mean more rows a thread in sequence, fewer mean more overlapping window
# re-read.
STREAM_BLOCK_ELEMS = 2048


def stream_block_rows(width: int) -> int:
    """Default rows per streamed block for ELL width ``width``."""
    return max(ROW_PAD, STREAM_BLOCK_ELEMS // width)


@dataclasses.dataclass(frozen=True)
class TableWindows:
    """Per-row-block table windows of the streamed local_move layout.

    Block b of ``block_rows`` consecutive (locality-ordered) rows touches
    real vertex ids inside ``[win_blk[b]·slot, win_blk[b]·slot + 2·slot)``:
    the streamed kernel stages exactly that slice of each per-vertex table
    in shared memory.  ``slot`` is a multiple of ``TABLE_LANE``;
    ``n_slots`` windows cover ids 0..n_max.  Sentinel ids need no
    coverage: they are masked, never read."""

    win_blk: torch.Tensor   # int32[n_blocks], on the bucket's device
    slot: int
    block_rows: int
    n_slots: int


def compute_windows(rows: torch.Tensor, nbr: torch.Tensor, n_max: int,
                    block_rows: int) -> TableWindows:
    """Windows of a bucket's flat (R,)/(R, W) tiles, on their device: per
    block, [lo, hi) spans every real id of its rows and neighbors; the
    slot is the widest span rounded up to ``TABLE_LANE``, so every block
    fits one 2-slot window whatever its alignment.  An all-padding block
    takes [0, 1).  The JAX package's ``compute_windows``, as tensor ops."""
    R, W = nbr.shape
    nb = max(1, cdiv(R, block_rows))
    pad = nb * block_rows - R
    dev = nbr.device
    rows2 = torch.cat([rows, torch.full((pad,), n_max, dtype=rows.dtype,
                                        device=dev)]).view(nb, block_rows)
    nbr2 = torch.cat([nbr, torch.full((pad, W), n_max, dtype=nbr.dtype,
                                      device=dev)]).view(nb, block_rows * W)
    lo = torch.minimum(
        torch.where(rows2 < n_max, rows2, n_max).amin(dim=1),
        torch.where(nbr2 < n_max, nbr2, n_max).amin(dim=1)).long()
    hi = torch.maximum(
        torch.where(rows2 < n_max, rows2, -1).amax(dim=1),
        torch.where(nbr2 < n_max, nbr2, -1).amax(dim=1)).long() + 1
    empty = hi <= lo
    lo = torch.where(empty, 0, lo)
    hi = torch.where(empty, 1, hi)
    slot = cdiv(max(int((hi - lo).max()), 1), TABLE_LANE) * TABLE_LANE
    return TableWindows(
        win_blk=(lo // slot).to(torch.int32),
        slot=slot,
        block_rows=int(block_rows),
        n_slots=max(1, cdiv(n_max + 1, slot)),
    )


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One degree bucket: ``rows`` int32[R] (vertex id, ``n_max`` for
    padding rows), ``nbr`` int32[R, W] (``n_max`` padding), ``w``
    float32[R, W] (0 padding); ``n_rows_valid`` real rows lead.  The tiles
    keep the module's tile contract (padding rows are sentinels only), and
    a real row's ``deg`` neighbours fill ``[0, deg)``.
    ``windows`` enables the streamed table layout; a bucket built by hand
    without it supports the resident layout only."""

    width: int
    rows: torch.Tensor
    nbr: torch.Tensor
    w: torch.Tensor
    n_rows_valid: int
    windows: Optional[TableWindows] = None


@dataclasses.dataclass(frozen=True)
class DeviceEll:
    """The ELL layout the sweep engine consumes, on one device.

    Tail edges are the (dst, src)-sorted edges — self-loops included —
    whose dst is a tail vertex, in the order the JAX package's
    ``to_device`` materializes them."""

    n_max: int
    buckets: Tuple[EllBucket, ...]
    tail_vertices: torch.Tensor   # int32[T]
    tail_src: torch.Tensor        # int32[K]
    tail_dst: torch.Tensor        # int32[K]
    tail_w: torch.Tensor          # float32[K]
    is_tail: torch.Tensor         # bool[n_max]

    @property
    def has_tail(self) -> bool:
        return self.tail_vertices.numel() > 0


def build_ell(g: Graph, widths: Tuple[int, ...] = BUCKET_WIDTHS,
              block_rows: Optional[int] = None) -> DeviceEll:
    """ELL build on ``g``'s device.  Rows are IN-neighborhoods (edges
    grouped by dst; by symmetry these equal out-neighborhoods); self-loops
    are never move candidates and stay out of the tiles.  Within a bucket,
    rows are ordered by (min neighbor id, mean neighbor id, vertex id), the
    JAX package's locality order.  ``block_rows`` sets the rows per
    streamed block of every bucket (default ``stream_block_rows(W)``,
    capped at the bucket's rows).  The buckets keep the tile contract
    (module docstring): padding rows (id ``n_max``) hold only sentinel
    slots of weight 0.  A row of degree d holds its neighbours in slots
    ``[0, d)`` with no sentinel among them."""
    n, dev = g.n_max, g.device
    mask = g.edge_mask
    src, dst, w = g.src[mask].long(), g.dst[mask].long(), g.w[mask]
    # (dst, src) order, stable for parallel edges (np.lexsort((src, dst)))
    order = torch.sort(dst * max(n, 1) + src, stable=True).indices
    src, dst, w = src[order], dst[order], w[order]

    keep = src != dst
    src_b, dst_b, w_b = src[keep], dst[keep], w[keep]
    deg = torch.bincount(dst_b, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.long, device=dev)
    row_ptr[1:] = torch.cumsum(deg, 0)
    # float64 prefix sums of the neighbor ids: exact for integer ids, so
    # the per-row mean equals numpy's bit for bit
    src_cum = torch.zeros(src_b.numel() + 1, dtype=torch.float64, device=dev)
    src_cum[1:] = torch.cumsum(src_b.double(), 0)

    buckets = []
    prev = 0
    for W in widths:
        vids = torch.nonzero((deg > prev) & (deg <= W)).flatten()
        prev = W
        if vids.numel():
            lo_n = src_b[row_ptr[vids]]            # in-row neighbors ascend
            mean_n = (src_cum[row_ptr[vids + 1]] - src_cum[row_ptr[vids]]) \
                / deg[vids]
            # lexsort by (lo_n, mean_n, vid): stable sorts, least key first
            perm = torch.sort(mean_n, stable=True).indices
            perm = perm[torch.sort(lo_n[perm], stable=True).indices]
            vids = vids[perm]
        V = vids.numel()
        R = -(-max(1, V) // ROW_PAD) * ROW_PAD
        rows = torch.full((R,), n, dtype=torch.int32, device=dev)
        rows[:V] = vids.to(torch.int32)
        nbr = torch.full((R, W), n, dtype=torch.int32, device=dev)
        ww = torch.zeros((R, W), dtype=torch.float32, device=dev)
        d = deg[vids]
        r_idx = torch.repeat_interleave(torch.arange(V, device=dev), d)
        col = torch.arange(r_idx.numel(), device=dev) - (torch.cumsum(d, 0) - d)[r_idx]
        e_idx = row_ptr[vids][r_idx] + col
        nbr[r_idx, col] = src_b[e_idx].to(torch.int32)
        ww[r_idx, col] = w_b[e_idx]
        br = min(block_rows or stream_block_rows(W), R)
        buckets.append(EllBucket(W, rows, nbr, ww, V,
                                 compute_windows(rows, nbr, n, br)))

    is_tail = deg > widths[-1]
    tail = is_tail[dst]
    return DeviceEll(
        n_max=n,
        buckets=tuple(buckets),
        tail_vertices=torch.nonzero(is_tail).flatten().to(torch.int32),
        tail_src=src[tail].to(torch.int32),
        tail_dst=dst[tail].to(torch.int32),
        tail_w=w[tail],
        is_tail=is_tail,
    )


def traced_ell_tile(g: Graph, width: int) -> Tuple[torch.Tensor, ...]:
    """Single-bucket ELL view of a src-sorted coarse graph: the layout of
    the cascade's coarse levels, rebuilt per level on the device from CSR
    row pointers with no host-side row ordering (the JAX package's
    ``traced_ell_tile``).

    One vertex-aligned ``(n_max, width)`` tile: row v holds vertex v's
    out-edges in edge order — by the directed-symmetric convention these
    are its in-neighbourhood — with its self-loop masked to the sink.
    Vertices whose degree (loop included) exceeds ``width`` are flagged
    ``is_tail`` and their row is pure padding; the engine scores them
    through the tables tail evaluator over the full edge list.

    Returns ``(rows[n], nbr[n, W], w[n, W], is_tail[n])`` with the
    sentinels of ``EllBucket`` (row and neighbour id ``n_max``, weight 0).
    The tile keeps the tile contract (module docstring): the row of a
    padding vertex slot or of a tail vertex has id ``n_max`` and only
    sentinel slots of weight 0.  A live row of degree d (self-loop
    included) holds its edges in slots ``[0, d)``, its masked self-loop,
    of weight 0, the only sentinel among them where the graph holds one
    self-loop a vertex at most (a coarse graph does).
    """
    n, m, dev = g.n_max, g.m_max, g.device
    if g.sorted_by != "src":
        raise ValueError("traced_ell_tile requires a src-sorted graph")
    rp = g.row_ptr()
    deg = rp[1:] - rp[:-1]
    vmask = g.vertex_mask()
    is_tail = vmask & (deg > width)
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.where(vmask & ~is_tail, arange_n, n).to(torch.int32)
    j = torch.arange(width, dtype=torch.int32, device=dev)
    idx = torch.clamp(rp[:-1, None] + j[None, :], 0, max(m - 1, 0))
    take = (j[None, :] < deg[:, None]) & (rows < n)[:, None]
    nbr = torch.where(take, g.dst[idx], n).to(torch.int32)
    wt = torch.where(take, g.w[idx], 0.0)
    loop = nbr == arange_n[:, None]
    return (rows, torch.where(loop, n, nbr).to(torch.int32),
            torch.where(loop, 0.0, wt), is_tail)


def tile_contract(rows: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                  n_max: int) -> Tuple[int, int, int, int]:
    """Checks the tile contract (module docstring) on a ``(rows[R],
    nbr[R, W], w[R, W])`` tile and returns ``(live rows, real slots, valid
    prefix slots, crowded rows)``: the valid prefix slots are the sum over
    live rows of 1 + the row's last real slot; a crowded row is a live row
    with more than one sentinel before its last real slot, which the
    builders' layout never makes.  Raises ``ValueError`` where the tile
    breaks the contract.  Reads back to the host: a check, not a step of
    the sweep."""
    real = nbr < n_max
    live = rows < n_max
    if bool((real & ~live[:, None]).any()):
        raise ValueError("tile contract: a sentinel row holds a real slot")
    if bool(((w != 0) & ~real).any()):
        raise ValueError("tile contract: a sentinel slot has weight != 0")
    W = nbr.shape[1]
    pos = torch.arange(1, W + 1, device=nbr.device)
    prefix = torch.where(real, pos, 0).amax(dim=1)
    holes = (pos[None, :] <= prefix[:, None]) & ~real
    return (int(live.sum()), int(real.sum()), int(prefix.sum()),
            int((holes.sum(dim=1) > 1).sum()))


def grid_view(b: EllBucket) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rows[R], nbr[R, W], w[R, W])`` — the flat tiles a kernel launch
    covers, one thread block per row (or per few rows, for narrow W)."""
    return b.rows, b.nbr, b.w


def to_device(e: DeviceEll, device: torch.device) -> DeviceEll:
    """Copy every tile and tail array of ``e`` to ``device``."""
    def moved(win):
        return None if win is None else dataclasses.replace(
            win, win_blk=win.win_blk.to(device))

    return dataclasses.replace(
        e,
        buckets=tuple(dataclasses.replace(
            b, rows=b.rows.to(device), nbr=b.nbr.to(device), w=b.w.to(device),
            windows=moved(b.windows))
            for b in e.buckets),
        tail_vertices=e.tail_vertices.to(device),
        tail_src=e.tail_src.to(device),
        tail_dst=e.tail_dst.to(device),
        tail_w=e.tail_w.to(device),
        is_tail=e.is_tail.to(device),
    )

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
``(n_chunks, rows, W)`` stacking and window metadata serve the TPU grid and
the streamed layout; neither exists here, and a bucket stays one flat tile.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.graph.structure import Graph

BUCKET_WIDTHS = (16, 64, 256, 1024)
ROW_PAD = 8  # rows per bucket are padded to a multiple of this


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One degree bucket: ``rows`` int32[R] (vertex id, ``n_max`` for
    padding rows), ``nbr`` int32[R, W] (``n_max`` padding), ``w``
    float32[R, W] (0 padding); ``n_rows_valid`` real rows lead."""

    width: int
    rows: torch.Tensor
    nbr: torch.Tensor
    w: torch.Tensor
    n_rows_valid: int


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


def build_ell(g: Graph, widths: Tuple[int, ...] = BUCKET_WIDTHS) -> DeviceEll:
    """ELL build on ``g``'s device.  Rows are IN-neighborhoods (edges
    grouped by dst; by symmetry these equal out-neighborhoods); self-loops
    are never move candidates and stay out of the tiles.  Within a bucket,
    rows are ordered by (min neighbor id, mean neighbor id, vertex id), the
    JAX package's locality order."""
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
        buckets.append(EllBucket(W, rows, nbr, ww, V))

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


def grid_view(b: EllBucket) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rows[R], nbr[R, W], w[R, W])`` — the flat tiles a kernel launch
    covers, one thread block per row (or per few rows, for narrow W)."""
    return b.rows, b.nbr, b.w


def to_device(e: DeviceEll, device: torch.device) -> DeviceEll:
    """Copy every tile and tail array of ``e`` to ``device``."""
    return dataclasses.replace(
        e,
        buckets=tuple(dataclasses.replace(
            b, rows=b.rows.to(device), nbr=b.nbr.to(device), w=b.w.to(device))
            for b in e.buckets),
        tail_vertices=e.tail_vertices.to(device),
        tail_src=e.tail_src.to(device),
        tail_dst=e.tail_dst.to(device),
        tail_w=e.tail_w.to(device),
        is_tail=e.is_tail.to(device),
    )

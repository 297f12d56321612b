"""Core graph structure (port of ``repro.graph.structure``).

Representation: an undirected weighted graph is stored as a
**directed-symmetric** edge list —

  * every undirected edge {u, v}, u != v, appears as BOTH (u, v, w) and (v, u, w);
  * a self-loop on v appears ONCE as (v, v, w_loop) where ``w_loop`` is the
    *doubled* loop weight ("loops are counted twice", paper §II-A).

All arrays have **static capacity** (``n_max`` vertices / ``m_max`` directed
edges) with validity masks; padding entries hold the ``n_max`` sentinel as
both endpoints and weight 0.  ``n_valid``/``m_valid`` are host integers: the
per-level driver reads them back at every level anyway, and keeping them on
the host saves a device sync per use.

Every tensor of a ``Graph`` lives on one device.  Entry points that build
graphs default to ``"cuda"`` and raise when no card is present
(``resolve_device``); callers ask for the CPU explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.graph.segment import segment_sum


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point builds on: ``"cuda"`` unless the caller
    names another.  Raises if CUDA is asked for (or defaulted to) and no
    card is present — nothing silently carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed-symmetric weighted graph with static capacity.

    Attributes:
      src, dst:  int32[m_max] endpoints (invalid entries hold ``n_max``)
      w:         float32[m_max] edge weights (0 for invalid entries)
      edge_mask: bool[m_max] validity
      n_valid:   live vertices (vertices are [0, n_valid))
      m_valid:   live directed edges
      n_max, m_max: static capacities
      sorted_by: "src" | "dst" | None — current sort invariant
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    edge_mask: torch.Tensor
    n_valid: int
    m_valid: int
    n_max: int
    m_max: int
    sorted_by: Optional[str]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def vertex_mask(self) -> torch.Tensor:
        return torch.arange(self.n_max, device=self.device) < self.n_valid

    def weighted_degrees(self) -> torch.Tensor:
        """deg_w(v): sum of out-edge weights (self-loops stored doubled).
        A deterministic sorted reduction: it feeds the Louvain gains."""
        return segment_sum(
            torch.where(self.edge_mask, self.w, 0.0), self.src, self.n_max,
            ids_sorted=self.sorted_by == "src")

    def total_volume(self) -> torch.Tensor:
        """vol_w(V) = 2W (sum of all directed weights incl. doubled loops)."""
        return torch.sum(torch.where(self.edge_mask, self.w, 0.0))

    def row_ptr(self) -> torch.Tensor:
        """CSR row pointers, int32[n_max + 1] — requires ``sorted_by ==
        'src'`` (padding holds the ``n_max`` sentinel, so it sorts last)."""
        if self.sorted_by != "src":
            raise ValueError("row_ptr requires the graph sorted by src")
        bounds = torch.arange(self.n_max + 1, dtype=self.src.dtype,
                              device=self.device)
        return torch.searchsorted(self.src, bounds).to(torch.int32)

    def to_numpy_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, w) of valid directed edges, as host numpy."""
        mask = self.edge_mask
        return (
            self.src[mask].cpu().numpy(),
            self.dst[mask].cpu().numpy(),
            self.w[mask].cpu().numpy(),
        )

    def __repr__(self) -> str:
        return (f"Graph(n_max={self.n_max}, m_max={self.m_max}, "
                f"sorted_by={self.sorted_by!r}, device={self.device})")


def graph_from_numpy(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    edge_mask: np.ndarray,
    n_valid: int,
    m_valid: int,
    n_max: int,
    m_max: int,
    sorted_by: Optional[str] = None,
    *,
    device: Union[str, torch.device, None] = None,
) -> Graph:
    """Wrap host arrays that already have the Graph layout (padding and
    sentinels included) — the carry-across from a JAX ``Graph``, whose
    fields hand over as numpy arrays with the same ``n_max``/``m_max``."""
    dev = resolve_device(device)
    if not (len(src) == len(dst) == len(w) == len(edge_mask) == m_max):
        raise ValueError("src, dst, w, edge_mask must all have m_max entries")
    return Graph(
        src=torch.tensor(np.asarray(src, np.int32), device=dev),
        dst=torch.tensor(np.asarray(dst, np.int32), device=dev),
        w=torch.tensor(np.asarray(w, np.float32), device=dev),
        edge_mask=torch.tensor(np.asarray(edge_mask, bool), device=dev),
        n_valid=int(n_valid),
        m_valid=int(m_valid),
        n_max=int(n_max),
        m_max=int(m_max),
        sorted_by=sorted_by,
    )


def graph_from_arrays(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    *,
    n_max: int,
    m_max: Optional[int] = None,
    n_valid: Optional[int] = None,
    sorted_by: Optional[str] = None,
) -> Graph:
    """Wrap already-symmetrized directed edge tensors, padding to capacity
    on their device.  The edge capacity is floored at 1, as in the JAX
    package: an edgeless graph keeps one fully-masked padding slot."""
    m = src.shape[0]
    m_max = m_max or max(m, 1)
    if m_max < m:
        raise ValueError(f"m_max={m_max} < m={m}")
    dev, pad = src.device, m_max - m
    fill = torch.full((pad,), n_max, dtype=torch.int32, device=dev)
    return Graph(
        src=torch.cat([src.to(torch.int32), fill]),
        dst=torch.cat([dst.to(torch.int32), fill]),
        w=torch.cat([w.to(torch.float32),
                     torch.zeros(pad, dtype=torch.float32, device=dev)]),
        edge_mask=torch.arange(m_max, device=dev) < m,
        n_valid=int(n_max if n_valid is None else n_valid),
        m_valid=int(m),
        n_max=int(n_max),
        m_max=int(m_max),
        sorted_by=sorted_by,
    )

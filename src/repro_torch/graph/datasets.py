"""Dataset registry: paper's SNAP graphs (Table I) as seeded synthetic stand-ins
(port of ``repro.graph.datasets``: same generators, same seeds, same graphs).

The container is offline, so the six SNAP graphs are represented by generators
matched to each graph's V, E/V ratio and community character, at a reduced
scale (default 1/32 of V; override with ``REPRO_DATASET_SCALE``).  Paper
statistics are kept as metadata so benchmark tables can print both.

  * community-rich graphs (com-amazon, com-dblp) -> SBM with strong planted
    structure (their published Louvain modularity is ~0.92/0.82);
  * heavy-tailed web/social graphs (com-youtube, as-skitter, com-livejournal,
    com-orkut) -> R-MAT with Graph500 skew.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.graph import generators
from repro_torch.graph.builders import from_numpy_edges
from repro_torch.graph.structure import Graph
from repro_torch.utils.registry import Registry


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    name: str
    paper_vertices: Optional[int]
    paper_edges: Optional[int]
    paper_diameter: Optional[int]
    kind: str  # "snap-standin" | "synthetic" | "classic"
    description: str = ""


@dataclasses.dataclass
class LoadedGraph:
    graph: Graph
    truth: Optional[np.ndarray]
    meta: DatasetMeta
    n: int
    m_undirected: int


DATASETS: Registry[Callable[..., LoadedGraph]] = Registry("dataset")

# Paper Table I
_TABLE_I = {
    "com-amazon": (334_863, 925_872, 44),
    "com-dblp": (317_080, 1_049_866, 21),
    "com-youtube": (1_134_890, 2_987_624, 20),
    "com-livejournal": (3_997_962, 34_681_189, 17),
    "as-skitter": (1_696_415, 11_095_298, 25),
    "com-orkut": (3_072_441, 117_185_083, 9),
}


def _scale() -> float:
    return float(os.environ.get("REPRO_DATASET_SCALE", "0.03125"))  # 1/32


def _mk_loaded(u, v, w, truth, meta: DatasetMeta, n: int,
               device) -> LoadedGraph:
    g = from_numpy_edges(u, v, w, n=n, sort_by="src", device=device)
    return LoadedGraph(graph=g, truth=truth, meta=meta, n=n, m_undirected=len(u))


def _register_snap_standins() -> None:
    def make_sbm_standin(name: str, communities_frac: float, p_in: float, deg_out: float):
        V, E, diam = _TABLE_I[name]

        def load(seed: int = 0, scale: Optional[float] = None,
                 device=None) -> LoadedGraph:
            s = scale if scale is not None else _scale()
            n = max(512, int(V * s))
            k = max(4, int(n * communities_frac))
            csize = n / k
            # mean intra-degree = p_in*(csize-1); choose p_out to hit E/V target
            target_deg = 2.0 * E / V
            intra = p_in * (csize - 1)
            p_out = max(0.0, (target_deg - intra)) / max(1.0, (n - csize))
            u, v, w, truth = generators.sbm(n, k, p_in=p_in, p_out=p_out, seed=seed)
            meta = DatasetMeta(name, V, E, diam, "snap-standin", "SBM-matched")
            return _mk_loaded(u, v, w, truth, meta, n, device)

        DATASETS.register(name, load)

    def make_rmat_standin(name: str):
        V, E, diam = _TABLE_I[name]

        def load(seed: int = 0, scale: Optional[float] = None,
                 device=None) -> LoadedGraph:
            s = scale if scale is not None else _scale()
            n_target = max(1024, int(V * s))
            sc = max(10, int(np.ceil(np.log2(n_target))))
            ef = max(2, int(round(E / V)))
            u, v, w = generators.rmat(sc, ef, seed=seed)
            n = 1 << sc
            meta = DatasetMeta(name, V, E, diam, "snap-standin", "R-MAT-matched")
            return _mk_loaded(u, v, w, None, meta, n, device)

        DATASETS.register(name, load)

    # community-rich graphs: ~30 vertices per community, dense blocks
    make_sbm_standin("com-amazon", communities_frac=1 / 30, p_in=0.35, deg_out=0.5)
    make_sbm_standin("com-dblp", communities_frac=1 / 40, p_in=0.30, deg_out=0.5)
    make_rmat_standin("com-youtube")
    make_rmat_standin("com-livejournal")
    make_rmat_standin("as-skitter")
    make_rmat_standin("com-orkut")


def _register_synthetic() -> None:
    def load_ring(seed: int = 0, n_cliques: int = 16, clique_size: int = 8,
                  device=None) -> LoadedGraph:
        u, v, w, truth = generators.ring_of_cliques(n_cliques, clique_size)
        meta = DatasetMeta("ring-of-cliques", None, None, None, "classic")
        return _mk_loaded(u, v, w, truth, meta, n_cliques * clique_size,
                          device)

    def load_sbm_small(seed: int = 0, device=None) -> LoadedGraph:
        n, k = 2000, 40
        u, v, w, truth = generators.sbm(n, k, p_in=0.3, p_out=0.002, seed=seed)
        meta = DatasetMeta("sbm-small", None, None, None, "synthetic")
        return _mk_loaded(u, v, w, truth, meta, n, device)

    def load_sbm_medium(seed: int = 0, device=None) -> LoadedGraph:
        n, k = 20_000, 200
        u, v, w, truth = generators.sbm(n, k, p_in=0.25, p_out=0.0004, seed=seed)
        meta = DatasetMeta("sbm-medium", None, None, None, "synthetic")
        return _mk_loaded(u, v, w, truth, meta, n, device)

    def load_karate(seed: int = 0, device=None) -> LoadedGraph:
        # lazy: networkx is a test-time dependency, absent where the port
        # runs on the card
        import networkx as nx

        G = nx.karate_club_graph()
        edges = np.asarray(list(G.edges()), dtype=np.int64)
        meta = DatasetMeta("karate", 34, 78, 5, "classic", "Zachary karate club")
        truth = np.asarray(
            [0 if G.nodes[i]["club"] == "Mr. Hi" else 1 for i in G.nodes()]
        )
        return _mk_loaded(
            edges[:, 0], edges[:, 1], np.ones(len(edges)), truth, meta, 34,
            device)

    DATASETS.register("ring-of-cliques", load_ring)
    DATASETS.register("sbm-small", load_sbm_small)
    DATASETS.register("sbm-medium", load_sbm_medium)
    DATASETS.register("karate", load_karate)


_register_snap_standins()
_register_synthetic()


def load(name: str, *, device: Union[str, torch.device, None] = None,
         **kw) -> LoadedGraph:
    """Generate a registered dataset on ``device`` (``"cuda"`` unless the
    caller names another; raises without a card)."""
    return DATASETS.get(name)(device=device, **kw)


def paper_table_i() -> dict:
    return dict(_TABLE_I)

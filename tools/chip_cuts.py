#!/usr/bin/env python3
"""Time, on one card, what ``chip_smoke.py`` cut to pay for phase 5p's
model-axis cases.

    python3 tools/chip_cuts.py [dist] [par] [full]

``dist``: phase 3d's four gloo ranks on cuda:0 building com-dblp from the
seed at once (as each rank did) against loading the parent's graph from a
file (``torch.save`` of its fields, as each rank now does); the wall
seconds of each spawn and each rank's own seconds.  ``par``: phase 5p
with its dense case alone (qwen3-1.7b at full width, weights drawn on the
card) at 7 layers and at 2.  ``full``: the whole phase 5p at 2 layers
(the dense case, the full-width MoE case and the REDUCED cases).  Prints
the phase's own lines, a ``[cuts]`` line a measurement and one JSON
object of the seconds last.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def build_rank(rank, world, name, scale, device):
    """Phase 3d's old rank set-up: the graph built from the seed."""
    from repro_torch.graph import datasets

    t = time.perf_counter()
    datasets.load(name, scale=scale, device=torch.device(device))
    torch.cuda.synchronize()
    return time.perf_counter() - t


def load_rank(rank, world, path, device):
    """Phase 3d's rank set-up: the parent's graph loaded from ``path``."""
    from repro_torch.graph.structure import Graph

    t = time.perf_counter()
    Graph(**torch.load(path, map_location=device))
    torch.cuda.synchronize()
    return time.perf_counter() - t


def dist(rt) -> dict:
    name, scale = cs.COMMUNITY_GRAPH
    t = time.perf_counter()
    g = rt.datasets.load(name, scale=scale, device=torch.device("cuda")).graph
    torch.cuda.synchronize()
    out = {"parent_build_s": time.perf_counter() - t}
    t = time.perf_counter()
    out["ranks_build_s"] = rt.spawn_ranks(build_rank, cs.DIST_RANKS,
                                          backend="gloo",
                                          args=(name, scale, "cuda"))
    out["ranks_build_wall_s"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.pt")
        t = time.perf_counter()
        torch.save({f.name: getattr(g, f.name)
                    for f in dataclasses.fields(g)}, path)
        out["ranks_load_s"] = rt.spawn_ranks(load_rank, cs.DIST_RANKS,
                                             backend="gloo",
                                             args=(path, "cuda"))
        out["ranks_load_wall_s"] = time.perf_counter() - t
    cs.log(f"[cuts] phase 3d's rank graphs: {out}")
    return out


def par(rt, layers: int, dense_only: bool) -> float:
    """Phase 5p's seconds at ``layers`` dense layers, with its dense case
    alone or whole."""
    cs.PAR_LAYERS = layers
    real = cs.par_cases
    if dense_only:
        cs.par_cases = lambda *a: real(*a)[:1]
    c = rt.configs.get(cs.LM_ARCH)
    params = cs.device_init(torch, rt, rt.model_api.build(c).decls, 0,
                            torch.device("cuda"))
    t = time.perf_counter()
    try:
        cs.phase_parallel(argparse.Namespace(), torch, rt, params)
    finally:
        cs.par_cases = real
    dt = time.perf_counter() - t
    cs.log(f"[cuts] phase 5p at {layers} dense layers"
           f"{', the dense case alone' if dense_only else ''}: {dt:.1f} s")
    torch.cuda.empty_cache()
    return dt


def main(argv) -> int:
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is available")
    rt = cs.runtime(torch)
    cs.phase_build(rt.build)
    out = {}
    if "dist" in argv:
        out["dist"] = dist(rt)
    if "par" in argv:
        out["dense7_s"] = par(rt, 7, True)
        out["dense2_s"] = par(rt, 2, True)
    if "full" in argv:
        out["full_s"] = par(rt, cs.PAR_LAYERS, False)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

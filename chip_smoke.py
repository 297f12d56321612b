#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--reps 20] [--profile] [--out FILE]

Phases, each failing loudly (exit code 1, no result line):

1. Device: the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.  No card → failure.
2. Build: the three CUDA kernels of the main path from
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` per source, all started
   together; prints what ``-Xptxas -v`` reports for each.
3. Main path, on two graphs of real size built on the card with
   ``datasets.load(name, scale, device="cuda")``: the R-MAT ``as-skitter``
   stand-in at scale 1.0 (2^21 vertices, ~28 M directed edges), and the
   community-rich ``com-dblp`` stand-in at scale 1.0 (the SNAP graph's
   317 080 vertices, ~2 M directed edges).  The R-MAT graph's
   hub communities overflow the aggregation's bin gate at every level, so
   only the community-rich graph takes the binned path that launches
   ``bin_rank``.  On each: ``plp()`` and ``louvain()`` with
   ``backend="pallas"`` (the CUDA kernels), then again with
   ``backend="ell"`` (plain PyTorch on the card).  Every launch counter is
   set to 0 just before the ``pallas`` runs and read just after them; each
   kernel must have launched, the run reports must show no degradation,
   and both backends must agree on labels, iterations, levels and every
   per-level history.
4. Kernels: each kernel against its plain version on the inputs the main
   path gave it (every level-0 ELL bucket of both graphs, first and last
   sweep; the first level whose bin gate passed), with the graph's unit
   weights and with integer weights 1..8 — bit for bit — then timed:
   each kernel by device time (``device_ms``: a ``torch.profiler`` trace
   of ``--reps`` launches after warm-up, the kernel's own durations, so
   the wrapper's host work between launches is not in it), each plain
   version by ``loop_ms`` (CUDA events around ``--reps`` back-to-back
   calls), beside the least time the card could take (``bound_ms``).  The
   ``kernels`` line sums the R-MAT graph's four buckets (one level-0 sweep).

The line before the last is the card as ``nvidia-smi`` prints it, the one
before that the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The main path's graphs, (name in graph/datasets.py, scale): the R-MAT
# as-skitter stand-in, whose early levels overflow the bin gate, first; the
# community-rich com-dblp stand-in, whose later levels pass it.
MAIN_GRAPH = ("as-skitter", 1.0)
COMMUNITY_GRAPH = ("com-dblp", 1.0)

# NVIDIA H100 SXM data-sheet peaks used for the bound: HBM3 bandwidth and
# the 32-bit rate outside the tensor cores, which prices the compares and
# adds the functions need.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ kernel capture


class Recorder:
    """Wraps a kernel wrapper during the main path and keeps the arguments
    of the first and the last call per key, so phase 4 compares and times
    each kernel on inputs the main path really gave it.  The tensors are
    kept by reference: the main path never writes them after the call."""

    def __init__(self, fn, key):
        self.fn, self.key, self.calls = fn, key, {}
        self.tag = None          # the graph being run, set by phase_main

    def __call__(self, *args, **kw):
        k = self.key(*args, **kw)
        first = self.calls.get(k, (None, None))[0]
        self.calls[k] = (first or (args, kw), (args, kw))
        return self.fn(*args, **kw)


# ------------------------------------------------------------ timing


def device_events(prof):
    """The trace's device-side events (kernels, copies, fills): the ones
    that carry device time exactly once.  Host-side operators also report
    the device time of the kernels they launched, so summing every event
    would count those kernels twice."""
    return [e for e in prof.events()
            if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, reps: int, torch) -> float:
    """Device milliseconds per call of ``fn()``: the summed durations of
    the device events of ``reps`` calls traced by ``torch.profiler`` after
    three warm-up calls, over ``reps``.  Host time between launches (the
    wrapper's checks, allocation and ctypes call) is not in it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        fail("the profiler saw no device time")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def loop_ms(fn, reps: int, torch) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls after three warm-up calls, over ``reps``.  Used for
    the plain versions, whose thousands of small launches per call would
    swamp a profiler trace; the device's waits on the host between those
    launches are part of their cost."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_weights(w, torch, seed: int):
    """The tile's weights replaced by integers 1..8 (padding stays 0)."""
    gen = torch.Generator(device=w.device).manual_seed(seed)
    ints = torch.randint(1, 9, w.shape, generator=gen, device=w.device)
    return torch.where(w != 0, ints.to(w.dtype), w)


def max_abs_err(a, b) -> float:
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------ phases


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {card}")
    return name, count, card


def phase_build(build):
    t = time.perf_counter()
    reports = build.build()
    for name in build.KERNELS:
        text = reports.get(name)
        log(f"[build] {name}: "
            + ("already built" if text is None else "ptxas -v:"))
        for line in (text or "").splitlines():
            if "ptxas" in line:
                log(f"    {line.strip()}")
    log(f"[build] {len(reports)} kernel(s) built in "
        f"{time.perf_counter() - t:.1f} s")


def compare_runs(a, b, fields, what):
    import numpy as np

    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        same = (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y)
        if not same:
            fail(f"{what}: pallas and ell differ in {f}")


def _summary(plp_res, lv_res, g):
    if not (0.0 < lv_res.modularity <= 1.0):
        fail(f"implausible modularity {lv_res.modularity!r}")
    if len(plp_res.labels) != g.n_max or len(lv_res.labels) != g.n_max:
        fail("label vectors do not cover the graph")
    return {
        "plp_iterations": plp_res.iterations,
        "plp_communities": int(len(set(plp_res.labels.tolist()))),
        "louvain_levels": lv_res.levels,
        "louvain_communities": lv_res.n_communities,
        "modularity": lv_res.modularity,
        "sweeps_per_level": lv_res.sweeps_per_level,
        "n_comm_per_level": lv_res.n_comm_per_level,
        "aggregation_per_level": lv_res.aggregation_per_level,
        "warnings": lv_res.run_report.warnings,
        "louvain_timer_s": lv_res.timer.totals,
        "plp_timer_s": plp_res.timer.totals}


def phase_main(torch, rt):
    """Both graphs of the main path: the R-MAT stand-in (PLP + Louvain, its
    early levels overflow the bin gate) and a community-rich stand-in
    (PLP + Louvain, whose later levels pass it, so ``bin_rank`` runs)."""
    dev = torch.device("cuda")
    graphs = {}
    for name, scale in (MAIN_GRAPH, COMMUNITY_GRAPH):
        t = time.perf_counter()
        lg = rt.datasets.load(name, scale=scale, device=dev)
        torch.cuda.synchronize()
        ingest = time.perf_counter() - t
        t = time.perf_counter()
        ell = rt.build_ell(lg.graph)
        torch.cuda.synchronize()
        info = {"scale": scale, "n": lg.graph.n_max,
                "m_directed": lg.graph.m_valid, "ingest_s": ingest,
                "ell_build_s": time.perf_counter() - t,
                "ell_rows": {b.width: b.n_rows_valid for b in ell.buckets},
                "tail_vertices": int(ell.tail_vertices.numel())}
        graphs[name] = (lg.graph, ell, info)
        log(f"[main] {name} scale {scale}: n={info['n']} directed edges="
            f"{info['m_directed']}; ingest {ingest:.2f} s; ELL build "
            f"{info['ell_build_s']:.2f} s, rows per width {info['ell_rows']},"
            f" tail vertices {info['tail_vertices']}")

    # capture the kernels' main-path inputs, per graph and ELL width
    rec_plp = Recorder(rt.lm_kernel.local_move_plp_kernel,
                       lambda rows, nbr, *a, **k: (rec_plp.tag, nbr.shape[1]))
    rec_lv = Recorder(rt.lm_kernel.local_move_louvain_kernel,
                      lambda rows, nbr, *a, **k: (rec_lv.tag, nbr.shape[1]))
    rec_bin = Recorder(rt.agg_kernel.bin_rank_kernel,
                       lambda *a, **k: rec_bin.tag)
    recs = (rec_plp, rec_lv, rec_bin)
    rt.lm_ops.local_move_plp_kernel = rec_plp
    rt.lm_ops.local_move_louvain_kernel = rec_lv
    rt.agg_ops.bin_rank_kernel = rec_bin

    counters = tuple(r.fn for r in recs)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, (g, ell, info) in graphs.items():
        for r in recs:
            r.tag = name
        t = time.perf_counter()
        plp_res = rt.plp(g, rt.PLPConfig(backend="pallas"), ell_graph=ell)
        torch.cuda.synchronize()
        info["plp_s"] = time.perf_counter() - t
        t = time.perf_counter()
        lv_res = rt.louvain(g, rt.LouvainConfig(backend="pallas"))
        torch.cuda.synchronize()
        info["louvain_s"] = time.perf_counter() - t
        runs[name] = (plp_res, lv_res)
    launches = {c.__name__.replace("_kernel", ""): c.launches
                for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for r in recs:
        setattr(rt.agg_ops if r is rec_bin else rt.lm_ops, r.fn.__name__, r.fn)
    log(f"[main] pallas runs done; peak memory {peak:.2f} GiB; launches "
        f"{launches}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was launched no time on the main path")

    for name, (g, ell, info) in graphs.items():
        plp_k, lv_k = runs[name]
        for res, what in ((plp_k, "plp"), (lv_k, "louvain")):
            if res.run_report.degradations:
                fail(f"{name} {what} degraded: {res.run_report.degradations}")
        t = time.perf_counter()
        plp_e = rt.plp(g, rt.PLPConfig(backend="ell"), ell_graph=ell)
        torch.cuda.synchronize()
        info["plp_ell_s"] = time.perf_counter() - t
        t = time.perf_counter()
        lv_e = rt.louvain(g, rt.LouvainConfig(backend="ell"))
        torch.cuda.synchronize()
        info["louvain_ell_s"] = time.perf_counter() - t
        compare_runs(plp_k, plp_e, ("labels", "iterations", "delta_n_history",
                                    "active_history"), f"{name} plp")
        compare_runs(lv_k, lv_e, ("labels", "n_communities", "levels",
                                  "modularity", "modularity_history",
                                  "sweeps_per_level", "n_comm_per_level",
                                  "delta_n_per_level",
                                  "aggregation_per_level"), f"{name} louvain")
        info.update(_summary(plp_k, lv_k, g))
        paths = lv_k.aggregation_per_level
        log(f"[main] {name}: PLP pallas {info['plp_s']:.2f} s / ell "
            f"{info['plp_ell_s']:.2f} s ({plp_k.iterations} iterations, "
            f"{info['plp_communities']} communities); Louvain pallas "
            f"{info['louvain_s']:.2f} s / ell {info['louvain_ell_s']:.2f} s, "
            f"Q={lv_k.modularity!r}, {lv_k.levels} levels, "
            f"{lv_k.n_communities} communities; pallas == ell in labels, "
            f"iterations, levels and every history")
        log(f"[main] {name}: per level communities {lv_k.n_comm_per_level}, "
            f"sweeps {lv_k.sweeps_per_level}, aggregation {paths} (binned "
            f"{paths.count('binned')}, sort fallback "
            f"{paths.count('sort_fallback')}); Louvain timer "
            f"{ {k: round(v, 3) for k, v in lv_k.timer.totals.items()} }")
    out = {"graphs": {k: v[2] for k, v in graphs.items()},
           "launches": launches, "peak_mem_gib": peak}
    return out, recs, graphs


def phase_kernels(args, torch, rt, recs, launches):
    rec_plp, rec_lv, rec_bin = recs
    reps = args.reps
    rows_out = []

    def local_move(rec, name, kernel, plain, n_tables):
        """Compare on every recorded (graph, width) input; the totals sum
        the R-MAT graph's level-0 buckets (one main-path sweep)."""
        total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
        err, bound_kinds, detail = 0.0, {"bytes": 0.0, "operations": 0.0}, []
        for graph, width in sorted(rec.calls):
            first, last = rec.calls[(graph, width)]
            for tag, (a, kw) in (("first", first), ("last", last)):
                rows, nbr, w, *rest = a
                for wname, ww in (("unit", w), ("int1..8",
                                                int_weights(w, torch, width))):
                    ko = kernel(rows, nbr, ww, *rest, **kw)
                    po = plain(rows, nbr, ww, *rest, **kw)
                    torch.cuda.synchronize()
                    e = max(max_abs_err(ko[0], po[0]),
                            max_abs_err(ko[1], po[1]))
                    if e != 0.0:
                        fail(f"{name} {graph} W={width} ({tag} sweep, "
                             f"{wname} weights): kernel and plain differ")
                    err = max(err, e)
            rows, nbr, w, *rest = last[0]
            kw = last[1]
            k_ms = device_ms(lambda: kernel(rows, nbr, w, *rest, **kw), reps,
                             torch)
            p_ms = loop_ms(lambda: plain(rows, nbr, w, *rest, **kw), reps,
                           torch)
            R, W = nbr.shape
            n1 = rest[0].shape[0]
            valid = int((nbr < n1 - 1).sum())
            # bytes: rows, the (R, W) ids and weights and every table read
            # once; the (R,) label/candidate and flag outputs written once.
            # Operations: a weighted mode or gain argmax over a row's valid
            # entries needs no more than a sort (log2 W compares per entry)
            # and a scan (one add and one compare per entry).
            nbytes = 4 * R + 8 * R * W + 4 * n_tables * n1 + 5 * R
            b_ms, kind = bound_ms(nbytes, valid * (math.log2(W) + 2.0))
            if graph == MAIN_GRAPH[0]:
                bound_kinds[kind] += b_ms
                total["ms"] += k_ms
                total["plain_ms"] += p_ms
                total["bound_ms"] += b_ms
            detail.append({"graph": graph, "width": W, "rows": R,
                           "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                           "bound_by": kind})
            log(f"[kernels] {name} {graph} W={W} rows={R}: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({kind})")
        return total, err, bound_kinds, detail

    plp_tot, plp_err, plp_kinds, plp_det = local_move(
        rec_plp, "local_move_plp", rec_plp.fn,
        rt.lm_ref.local_move_plp_ref, 1)
    lv_tot, lv_err, lv_kinds, lv_det = local_move(
        rec_lv, "local_move_louvain", rec_lv.fn,
        rt.lm_ref.local_move_louvain_tables_ref, 4)

    if not rec_bin.calls:
        fail("bin_rank recorded no main-path call")
    bin_graph = next(iter(rec_bin.calls))   # the first graph that launched it
    (a, kw), _ = rec_bin.calls[bin_graph]
    keys, cs, cd = a
    ko = rec_bin.fn(keys, cs, cd, **kw)
    po = rt.agg_ref.bin_rank_ref(keys, cs, cd, **kw)
    torch.cuda.synchronize()
    bin_err = max_abs_err(ko, po)
    if bin_err != 0.0:
        fail("bin_rank: kernel and plain differ")
    b_k = device_ms(lambda: rec_bin.fn(keys, cs, cd, **kw), reps, torch)
    b_p = loop_ms(lambda: rt.agg_ref.bin_rank_ref(keys, cs, cd, **kw),
                  reps, torch)
    m, W = cs.shape[0], kw["width"]
    # bytes: cs, cd and the rank output once each, and the bin rows the
    # edges name (this level's communities, plus the sink row of the
    # masked edges) — not the whole (n+1)-row table, most of whose rows
    # belong to no community at a late level.  Operations: a binary search
    # per edge in a sorted row, and the rows' sort.
    rows_read = int(torch.unique(cs).numel())
    b_b, b_kind = bound_ms(12 * m + 4 * W * rows_read,
                           (m + rows_read * W) * math.log2(W))
    log(f"[kernels] bin_rank {bin_graph} W={W} edges={m} rows read "
        f"{rows_read}: kernel {b_k:.4f} ms, plain {b_p:.4f} ms, bound "
        f"{b_b:.4f} ms ({b_kind})")

    def row(name, source, replaces, tot, err, kinds, detail):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": tot["ms"], "kernel_ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": max(kinds, key=kinds.get),
                "library_ms": None, "equal": err == 0.0, "per_width": detail}

    rows_out.append(row(
        "local_move_plp", "src/repro_torch/kernels/csrc/local_move_plp.cu",
        "src/repro/kernels/local_move/kernel.py:192", plp_tot, plp_err,
        plp_kinds, plp_det))
    rows_out.append(row(
        "local_move_louvain",
        "src/repro_torch/kernels/csrc/local_move_louvain.cu",
        "src/repro/kernels/local_move/kernel.py:386", lv_tot, lv_err,
        lv_kinds, lv_det))
    rows_out.append(row(
        "bin_rank", "src/repro_torch/kernels/csrc/bin_rank.cu",
        "src/repro/kernels/aggregation/kernel.py:62",
        {"ms": b_k, "plain_ms": b_p, "bound_ms": b_b}, bin_err, {b_kind: b_b},
        [{"graph": bin_graph, "width": W, "edges": m, "rows_read": rows_read,
          "ms": b_k, "plain_ms": b_p, "bound_ms": b_b, "bound_by": b_kind}]))
    return rows_out


def phase_profile(torch, rt, name, g, top: int = 15):
    """One ``louvain(backend="pallas")`` run of ``g`` under
    ``torch.profiler``: device time by kernel name (largest first) and the
    device's busy share of the traced wall time.  The profiler adds host
    overhead, so this run's wall time is not the main path's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.louvain(g, rt.LouvainConfig(backend="pallas"))
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3

    by_name: dict = {}
    for e in device_events(prof):
        us, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    rows = [{"op": k, "device_ms": us / 1e3, "calls": calls}
            for k, (us, calls) in sorted(by_name.items(),
                                         key=lambda kv: -kv[1][0])[:top]]
    log(f"[profile] {name} louvain(pallas) under the profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for r in rows:
        log(f"[profile]   {r['device_ms']:10.2f} ms  {r['calls']:7d}x  "
            f"{r['op'][:90]}")
    return {"graph": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top_ops": rows}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--profile", action="store_true",
                   help="also trace one Louvain run of the first graph")
    p.add_argument("--out", default=None,
                   help="also write every measurement to this JSON file")
    args = p.parse_args(argv)

    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.graph.datasets as datasets
        from repro_torch.core.louvain import LouvainConfig, louvain
        from repro_torch.core.plp import PLPConfig, plp
        from repro_torch.graph.ell import build_ell
        from repro_torch.kernels import build
        from repro_torch.kernels.aggregation import kernel as agg_kernel
        from repro_torch.kernels.aggregation import ops as agg_ops
        from repro_torch.kernels.aggregation import ref as agg_ref
        from repro_torch.kernels.local_move import kernel as lm_kernel
        from repro_torch.kernels.local_move import ops as lm_ops
        from repro_torch.kernels.local_move import ref as lm_ref
    except ImportError as err:
        fail(f"the repro_torch package is not next to this script ({err})")
    rt = argparse.Namespace(
        datasets=datasets, LouvainConfig=LouvainConfig, louvain=louvain,
        PLPConfig=PLPConfig, plp=plp, build_ell=build_ell,
        agg_kernel=agg_kernel, agg_ops=agg_ops, agg_ref=agg_ref,
        lm_kernel=lm_kernel, lm_ops=lm_ops, lm_ref=lm_ref)
    t0 = time.perf_counter()
    name, count, card = phase_device(torch)
    phase_build(build)
    main_out, recs, graphs = phase_main(torch, rt)
    kernels = phase_kernels(args, torch, rt, recs, main_out["launches"])
    if args.profile:
        main_out["profile"] = phase_profile(
            torch, rt, MAIN_GRAPH[0], graphs[MAIN_GRAPH[0]][0])
    main_out["total_s"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "device": name, "main": main_out,
             "kernels": kernels}, indent=1, default=str))
    log(f"[done] {main_out['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

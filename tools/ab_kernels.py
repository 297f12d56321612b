#!/usr/bin/env python3
"""Time one CUDA kernel family of several source trees, interleaved.

    python3 tools/ab_kernels.py KERNEL [--widths=64,...] [--sets=traced,...] \
        [--block-rows=128,...] [--blocks=512,...] [--unchecked=LABEL,...] \
        LABEL=CSRC_DIR LABEL=CSRC_DIR ...

KERNEL is ``local_move`` (the resident ``local_move_plp`` and
``local_move_louvain`` kernels, on seeded random inputs at the as-skitter
stand-in's level-0 shapes: tables of 2^21 + 1 entries; W = 16, 64, 256,
1024 buckets of 810 488, 118 136, 54 888 and 25 624 rows; 50 launches a
timing; five input sets per width: ``scattered`` — 30 % padding slots
anywhere in the row, labels from 2^19 ids (runs of one), unit weights;
``prefix`` — each row's valid slots a prefix of W/4 < d <= W slots, as a
level-0 bucket holds them, labels from 2^19 ids, uniform(0.5, 1.5)
weights; ``long_runs`` — the same prefixes with labels from 8 ids, so
each row holds a few long runs, uniform(0.5, 1.5) weights; ``one_run``
— the same prefixes all of one label, a single run of d slots, as rows
of a converged PLP sweep nearly are; ``traced`` — the layout of a coarse
level's traced tile (``graph/ell.py traced_ell_tile``): the first half of
the rows live and vertex-aligned (row v holds vertex v), the second half
dead (row id and every slot the sentinel, weight 0), live degrees drawn
heavy-tailed (1 + Pareto(1.0), capped at W) as a prefix of the row with
one masked self-loop (a sentinel slot) among them, labels from 2^19 ids,
uniform(0.5, 1.5) weights; at each width's rows and at the as-skitter
stand-in's coarse tile, W = 64 with 2^21 rows; and ``late_coarse``, at
that coarse tile's shape only — a late coarse level of the as-skitter
stand-in as ``chip_smoke.py`` logs it: 1 087 552 live rows, of which
one in a hundred holds a ``traced`` prefix and the rest nothing but the
masked loop),
``local_move_streamed`` (the streamed ``local_move_plp_streamed`` and
``local_move_louvain_streamed`` kernels at the com-dblp stand-in's W = 16
bucket: 316 776 rows, tables of 317 081 entries, windows from
``graph/ell.py compute_windows`` at ``--block-rows``, default
``stream_block_rows(16)``; 50 launches a timing; Louvain under both
singleton rules; five input sets, each over banded ids — the rows hold
ascending vertex ids, each neighbour within 60 ids of its row, so the
windows stay narrow as on the locality-ordered bucket: ``prefix``,
``long_runs`` and ``one_run`` as for ``local_move``; ``clipped`` — the
``prefix`` tiles with 2 % of the real slots moved, after the windows were
computed, to ids below or above their block's window, which both the
kernel and the plain version clamp into it; ``dead_tail`` — the
``prefix`` tiles with their last quarter of rows dead: row id and every
slot the sentinel, weight 0),
``label_argmax`` and ``delta_q`` (the scored-tile kernels of the two-step
path, on seeded (R, W) tiles at the as-skitter stand-in's four level-0
bucket shapes, as for ``local_move``; 50 launches a timing; sentinel 2^21;
uniform(0.5, 1.5) weights; six sets per width: ``scattered``, ``prefix``,
``long_runs`` and ``one_run`` as for ``local_move`` but with the labels in
the tile, ``all_distinct`` — every slot valid and a different label (W
runs of one), and ``padding_rows`` — the ``prefix`` tiles with a quarter
of the rows holding no valid slot under the sentinel key; the current
label is the row's first slot's on half the rows; ``delta_q`` with
per-slot volumes and sizes, under both singleton rules),
``flash_attention_fwd`` (the float32 kernel, on seeded float32 inputs,
causal, at the qwen3-1.7b prefill shape of ``chip_smoke.py`` (2, 16, 4096,
128), 20 launches a timing, and at one prefill_32k sequence (1, 16, 32768,
128), 3 launches; a tree whose C entry still takes a dtype code, as
4aab1e7's and older do, is passed 0, float32) or
``flash_attention_fwd_wgmma`` (the bf16 tensor-core kernel, the same
shapes on bf16 inputs),
``block_segment_sums`` (the block pass of ``sorted_segment_sum`` at
``--blocks``, default 512 and 256; float32 values from a normal draw,
so the trees must agree on the order of their adds; keys padded with
INT32_MAX to a block multiple, as the entry pads them; 50 launches a
timing; three sets: ``skitter`` — the src-sorted edge sources of the
as-skitter stand-in at scale 1.0 (``graph/datasets.py``; 28.45 M keys,
hub runs of tens of thousands), ``distinct`` — as many keys, all
different, and ``one_run`` — as many keys, each key block one run) or
``bin_rank`` (the rank pass of the binned aggregation at the com-dblp
stand-in's third cascade stage: a table of 19 819 rows, the last the
sink, of which 10 000 hold keys, 127 409 edges; W = 16, 64 and 256; each
live row holds 1..W distinct keys below the 19 818 communities; the
edges come in runs of 1–40 (a source vertex's edges), each run on one
row, every live row named, 5 % of the runs masked onto the sink row, and
each edge names one of its row's keys; two sets: ``grouped`` — the runs
one after another, as a src-sorted coarse graph gives them, and
``shuffled`` — the same edges in a random order; 200 launches a timing;
and the launch floor: a one-element ``add_`` timed the same way).

Each CSRC_DIR holds the family's ``.cu`` sources and the headers they
include (``src/repro_torch/kernels/csrc`` of a checkout; an older
commit's with ``git archive <commit> src/repro_torch/kernels/csrc | tar
-x -C <dir>``).  Each tree is built with the flags of
``kernels/build.py`` into ``build/ab/<label>/``, every tree runs the same
inputs, the outputs of all trees must be equal, and each kernel is timed
in the order A B ... B A by ``chip_smoke.py``'s ``device_ms``: CUDA events
over back-to-back launches enqueued behind a spin kernel, so the host's
enqueue time is not in the time.
The flash kernels' contracts are tolerances, so their trees' outputs are
each held to ``attention_ref`` instead (float32 within rtol = atol = 1e-5,
bf16 within one bf16 ulp of the larger value plus 1e-6, at the prefill
shape; at 32 768 keys, whose float32 scores alone take 64 GiB, only
finite) and may differ from each other.  ``--unchecked`` names trees
that are timed but whose outputs are not compared: variant trees with a
part of the kernel taken out, to split its time by removal.  Needs one
CUDA card and ``nvcc``.
"""
import argparse
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import device_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SOURCES = {"local_move": ("local_move_plp", "local_move_louvain"),
           "label_argmax": ("label_argmax",),
           "delta_q": ("delta_q",),
           "local_move_streamed": ("local_move_plp_streamed",
                                   "local_move_louvain_streamed"),
           "flash_attention_fwd": ("flash_attention_fwd",),
           "flash_attention_fwd_wgmma": ("flash_attention_fwd_wgmma",),
           "block_segment_sums": ("block_segment_sums",),
           "bin_rank": ("bin_rank",)}
N = 2_097_152
# the com-dblp stand-in's W = 16 bucket: rows, vertices (the sentinel)
DBLP_ROWS, DBLP_N = 316_776, 317_080
# the com-dblp stand-in's third cascade stage: communities (the sink row
# and the empty key), edges, rows that hold keys
BIN_N, BIN_EDGES, BIN_LIVE = 19_818, 127_409, 10_000
INT32_MAX = 2**31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int


def compile_trees(trees, sources):
    procs, libs = [], {}
    for label, csrc in trees:
        out_dir = ROOT / "build" / "ab" / label
        out_dir.mkdir(parents=True, exist_ok=True)
        for k in sources:
            out = out_dir / f"lib{k}.so"
            procs.append((label, k, out, subprocess.Popen(
                [build.nvcc(), *build.flags(k), "-o", str(out),
                 str(Path(csrc) / f"{k}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for label, k, out, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for {label} {k}:\n{text}")
        libs[(label, k)] = ctypes.CDLL(str(out))
    return libs


def entry(lib, name, argtypes, args):
    """A call of ``<name>_launch`` with ``args`` that exits on an error."""
    f = getattr(lib, f"{name}_launch")
    f.argtypes, f.restype = argtypes, _I

    def run():
        err = f(*args)
        if err:
            sys.exit(f"{name} launch failed: cudaError {err}")
    return run


def ab(labels, launcher, outputs, what, reps, check=None, unchecked=()):
    """Runs every tree once and checks ``outputs`` — equal across the
    trees, or each passing ``check(outputs)`` where one is given; trees in
    ``unchecked`` are left out — then times each tree in the order A B ...
    B A with ``chip_smoke.device_ms``."""
    outs = []
    for label in labels:
        launcher(label)()
        torch.cuda.synchronize()
        if label not in unchecked:
            outs.append([t.clone() for t in outputs])
    if check is None:
        ok = all(torch.equal(x, y) for o in outs for x, y in zip(o, outs[0]))
        verdict = f"outputs equal: {ok}"
    else:
        ok = all(check(o) for o in outs)
        verdict = f"outputs within tolerance: {ok}"
    times = {label: [] for label in labels}
    for label in labels + labels[::-1]:
        times[label].append(device_ms(launcher(label), reps, torch))
    print(f"{what}, {reps} launches a timing: {verdict}; ms "
          + ", ".join(f"{lb} {t[0]:.4f} / {t[1]:.4f}"
                      for lb, t in times.items()), flush=True)
    if not ok:
        sys.exit(1)


def local_move_inputs(rng, W, R, kind):
    """(rows, nbr, w) of one input set (module docstring)."""
    if kind in ("traced", "late_coarse"):
        live = R // 2 if kind == "traced" else 1_087_552
        rows = np.full(R, N, np.int32)
        rows[:live] = np.arange(live)
        deg = np.minimum(W, 1 + rng.pareto(1.0, live).astype(np.int64))
        if kind == "late_coarse":
            deg[rng.random(live) >= 0.01] = 1          # the loop alone
        nbr = rng.integers(0, N, (R, W)).astype(np.int32)
        nbr[live:] = N
        nbr[:live][np.arange(W)[None, :] >= deg[:, None]] = N
        nbr[np.arange(live), rng.integers(0, deg)] = N    # the masked loop
        w = np.where(nbr < N, rng.uniform(0.5, 1.5, (R, W)), 0.0)
        return rows, nbr, w.astype(np.float32)
    rows = rng.choice(N, R, replace=False).astype(np.int32)
    if kind == "scattered":
        nbr = rng.integers(0, N, (R, W)).astype(np.int32)
        nbr[rng.random((R, W)) < 0.3] = N
        return rows, nbr, (nbr < N).astype(np.float32)
    deg = rng.integers(W // 4 + 1, W + 1, R)
    nbr = rng.integers(0, N, (R, W)).astype(np.int32)
    nbr[np.arange(W)[None, :] >= deg[:, None]] = N
    w = np.where(nbr < N, rng.uniform(0.5, 1.5, (R, W)), 0.0)
    return rows, nbr, w.astype(np.float32)


def local_move(libs, labels, dev, widths=None, sets=None):
    rng = np.random.default_rng(0)

    def card(x):
        return torch.from_numpy(x).to(dev)

    tabs = [card(np.append(rng.integers(0, N // 4, N), N).astype(np.int32)),
            card(np.append(rng.integers(1, 50, N), 0).astype(np.float32)),
            card(np.append(rng.integers(1, 3, N), 0).astype(np.int32)),
            card(np.append(rng.integers(1, 9, N), 0).astype(np.float32))]
    # the label / community tables of the long-run inputs: 8 ids, 1 id
    tables = {"long_runs": card(np.append(rng.integers(0, 8, N), N).astype(
                  np.int32)),
              "one_run": card(np.append(np.full(N, 3), N).astype(np.int32))}
    inv = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    cases = list(itertools.product(
        ((16, 810_488), (64, 118_136), (256, 54_888), (1024, 25_624)),
        ("scattered", "prefix", "long_runs", "one_run", "traced")))
    for (W, R), kind in cases + [((64, N), "traced"),
                                 ((64, N), "late_coarse")]:
        if (widths and W not in widths) or (sets and kind not in sets):
            continue
        rows, nbr, w = (card(x) for x in local_move_inputs(rng, W, R, kind))
        lab = tables.get(kind, tabs[0])
        best = torch.empty(R, dtype=torch.int32, device=dev)
        prop = torch.empty(R, dtype=torch.bool, device=dev)
        out = (best.data_ptr(), prop.data_ptr(), stream)
        head = (rows.data_ptr(), nbr.data_ptr(), w.data_ptr())

        def plp(label):
            return entry(libs[(label, "local_move_plp")], "local_move_plp",
                         [_P] * 4 + [ctypes.c_uint32, ctypes.c_float, _I,
                                     ctypes.c_longlong, _I, _P, _P, _P],
                         (*head, lab.data_ptr(), 7, 1e-10, N, R, W, *out))

        def louvain(label):
            return entry(libs[(label, "local_move_louvain")],
                         "local_move_louvain",
                         [_P] * 8 + [_I, _I, ctypes.c_longlong, _I, _P, _P,
                                     _P],
                         (*head, lab.data_ptr(),
                          *(t.data_ptr() for t in tabs[1:]),
                          inv.data_ptr(), 1, N, R, W, *out))

        for k, launcher in (("local_move_plp", plp),
                            ("local_move_louvain", louvain)):
            ab(labels, launcher, (best, prop),
               f"{k} W={W} rows={R} {kind}", 50)


def streamed_inputs(rng, R, n, kind):
    """(rows, nbr, w) of one ``local_move_streamed`` set at W = 16 over
    banded ids (module docstring); ``clipped`` is moved off its windows by
    ``clip_off_windows`` once they are computed."""
    W = 16
    rows = np.sort(rng.choice(n, R, replace=False)).astype(np.int32)
    deg = rng.integers(W // 4 + 1, W + 1, R)
    nbr = np.clip(rows[:, None] + rng.integers(-60, 61, (R, W)), 0,
                  n - 1).astype(np.int32)
    nbr[np.arange(W)[None, :] >= deg[:, None]] = n
    if kind == "dead_tail":
        rows[R - R // 4:] = n
        nbr[R - R // 4:] = n
    w = np.where(nbr < n, rng.uniform(0.5, 1.5, (R, W)), 0.0)
    return rows, nbr, w.astype(np.float32)


def clip_off_windows(rng, nbr, n, win):
    """Moves 2 % of the real slots of ``nbr`` to ids below or above their
    block's window [lo, lo + 2·slot) (those that stay in [0, n))."""
    R = nbr.shape[0]
    lo = (win.win_blk.cpu().numpy().astype(np.int64)
          * win.slot).repeat(win.block_rows)[:R, None]
    pick = (nbr < n) & (rng.random(nbr.shape) < 0.02)
    below = rng.random(nbr.shape) < 0.5
    off = rng.integers(1, 50, nbr.shape)
    moved = np.where(below, lo - off, lo + 2 * win.slot - 1 + off)
    pick &= (moved >= 0) & (moved < n)
    nbr = nbr.copy()
    nbr[pick] = moved[pick]
    return nbr, int(pick.sum())


def local_move_streamed(libs, labels, dev, sets=None, block_rows=None):
    from repro_torch.graph.ell import compute_windows, stream_block_rows

    rng = np.random.default_rng(0)
    R, n, W = DBLP_ROWS, DBLP_N, 16
    kinds = ("prefix", "long_runs", "one_run", "clipped", "dead_tail")

    def card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    tabs = [card(np.append(rng.integers(0, n, n), n).astype(np.int32)),
            card(np.append(rng.integers(1, 50, n), 0).astype(np.float32)),
            card(np.append(rng.integers(1, 3, n), 0).astype(np.int32)),
            card(np.append(rng.integers(1, 9, n), 0).astype(np.float32))]
    tables = {"long_runs": card(np.append(rng.integers(0, 8, n), n).astype(
                  np.int32)),
              "one_run": card(np.append(np.full(n, 3), n).astype(np.int32))}
    inv = torch.tensor(1e-6, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for br, kind in itertools.product(block_rows or [stream_block_rows(W)],
                                      kinds):
        if sets and kind not in sets:
            continue
        # the same inputs at every block size
        krng = np.random.default_rng([1, kinds.index(kind)])
        rows_np, nbr_np, w_np = streamed_inputs(krng, R, n, kind)
        rows, nbr = card(rows_np), card(nbr_np)
        win = compute_windows(rows, nbr, n, br)
        what = f"W={W} rows={R} block_rows={br} slot={win.slot} {kind}"
        if kind == "clipped":
            nbr_np, moved = clip_off_windows(krng, nbr_np, n, win)
            nbr = card(nbr_np)
            what += f" ({moved} slots off their window)"
        w = card(w_np)
        lab = tables.get(kind, tabs[0])
        best = torch.empty(R, dtype=torch.int32, device=dev)
        prop = torch.empty(R, dtype=torch.bool, device=dev)
        out = (best.data_ptr(), prop.data_ptr(), stream)
        head = (rows.data_ptr(), nbr.data_ptr(), w.data_ptr())
        blocks = (win.win_blk.data_ptr(), win.slot, win.block_rows)

        def plp(label):
            name = "local_move_plp_streamed"
            return entry(libs[(label, name)], name,
                         [_P] * 5 + [_I, ctypes.c_longlong, ctypes.c_uint32,
                                     ctypes.c_float, _I, ctypes.c_longlong,
                                     _I, _P, _P, _P],
                         (*head, lab.data_ptr(), *blocks, 7, 1e-10, n, R, W,
                          *out))

        def louvain(rule):
            def launcher(label):
                name = "local_move_louvain_streamed"
                return entry(libs[(label, name)], name,
                             [_P] * 9 + [_I, ctypes.c_longlong, _I, _I,
                                         ctypes.c_longlong, _I, _P, _P, _P],
                             (*head, lab.data_ptr(),
                              *(t.data_ptr() for t in tabs[1:]),
                              inv.data_ptr(), *blocks, rule, n, R, W, *out))
            return launcher

        for k, launcher in (("local_move_plp_streamed", plp),
                            ("local_move_louvain_streamed rule=1",
                             louvain(1)),
                            ("local_move_louvain_streamed rule=0",
                             louvain(0))):
            ab(labels, launcher, (best, prop), f"{k} {what}", 50)


TILE_SETS = ("scattered", "prefix", "long_runs", "one_run", "all_distinct",
             "padding_rows")


def tile_inputs(rng, W, R, kind):
    """(keys, lab, w, cur) of one scored-tile set (module docstring)."""
    keys = rng.choice(N, R, replace=False).astype(np.int64)
    slot = np.arange(W)[None, :]
    if kind == "scattered":
        pad = rng.random((R, W)) < 0.3
    elif kind == "all_distinct":
        pad = np.zeros((R, W), bool)
    else:
        pad = slot >= rng.integers(W // 4 + 1, W + 1, R)[:, None]
    if kind == "long_runs":
        lab = rng.integers(0, 8, (R, W))
    elif kind == "one_run":
        lab = np.full((R, W), 3)
    elif kind == "all_distinct":      # an odd stride keeps them distinct
        perm = np.argsort(rng.random((R, W)), axis=1)
        lab = (rng.integers(0, N, R)[:, None] + 7919 * perm) % N
    else:
        lab = rng.integers(0, 1 << 19, (R, W))
    # the current label: the row's first slot's or another, half and half
    cur = np.where(rng.random(R) < 0.5, lab[:, 0],
                   rng.integers(0, 1 << 19, R))
    if kind == "padding_rows":
        dead = rng.random(R) < 0.25
        pad[dead] = True
        keys[dead] = N
        cur[dead] = N
    lab = np.where(pad, N, lab)
    w = np.where(pad, 0.0, rng.uniform(0.5, 1.5, (R, W)))
    return (keys.astype(np.int32), lab.astype(np.int32),
            w.astype(np.float32), cur.astype(np.int32))


def scored_tiles(libs, labels, dev, name, widths=None, sets=None):
    """``label_argmax`` or ``delta_q`` on seeded tiles at the as-skitter
    stand-in's level-0 bucket shapes (module docstring)."""
    rng = np.random.default_rng(0)

    def card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    stream = torch.cuda.current_stream().cuda_stream
    inv = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    for (W, R), kind in itertools.product(
            ((16, 810_488), (64, 118_136), (256, 54_888), (1024, 25_624)),
            TILE_SETS):
        if (widths and W not in widths) or (sets and kind not in sets):
            continue
        keys, lab, w, cur = (card(x) for x in tile_inputs(rng, W, R, kind))
        what = f"{name} W={W} rows={R} {kind}"
        if name == "label_argmax":
            outs = (torch.empty(R, dtype=torch.int32, device=dev),
                    torch.empty(R, dtype=torch.float32, device=dev),
                    torch.empty(R, dtype=torch.float32, device=dev))

            def launcher(label):
                return entry(libs[(label, name)], name,
                             [_P] * 4 + [ctypes.c_uint32, ctypes.c_float, _I,
                                         ctypes.c_longlong, _I, _P, _P, _P,
                                         _P],
                             (lab.data_ptr(), w.data_ptr(), cur.data_ptr(),
                              keys.data_ptr(), 7, 1e-10, N, R, W,
                              *(o.data_ptr() for o in outs), stream))
            ab(labels, launcher, outs, what, 50)
            continue
        pad = lab == N
        vol_c = card(rng.integers(1, 50, (R, W))).float().masked_fill(pad, 0)
        size_c = card(rng.integers(1, 3, (R, W))).int().masked_fill(pad, 0)
        terms = (card(rng.integers(1, 9, R)).float(),        # deg
                 card(rng.integers(1, 50, R)).float(),       # vol(A)
                 card(rng.integers(1, 3, R)).int())          # |A|
        outs = (torch.empty(R, dtype=torch.int32, device=dev),
                torch.empty(R, dtype=torch.float32, device=dev))
        for rule in (1, 0):
            def launcher(label, rule=rule):
                return entry(libs[(label, name)], name,
                             [_P] * 9 + [_I, _I, ctypes.c_longlong, _I, _P,
                                         _P, _P],
                             (lab.data_ptr(), w.data_ptr(), vol_c.data_ptr(),
                              size_c.data_ptr(), cur.data_ptr(),
                              *(t.data_ptr() for t in terms), inv.data_ptr(),
                              rule, N, R, W,
                              *(o.data_ptr() for o in outs), stream))
            ab(labels, launcher, outs, f"{what} rule={rule}", 50)


def within_bf16_ulp(a, r) -> bool:
    """|a - r| within one bf16 ulp of the larger of the two plus 1e-6
    everywhere (``chip_smoke.py``'s bound for the bf16 kernel)."""
    a, r = a.float(), r.float()
    e = torch.frexp(torch.maximum(a.abs(), r.abs())).exponent
    return bool(((a - r).abs()
                 <= torch.ldexp(torch.ones_like(a), e - 8) + 1e-6).all())


def takes_dtype(csrc) -> bool:
    """Whether a tree's float32 flash kernel has the C entry of 4aab1e7
    and older, with a dtype code between D and causal."""
    text = (Path(csrc) / "flash_attention_fwd.cu").read_text()
    return "int D, int dtype, int causal" in " ".join(text.split())


def flash_attention_fwd(libs, trees, dev, name="flash_attention_fwd"):
    """The float32 kernel on float32 inputs, or with
    ``name="flash_attention_fwd_wgmma"`` the bf16 tensor-core kernel on
    bf16 inputs."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    wgmma = name == "flash_attention_fwd_wgmma"
    dt = torch.bfloat16 if wgmma else torch.float32
    labels = [label for label, _ in trees]
    old_entry = {label: not wgmma and takes_dtype(csrc)
                 for label, csrc in trees}
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, reps in (((2, 16, 4096, 128), 20), ((1, 16, 32768, 128), 3)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dt)
                   for _ in range(3))
        o = torch.empty_like(q)
        b, hq, sq, d = shape
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                hq, k.shape[1], sq, k.shape[2], d)
        tail = (1, torch.cuda.current_stream().cuda_stream)
        if sq <= 4096:
            ref = attention_ref(q, k, v, causal=True)
            check = ((lambda out, ref=ref: within_bf16_ulp(out[0], ref))
                     if wgmma else
                     (lambda out, ref=ref: bool(torch.isclose(
                         out[0], ref, rtol=1e-5, atol=1e-5).all())))
        else:        # no reference: its float32 scores take 64 GiB
            check = (lambda out: bool(torch.isfinite(out[0]).all()))

        def launcher(label):
            args = head + (0,) + tail if old_entry[label] else head + tail
            return entry(libs[(label, name)], name,
                         [_P] * 4 + [_I] * (len(args) - 5) + [_P], args)

        ab(labels, launcher, (o,), f"{name} {shape} {str(dt)[6:]} causal",
           reps, check)


def segment_keys(dev, kind, m):
    """The sorted int32 keys of one ``block_segment_sums`` set (module
    docstring; ``one_run`` divides them by the block); ``m`` is the
    ``skitter`` set's length."""
    if kind == "skitter":
        from repro_torch.graph import datasets
        return datasets.load("as-skitter", scale=1.0, device=dev).graph.src
    return torch.arange(m, dtype=torch.int32, device=dev)


def block_segment_sums(libs, labels, dev, sets=None, blocks=None,
                       unchecked=()):
    stream = torch.cuda.current_stream().cuda_stream
    m = None
    for kind in ("skitter", "distinct", "one_run"):
        keys = segment_keys(dev, kind, m)
        m = keys.numel()
        if sets and kind not in sets:
            continue
        gen = torch.Generator(device=dev).manual_seed(0)
        vals = torch.randn(m, generator=gen, device=dev)
        for block in blocks or (512, 256):
            kb = keys // block if kind == "one_run" else keys
            pad = (-m) % block
            kp = torch.cat([kb, kb.new_full((pad,), INT32_MAX)])
            vp = torch.cat([vals, vals.new_zeros(pad)])
            out = torch.empty_like(vp)
            runs = int(torch.unique_consecutive(kp).numel())

            def launcher(label):
                name = "block_segment_sums"
                return entry(libs[(label, name)], name,
                             [_P, _P, ctypes.c_longlong, _I, _P, _P],
                             (kp.data_ptr(), vp.data_ptr(), kp.numel(), block,
                              out.data_ptr(), stream))
            ab(labels, launcher, (out,), f"block_segment_sums {kind} "
               f"m={kp.numel()} runs={runs} block={block}", 50,
               unchecked=unchecked)


def bin_inputs(rng, W, kind):
    """(keys, cs, cd) of one ``bin_rank`` set (module docstring)."""
    n = BIN_N
    keys = np.full((n + 1, W), n, np.int32)
    live = np.sort(rng.choice(n, BIN_LIVE, replace=False))
    occ = rng.integers(1, W + 1, BIN_LIVE)
    for row, k in zip(live, occ):
        keys[row, rng.choice(W, k, replace=False)] = rng.choice(
            n, k, replace=False)
    # a run a source vertex, 1-40 edges (mean ~6.4, as 127 409 edges of
    # 19 818 vertices), each on its community's row; every live row named
    lengths = np.minimum(40, rng.geometric(1 / 6.4, 2 * BIN_EDGES // 6))
    runs = int(np.searchsorted(np.cumsum(lengths), BIN_EDGES)) + 1
    rows = np.concatenate([live, rng.choice(live, runs - BIN_LIVE)])
    rows = np.where(rng.random(runs) < 0.05, n, rng.permutation(rows))
    cs, cd = [], []
    for row, run in zip(rows, lengths[:runs]):
        held = keys[row][keys[row] != n] if row < n else np.array([n])
        cs.append(np.full(run, row))
        cd.append(rng.choice(held, run))
    cs = np.concatenate(cs)[:BIN_EDGES].astype(np.int32)
    cd = np.concatenate(cd)[:BIN_EDGES].astype(np.int32)
    if kind == "shuffled":
        order = rng.permutation(BIN_EDGES)
        cs, cd = cs[order], cd[order]
    return keys.reshape(-1), cs, cd


def bin_rank(libs, labels, dev, widths=None, sets=None, unchecked=()):
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.zeros(1, device=dev)
    print(f"launch floor (one-element add_): "
          f"{device_ms(lambda: one.add_(1), 200, torch):.4f} ms",
          flush=True)
    for W, kind in itertools.product((16, 64, 256), ("grouped", "shuffled")):
        if (widths and W not in widths) or (sets and kind not in sets):
            continue
        rng = np.random.default_rng([W, kind == "shuffled"])
        keys, cs, cd = (torch.from_numpy(x).to(dev)
                        for x in bin_inputs(rng, W, kind))
        out = torch.empty_like(cs)
        rows = int(torch.unique(cs).numel())

        def launcher(label):
            return entry(libs[(label, "bin_rank")], "bin_rank",
                         [_P, _P, _P, ctypes.c_longlong, _I, _I, _P, _P],
                         (keys.data_ptr(), cs.data_ptr(), cd.data_ptr(),
                          cs.numel(), W, BIN_N, out.data_ptr(), stream))
        ab(labels, launcher, (out,), f"bin_rank W={W} edges={cs.numel()} "
           f"rows read {rows} {kind}", 200, unchecked=unchecked)


def main(argv):
    parser = argparse.ArgumentParser(
        usage=__doc__.split("\n\n")[1].strip())
    parser.add_argument("kernel", choices=sorted(SOURCES))
    parser.add_argument("trees", nargs="+", metavar="LABEL=CSRC_DIR")
    for opt in ("--widths", "--sets", "--block-rows", "--blocks",
                "--unchecked"):
        parser.add_argument(opt, type=lambda v: v.split(","),
                            help="keep the named ones (--block-rows: the "
                            "streamed windows' rows per block; --blocks: "
                            "block_segment_sums' block sizes; --unchecked: "
                            "trees timed, outputs not compared)")
    args = parser.parse_intermixed_args(argv)
    trees = [t.split("=", 1) for t in args.trees]
    if len(trees) < 2 or any(len(t) != 2 for t in trees) \
            or not torch.cuda.is_available():
        sys.exit(__doc__)
    libs = compile_trees(trees, SOURCES[args.kernel])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    labels, dev = [t[0] for t in trees], torch.device("cuda")
    unchecked = args.unchecked or ()
    if args.kernel == "block_segment_sums":
        block_segment_sums(libs, labels, dev, args.sets,
                           args.blocks and [int(x) for x in args.blocks],
                           unchecked)
    elif args.kernel == "bin_rank":
        widths = args.widths and [int(x) for x in args.widths]
        bin_rank(libs, labels, dev, widths, args.sets, unchecked)
    elif args.kernel == "local_move":
        widths = args.widths and [int(x) for x in args.widths]
        local_move(libs, labels, dev, widths, args.sets)
    elif args.kernel in ("label_argmax", "delta_q"):
        widths = args.widths and [int(x) for x in args.widths]
        scored_tiles(libs, labels, dev, args.kernel, widths, args.sets)
    elif args.kernel == "local_move_streamed":
        local_move_streamed(libs, labels, dev, args.sets,
                            args.block_rows and [int(x)
                                                 for x in args.block_rows])
    else:
        flash_attention_fwd(libs, trees, dev, args.kernel)


if __name__ == "__main__":
    main(sys.argv[1:])

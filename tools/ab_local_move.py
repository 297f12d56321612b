#!/usr/bin/env python3
"""Time the resident local_move kernels of several source trees, interleaved.

    python3 tools/ab_local_move.py LABEL=CSRC_DIR LABEL=CSRC_DIR ...

Each CSRC_DIR holds ``local_move_plp.cu``, ``local_move_louvain.cu`` and
the headers they include (``src/repro_torch/kernels/csrc`` of a checkout;
an older commit's with ``git archive <commit> src/repro_torch/kernels/csrc
| tar -x -C <dir>``).  Each tree is built with the flags of
``kernels/build.py`` into ``build/ab/<label>/``, every tree runs the same
seeded random inputs at the as-skitter stand-in's level-0 shapes (tables
of 2^21 + 1 entries; W = 16, 64, 1024 buckets of 810 488, 118 136 and
25 624 rows), the outputs of all trees must be equal, and each kernel is
timed with CUDA events over 50 launches in the order A B ... B A.  Needs
one CUDA card and ``nvcc``.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build  # noqa: E402

KERNELS = ("local_move_plp", "local_move_louvain")
SHAPES = ((16, 810_488), (64, 118_136), (1024, 25_624))
N = 2_097_152
_P = ctypes.c_void_p


def compile_trees(trees):
    procs, libs = [], {}
    for label, csrc in trees:
        out_dir = ROOT / "build" / "ab" / label
        out_dir.mkdir(parents=True, exist_ok=True)
        for k in KERNELS:
            out = out_dir / f"lib{k}.so"
            procs.append((label, k, out, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                 str(Path(csrc) / f"{k}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for label, k, out, p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"nvcc failed for {label} {k}:\n{text}")
        libs[(label, k)] = ctypes.CDLL(str(out))
    return libs


def events_ms(fn, reps=50):
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


def main(argv):
    trees = [a.split("=", 1) for a in argv]
    if len(trees) < 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    libs = compile_trees(trees)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def card(x):
        return torch.from_numpy(x).to(dev)

    tabs = [card(np.append(rng.integers(0, N // 4, N), N).astype(np.int32)),
            card(np.append(rng.integers(1, 50, N), 0).astype(np.float32)),
            card(np.append(rng.integers(1, 3, N), 0).astype(np.int32)),
            card(np.append(rng.integers(1, 9, N), 0).astype(np.float32))]
    inv = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for W, R in SHAPES:
        rows = card(rng.choice(N, R, replace=False).astype(np.int32))
        nbr_np = rng.integers(0, N, (R, W)).astype(np.int32)
        nbr_np[rng.random((R, W)) < 0.3] = N
        nbr = card(nbr_np)
        w = torch.where(nbr < N, 1.0, 0.0).to(torch.float32)
        best = torch.empty(R, dtype=torch.int32, device=dev)
        prop = torch.empty(R, dtype=torch.bool, device=dev)

        def launcher(label, k):
            f = getattr(libs[(label, k)], f"{k}_launch")
            if k == "local_move_plp":
                f.argtypes = [_P, _P, _P, _P, ctypes.c_uint32, ctypes.c_float,
                              ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                              _P, _P, _P]
                args = (rows.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                        tabs[0].data_ptr(), 7, 1e-10, N, R, W)
            else:
                f.argtypes = [_P] * 8 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         _P, _P, _P]
                args = (rows.data_ptr(), nbr.data_ptr(), w.data_ptr(),
                        *(t.data_ptr() for t in tabs), inv.data_ptr(), 1, N,
                        R, W)
            return lambda: f(*args, best.data_ptr(), prop.data_ptr(), stream)

        for k in KERNELS:
            outs = []
            for label, _ in trees:
                launcher(label, k)()
                torch.cuda.synchronize()
                outs.append((best.clone(), prop.clone()))
            equal = all(torch.equal(o[0], outs[0][0])
                        and torch.equal(o[1], outs[0][1]) for o in outs)
            times = {label: [] for label, _ in trees}
            order = [label for label, _ in trees]
            for label in order + order[::-1]:
                times[label].append(events_ms(launcher(label, k)))
            print(f"{k} W={W} rows={R} outputs equal: {equal}; ms "
                  + ", ".join(f"{lb} {t[0]:.4f} / {t[1]:.4f}"
                              for lb, t in times.items()), flush=True)
            if not equal:
                sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1:])

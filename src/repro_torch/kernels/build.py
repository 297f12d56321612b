"""Build and load the CUDA kernels (``csrc/*.cu``) with ``nvcc`` + ``ctypes``.

Each source has a plain C interface and is compiled on its own into a shared
library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v -o lib<name>-<hash>.so <name>.cu

``-fmad=false`` keeps every float multiply and add separately rounded, as
eager PyTorch rounds them, so the kernels agree bit for bit with their
plain versions; an FMA would change last bits and reorder near-tie argmaxes.
The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  ``build()`` starts
one ``nvcc`` per source, all at once, and returns what ``-Xptxas -v``
printed (registers, shared memory, spills) for each.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` never builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

from repro_torch.utils.errors import KernelError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("local_move_plp", "local_move_louvain", "bin_rank")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

# loaded libraries, per process
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc`` in the CUDA toolkit PyTorch found."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (CUDA_HOME is unset)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + (CSRC / "common.cuh").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns the ptxas report per
    kernel built now; raises ``KernelError`` if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.parent / f".{out.stem}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{reports[name]}")
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise KernelError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise ``KernelError`` when a launch returned a CUDA error code."""
    if err != 0:
        raise KernelError(f"kernel {name} failed to launch: cudaError {err}")

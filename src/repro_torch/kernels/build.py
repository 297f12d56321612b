"""Build and load the CUDA kernels (``csrc/*.cu``) with ``nvcc`` + ``ctypes``.

Each source has a plain C interface and is compiled on its own into a shared
library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v -o lib<name>-<hash>.so <name>.cu

``-fmad=false`` keeps every float multiply and add separately rounded, as
eager PyTorch rounds them, so the kernels agree bit for bit with their
plain versions; an FMA would change last bits and reorder near-tie argmaxes.
``flash_attention_fwd_wgmma`` alone is built without it (``flags``): its
contract is one bf16 ulp against its plain version, not bit-exact parity,
and its softmax wants FMAs.  The library name carries a hash of the source,
the shared headers (``csrc/*.cuh``) and that source's flags, so an edited
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
KERNELS = ("local_move_plp", "local_move_louvain", "local_move_plp_streamed",
           "local_move_louvain_streamed", "bin_rank", "label_argmax", "delta_q",
           "block_segment_sums", "flash_attention_fwd",
           "flash_attention_fwd_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
# sources whose contract is a tolerance, not bit-exact parity: FMAs allowed
FMA_KERNELS = ("flash_attention_fwd_wgmma",)

# loaded libraries, per process
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc`` in the CUDA toolkit PyTorch found."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (CUDA_HOME is unset)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def flags(name: str) -> tuple:
    """The nvcc flags of kernel ``name``'s source."""
    if name in FMA_KERNELS:
        return tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
    return NVCC_FLAGS


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


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
        cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def entry(name: str, argtypes, suffix: str = "launch"):
    """The C function ``<name>_<suffix>`` of kernel ``name``, loaded (and
    built) at first use, with its argument types set; it returns a
    ``cudaError_t`` as an int."""
    fn = getattr(load(name), f"{name}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise ``KernelError`` when a launch returned a CUDA error code."""
    if err != 0:
        raise KernelError(f"kernel {name} failed to launch: cudaError {err}")

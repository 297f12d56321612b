"""Start the ranks of a ``torch.distributed`` process group for the
distributed drivers (``core.distributed``).

Nothing tells a program of a cluster here: ``init_group`` takes the
rendezvous (``file://`` or ``tcp://localhost:<port>``), the world size and
the rank from its caller.  ``spawn_ranks`` starts ``world_size`` processes
on this host with the ``spawn`` method (a parent that has touched CUDA
cannot fork), runs ``fn(rank, world_size, *args)`` in each inside its
group, and returns the ranks' results in rank order.  A rank that raises
ends the run: the others are stopped and the error is raised here.  The
group's ``timeout`` bounds how long a rank waits in a collective for a
peer that has gone, so a failed rank never hangs the rest.

    results = spawn_ranks(fn, 4, backend="gloo", args=(seed,))
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, world_size: int) -> None:
    """Raise unless ``backend`` can join ``world_size`` ranks here:
    ``nccl`` needs the card (it never runs on the CPU) and a card a rank
    (NCCL refuses two ranks on one card); gloo runs anywhere, several
    ranks sharing one card too."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the nccl backend needs the "
                "card; use gloo on the CPU")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"an nccl group needs a card a rank: {world_size} ranks, "
                f"{cards} cards; use gloo for several ranks on one card")


def init_group(backend: str, rank: int, world_size: int, init_method: str,
               *, timeout_s: float = 120.0):
    """``init_process_group`` with the rendezvous, rank and world size
    given, after ``check_backend``.  Each ``nccl`` rank binds its own card
    (``rank`` mod the card count).  Returns the world group."""
    check_backend(backend, world_size)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def _rank_main(rank, fn, world_size, backend, init_method, out_dir,
               timeout_s, args):
    torch.set_num_threads(1)
    init_group(backend, rank, world_size, init_method, timeout_s=timeout_s)
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn, world_size: int, *, backend: str = "gloo",
                args: tuple = (), timeout_s: float = 900.0,
                collective_timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one group; returns the results in rank order.
    ``fn`` and its results must pickle (``fn`` a module-level function).
    Raises if a rank raises or exits non-zero, and stops every
    rank if the run outlasts ``timeout_s``."""
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(fn, world_size, backend, init_method, tmp,
                  collective_timeout_s, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks outlasted {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results

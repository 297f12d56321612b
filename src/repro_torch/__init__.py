"""PyTorch + CUDA port of the ``repro`` community-detection package.

Mirrors ``src/repro/`` module for module (``graph``, ``kernels``, ``core``,
``config``, ``utils``) and imports neither JAX nor ``repro``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``; the three
hot loops of the main path (``local_move_plp``, ``local_move_louvain``,
``bin_rank``) are hand-written CUDA kernels for Hopper (``kernels/csrc``),
each with a plain PyTorch version that CPU tensors use.
"""

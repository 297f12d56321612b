"""Hand-written CUDA kernels, their plain PyTorch versions, and the dispatch
wrappers between them (port of ``repro.kernels``).

* ``local_move`` — the fused gather-and-score local move (PLP label mode,
  Louvain Eq. 1 argmax), resident and streamed table layouts: what the
  sweep engine runs.
* ``label_argmax`` — PLP move scoring only, over pre-gathered ELL tiles.
* ``delta_q`` — Louvain ΔQ scoring only, over pre-gathered candidate tiles.
* ``segment_sum`` — block-segmented sums over sorted keys with the spine
  fix-up (the GroupBy reduce).
* ``aggregation`` — the sort-free binned coarsening and its ``bin_rank``
  pass.

``label_argmax``/``delta_q`` are the scored-tile building blocks of the
two-step scoring path (gather the tiles, then score them), which the fused
``local_move`` kernels replace and agree with bit for bit.

Layout: <name>/kernel.py (the wrapper: checks, launch, launch counter),
ops.py (dispatch), ref.py (the plain version); CUDA sources in csrc/.
"""
from repro_torch.kernels import delta_q, label_argmax, local_move, segment_sum

__all__ = ["label_argmax", "delta_q", "local_move", "segment_sum"]

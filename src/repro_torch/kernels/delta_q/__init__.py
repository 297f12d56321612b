"""Louvain Eq. 1 ΔQ scoring over pre-gathered tiles: the CUDA kernel, its
plain version and the dispatch."""

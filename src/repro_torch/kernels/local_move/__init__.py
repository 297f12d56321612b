"""Fused gather-and-score local-move kernels (CUDA) with plain versions."""

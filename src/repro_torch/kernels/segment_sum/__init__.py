"""Sorted segment sum: the block kernel (CUDA) and its spine fix-up."""

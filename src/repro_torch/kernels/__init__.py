"""Hand-written CUDA kernels of the main path, their plain PyTorch versions,
and the dispatch wrappers between them."""

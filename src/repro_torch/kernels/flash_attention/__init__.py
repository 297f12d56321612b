"""Causal GQA flash attention: the CUDA kernel, its plain version and the
dispatch between them."""

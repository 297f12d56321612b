"""Causal GQA flash attention: the two CUDA kernels (bf16 on the tensor
cores, float32 on the CUDA cores), their plain version and the dispatch
between them."""

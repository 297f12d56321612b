"""Causal GQA flash attention: the two CUDA kernels (both by wgmma on the
tensor cores, bf16 and float32 in split TF32), their plain version and the
dispatch between them."""

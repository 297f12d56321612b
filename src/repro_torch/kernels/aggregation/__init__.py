"""Sort-free binned coarsening and its ``bin_rank`` kernel (CUDA)."""

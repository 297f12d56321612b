"""PLP weighted-label-mode scoring over pre-gathered tiles: the CUDA
kernel, its plain version and the dispatch."""

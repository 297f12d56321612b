"""Plain Louvain Eq. 1 ΔQ scoring over pre-gathered tiles."""

"""Community-detection algorithms: PLP (Alg. 1) and Louvain (Alg. 2 + 3)."""

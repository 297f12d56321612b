"""Community-detection algorithms: PLP (Alg. 1) and Louvain (Alg. 2 + 3),
and the batched many-graph engine over both (``louvain_batch``,
``plp_batch``)."""
from repro_torch.core.batch import louvain_batch, plp_batch

__all__ = ["louvain_batch", "plp_batch"]

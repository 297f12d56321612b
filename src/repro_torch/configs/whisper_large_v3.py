"""whisper-large-v3 [audio] — 32L (enc) + 32L (dec) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866.  Enc-dec; the conv frontend is a STUB — ``input_specs``
provides precomputed frame embeddings (B, 1500, D).  [arXiv:2212.04356; unverified]

vocab=51866 is not divisible by the 16-way 'model' axis; the divisibility-aware
sharding rules automatically replicate the embedding/unembedding instead
(133 MB replicated — acceptable; noted in DESIGN.md §7)."""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    head_dim=64, d_ff=5120, vocab_size=51866,
    activation="gelu", norm="layer", n_frames=1500,
    optimizer="adamw", grad_accum=4, kv_repeat_to=16,
)

REDUCED = CONFIG.replace(
    name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, n_frames=12,
    grad_accum=1, kv_repeat_to=1)

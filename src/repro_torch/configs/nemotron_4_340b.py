"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  GQA, squared-ReLU.  [arXiv:2402.16819; unverified]

Memory policy (DESIGN.md §7): adafactor (factored 2nd moment — AdamW f32
states would not fit 256 chips), 16-way grad accumulation (microbatch 1 per
data shard), residual activations sharded over 'model' (SP-style), int8 KV
for the 32k decode cells.  On one card the port runs it at REDUCED size, or
at its full widths with fewer layers (``chip_smoke.py`` phase 5f);
``shard_residual_embed`` only moves the residual's sharding, which one card
does not have.
"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000,
    activation="squared_relu", qk_norm=False, rope_theta=1e4,
    optimizer="adafactor", grad_accum=16, kv_repeat_to=16,
    shard_residual_embed=True, kv_cache_dtype="int8",
)

REDUCED = CONFIG.replace(
    name="nemotron-4-340b-smoke", n_layers=2, d_model=96, n_heads=4,
    n_kv_heads=2, head_dim=24, d_ff=256, vocab_size=512, grad_accum=1,
    kv_repeat_to=1, shard_residual_embed=False)

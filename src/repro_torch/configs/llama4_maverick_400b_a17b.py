"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
vocab=202048, MoE 128 experts top-1, alternating dense/MoE layers
(interleave-MoE, the Llama-4 pattern), shared expert d_ff=8192, routed expert
d_ff=8192, dense layers d_ff=16384.  Totals ~400B, ~17B active.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Memory policy: adafactor + 16-way grad accumulation + SP residual sharding +
int8 KV (same rationale as nemotron-4-340b).
"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=202048,
    n_experts=128, top_k=1, moe_every=2, d_ff_expert=8192,
    shared_expert=True, d_ff_shared=8192,
    activation="swiglu", qk_norm=False, rope_theta=5e5,
    # 40 heads % 16 != 0, so KV heads stay at 8 and the decode cache shards
    # along the SEQUENCE axis over 'model' (flash-decode style) instead of
    # the head axis — see the JAX package's launch/train_step._state_spec.
    optimizer="adafactor", grad_accum=16, kv_repeat_to=1,
    shard_residual_embed=True, kv_cache_dtype="int8",
)

REDUCED = CONFIG.replace(
    name="llama4-maverick-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, n_experts=8, d_ff_expert=32,
    d_ff_shared=32, vocab_size=512, grad_accum=1, kv_repeat_to=1,
    shard_residual_embed=False)

"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128 experts top-8 (every layer).  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8, moe_every=1, d_ff_expert=768,
    activation="swiglu", qk_norm=True, rope_theta=1e6,
    optimizer="adamw", grad_accum=8, kv_repeat_to=16,
)

REDUCED = CONFIG.replace(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=32, n_experts=8, top_k=2, d_ff_expert=32,
    vocab_size=512, grad_accum=1, kv_repeat_to=1)

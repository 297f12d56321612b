"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936,
    activation="swiglu", qk_norm=True, rope_theta=1e6,
    optimizer="adamw", grad_accum=8, kv_repeat_to=16,
)

REDUCED = CONFIG.replace(
    name="qwen3-8b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=512, grad_accum=1, kv_repeat_to=1)

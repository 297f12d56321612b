"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352.  RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352,
    activation="swiglu", qk_norm=False, rope_theta=1e4,
    optimizer="adamw", grad_accum=8, kv_repeat_to=16,
)

REDUCED = CONFIG.replace(
    name="phi3-medium-14b-smoke", n_layers=2, d_model=80, n_heads=5,
    n_kv_heads=5, head_dim=16, d_ff=160, vocab_size=512, grad_accum=1,
    kv_repeat_to=1)

"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay + ddlerp token shift.  [arXiv:2404.05892; unverified]"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    rwkv_head_dim=64, rwkv_lora_rank=64, chunk_size=128,
    optimizer="adamw", grad_accum=4,
)

REDUCED = CONFIG.replace(
    name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, rwkv_head_dim=16, rwkv_lora_rank=8,
    chunk_size=8, grad_accum=1)

"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32, full MHA) d_ff=8192,
ssm_state=64.  Mamba2 backbone + ONE shared attention block (weights tied)
invoked every 6 layers on concat(hidden, embedding).  [arXiv:2411.15242; hf]"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    shared_attn_every=6, chunk_size=128, rope_theta=1e4,
    optimizer="adamw", grad_accum=4, kv_repeat_to=16,
)

REDUCED = CONFIG.replace(
    name="zamba2-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    shared_attn_every=3, chunk_size=8, grad_accum=1, kv_repeat_to=1)

"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  Cross-attn image layers every 5th layer; the vision tower is a
STUB — ``input_specs`` provides precomputed patch embeddings (B, 1600, D).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.models.arch_config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    activation="swiglu", qk_norm=False, rope_theta=5e5,
    cross_attn_every=5, n_img_tokens=1600,
    optimizer="adamw", grad_accum=8, kv_repeat_to=16,
)

REDUCED = CONFIG.replace(
    name="llama-3.2-vision-11b-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, cross_attn_every=2,
    n_img_tokens=10, grad_accum=1, kv_repeat_to=1)

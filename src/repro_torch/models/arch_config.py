"""Unified architecture config for the assigned model zoo (a copy of the JAX
package's ``repro.models.arch_config``; the port imports nothing of it).

One frozen dataclass covers all 10 assigned architectures; family-specific
fields are optional and ignored by other families.  Families:

  dense   — decoder-only transformer (qwen3-8b/1.7b, nemotron-4-340b, phi3)
  moe     — decoder-only with routed-expert FFNs (llama4-maverick, qwen3-moe)
  vlm     — dense decoder + cross-attention layers over precomputed patch
            embeddings (llama-3.2-vision); the vision tower is a STUB —
            ``input_specs`` provides the patch embeddings directly.
  ssm     — RWKV6 "Finch" (attention-free, data-dependent decay)
  hybrid  — Zamba2: Mamba2 backbone + one shared attention block
  audio   — Whisper enc-dec; conv frontend is a STUB (precomputed frame
            embeddings), decoder is a standard causal transformer.

The config covers every family so that ``from_dict(jax_cfg.to_dict())``
round-trips; the port's ``models.api.build`` runs all six.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.config import ConfigBase


@dataclasses.dataclass(frozen=True)
class ArchConfig(ConfigBase):
    name: str = "unnamed"
    family: str = "dense"          # dense | moe | vlm | ssm | hybrid | audio

    # core transformer dims
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0              # 0 -> d_model // n_heads
    activation: str = "swiglu"     # swiglu | squared_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm: str = "rms"              # rms | layer
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0             # 0 -> dense FFN
    top_k: int = 1
    moe_every: int = 1             # 1 = every layer routed; 2 = alternate dense/moe
    d_ff_expert: int = 0
    shared_expert: bool = False
    d_ff_shared: int = 0
    capacity_factor: float = 1.25

    # VLM cross-attention
    cross_attn_every: int = 0      # every k-th layer gets a cross-attn block
    n_img_tokens: int = 0

    # SSM / RWKV / hybrid
    ssm_state: int = 0             # Mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 0     # Zamba2: shared attn block cadence
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    chunk_size: int = 128          # chunked linear-attention/SSD chunk length

    # enc-dec (audio)
    n_enc_layers: int = 0
    n_frames: int = 1500           # encoder frames emitted by the (stub) frontend

    # precision / memory policy
    dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8
    optimizer: str = "adamw"       # adamw | adafactor (big archs)
    grad_accum: int = 1            # microbatch accumulation steps
    kv_repeat_to: int = 1          # expand KV heads to >= this (TP divisibility)
    shard_residual_embed: bool = False  # shard residual D over 'model' (SP-like)

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def kv_eff(self) -> int:
        """Effective KV heads after TP-divisibility expansion."""
        k = self.n_kv_heads
        while k < self.kv_repeat_to:
            k *= 2
        return k

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def active_params(self) -> int:
        """Parameters touched per token (MoE counts top_k experts only)."""
        return _count_params(self, active_only=True)

    def total_params(self) -> int:
        return _count_params(self, active_only=False)


def _count_params(c: ArchConfig, active_only: bool) -> int:
    d, hd = c.d_model, c.hd
    embed = c.vocab_size * d * (1 if c.tie_embeddings else 2)
    attn = d * (c.n_heads * hd) + 2 * d * (c.n_kv_heads * hd) + (c.n_heads * hd) * d

    def ffn(d_ff: int) -> int:
        mults = 3 if c.activation == "swiglu" else 2
        return mults * d * d_ff

    if c.family == "ssm":  # RWKV6
        per = 0
        per += 6 * c.rwkv_lora_rank * d * 2          # ddlerp loras (r,k,v,g,w,x)
        per += 4 * d * d + d * d                     # r,k,v,g,o projections
        per += 2 * d * c.d_ff                        # channel mix (relu^2)
        return c.n_layers * per + embed
    if c.family == "hybrid":  # Zamba2
        d_in = c.ssm_expand * d
        nheads = d_in // c.ssm_head_dim
        per = d * (2 * d_in + 2 * c.ssm_state + nheads) + d_in * d  # in/out proj
        per += c.conv_width * (d_in + 2 * c.ssm_state)
        shared = (2 * d) * (c.n_heads * hd) + 2 * (2 * d) * (c.n_kv_heads * hd) \
            + (c.n_heads * hd) * d + 3 * (2 * d) * c.d_ff // 2 + c.d_ff // 2 * d
        return c.n_layers * per + shared + embed
    if c.family == "audio":
        enc = c.n_enc_layers * (attn + ffn(c.d_ff) + (2 * d * c.d_ff - ffn(c.d_ff)))
        enc = c.n_enc_layers * (attn + 2 * d * c.d_ff)
        dec = c.n_layers * (2 * attn + 2 * d * c.d_ff)   # self + cross attn
        return enc + dec + embed
    # dense / moe / vlm
    per_dense = attn + ffn(c.d_ff)
    if c.n_experts == 0:
        total = c.n_layers * per_dense
        if c.cross_attn_every:
            n_cross = c.n_layers // c.cross_attn_every
            total += n_cross * (attn + ffn(c.d_ff))
        return total + embed
    # MoE
    n_moe = c.n_layers // c.moe_every
    n_dense = c.n_layers - n_moe
    router = d * c.n_experts
    experts_all = c.n_experts * ffn(c.d_ff_expert)
    experts_act = c.top_k * ffn(c.d_ff_expert)
    shared = ffn(c.d_ff_shared) if c.shared_expert else 0
    per_moe_total = attn + router + experts_all + shared
    per_moe_act = attn + router + experts_act + shared
    per_moe = per_moe_act if active_only else per_moe_total
    return n_moe * per_moe + n_dense * per_dense + embed


# ---- shape cells (assigned input shapes; identical for every LM arch) ----

@dataclasses.dataclass(frozen=True)
class ShapeCell(ConfigBase):
    name: str = "train_4k"
    kind: str = "train"            # train | prefill | decode
    seq_len: int = 4096
    global_batch: int = 256


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)

SHAPES = {s.name: s for s in SHAPE_CELLS}


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the DESIGN.md §Arch-applicability rules."""
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k-token decode is quadratic-cost; skipped per spec"
    return True, ""

"""Model-building primitives: parameter declarations, init, norms, RoPE,
SwiGLU and the cross-entropy loss (port of ``repro.models.common``).

Parameters are declared as nested dicts of ``ParamDecl`` (shape, logical dim
names, dtype, init); ``init_params`` materialises them on a device.  Its
draws are the JAX package's bit for bit: one ``np.random.default_rng(seed)``
walked over the leaves in the order ``jax.tree.flatten`` visits a nested
dict, which is sorted keys, with the same per-leaf formulas.  So a test, or
``params_from_numpy`` fed the JAX package's tree, gives both packages the
same weights.

bf16 rounding points follow the JAX package's: a product of two bf16
tensors returns bf16 (``jnp.einsum`` does), ``rms_norm`` and ``apply_rope``
compute in float32 and cast back, and ``swiglu`` runs ``silu`` in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.structure import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    names: Tuple[Optional[str], ...]   # logical dim names (None = no sharding)
    # f32 master weights: compute casts to bf16 per layer slice through
    # ``cast_compute``
    dtype: torch.dtype = torch.float32
    init: str = "normal"               # normal | zeros | ones | embed | small
    scale: float = 1.0                 # fan-in style multiplier for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.names), (self.shape, self.names)


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


def _draw(d: ParamDecl, rng: np.random.Generator) -> np.ndarray:
    if d.init == "zeros":
        return np.zeros(d.shape, np.float32)
    if d.init == "ones":
        return np.ones(d.shape, np.float32)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(1, fan_in))
    if d.init == "embed":
        std = 0.02 * d.scale
    elif d.init == "small":
        std = 1e-3 * d.scale
    return rng.normal(0.0, std, d.shape).astype(np.float32)


def init_params(decls, seed: int = 0, *, device=None) -> Any:
    """Real parameters for ``decls``, drawn as the JAX package draws them,
    on ``device`` (the card unless the caller names another; raises when
    no card is present and none is named).  Each leaf is drawn in numpy
    and copied over at once, so the host holds one leaf at a time."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return torch.from_numpy(_draw(tree, rng)).to(device=dev,
                                                     dtype=tree.dtype)

    return walk(decls)


def params_from_numpy(tree, *, device=None) -> Any:
    """A parameter tree of numpy arrays (e.g. the JAX package's tree through
    ``np.asarray``) as tensors of the same dtypes on ``device`` (the card
    unless the caller names another)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
            t = torch.from_numpy(a.view(np.uint16).astype(np.int32) << 16)
            return t.view(torch.float32).to(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)     # a writable copy

    return tree_map(leaf, tree)


def param_count(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))


# ----------------------------------------------------------------- layers


def cast_compute(tree, dtype: torch.dtype = torch.bfloat16):
    """Cast the float32 leaves of two or more dimensions to the compute
    dtype; 1-D leaves (norm scales) stay float32.  Applied to a layer's
    slice, as the JAX package applies it inside its layer scan: casting
    the stacked tree would make the stacked (L, d) norms 2-D and cast them
    too."""
    return tree_map(
        lambda t: t.to(dtype) if (torch.is_tensor(t) and t.dtype == torch.float32
                                  and t.dim() >= 2) else t, tree)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would
    # be a host-to-device copy, which waits for the stream, at every call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e6
               ) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., seq, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       vocab_valid: Optional[int] = None) -> torch.Tensor:
    """Stable CE over (possibly padded) logits, in float32: the mean
    negative log-likelihood of ``labels``, over the positions where
    ``mask`` is set when it is given.  Vocabulary columns from
    ``vocab_valid`` on are padding and take no probability."""
    lg = logits.float()
    if vocab_valid is not None and vocab_valid < lg.shape[-1]:
        pad = torch.arange(lg.shape[-1], device=lg.device) >= vocab_valid
        lg = torch.where(pad, -1e30, lg)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

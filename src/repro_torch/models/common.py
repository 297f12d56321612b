"""Model-building primitives: parameter declarations, init, norms (RMS and
layer norm), RoPE, the MLPs (SwiGLU, squared ReLU, GELU) and the
cross-entropy loss (port of ``repro.models.common``).

Parameters are declared as nested dicts of ``ParamDecl`` (shape, logical dim
names, dtype, init); ``init_params`` materialises them on a device.  Its
draws are the JAX package's bit for bit: one ``np.random.default_rng(seed)``
walked over the leaves in the order ``jax.tree.flatten`` visits a nested
dict, which is sorted keys, with the same per-leaf formulas.  So a test, or
``params_from_numpy`` fed the JAX package's tree, gives both packages the
same weights.

bf16 rounding points follow the JAX package's: a product of two bf16
tensors returns bf16 (``jnp.einsum`` does), ``rms_norm``, ``layer_norm``
and ``apply_rope`` compute in float32 and cast back, and each MLP runs
its nonlinearity (``silu``, the squared ReLU, the tanh-approximated GELU)
in float32 and casts the result back to the input's dtype; the GELU MLP's
biases are cast to the input's dtype and added to the bf16 products.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.structure import resolve_device
from repro_torch.launch import collectives as coll
from repro_torch.launch import sharding as shd
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


def init_std(d: ParamDecl) -> float:
    """The standard deviation of a ``normal``, ``embed`` or ``small``
    leaf's zero-mean draw."""
    if d.init == "embed":
        return 0.02 * d.scale
    if d.init == "small":
        return 1e-3 * d.scale
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return d.scale / math.sqrt(max(1, fan_in))


def _draw(d: ParamDecl, rng: np.random.Generator) -> np.ndarray:
    if d.init == "zeros":
        return np.zeros(d.shape, np.float32)
    if d.init == "ones":
        return np.ones(d.shape, np.float32)
    return rng.normal(0.0, init_std(d), d.shape).astype(np.float32)


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


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


def squared_relu_mlp(x: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor) -> torch.Tensor:
    """Nemotron-4 style: relu(x W1)^2 W2."""
    h = x @ w_up
    h = torch.square(torch.relu(h.float())).to(x.dtype)
    return h @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP: GELU (tanh approximation) between two biased
    products."""
    h = x @ w_up + b_up.to(x.dtype)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ w_down + b_down.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       vocab_valid: Optional[int] = None, *,
                       vocab_axis: Optional[str] = None) -> torch.Tensor:
    """Stable CE over (possibly padded) logits, in float32: the mean
    negative log-likelihood of ``labels``, over the positions where
    ``mask`` is set when it is given.  Vocabulary columns from
    ``vocab_valid`` on are padding and take no probability.

    Under an active mesh: ``vocab_axis`` names the axis the logits'
    columns are split over (each rank holds its block; the max and the
    log-sum-exp are taken across it, and the label's logit and
    ``vocab_valid`` at global column indices), and rows split over mesh
    axes (``launch.sharding.split_rows``) make the mean one over every
    rank's rows."""
    mesh = shd.active_mesh()
    tp = vocab_axis is not None and mesh is not None \
        and mesh.axis_size(vocab_axis) > 1
    rows = shd.row_axes()
    lg = logits.float()
    width = lg.shape[-1]
    first = mesh.coord(vocab_axis) * width if tp else 0
    total = width * mesh.axis_size(vocab_axis) if tp else width
    if vocab_valid is not None and vocab_valid < total:
        pad = torch.arange(first, first + width, device=lg.device) \
            >= vocab_valid
        lg = torch.where(pad, -1e30, lg)
    if tp:
        top = mesh.max(lg.detach().amax(dim=-1), vocab_axis)
        sumexp = coll.reduce_from(torch.sum(torch.exp(lg - top[..., None]),
                                            dim=-1), mesh, vocab_axis)
        lse = top + torch.log(sumexp)
        local = labels.long() - first
        mine = (local >= 0) & (local < width)
        gold = torch.gather(lg, -1, local.clamp(0, width - 1)[..., None]
                            )[..., 0]
        gold = coll.reduce_from(torch.where(mine, gold, 0.0), mesh,
                                vocab_axis)
    else:
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if rows:
        return _mean_over_rows(nll, mask, mesh, rows)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _mean_over_rows(nll, mask, mesh, rows) -> torch.Tensor:
    """The mean of ``nll`` over every rank's rows along ``rows``: each
    rank's sum, summed over the axes (the gradient of each rank's rows
    stays its own), over the count summed alike."""
    if mask is not None:
        mask = mask.float()
        num, den = torch.sum(nll * mask), torch.sum(mask).detach()
    else:
        num = torch.sum(nll)
        den = torch.full((), nll.numel(), dtype=torch.float32,
                         device=nll.device)
    for a in rows:
        num = coll.reduce_from(num, mesh, a)
        den = mesh.sum(den, a)
    return num / torch.clamp(den, min=1.0)

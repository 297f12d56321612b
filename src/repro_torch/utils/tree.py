"""Tree helpers on nested containers of tensors (port of
``repro.utils.tree``): parameter counting, byte accounting, flat dict views.

A tree is nested dicts, NamedTuples, lists and tuples; anything else is a
leaf, and ``None`` is an empty subtree.  Leaves are visited in the order
``jax.tree.flatten`` visits the same structure: dict keys sorted,
NamedTuple fields and sequence entries in order.  ``flatten_dict`` keys
are the JAX package's: the path's dict keys, field names and indices
joined by ``sep``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree: Any, path: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf), ...]`` in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in tree_flatten_with_path(v, path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, path + (str(i),))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure;
    the other trees must have it too."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with ``leaves`` (in ``tree_leaves``
    order) in place of its own."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def param_count(tree: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def param_bytes(tree: Any) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def flatten_dict(tree: Any, sep: str = "/") -> Dict[str, Any]:
    """Flatten a tree into ``{path: leaf}``."""
    return {sep.join(p): leaf for p, leaf in tree_flatten_with_path(tree)}


def unflatten_like(template: Any, flat: Dict[str, Any], sep: str = "/"
                   ) -> Any:
    """Rebuild a tree with the structure of ``template`` from a flat
    dict."""
    leaves = []
    for path, _ in tree_flatten_with_path(template):
        key = sep.join(path)
        if key not in flat:
            raise KeyError(f"missing leaf '{key}' when unflattening")
        leaves.append(flat[key])
    return tree_unflatten(template, leaves)


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Floating tensor leaves cast to ``dtype``; the other leaves as they
    are."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)

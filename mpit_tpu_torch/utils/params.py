"""Parameter trees and the flat parameter vector (``getParameters()``).

Counterpart of ``mpit_tpu/utils/params.py``. Parameters are nested dicts of
tensors keyed like the flax tree (``{"Conv_0": {"bias", "kernel"}, ...}``).
The leaf order is ``jax.tree``'s: dict keys sorted, lists and tuples in
order. So :func:`flatten_params` lays leaves out as ``ravel_pytree`` does,
and a flat vector means the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


def _is_node(tree: Any) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_leaves(tree: Any) -> list:
    """Leaves in ``jax.tree.leaves`` order (``None`` is an empty node)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> list:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order; a path is the
    tuple of dict keys and sequence indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree) for pl in tree_leaves_with_path(t, path + (i,))]
    return [(path, tree)]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """A tree shaped like ``template`` with ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # keep the caller's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: ``fn`` over corresponding leaves of same-shaped
    trees."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(ls) != len(leaves[0]) for ls in leaves):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


@dataclasses.dataclass(frozen=True)
class FlatParamSpec:
    """Static description of a flattened tree: size, dtype, and the leaf
    shapes and dtypes :func:`unflatten_params` restores."""

    size: int
    dtype: torch.dtype
    template: Any
    shapes: tuple
    dtypes: tuple

    def __repr__(self) -> str:
        return f"FlatParamSpec(size={self.size}, dtype={self.dtype})"


def flatten_params(tree: Any) -> tuple[torch.Tensor, FlatParamSpec]:
    """Flatten a parameter tree to one 1-D vector, in ``ravel_pytree``'s
    order and dtype (leaves of mixed dtypes promote, as there)."""
    leaves = tree_leaves(tree)
    if not leaves:
        raise ValueError("cannot flatten a tree with no leaves")
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    flat = torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves])
    spec = FlatParamSpec(
        size=flat.numel(),
        dtype=dtype,
        template=tree,
        shapes=tuple(tuple(leaf.shape) for leaf in leaves),
        dtypes=tuple(leaf.dtype for leaf in leaves),
    )
    return flat, spec


def unflatten_params(spec: FlatParamSpec, flat: torch.Tensor) -> Any:
    """Inverse of :func:`flatten_params`."""
    if tuple(flat.shape) != (spec.size,):
        raise ValueError(
            f"flat vector shape {tuple(flat.shape)} does not match spec "
            f"({spec.size},)"
        )
    sizes = [math.prod(s) for s in spec.shapes]
    parts = torch.split(flat, sizes)
    leaves = [
        p.reshape(s).to(dt) for p, s, dt in zip(parts, spec.shapes, spec.dtypes)
    ]
    return tree_unflatten(spec.template, leaves)


def tree_zeros_like(tree: Any) -> Any:
    """A tree like ``tree`` with every tensor leaf zeroed (new tensors)."""
    return tree_map(torch.zeros_like, tree)

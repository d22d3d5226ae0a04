"""Nested dicts of tensors: the port's stand-in for a JAX pytree.

Params, gradients and optimiser state are nested dicts whose leaves are
tensors (or arrays, for `convert`). Leaves are visited in sorted-key
order, the order `jax.tree` flattens a dict in.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    which have `tree`'s structure; returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of `tree` in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of `like`'s structure whose leaves are `leaves`, given in
    the order `tree_leaves(like)` returns."""
    return _unflatten(like, iter(leaves))


def _unflatten(t: Any, it) -> Any:
    # Not a closure over `it`: a recursive closure is a reference cycle,
    # which would keep the leaves (a step's gradients) alive until the
    # garbage collector runs.
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    return next(it)

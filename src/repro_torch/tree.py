"""Nested dicts and lists of tensors: the port's stand-in for a JAX pytree.

Params, gradients and optimiser state are nested dicts and lists whose
leaves are tensors (or arrays, for `convert`). Leaves are visited in
JAX's flatten order: a dict's values in sorted-key order, a list's in
index order. Everything else is a leaf, tuples included: the optimiser
maps over trees whose leaves are tuples such as `(p, m, v)` and picks
their parts afterwards.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`,
    which have `tree`'s structure; returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, x, *(r[i] for r in rest))
                for i, x in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of `tree` in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
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
    if isinstance(t, list):
        return [_unflatten(x, it) for x in t]
    return next(it)

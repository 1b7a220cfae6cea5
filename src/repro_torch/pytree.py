"""Pytrees of the port: nested dicts (keys sorted, as JAX sorts them), lists,
tuples and ``None``; anything else is a leaf.

The request engine batches and ships trees of tensors with these, and the
checkpoint manager names leaves by ``tree_flatten_with_path``, whose paths
are the JAX package's (dict keys, list and tuple indices), so a
checkpoint's keys are the same in both packages.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_flatten", "tree_flatten_with_path", "tree_leaves", "tree_map",
           "tree_unflatten"]

_LEAF = "*"


def _walk(node, path: tuple, leaves: list):
    if node is None:
        return None
    if type(node) is dict:
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_walk(node[k], path + (k,), leaves) for k in keys))
    if type(node) in (list, tuple):
        return (type(node).__name__,
                tuple(_walk(c, path + (i,), leaves) for i, c in enumerate(node)))
    leaves.append((path, node))
    return _LEAF


def tree_flatten_with_path(tree) -> "tuple[list[tuple[tuple, Any]], Any]":
    """([(path, leaf)], treedef), leaves in ``tree_flatten``'s order; a path
    is the tuple of dict keys and sequence indices from the root.  The walk
    is a module-level function, not a closure over the leaves: a recursive
    closure is a reference cycle, which would keep the leaves alive until
    the garbage collector runs."""
    leaves: list = []
    treedef = _walk(tree, (), leaves)
    return leaves, treedef


def tree_flatten(tree) -> "tuple[list, Any]":
    """(leaves, treedef).  The treedef is nested tuples, hashable and
    comparable: two dicts built in different key orders flatten alike.
    ``None`` is a node without leaves; anything else is a leaf."""
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _build(d, it):
    if d is None:
        return None
    if d == _LEAF:
        return next(it)
    if d[0] == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    children = [_build(c, it) for c in d[1]]
    return children if d[0] == "list" else tuple(children)


def tree_unflatten(treedef, leaves):
    return _build(treedef, iter(leaves))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])

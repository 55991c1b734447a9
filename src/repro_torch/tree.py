"""Parameter trees: nested dicts and lists of tensors, the port's stand-in
for JAX pytrees (the CNN's ``{"conv1": {"w": ..., "b": ...}, ...}``, an
LM's ``first_dense`` list of layers).  As in JAX, dict leaves are visited
in sorted key order and list items by index, so two trees with the same
structure line up whatever order their dicts were built in."""
from __future__ import annotations

from typing import Any, Callable

import torch

Params = Any


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """Map ``fn`` over the leaves of nested dicts and lists of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """The leaves in JAX's order: sorted dict keys, list items by index."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Params, leaves) -> Params:
    """The tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_leaves_with_path(tree: Params,
                          path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in :func:`tree_leaves` order; a path holds the
    dict keys and list indices from the root (JAX's ``DictKey`` and
    ``SequenceKey`` entries)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [pair for i, t in enumerate(tree)
                for pair in tree_leaves_with_path(t, path + (i,))]
    return [(path, tree)]

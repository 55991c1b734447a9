"""Parameter trees: nested dicts of tensors, the port's stand-in for JAX
pytrees (the CNN's ``{"conv1": {"w": ..., "b": ...}, ...}``).  As in JAX,
leaves are visited in sorted key order, so two dicts with the same keys
line up whatever order they were built in."""
from __future__ import annotations

from typing import Any, Callable

import torch

Params = Any


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """Map ``fn`` over the leaves of nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """The leaves in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: Params, leaves) -> Params:
    """The tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

"""Padding a leading axis to a multiple of the mesh size (PyTorch port of
the grid / fleet part of ``repro.launch.sharding``).

A sharded sweep splits its (scenario, seed) cells, a sharded fleet
scheduler its problems and a sharded FL round its client rows into one
contiguous block a rank (:class:`repro_torch.launch.mesh.DataMesh`).  An
axis that does not divide the mesh is padded by cyclic repetition, so the
padded rows recompute real rows, and the tail is cut off after the
gather: padding never changes a result.

The JAX module's Megatron tensor-parallel rules for the LM
(``param_pspecs``, ``batch_pspecs``, ``cache_pspecs``) are not ported:
they place one model over a TPU pod's ``model`` axis, and the port's
models fit one card.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def padded_count(n: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` that is >= ``n``."""
    if n < 1 or n_shards < 1:
        raise ValueError(f"need n >= 1 and n_shards >= 1, got {n}, "
                         f"{n_shards}")
    return -(-n // n_shards) * n_shards


def _map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` over the tensors of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def pad_leading(tree: Tree, n_pad: int) -> Tree:
    """Pad every leaf's leading axis to ``n_pad`` by cyclic repetition
    (row ``i`` of the padded leaf is row ``i % n``); a leaf already
    ``n_pad`` long is returned as it is."""
    def pad(leaf):
        n = leaf.shape[0]
        if n == n_pad:
            return leaf
        return leaf[torch.arange(n_pad, device=leaf.device) % n]

    return _map(pad, tree)


def unpad_leading(tree: Tree, n: int) -> Tree:
    """Drop the padded tail: the inverse of :func:`pad_leading`."""
    return _map(lambda leaf: leaf[:n], tree)

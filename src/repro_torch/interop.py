"""Carry weights and keys between the JAX package and the port.

Both packages keep the CNN's parameters as ``{"conv1": {"w", "b"}, ...}``
in the same layouts, so moving a model across is a leaf-by-leaf copy of
numpy arrays.  The tests use these to run both packages on identical
parameters; nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import Params, tree_map


def params_from_numpy(tree, device="cpu") -> Params:
    """Nested dicts of arrays (e.g. ``jax.tree.map(np.asarray, params)``)
    -> the same dicts of float32 tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                           device=device), tree)


def params_to_numpy(params: Params):
    """Dicts of tensors -> dicts of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """A raw jax threefry key (uint32 ``[..., 2]``) -> the port's int64
    ``[..., 2]`` key."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected a uint32 [..., 2] key, got "
                         f"{arr.dtype} {arr.shape}")
    return torch.tensor(arr.astype(np.int64), device=device)

"""Carry weights and keys between the JAX package and the port.

Both packages keep their parameters as nested dicts and lists in the same
layouts (the CNN's ``{"conv1": {"w", "b"}, ...}``, the LM's ``{"embed":
{"table"}, "layers": {...}, "first_dense": [...], ...}``), so moving a
model across is a leaf-by-leaf copy of numpy arrays.  The tests use these to run both
packages on identical parameters; nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import Params, tree_map


def _leaf_to_torch(a, device) -> torch.Tensor:
    """One array in its own dtype.  numpy has no bfloat16 of its own: the
    ``ml_dtypes`` bfloat16 of a JAX array crosses through float32, which
    holds every bfloat16 value exactly."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def params_from_numpy(tree, device="cpu", keep_dtype: bool = False) -> Params:
    """Nested dicts and lists of arrays (e.g. ``jax.tree.map(np.asarray,
    params)``) -> the same tree of tensors on ``device``: float32 by default, or each
    leaf in its own dtype with ``keep_dtype`` (bfloat16 weights beside the
    float32 ``A_log`` / ``D`` / ``dt_bias`` of an LM)."""
    if keep_dtype:
        return tree_map(lambda a: _leaf_to_torch(a, device), tree)
    return tree_map(lambda a: _leaf_to_torch(a, device).to(torch.float32),
                    tree)


def params_to_numpy(params: Params):
    """A tree of tensors -> the same tree of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """A raw jax threefry key (uint32 ``[..., 2]``) -> the port's int64
    ``[..., 2]`` key."""
    arr = np.asarray(key)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected a uint32 [..., 2] key, got "
                         f"{arr.dtype} {arr.shape}")
    return torch.tensor(arr.astype(np.int64), device=device)

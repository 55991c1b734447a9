"""Parameter trees to and from ``.npz`` (PyTorch port of
``repro.checkpoint.ckpt``), in the JAX package's layout, so either package
reads the other's files:

* leaf i is stored under ``"{i:05d}|{path}"``, in :func:`tree_leaves`
  order, the path its dict keys and list indices joined by ``/``;
* a bfloat16 leaf is stored as its ``uint16`` view, the name tagged
  ``__bf16__``;
* ``__meta__`` is the UTF-8 JSON of ``{"treedef", "names", "step"}``;
  ``treedef`` describes the tree in the port's own words (JAX's loader
  does not read it).

:func:`load_pytree` restores into the structure, dtypes and devices of a
``like`` tree and checks every shape against it.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_map, tree_unflatten

PyTree = Any
_BF16_TAG = "__bf16__"


def _names(tree: PyTree) -> list[str]:
    return [f"{i:05d}|{'/'.join(map(str, path))}"
            for i, (path, _) in enumerate(tree_leaves_with_path(tree))]


def save_pytree(path: str, tree: PyTree, step: int | None = None) -> None:
    arrays, names = {}, _names(tree)
    for name, (_, leaf) in zip(names, tree_leaves_with_path(tree)):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            arrays[name + _BF16_TAG] = leaf.view(torch.int16).numpy().view(
                np.uint16)
        else:
            arrays[name] = leaf.numpy()
    # the structure, every leaf written "*"
    meta = {"treedef": repr(tree_map(lambda _: "*", tree)), "names": names,
            "step": step}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8), **arrays)


def load_pytree(path: str, like: PyTree) -> PyTree:
    """The tree saved at ``path``, shaped like ``like``: each leaf in the
    dtype and on the device of ``like``'s; raises ValueError on a shape
    that differs."""
    leaves = []
    with np.load(path) as z:
        for name, (_, leaf) in zip(_names(like), tree_leaves_with_path(like)):
            if name + _BF16_TAG in z:
                t = torch.from_numpy(z[name + _BF16_TAG].view(np.int16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(z[name])
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {name}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(like, leaves)

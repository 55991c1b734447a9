"""Sharding rules (PyTorch port of ``repro.launch.sharding``): padding a
leading axis to a multiple of the mesh size, and the LM's parameter /
batch / cache specs over a ``("data", "model")`` mesh.

A sharded sweep splits its (scenario, seed) cells, a sharded fleet
scheduler its problems and a sharded FL round its client rows into one
contiguous block a rank (:class:`repro_torch.launch.mesh.DataMesh`).  An
axis that does not divide the mesh is padded by cyclic repetition, so the
padded rows recompute real rows, and the tail is cut off after the
gather: padding never changes a result.

The LM's rules are JAX's Megatron tensor-parallel scheme over the
``"model"`` axis, batch over ``"data"``:
  * embeddings              [V, d]        -> (model, None)   (vocab padded)
  * attn wq/wk/wv           [d, H*dh]     -> (None, model)   column-parallel
  * attn wo                 [H*dh, d]     -> (model, None)   row-parallel
  * mlp gate/up             [d, ff]       -> (None, model)
  * mlp down                [ff, d]       -> (model, None)
  * MoE experts             [E, d, f]     -> (model, None, None)  expert-par
  * MoE router              [d, E]        -> replicated
  * MLA wq_b / wkv_b        [r, H*x]      -> (None, model)
  * SSM block weights                     -> replicated
  * norms / scalars                       -> replicated
Stacked ("layers/...") leaves get a leading None for the layer axis.  A
dimension shards only where the axis size divides it.

A spec is a plain tuple with one entry per dimension, as JAX's
``PartitionSpec`` holds them: None, an axis name, or a tuple of two or
more names (a one-name tuple is held as the name, an empty one as None).
The rules are pure functions of the leaves' shapes, so they run on a tree
of ``meta`` tensors; a mesh is anything with ``axis_names`` and ``shape``
(:class:`repro_torch.launch.mesh.Mesh`).  What a rank computes under these
specs is :mod:`repro_torch.models.parallel`'s.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable

import torch

Tree = Any
Spec = tuple

_SSM_LEAVES = {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "out_proj"}


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


# ------------------------------------------------------------ LM specs ---
def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (``shape`` a tuple in ``axis_names``'
    order, or a mapping of name to size)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.axis_names, mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """The axes that shard the batch (pod + data where a mesh has both)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _spec(entries) -> Spec:
    """``entries`` as ``PartitionSpec`` holds them: a one-name tuple as the
    name, an empty tuple as None."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple)
                 and len(e) == 1 else e for e in entries)


def map_with_path(fn: Callable, tree: Tree, path: tuple = ()) -> Tree:
    """``fn(path, leaf)`` over nested dicts and lists; a path holds the
    dict keys and ``"[i]"`` for list items, as JAX names its keys."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (f"[{i}]",))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _rule(names: tuple, shape: tuple, model_size: int) -> Spec:
    """The spec of one parameter leaf from its path names and shape."""
    leaf = names[-1]
    parents = set(names[:-1])

    def ok(dim):           # a dim can only shard if divisible
        return dim % model_size == 0

    if leaf == "table":
        trailing = ("model", None) if ok(shape[-2]) else (None, None)
    elif leaf in ("patch_proj", "frontend_proj"):
        trailing = (None, "model") if ok(shape[-1]) else (None, None)
    elif "ssm" in parents and leaf in _SSM_LEAVES:
        trailing = (None,) * len(shape)
    elif leaf in ("wq", "wk", "wv", "wq_b", "wkv_b"):
        trailing = (None, "model") if ok(shape[-1]) else (None, None)
    elif leaf == "wo":
        trailing = ("model", None) if ok(shape[-2]) else (None, None)
    elif leaf in ("wq_a", "wkv_a", "router"):
        trailing = (None, None)
    elif leaf in ("gate", "up", "down") and "moe" in parents \
            and len(shape) >= 3:
        trailing = (("model", None, None) if ok(shape[-3])
                    else (None, None, None))
    elif leaf in ("gate", "up"):
        trailing = (None, "model") if ok(shape[-1]) else (None, None)
    elif leaf == "down":
        trailing = ("model", None) if ok(shape[-2]) else (None, None)
    else:   # norms, biases, conv, scalars
        trailing = (None,) * len(shape)
    lead = len(shape) - len(trailing)
    if lead < 0:
        raise ValueError(f"leaf {'/'.join(names)} of shape {tuple(shape)} "
                         f"has fewer dims than its spec {trailing}")
    return (None,) * lead + tuple(trailing)


def param_pspecs(cfg, params: Tree, mesh) -> Tree:
    """The spec tree of a parameter tree (any leaves with ``.shape``)."""
    del cfg
    model_size = axis_sizes(mesh)["model"]
    return map_with_path(
        lambda path, leaf: _rule(path, tuple(leaf.shape), model_size),
        params)


def batch_pspecs(cfg, batch: Tree, mesh) -> Tree:
    """Batch tensors shard their leading (batch) dim over pod + data where
    it divides."""
    del cfg
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]

    def spec(leaf):
        lead = dp if leaf.shape[0] % dp_size == 0 else None
        return _spec((lead,) + (None,) * (len(leaf.shape) - 1))

    return map_with_path(lambda path, leaf: spec(leaf), batch)


# batch / seq dims counted from the END, so the optional leading layer axis
# never matters: k/v [.., B, S, KV, D], ckv [.., B, S, R], kpe [.., B, S,
# 1, rope], conv [.., B, w-1, ch], state [.., B, H, N, P], memory [B, S, d].
_CACHE_DIMS_FROM_END = {"k": (4, 3), "v": (4, 3), "ckv": (3, 2),
                        "kpe": (4, 3), "conv": (3, None), "state": (4, None),
                        "memory": (3, 2)}


def cache_pspecs(cfg, cache: Tree, mesh, seq_shard: bool = False) -> Tree:
    """Decode-cache specs.

    The batch dim shards over pod + data where it divides (and is above
    1).  The SEQUENCE axis of attention KV caches shards per
    ``cfg.cache_seq_shard``:
      none     — replicated over "model"
      model    — sharded over the tensor axis (flash-decoding style)
      dp_model — over data + model (batch 1 frees the data axes)
      auto     — over the data axes when ``seq_shard`` (batch 1)
    """
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    mode = cfg.cache_seq_shard
    if mode == "auto":
        seq_axes = dp if seq_shard else None
    elif mode == "model":
        seq_axes = ("model",)
    elif mode == "dp_model":
        seq_axes = tuple(dp) + ("model",)
    else:
        seq_axes = None
    seq_div = 1
    for a in (seq_axes or ()):
        seq_div *= sizes[a]

    def spec(path, leaf):
        name = path[-1]
        shp = tuple(leaf.shape)
        nd = len(shp)
        b_from_end, s_from_end = _CACHE_DIMS_FROM_END[name]
        batch_dim = nd - b_from_end
        out = [None] * nd
        seq_used: tuple = ()
        if (seq_axes and s_from_end is not None and name != "memory"
                and shp[nd - s_from_end] % seq_div == 0):
            out[nd - s_from_end] = seq_axes
            seq_used = seq_axes
        dp_free = [a for a in dp if a not in seq_used]
        dp_free_size = 1
        for a in dp_free:
            dp_free_size *= sizes[a]
        if dp_free and shp[batch_dim] % dp_free_size == 0 \
                and shp[batch_dim] > 1:
            out[batch_dim] = tuple(dp_free)
        return _spec(out)

    return map_with_path(spec, cache)

"""Decoder-only LM assembly (PyTorch port of ``repro.models.lm``), for the
dense, SSM and hybrid archs the port runs.

Per-layer weights are stacked with a leading [L] axis as in JAX; where JAX
scans the stack with ``lax.scan``, the port walks it layer by layer.
Zamba2-style hybrids run GROUPS of ``shared_attn_every`` Mamba2 layers and
apply the single SHARED attention block after each whole group, not after
the tail (one set of weights, reused: the Zamba trick).

Serving: :func:`prefill` is the one-shot prompt forward (kernels 7, 8 and
9); :func:`init_cache` and :func:`decode_step` are the cached decode
(kernel 8; attention and the SSM recurrence plain, as in JAX).
:func:`decode_step` updates the cache in place and returns it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device, rng
from repro_torch.models import blocks, layers
from repro_torch.models.config import ModelConfig, check_supported, unported
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def _layer(stack: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda w: w[i], stack)


# ------------------------------------------------------------------- init --
def _stacked_init(key: torch.Tensor, n: int, init_fn) -> PyTree:
    """``vmap(init_fn)(split(key, n))`` of the JAX package, built layer by
    layer into preallocated stacks, so no draw is ever n layers wide."""
    keys = rng.split(key, n)
    stack = None
    for i in range(n):
        layer = init_fn(keys[i])
        if stack is None:
            stack = tree_map(lambda w: w.new_empty((n,) + tuple(w.shape)),
                             layer)
        tree_map(lambda s, w: s[i].copy_(w), stack, layer)
        del layer
    return stack


def init_params(key: torch.Tensor, cfg: ModelConfig) -> PyTree:
    """Weights on ``key.device``, the same numbers as JAX's from the same
    key."""
    check_supported(cfg)
    ks = rng.split(key, 6).unbind(0)
    params: dict = {"embed": layers.embed_init(ks[0], cfg),
                    "final_norm": layers.norm_init(cfg, cfg.d_model,
                                                   key.device)}
    main_kind = cfg.layer_kinds()[-1]
    params["layers"] = _stacked_init(
        ks[1], cfg.n_layers, lambda k: blocks.BLOCK_INIT[main_kind](k, cfg))
    if cfg.arch_type == "hybrid":
        params["shared"] = blocks.dense_block_init(ks[3], cfg)
    return params


def n_params(params: PyTree) -> int:
    return sum(p.numel() for p in tree_leaves(params))


# -------------------------------------------------------------- positions --
def build_positions(cfg: ModelConfig, b: int, s: int,
                    device=None) -> torch.Tensor:
    """[B, S] int32 (plain RoPE)."""
    if cfg.mrope:
        raise unported("M-RoPE positions", "A.1e")
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


# ---------------------------------------------------------------- forward --
def _hybrid_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, every): the shared block follows each whole group."""
    if cfg.arch_type == "hybrid" and cfg.shared_attn_every:
        every = cfg.shared_attn_every
        return cfg.n_layers // every, every
    return 0, 0


def _run_layers(params, cfg: ModelConfig, x, positions):
    """The layer stack (plus the hybrid shared-block insertions)."""
    apply_fn = blocks.BLOCK_APPLY[cfg.layer_kinds()[-1]]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    _, every = _hybrid_groups(cfg)
    for i in range(cfg.n_layers):
        x, aux = apply_fn(_layer(params["layers"], i), cfg, x, positions)
        aux_total = aux_total + aux
        if every and (i + 1) % every == 0:
            x, aux = blocks.dense_block_apply(params["shared"], cfg, x,
                                              positions)
            aux_total = aux_total + aux
    return x, aux_total


def forward(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """batch {"tokens": [B, T+1]} -> (logits [B, T, V], aux); the last
    token is the target of the one before and is not an input."""
    check_supported(cfg)
    x = layers.embed_apply(params["embed"], batch["tokens"][:, :-1])
    b, s, _ = x.shape
    positions = build_positions(cfg, b, s, x.device)
    x, aux = _run_layers(params, cfg, x, positions)
    x = layers.norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_logits(params["embed"], x, cfg), aux


def prefill(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """One-shot prompt forward: batch {"tokens": [B, S]} (all inputs) ->
    the logits of the last position [B, V]."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = layers.embed_apply(params["embed"], tokens)
    positions = build_positions(cfg, b, s, x.device)
    x, _ = _run_layers(params, cfg, x, positions)
    x = layers.norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_logits(params["embed"], x[:, -1], cfg)


# ------------------------------------------------------------------ cache --
def init_cache(cfg: ModelConfig, b: int, s: int, device=None) -> PyTree:
    """Preallocated decode cache for sequence capacity ``s`` on ``device``
    (default CUDA; raises without it)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.param_dtype

    def attn_cache(lead):
        shape = lead + (b, s, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    cache: dict = {}
    if cfg.layer_kinds()[-1] == "ssm":
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        cache["layers"] = {
            "conv": torch.zeros((cfg.n_layers, b, cfg.ssm_conv_width - 1,
                                 conv_ch), dtype=dt, device=dev),
            "state": torch.zeros((cfg.n_layers, b, cfg.ssm_heads,
                                  cfg.ssm_state, cfg.ssm_head_dim),
                                 dtype=torch.float32, device=dev)}
        n_groups, _ = _hybrid_groups(cfg)
        if n_groups:
            cache["shared"] = attn_cache((n_groups,))
    else:
        cache["layers"] = attn_cache((cfg.n_layers,))
    return cache


def _store(stack: PyTree, i: int, new: PyTree) -> None:
    """Write one layer's new cache into its slot of the stack (a no-op for
    the k/v that decode_attention already wrote in place)."""
    for name, src in new.items():
        dst = stack[name][i]
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)


def decode_step(params, cfg: ModelConfig, cache: PyTree,
                token: torch.Tensor, pos: int):
    """One decode step: token [B, 1] int; pos the current index.

    Returns (logits [B, V], cache), the cache updated in place.
    """
    check_supported(cfg)
    pos = int(pos)
    x = layers.embed_apply(params["embed"], token)
    decode_fn = blocks.BLOCK_DECODE[cfg.layer_kinds()[-1]]
    _, every = _hybrid_groups(cfg)
    for i in range(cfg.n_layers):
        x, new = decode_fn(_layer(params["layers"], i), cfg, x,
                           _layer(cache["layers"], i), pos)
        _store(cache["layers"], i, new)
        if every and (i + 1) % every == 0:
            g = (i + 1) // every - 1
            x, new = blocks.dense_block_decode(
                params["shared"], cfg, x, _layer(cache["shared"], g), pos)
            _store(cache["shared"], g, new)
    x = layers.norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_logits(params["embed"], x[:, 0], cfg), cache

"""Decoder-only LM assembly (PyTorch port of ``repro.models.lm``) for the
dense, MoE, SSM, hybrid and VLM archs.

Per-layer weights are stacked with a leading [L] axis as in JAX; where JAX
scans the stack with ``lax.scan``, the port walks it layer by layer.
DeepSeek-V2's ``first_k_dense`` dense layers come first, as a list (JAX
keeps them as one), then the stack of the remaining layers.
Zamba2-style hybrids run GROUPS of ``shared_attn_every`` Mamba2 layers and
apply the single SHARED attention block after each whole group, not after
the tail (one set of weights, reused: the Zamba trick).  The VLM prepends
its projected patch embeddings to the text and rotates by M-RoPE's three
position streams (:func:`build_positions`).

Serving: :func:`prefill` is the one-shot prompt forward (kernels 7, 8 and
9); :func:`init_cache` and :func:`decode_step` are the cached decode
(kernel 8; attention and the SSM recurrence plain, as in JAX).
:func:`decode_step` updates the cache in place and returns it.  With a
:func:`repro_torch.models.parallel.local_config` the same functions run
one rank of a tensor-parallel mesh: the init draws the rank's blocks of
the whole model's numbers alone (the SSM layers whole, zamba2's shared
block split as a dense block), the cache holds the rank's KV heads (the
SSM's conv and state whole), and the logits are the rank's vocab shard.

Training: :func:`loss_fn` is the next-token NLL plus the MoE aux loss.
With ``cfg.remat`` set, a differentiated forward checkpoints each layer of
the stack (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` of the
scanned block): the backward recomputes the layer, so only its input is
kept.  Serving differentiates nothing and takes no checkpoint.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, rng
from repro_torch.models import blocks, layers, parallel
from repro_torch.models.config import ModelConfig
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
    if n == 0:      # vmap over no keys: empty stacks of the layer's shapes
        return tree_map(lambda w: w.new_empty((0,) + tuple(w.shape)),
                        init_fn(rng.split(key, 1)[0]))
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
    key; for a local config, the rank's blocks of the whole model's
    weights, each placed by ``parallel.placement`` and drawn alone
    (``parallel.draw_plan``)."""
    cfg, place = parallel.draw_plan(cfg)
    ks = rng.split(key, 6).unbind(0)
    params: dict = {
        "embed": layers.embed_init(ks[0], cfg, parallel.scope(place,
                                                              "embed")),
        "final_norm": layers.norm_init(cfg, cfg.d_model, key.device)}
    block_init = blocks.BLOCK_INIT[cfg.layer_kinds()[-1]]
    if place is not None:
        block_init = functools.partial(
            block_init, place=parallel.scope(place, "layers"))
    params["layers"] = _stacked_init(
        ks[1], cfg.n_layers - cfg.first_k_dense, lambda k: block_init(k, cfg))
    if cfg.first_k_dense:
        params["first_dense"] = [
            blocks.dense_block_init(
                rng.fold_in(ks[2], i), cfg, d_ff=cfg.d_ff_dense or cfg.d_ff,
                place=parallel.scope(place, "first_dense", f"[{i}]"))
            for i in range(cfg.first_k_dense)]
    if cfg.arch_type == "hybrid":
        params["shared"] = blocks.dense_block_init(
            ks[3], cfg, place=parallel.scope(place, "shared"))
    if cfg.frontend == "vision":
        shape = (cfg.frontend_dim, cfg.d_model)
        params["patch_proj"] = layers.dense_init(
            ks[4], *shape, cfg.param_dtype,
            parallel.block(place, "patch_proj", shape))
    return params


def n_params(params: PyTree) -> int:
    return sum(p.numel() for p in tree_leaves(params))


# -------------------------------------------------------------- positions --
def grid_side(cfg: ModelConfig) -> int:
    side = int(round(cfg.n_patches ** 0.5))
    if side * side != cfg.n_patches:
        raise ValueError(f"n_patches must be square, got {cfg.n_patches}")
    return side


def build_positions(cfg: ModelConfig, b: int, s: int,
                    device=None) -> torch.Tensor:
    """[B, S] int32 (plain RoPE) or [3, B, S] (M-RoPE: the patch grid's
    (0, row, column) ids, then text at side + i on all three streams)."""
    ar = torch.arange(s, dtype=torch.int32, device=device)
    if not cfg.mrope:
        return ar.expand(b, s)
    side = grid_side(cfg)
    npch = cfg.n_patches
    grid = torch.arange(side, dtype=torch.int32, device=device)
    text = side + ar[:s - npch]
    pos3 = torch.stack([
        torch.cat([torch.zeros(npch, dtype=torch.int32, device=device),
                   text]),
        torch.cat([grid.repeat_interleave(side), text]),
        torch.cat([grid.repeat(side), text])])                 # [3, S]
    return pos3[:, None, :].expand(3, b, s)


# ---------------------------------------------------------------- forward --
def _hybrid_groups(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, every): the shared block follows each whole group."""
    if cfg.arch_type == "hybrid" and cfg.shared_attn_every:
        every = cfg.shared_attn_every
        return cfg.n_layers // every, every
    return 0, 0


def _embed_sequence(params, cfg: ModelConfig, tokens,
                    patch_embeds=None) -> torch.Tensor:
    """Token (+ projected patch prefix) embedding -> [B, S, d]; under a
    model mesh the column-parallel projection's [B, P, d / m] blocks are
    gathered whole before they join the text."""
    x = layers.embed_apply(params["embed"], tokens, cfg)
    if cfg.frontend == "vision":
        patches = patch_embeds.to(cfg.param_dtype) @ params["patch_proj"]
        x = torch.cat([parallel.gather_columns(cfg, patches), x], dim=1)
    return x


def _differentiated(x: torch.Tensor, stack: PyTree) -> bool:
    """True when autograd records a layer on ``x`` with weights from
    ``stack``: grad is enabled and the input or a weight requires it."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(w.requires_grad for w in tree_leaves(stack)))


def _run_layers(params, cfg: ModelConfig, x, positions):
    """The first dense layers, then the layer stack (plus the hybrid
    shared-block insertions); each layer of the stack checkpointed when
    ``cfg.remat`` is set and the forward is differentiated, as JAX
    checkpoints its scanned block (not the first dense layers nor the
    shared block)."""
    apply_fn = blocks.BLOCK_APPLY[cfg.layer_kinds()[-1]]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_dense in params.get("first_dense", []):
        x, aux = blocks.dense_block_apply(p_dense, cfg, x, positions)
        aux_total = aux_total + aux
    _, every = _hybrid_groups(cfg)
    if cfg.remat and _differentiated(x, params["layers"]):
        def layer_fn(lp, h):
            # the layers draw no random numbers: no RNG state to replay
            return checkpoint(apply_fn, lp, cfg, h, positions,
                              use_reentrant=False, preserve_rng_state=False)
    else:
        def layer_fn(lp, h):
            return apply_fn(lp, cfg, h, positions)
    for i in range(cfg.n_layers - cfg.first_k_dense):
        x, aux = layer_fn(_layer(params["layers"], i), x)
        aux_total = aux_total + aux
        if every and (i + 1) % every == 0:
            x, aux = blocks.dense_block_apply(params["shared"], cfg, x,
                                              positions)
            aux_total = aux_total + aux
    return x, aux_total


def forward(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """batch {"tokens": [B, T+1], ["patch_embeds"]} -> (logits [B, S, V],
    aux), S = T (+ the patches); the last token is the target of the one
    before and is not an input."""
    x = _embed_sequence(params, cfg, batch["tokens"][:, :-1],
                        batch.get("patch_embeds"))
    b, s, _ = x.shape
    positions = build_positions(cfg, b, s, x.device)
    x, aux = _run_layers(params, cfg, x, positions)
    x = layers.norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_logits(params["embed"], x, cfg), aux


def loss_fn(params, cfg: ModelConfig, batch):
    """(nll + aux, (nll, aux)): the mean NLL of each next token (the VLM's
    text positions only; its logits begin with the patch prefix) and the
    MoE load-balance loss."""
    logits, aux = forward(params, cfg, batch)
    labels = batch["tokens"][:, 1:]
    if cfg.frontend == "vision":
        logits = logits[:, -labels.shape[1]:]
    nll = layers.cross_entropy(logits, labels)
    return nll + aux, (nll, aux)


def prefill(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """One-shot prompt forward: batch {"tokens": [B, S], ["patch_embeds"]}
    (all inputs) -> the logits of the last position [B, V]."""
    x = _embed_sequence(params, cfg, batch["tokens"],
                        batch.get("patch_embeds"))
    b, s, _ = x.shape
    positions = build_positions(cfg, b, s, x.device)
    x, _ = _run_layers(params, cfg, x, positions)
    x = layers.norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_logits(params["embed"], x[:, -1], cfg)


# ------------------------------------------------------------------ cache --
def init_cache(cfg: ModelConfig, b: int, s: int, device=None) -> PyTree:
    """Preallocated decode cache for sequence capacity ``s`` on ``device``
    (default CUDA; raises without it)."""
    dev = resolve_device(device)
    dt = cfg.param_dtype

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache(lead):
        if cfg.attention == "mla":
            return {"ckv": zeros(lead + (b, s, cfg.kv_lora_rank)),
                    "kpe": zeros(lead + (b, s, 1, cfg.qk_rope_head_dim))}
        shape = lead + (b, s, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

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
        cache["layers"] = attn_cache((cfg.n_layers - cfg.first_k_dense,))
    if cfg.first_k_dense:
        cache["first_dense"] = [attn_cache(())
                                for _ in range(cfg.first_k_dense)]
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
    pos = int(pos)
    x = layers.embed_apply(params["embed"], token, cfg)
    for p_dense, c in zip(params.get("first_dense", []),
                          cache.get("first_dense", [])):
        x, _ = blocks.dense_block_decode(p_dense, cfg, x, c, pos)
    decode_fn = blocks.BLOCK_DECODE[cfg.layer_kinds()[-1]]
    _, every = _hybrid_groups(cfg)
    for i in range(cfg.n_layers - cfg.first_k_dense):
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

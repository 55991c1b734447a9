"""Uniform model API (PyTorch port of ``repro.models.api``): the serving
and training entry points of every architecture, dispatching decoder-only
(``lm``) vs encoder-decoder (``encdec``), the random batches that feed
them and their specs (tensors on the ``meta`` device: shapes and dtypes,
no storage).

Training differentiates the parameter tree with autograd
(:func:`value_and_grad`); :func:`sgd_train_step` is JAX's plain SGD step,
with ``cfg.grad_accum`` microbatches summed in float32.  On the card the
backward of kernels 7, 8 and 9 is a hand-written kernel too, so every
config trains there, Mamba2 and Zamba2 included.

Serving runs tensor-parallel with a rank's config,
``repro_torch.models.parallel.local_config(cfg, mesh)``: ``init_params``
then draws the rank's blocks, ``init_cache`` holds its KV heads, and
``prefill_fn`` / ``decode_step`` return its vocab shard of the logits
(``parallel.gather_columns`` joins them, ``parallel.greedy`` picks).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import rng
from repro_torch.models import encdec, lm, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any
FLOAT32_LEAVES = moe.FLOAT32_LEAVES + ssm.FLOAT32_LEAVES


def init_params(key: torch.Tensor, cfg: ModelConfig) -> PyTree:
    if cfg.encoder_decoder:
        return encdec.init_params(key, cfg)
    return lm.init_params(key, cfg)


def cast_params(params, cfg: ModelConfig) -> PyTree:
    """A float32 init's ``params`` in ``cfg.param_dtype``: leaf for leaf
    what ``init_params`` gives from the same key in that dtype (each leaf
    but those the inits keep float32 is the float32 draw, cast)."""
    def cast(tree, name):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, name) for v in tree]
        return tree if name in FLOAT32_LEAVES else tree.to(cfg.param_dtype)
    return cast(params, "")


def loss_fn(params, cfg: ModelConfig, batch):
    """(loss, (nll, aux)) of a training batch {"tokens": [B, T + 1]} (+
    "patch_embeds" or "audio_embeds"): loss = nll + aux, all float32."""
    if cfg.encoder_decoder:
        return encdec.loss_fn(params, cfg, batch)
    return lm.loss_fn(params, cfg, batch)


def value_and_grad(params, cfg: ModelConfig, batch):
    """((loss, (nll, aux)), grads): :func:`loss_fn` and its gradient
    with respect to every leaf of ``params`` (``jax.value_and_grad(...,
    has_aux=True)``); the values are detached, the gradients are in each
    leaf's dtype, zero for a leaf the loss does not reach."""
    leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
    loss, (nll, aux) = loss_fn(tree_unflatten(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(leaves, grads)]
    return ((loss.detach(), (nll.detach(), aux.detach())),
            tree_unflatten(params, grads))


def prefill_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The last position's logits [B, V] of a prompt: {"tokens"} (+
    "patch_embeds" for the VLM; "audio_embeds" for the encoder-decoder,
    whose tokens are the decoder's)."""
    if cfg.encoder_decoder:
        memory = encdec.encode(params, cfg, batch["audio_embeds"])
        logits = encdec.decode_train(params, cfg, memory, batch["tokens"])
        return logits[:, -1]
    return lm.prefill(params, cfg, batch)


def init_cache(cfg: ModelConfig, b: int, s: int, device=None) -> PyTree:
    if cfg.encoder_decoder:
        return encdec.init_cache(cfg, b, s, s_enc=s, device=device)
    return lm.init_cache(cfg, b, s, device=device)


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    if cfg.encoder_decoder:
        return encdec.decode_step(params, cfg, cache, token, pos)
    return lm.decode_step(params, cfg, cache, token, pos)


# ---------------------------------------------------------------- batches --
def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Length of the TEXT part of a training batch for this arch."""
    if cfg.encoder_decoder:
        return max(seq_len // cfg.dec_ratio, 8)
    if cfg.frontend == "vision":
        return max(seq_len - cfg.n_patches, 8)
    return seq_len


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    if cfg.encoder_decoder:
        return {"audio_embeds": _meta((batch, seq_len, cfg.frontend_dim),
                                      torch.bfloat16)}
    if cfg.frontend == "vision":
        return {"patch_embeds": _meta((batch, cfg.n_patches,
                                       cfg.frontend_dim), torch.bfloat16)}
    return {}


def train_batch_specs(cfg: ModelConfig, batch: int, seq_len: int) -> PyTree:
    """The specs of one training batch (JAX's ShapeDtypeStructs): tokens
    [B, T + 1] int32 (T the text length), plus the frontend's bfloat16
    inputs."""
    t = _text_len(cfg, seq_len)
    return {"tokens": _meta((batch, t + 1), torch.int32),
            **_frontend_specs(cfg, batch, seq_len)}


def prefill_batch_specs(cfg: ModelConfig, batch: int,
                        seq_len: int) -> PyTree:
    """The specs of one prompt: tokens [B, T] int32, plus the frontend's
    bfloat16 inputs."""
    t = _text_len(cfg, seq_len)
    return {"tokens": _meta((batch, t), torch.int32),
            **_frontend_specs(cfg, batch, seq_len)}


def make_train_batch(key: torch.Tensor, cfg: ModelConfig, batch: int,
                     seq_len: int) -> PyTree:
    """JAX's random batch from the same key, on ``key.device``: tokens
    [B, T + 1] (T the text length), plus audio frame embeddings
    [B, seq_len, frontend_dim] or patch embeddings [B, n_patches,
    frontend_dim] in the param dtype."""
    t = _text_len(cfg, seq_len)
    k1, k2 = rng.split(key).unbind(0)
    out = {"tokens": rng.randint(k1, (batch, t + 1), 0, cfg.vocab)}
    if cfg.encoder_decoder:
        out["audio_embeds"] = rng.normal(
            k2, (batch, seq_len, cfg.frontend_dim)).to(cfg.param_dtype)
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.normal(
            k2, (batch, cfg.n_patches, cfg.frontend_dim)).to(cfg.param_dtype)
    return out


def sgd_train_step(params, cfg: ModelConfig, batch, lr: float = 1e-2):
    """JAX's paper-faithful local step: plain SGD, ``p - lr g`` in each
    leaf's dtype -> (new params, {"loss", "nll", "aux"}).

    ``cfg.grad_accum`` = a > 1 splits the batch into a microbatches of B / a
    rows (in order, as JAX's ``lax.scan`` over the reshaped batch), sums
    their gradients in float32 and steps with the mean; the loss and nll
    are then the mean microbatch loss and aux is 0, as in JAX.
    """
    a = cfg.grad_accum
    if a <= 1:
        (loss, (nll, aux)), grads = value_and_grad(params, cfg, batch)
    else:
        def micro(x, i):
            if x.shape[0] % a:
                raise ValueError(f"batch of {x.shape[0]} rows does not split "
                                 f"into grad_accum={a} microbatches")
            return x.reshape((a, x.shape[0] // a) + tuple(x.shape[1:]))[i]

        grads = tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                               device=w.device), params)
        l_sum = 0.0
        for i in range(a):
            (loss, _), g = value_and_grad(
                params, cfg, {k: micro(v, i) for k, v in batch.items()})
            grads = tree_map(lambda s, x: s + x.float(), grads, g)
            l_sum = l_sum + loss
        grads = tree_map(lambda g: g / a, grads)
        loss = nll = l_sum / a
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    new_params = tree_map(lambda p, g: (p - lr * g).to(p.dtype), params,
                          grads)
    return new_params, {"loss": loss, "nll": nll, "aux": aux}

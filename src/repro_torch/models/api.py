"""Uniform model API (PyTorch port of ``repro.models.api``): the serving
entry points of every architecture, dispatching decoder-only (``lm``) vs
encoder-decoder (``encdec``), and the random batches that feed them.  The
training side (``loss_fn``, ``sgd_train_step``, the batch specs) is not
ported yet (ROADMAP.md A.1f).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import rng
from repro_torch.models import encdec, lm, moe, ssm
from repro_torch.models.config import ModelConfig

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

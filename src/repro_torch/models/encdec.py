"""Whisper-style encoder-decoder (PyTorch port of ``repro.models.encdec``;
arXiv:2212.04356), transformer backbone.

The mel-spectrogram + conv feature extractor is a stub, as in JAX: the
caller supplies frame embeddings [B, S_enc, frontend_dim], which a linear
projector maps to d_model.  Sinusoidal absolute positions, no RoPE,
standard MHA, GELU MLPs, pre-norm.  The encoder's self-attention
(bidirectional), the decoder's (causal) and its cross attention over the
encoder's memory all run kernel 7; the cached decode's self-attention is
plain, as in JAX.

As in the reference, :func:`init_cache` leaves ``memory`` zero and nothing
here writes the encoder's output into it (ROADMAP.md C.15): a caller that
wants the decode to see the audio sets ``cache["memory"] = encode(...)``.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import resolve_device, rng
from repro_torch.models import attention, blocks, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _layer, _stacked_init

PyTree = Any


def _sinusoidal(s: int, d: int, device=None) -> torch.Tensor:
    """[s, d] float32: sin of each position's d/2 frequencies, then cos."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * 2 * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dec_block_init(key: torch.Tensor, cfg: ModelConfig):
    k1, k2, k3 = rng.split(key, 3).unbind(0)
    dev = key.device
    return {"norm1": layers.norm_init(cfg, cfg.d_model, dev),
            "self_attn": attention.attn_init(k1, cfg),
            "norm_x": layers.norm_init(cfg, cfg.d_model, dev),
            "cross_attn": attention.cross_attn_init(k2, cfg),
            "norm2": layers.norm_init(cfg, cfg.d_model, dev),
            "mlp": layers.mlp_init(k3, cfg, cfg.d_model, cfg.d_ff)}


def init_params(key: torch.Tensor, cfg: ModelConfig) -> PyTree:
    """Weights on ``key.device``, the same numbers as JAX's from the same
    key."""
    ks = rng.split(key, 5).unbind(0)
    return {
        "embed": layers.embed_init(ks[0], cfg),
        "frontend_proj": layers.dense_init(ks[1], cfg.frontend_dim,
                                           cfg.d_model, cfg.param_dtype),
        "enc_layers": _stacked_init(
            ks[2], cfg.n_enc_layers,
            lambda k: blocks.dense_block_init(k, cfg)),
        "enc_norm": layers.norm_init(cfg, cfg.d_model, key.device),
        "dec_layers": _stacked_init(ks[3], cfg.n_layers,
                                    lambda k: dec_block_init(k, cfg)),
        "final_norm": layers.norm_init(cfg, cfg.d_model, key.device),
    }


def encode(params, cfg: ModelConfig,
           audio_embeds: torch.Tensor) -> torch.Tensor:
    """audio_embeds [B, S_enc, frontend_dim] -> memory [B, S_enc, d]."""
    x = audio_embeds.to(cfg.param_dtype) @ params["frontend_proj"]
    b, s, _ = x.shape
    x = x + _sinusoidal(s, cfg.d_model, x.device).to(x.dtype)
    zero_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    for i in range(cfg.n_enc_layers):
        lp = _layer(params["enc_layers"], i)
        h = layers.norm_apply(cfg, lp["norm1"], x)
        x = x + attention.self_attention(lp["attn"], cfg, h, zero_pos,
                                         causal=False)
        h = layers.norm_apply(cfg, lp["norm2"], x)
        x = x + layers.mlp_apply(cfg, lp["mlp"], h)
    return layers.norm_apply(cfg, params["enc_norm"], x)


def _dec_block(lp, cfg: ModelConfig, x, memory, positions):
    h = layers.norm_apply(cfg, lp["norm1"], x)
    x = x + attention.self_attention(lp["self_attn"], cfg, h, positions)
    h = layers.norm_apply(cfg, lp["norm_x"], x)
    x = x + attention.cross_attention(lp["cross_attn"], cfg, h, memory)
    h = layers.norm_apply(cfg, lp["norm2"], x)
    return x + layers.mlp_apply(cfg, lp["mlp"], h)


def decode_train(params, cfg: ModelConfig, memory, tokens_in):
    """Teacher-forced decoder: tokens_in [B, T] -> logits [B, T, V]."""
    b, t = tokens_in.shape
    x = layers.embed_apply(params["embed"], tokens_in)
    x = x + _sinusoidal(t, cfg.d_model, x.device).to(x.dtype)
    zero_pos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        x = _dec_block(_layer(params["dec_layers"], i), cfg, x, memory,
                       zero_pos)
    x = layers.norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_logits(params["embed"], x, cfg)


def forward(params, cfg: ModelConfig, batch):
    """batch {"audio_embeds": [B, S, fd], "tokens": [B, T+1]} -> (logits
    [B, T, V], aux 0)."""
    memory = encode(params, cfg, batch["audio_embeds"])
    logits = decode_train(params, cfg, memory, batch["tokens"][:, :-1])
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(params, cfg: ModelConfig, batch):
    """(nll + aux, (nll, aux)) of the teacher-forced decoder; aux is 0."""
    logits, aux = forward(params, cfg, batch)
    nll = layers.cross_entropy(logits, batch["tokens"][:, 1:])
    return nll + aux, (nll, aux)


# ------------------------------------------------------------------ decode --
def init_cache(cfg: ModelConfig, b: int, s: int, s_enc: int,
               device=None) -> PyTree:
    """The decoder's self-attention cache for ``s`` tokens and a zero
    encoder ``memory`` of ``s_enc`` frames, on ``device`` (default CUDA;
    raises without it)."""
    dev = resolve_device(device)
    dt = cfg.param_dtype
    kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    return {"memory": torch.zeros((b, s_enc, cfg.d_model), dtype=dt,
                                  device=dev),
            "k": torch.zeros(kv, dtype=dt, device=dev),
            "v": torch.zeros(kv, dtype=dt, device=dev)}


def decode_step(params, cfg: ModelConfig, cache, token, pos: int):
    """One decoder token against the cached self-attention k/v (updated in
    place) and the encoder memory; returns (logits [B, V], cache)."""
    pos = int(pos)
    x = layers.embed_apply(params["embed"], token)
    # absolute position embedding of the current index
    posemb = _sinusoidal(cache["k"].shape[2], cfg.d_model, x.device)
    x = x + posemb[pos:pos + 1].to(x.dtype)[None]
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = layers.norm_apply(cfg, lp["norm1"], x)
        h, _, _ = attention.decode_attention(lp["self_attn"], cfg, h,
                                             cache["k"][i], cache["v"][i],
                                             pos)
        x = x + h
        h = layers.norm_apply(cfg, lp["norm_x"], x)
        x = x + attention.cross_attention(lp["cross_attn"], cfg, h,
                                          cache["memory"])
        h = layers.norm_apply(cfg, lp["norm2"], x)
        x = x + layers.mlp_apply(cfg, lp["mlp"], h)
    x = layers.norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_logits(params["embed"], x[:, 0], cfg), cache

"""GQA attention with RoPE (PyTorch port of ``repro.models.attention``).

Full-sequence causal self-attention (prefill) runs kernel 7
(:mod:`repro_torch.kernels.flash_attention`), where the JAX module's
docstring says the TPU path belongs; the JAX code itself computes
:func:`_sdpa` in jnp, and so does the one-token :func:`decode_attention`
here, as in JAX.  Layouts are the JAX package's: q [B, S, H, D], k/v
[B, S, KV, D].
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, unported
from repro_torch.models.layers import apply_rope, dense_init, rope_freqs


def attn_init(key: torch.Tensor, cfg: ModelConfig,
              d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    k1, k2, k3, k4 = rng.split(key, 4).unbind(0)
    p = {"wq": dense_init(k1, d, h * dh, cfg.param_dtype),
         "wk": dense_init(k2, d, kv * dh, cfg.param_dtype),
         "wv": dense_init(k3, d, kv * dh, cfg.param_dtype),
         "wo": dense_init(k4, h * dh, d, cfg.param_dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=cfg.param_dtype,
                                 device=key.device)
        p["k_norm"] = torch.ones((dh,), dtype=cfg.param_dtype,
                                 device=key.device)
    return p


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """x: [B, S, d] -> q [B,S,H,D], k/v [B,S,KV,D] with RoPE applied."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, dh)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, dh)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    if cfg.mrope:
        raise unported("M-RoPE", "A.1e")
    if cfg.use_rope:
        freqs = rope_freqs(cfg, dh, device=x.device)
        q = apply_rope(q, positions, freqs)
        k = apply_rope(k, positions, freqs)
    return q, k, v


def _sdpa(q, k, v, mask, dh):
    """[B,S,H,D] x [B,T,KV,D] -> [B,S,H,D]; H grouped onto KV heads."""
    b, s, h, _ = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(dh)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def self_attention(params, cfg: ModelConfig, x, positions,
                   causal: bool = True):
    """Full-sequence self-attention (prefill), through kernel 7."""
    if cfg.sliding_window and causal:
        raise unported("sliding-window attention", "A.1b")
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = flash_attention(q, k, v, causal=causal)
    return out.reshape(b, s, -1) @ params["wo"]


def decode_attention(params, cfg: ModelConfig, x, cache_k, cache_v,
                     pos: int):
    """One-token decode against a preallocated KV cache.

    x: [B, 1, d]; cache_k/v: [B, S, KV, D]; pos: the current index.  The new
    k/v are written into the caches in place; returns (out [B, 1, d],
    cache_k, cache_v).
    """
    if cfg.sliding_window:
        raise unported("sliding-window decode", "A.1b")
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    cache_k[:, pos] = k_new[:, 0]
    cache_v[:, pos] = v_new[:, 0]
    valid = torch.arange(s_cache, device=x.device) <= pos
    out = _sdpa(q, cache_k, cache_v, valid[None, None, None, None, :],
                cfg.head_dim)
    return out.reshape(b, 1, -1) @ params["wo"], cache_k, cache_v

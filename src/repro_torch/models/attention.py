"""GQA attention with RoPE / M-RoPE, sliding windows and cross attention
(PyTorch port of ``repro.models.attention``).

Full-sequence self-attention (prefill; causal, windowed or, in Whisper's
encoder, bidirectional) and cross attention over an encoder's memory run
kernel 7 (:mod:`repro_torch.kernels.flash_attention`), where the JAX
module's docstring says the TPU path belongs; the JAX code itself computes
:func:`_sdpa` in jnp, and so does the one-token :func:`decode_attention`
here, as in JAX.  Layouts are the JAX package's: q [B, S, H, D], k/v
[B, S, KV, D].  Under a model mesh a rank holds its heads' columns of
wq / wk / wv and rows of wo; the ``@ wo`` of self, decode and cross
attention sums over the model group
(:func:`repro_torch.models.parallel.row_matmul`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers, parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       rope_freqs)


def attn_init(key: torch.Tensor, cfg: ModelConfig,
              d_model: Optional[int] = None, place=None):
    """``place``: the blocks a rank draws (``parallel.draw_plan``)."""
    d = d_model or cfg.d_model
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    k1, k2, k3, k4 = rng.split(key, 4).unbind(0)

    def draw(k, name, d_in, d_out):
        return dense_init(k, d_in, d_out, cfg.param_dtype,
                          parallel.block(place, name, (d_in, d_out)))

    p = {"wq": draw(k1, "wq", d, h * dh), "wk": draw(k2, "wk", d, kv * dh),
         "wv": draw(k3, "wv", d, kv * dh), "wo": draw(k4, "wo", h * dh, d)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=cfg.param_dtype,
                                 device=key.device)
        p["k_norm"] = torch.ones((dh,), dtype=cfg.param_dtype,
                                 device=key.device)
    return p


def _project_qkv(params, cfg: ModelConfig, x, positions):
    """x: [B, S, d] -> q [B,S,H,D], k/v [B,S,KV,D] with RoPE applied
    (positions [B, S], or [3, B, S] under M-RoPE)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, dh)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, dh)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg, dh)
        k = apply_mrope(k, positions, cfg, dh)
    elif cfg.use_rope:
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
    """Full-sequence self-attention (prefill), through kernel 7; a causal
    call keeps ``cfg.sliding_window`` keys a query, as JAX's mask does."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    window = (cfg.sliding_window or 0) if causal else 0
    out = flash_attention(q, k, v, causal=causal, window=window)
    return parallel.row_matmul(cfg, out.reshape(b, s, -1), params["wo"])


def window_slice(cfg: ModelConfig, s_cache: int, pos: int) -> tuple[int, int]:
    """(start, length) of the cache a decode step at ``pos`` attends: the
    ``sliding_window`` keys ending at ``pos`` (JAX's ``clip(pos - w + 1, 0,
    S - w)``) when the window is shorter than the cache, else all of it."""
    w = cfg.sliding_window
    if w and w < s_cache:
        return min(max(pos - w + 1, 0), s_cache - w), w
    return 0, s_cache


def decode_attention(params, cfg: ModelConfig, x, cache_k, cache_v,
                     pos: int):
    """One-token decode against a preallocated KV cache.

    x: [B, 1, d]; cache_k/v: [B, S, KV, D]; pos: the current index.  The new
    k/v are written into the caches in place; with a sliding window shorter
    than the cache only the window's slice is attended, as in JAX.  Returns
    (out [B, 1, d], cache_k, cache_v).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    if cfg.mrope:
        positions = positions.expand(3, b, 1)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    cache_k[:, pos] = k_new[:, 0]
    cache_v[:, pos] = v_new[:, 0]
    start, w = window_slice(cfg, cache_k.shape[1], pos)
    valid = start + torch.arange(w, device=x.device) <= pos
    out = _sdpa(q, cache_k[:, start:start + w], cache_v[:, start:start + w],
                valid[None, None, None, None, :], cfg.head_dim)
    return (parallel.row_matmul(cfg, out.reshape(b, 1, -1), params["wo"]),
            cache_k, cache_v)


# ------------------------------------------------------- cross-attention --
def cross_attn_init(key: torch.Tensor, cfg: ModelConfig, place=None):
    """``place``: the blocks a rank draws (``parallel.draw_plan``)."""
    return attn_init(key, cfg, place=place)


def cross_attention(params, cfg: ModelConfig, x, memory):
    """Decoder cross-attention over encoder memory (no RoPE, bidirectional,
    S != T): kernel 7, non-causal."""
    b, s, _ = x.shape
    t = memory.shape[1]
    dh = cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, dh)
    k = (memory @ params["wk"]).reshape(b, t, cfg.n_kv_heads, dh)
    v = (memory @ params["wv"]).reshape(b, t, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    out = flash_attention(q, k, v, causal=False)
    return parallel.row_matmul(cfg, out.reshape(b, s, -1), params["wo"])

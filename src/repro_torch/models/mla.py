"""Multi-head Latent Attention, DeepSeek-V2 (PyTorch port of
``repro.models.mla``; arXiv:2405.04434).

KV is compressed into a rank-``kv_lora_rank`` latent c_kv plus a shared
rotary key k_pe; the decode cache stores ONLY (c_kv, k_pe).

Shapes (per layer):
  wq_a  [d, q_lora]        wq_b [q_lora, H*(nope+rope)]
  wkv_a [d, kv_lora+rope]  wkv_b [kv_lora, H*(nope+v)]
  wo    [H*v, d]

``q_norm`` and ``kv_norm`` run kernel 8 (the latent slice of ``wkv_a``'s
output is made contiguous first: the kernel takes no strided rows).  The
absorbed attention stays plain torch, as in JAX: a qk head of nope + rope
(192 at full width), a v head of 128 and a 512-wide latent are not a
kernel-7 shape.

Under a model mesh a rank holds its heads' columns of ``wq_b`` and
``wkv_b`` (both head-major, so a contiguous column block is whole heads)
and their rows of ``wo``, whose product sums over the model group
(:func:`repro_torch.models.parallel.row_matmul`); ``wq_a``, ``wkv_a`` and
the latent cache (``ckv``, ``kpe``) are whole on every rank.
"""
from __future__ import annotations

import math

import torch

from repro_torch import rng
from repro_torch.models import parallel
from repro_torch.models.attention import window_slice
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm,
                                       rope_freqs)


def mla_init(key: torch.Tensor, cfg: ModelConfig, place=None):
    """``place``: the blocks a rank draws (``parallel.draw_plan``)."""
    h = cfg.n_heads
    nope, rope, v = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt, dev = cfg.param_dtype, key.device
    ks = rng.split(key, 5).unbind(0)

    def draw(k, name, d_in, d_out):
        return dense_init(k, d_in, d_out, dt,
                          parallel.block(place, name, (d_in, d_out)))

    return {
        "wq_a": draw(ks[0], "wq_a", cfg.d_model, cfg.q_lora_rank),
        "q_norm": torch.ones((cfg.q_lora_rank,), dtype=dt, device=dev),
        "wq_b": draw(ks[1], "wq_b", cfg.q_lora_rank, h * (nope + rope)),
        "wkv_a": draw(ks[2], "wkv_a", cfg.d_model, cfg.kv_lora_rank + rope),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=dt, device=dev),
        "wkv_b": draw(ks[3], "wkv_b", cfg.kv_lora_rank, h * (nope + v)),
        "wo": draw(ks[4], "wo", h * v, cfg.d_model),
    }


def _queries(params, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = rms_norm(x @ params["wq_a"], params["q_norm"]) @ params["wq_b"]
    q = q.reshape(b, s, h, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, rope_freqs(cfg, rope, x.device))
    return q_nope, q_pe


def _latents(params, cfg: ModelConfig, x, positions):
    """x -> (c_kv [B,S,R], k_pe [B,S,1,rope]) — the decode cache contents."""
    kv_a = x @ params["wkv_a"]
    c_kv = rms_norm(kv_a[..., :cfg.kv_lora_rank].contiguous(),
                    params["kv_norm"])
    k_pe = kv_a[..., None, cfg.kv_lora_rank:]
    k_pe = apply_rope(k_pe, positions,
                      rope_freqs(cfg, cfg.qk_rope_head_dim, x.device))
    return c_kv, k_pe


def _attend(params, cfg: ModelConfig, q_nope, q_pe, c_kv, k_pe, mask):
    """Latent-space attention: scores from (q_nope . W_uk c) + (q_pe . k_pe),
    wkv_b's key half folded into the query (the "absorbed" form), so the
    cache is never expanded to per-head keys."""
    b, s, h, nope = q_nope.shape
    rope, v = cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    wkv_b = params["wkv_b"].reshape(r, h, nope + v)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
              + torch.einsum("bshn,btkn->bhst", q_pe, k_pe)).float()
    scores = scores / math.sqrt(nope + rope)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", probs, c_kv)
    out = torch.einsum("bshr,rhv->bshv", out_lat, w_uv)
    return parallel.row_matmul(cfg, out.reshape(b, s, h * v), params["wo"])


def mla_self_attention(params, cfg: ModelConfig, x, positions,
                       causal: bool = True):
    b, s, _ = x.shape
    q_nope, q_pe = _queries(params, cfg, x, positions)
    c_kv, k_pe = _latents(params, cfg, x, positions)
    i = torch.arange(s, device=x.device)[:, None]
    j = torch.arange(s, device=x.device)[None, :]
    mask = (j <= i) if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=x.device)
    if cfg.sliding_window and causal:
        mask = mask & (i - j < cfg.sliding_window)
    return _attend(params, cfg, q_nope, q_pe, c_kv, k_pe, mask[None, None])


def mla_decode_attention(params, cfg: ModelConfig, x, cache_ckv, cache_kpe,
                         pos: int):
    """x: [B,1,d]; cache_ckv: [B,S,R]; cache_kpe: [B,S,1,rope], both
    updated in place at ``pos``."""
    b = x.shape[0]
    positions = torch.full((b, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q_nope, q_pe = _queries(params, cfg, x, positions)
    c_new, kpe_new = _latents(params, cfg, x, positions)
    cache_ckv[:, pos] = c_new[:, 0]
    cache_kpe[:, pos] = kpe_new[:, 0]
    start, w = window_slice(cfg, cache_ckv.shape[1], pos)
    valid = start + torch.arange(w, device=x.device) <= pos
    out = _attend(params, cfg, q_nope, q_pe, cache_ckv[:, start:start + w],
                  cache_kpe[:, start:start + w], valid[None, None, None, :])
    return out, cache_ckv, cache_kpe

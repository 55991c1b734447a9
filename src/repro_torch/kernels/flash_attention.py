"""Flash attention, forward (PyTorch port of
``repro.kernels.flash_attention``).

On CUDA tensors :func:`flash_attention` launches the hand-written kernel in
``csrc/flash_attention.cu`` (online softmax in float32, GQA by head index,
any S and T; bfloat16 on the tensor cores with wgmma, float32 in SIMT
FMAs); on CPU tensors it runs :func:`flash_attention_plain`, the oracle
``repro.kernels.ref.flash_attention``.  q [B, S, H, D], k/v
[B, T, KV, D], all float32 or all bfloat16, D in {64, 128}.

The TPU kernel's causal mask is start-aligned (``k_pos > q_pos``) while the
oracle's is end-aligned (``tril(k=T-S)``); they agree only when S == T, so
:func:`flash_attention` takes ``causal=True`` only with S == T, which is
what self-attention over a prompt gives.

``window`` > 0 (causal only) is a sliding window: a key with q_pos - k_pos
>= window is masked, as the JAX models' jnp mask ``i - j <
sliding_window`` does (the Pallas kernel has none; JAX computes windowed
attention in jnp).  The kernel skips key tiles wholly before a query
tile's window.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None,
                          window: int = 0) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, s, kv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * sc
    if causal:
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=q.device), diagonal=t - s)
        if window:
            mask = mask & ~torch.tril(mask, diagonal=t - s - window)
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, T, KV, D] -> [B, S, H, D] in q's dtype;
    ``window`` a causal sliding window (0: none)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if causal and s != t:
        raise ValueError(f"causal flash_attention needs S == T (the kernel's "
                         f"mask is start-aligned), got S={s}, T={t}")
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention takes a window >= 1 with "
                         f"causal=True only, got window={window}, "
                         f"causal={causal}")
    index = _lib.cuda_index(q, k, v)
    if index is None:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    kind = _lib.float_kind(q, "q")
    if d not in HEAD_DIMS or kv < 1 or h % kv:
        raise ValueError(f"flash_attention needs D in {HEAD_DIMS} and H a "
                         f"multiple of KV, got D={d}, H={h}, KV={kv}")
    _lib.require(q, "q", q.dtype, (b, s, h, d))
    _lib.require(k, "k", q.dtype, (b, t, kv, d))
    _lib.require(v, "v", q.dtype, (b, t, kv, d))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # The bf16 kernel reads through TMA, which needs 16-byte aligned bases.
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    _lib.launch(f"flash_attention_{kind}", index, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s, t, h, kv, d, int(causal),
                window, scale)
    _lib.LAUNCHES["flash_attention"] += 1
    return out

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

Gradients: where autograd records the call (grad enabled and an input
requiring it), :func:`flash_attention` goes through an
``autograd.Function`` whose forward also writes each row's log-sum-exp
and whose backward is :func:`flash_attention_bwd`, the hand-written
kernels of ``csrc/flash_attention_bwd.cu`` on CUDA tensors (bfloat16 on
the tensor cores, float32 in SIMT FMAs; dq, dk and dv summed in float32,
no atomics), the plain version's autograd on CPU tensors.  Otherwise it
launches the forward directly, as the serving path always does, and
writes nothing more.

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


def _masked_scores(q, k, causal: bool, scale: float,
                   window: int) -> torch.Tensor:
    """The scaled scores [B, KV, G, S, T] in float32, masked to -1e30."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if causal:
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=q.device), diagonal=t - s)
        if window:
            mask = mask & ~torch.tril(mask, diagonal=t - s - window)
        scores = torch.where(mask, scores, -1e30)
    return scores


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None,
                          window: int = 0) -> torch.Tensor:
    b, s, h, d = q.shape
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = _masked_scores(q, k, causal, sc, window)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def flash_attention_lse_plain(q, k, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """Each query row's natural log-sum-exp of its scaled, masked scores,
    float32 [B, H, S]: what the forward kernels write for the backward."""
    b, s, h, d = q.shape
    scores = _masked_scores(q, k, causal, 1.0 / (d ** 0.5), window)
    return torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def _check_mask(s: int, t: int, causal: bool, window: int) -> None:
    if causal and s != t:
        raise ValueError(f"causal flash_attention needs S == T (the kernel's "
                         f"mask is start-aligned), got S={s}, T={t}")
    if window < 0 or (window and not causal):
        raise ValueError(f"flash_attention takes a window >= 1 with "
                         f"causal=True only, got window={window}, "
                         f"causal={causal}")


def _check_operands(q, k, v) -> str:
    """The kernels' storage kind of q, k, v; raises on what they do not
    take."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    kind = _lib.float_kind(q, "q")
    if d not in HEAD_DIMS or kv < 1 or h % kv:
        raise ValueError(f"flash_attention needs D in {HEAD_DIMS} and H a "
                         f"multiple of KV, got D={d}, H={h}, KV={kv}")
    _lib.require(q, "q", q.dtype, (b, s, h, d))
    _lib.require(k, "k", q.dtype, (b, t, kv, d))
    _lib.require(v, "v", q.dtype, (b, t, kv, d))
    return kind


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, index):
        out, lse = _forward(q, k, v, causal, window, index, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, T, KV, D] -> [B, S, H, D] in q's dtype;
    ``window`` a causal sliding window (0: none)."""
    _check_mask(q.shape[1], k.shape[1], causal, window)
    index = _lib.cuda_index(q, k, v)
    if index is None:
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, window, index)
    return _forward(q, k, v, causal, window, index)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             window: int = 0):
    """(out, lse): the forward and each row's log-sum-exp [B, H, S]
    float32, which the autograd path saves for
    :func:`flash_attention_bwd`."""
    _check_mask(q.shape[1], k.shape[1], causal, window)
    index = _lib.cuda_index(q, k, v)
    if index is None:
        return (flash_attention_plain(q, k, v, causal=causal, window=window),
                flash_attention_lse_plain(q, k, causal=causal, window=window))
    return _forward(q, k, v, causal, window, index, with_lse=True)


def _forward(q, k, v, causal: bool, window: int, index: int,
             with_lse: bool = False):
    """The forward kernel's launch: ``out`` (the serving path's direct
    call), or ``(out, lse)`` with each row's log-sum-exp written too."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    kind = _check_operands(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    q, k, v = _lib.aligned(q), _lib.aligned(k), _lib.aligned(v)
    scale = 1.0 / math.sqrt(d)
    _lib.launch(f"flash_attention_{kind}", index, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None, b, s, t, h, kv, d,
                int(causal), window, scale)
    _lib.LAUNCHES["flash_attention"] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_plain(q, k, v, out, dout, causal: bool = True,
                              window: int = 0):
    """(dq, dk, dv): autograd of :func:`flash_attention_plain` (``out``
    is not read; the plain forward is recomputed)."""
    del out
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_plain(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, dout)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool = True,
                        window: int = 0):
    """The gradients (dq, dk, dv) of ``out = flash_attention(q, k, v)``
    given ``dout`` = dL/dout [B, S, H, D] and the forward's row
    log-sum-exp ``lse`` [B, H, S] float32 (:func:`flash_attention_with_lse`;
    the plain version recomputes it), in the operands' dtypes.

    On CUDA two kernels run in order (csrc/flash_attention_bwd.cu): one a
    query tile takes delta = rowsum(dout * out) and walks the keys for
    dq; one a key tile walks its KV head's G query heads and their queries
    for dk and dv, so GQA's sums need no atomics and two runs agree bit
    for bit."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    _check_mask(s, t, causal, window)
    index = _lib.cuda_index(q, k, v, out, dout, lse)
    if index is None:
        return flash_attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                         window=window)
    kind = _check_operands(q, k, v)
    _lib.require(out, "out", q.dtype, (b, s, h, d))
    _lib.require(dout, "dout", q.dtype, (b, s, h, d))
    _lib.require(lse, "lse", torch.float32, (b, h, s))
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if s == 0 or t == 0:         # no pairs: every gradient is zero
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    q, k, v, dout = (_lib.aligned(a) for a in (q, k, v, dout))
    _lib.launch(f"flash_attention_bwd_{kind}", index, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), b, s, t, h, kv, d, int(causal), window,
                1.0 / math.sqrt(d))
    _lib.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv

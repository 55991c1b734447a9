"""Mamba2 block via SSD, state-space duality (PyTorch port of
``repro.models.ssm``; arXiv:2405.21060).

Prefill and training use the chunked SSD algorithm: :func:`ssm_forward`
pads the sequence to a chunk multiple and runs kernel 9
(:mod:`repro_torch.kernels.ssd_scan`; differentiated, its backward
kernels), whose plain version is :func:`ssd_chunked`, the JAX module's
jnp path.  Decode is the O(1)
recurrent update on the [B, H, N, P] state (:func:`ssm_decode`), plain as
in JAX.

Per-layer params:
  in_proj [d, 2*d_inner + 2*G*N + H]   (z | x | B | C | dt)
  conv_w  [w, d_inner + 2*G*N]  conv_b [d_inner + 2*G*N]
  A_log [H]  D [H]  dt_bias [H]  norm [d_inner]  out_proj [d_inner, d]
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

NGROUPS = 1  # B/C shared across heads (Mamba2 default ngroups=1)
# Leaves ssm_init makes float32 whatever cfg.dtype (api.cast_params keeps
# them so).
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_init(key: torch.Tensor, cfg: ModelConfig):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = key.device
    conv_ch = di + 2 * NGROUPS * n
    ks = rng.split(key, 4).unbind(0)
    lo, hi = torch.log(torch.tensor([0.001, 0.1], dtype=torch.float32,
                                    device=dev)).unbind(0)
    dt = torch.exp(rng.uniform(ks[2], (h,)) * (hi - lo) + lo)
    return {
        "in_proj": dense_init(ks[0], d, 2 * di + 2 * NGROUPS * n + h,
                              cfg.param_dtype),
        "conv_w": (rng.normal(ks[1], (cfg.ssm_conv_width, conv_ch))
                   * 0.1).to(cfg.param_dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=cfg.param_dtype, device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm": torch.ones((di,), dtype=cfg.param_dtype, device=dev),
        "out_proj": dense_init(ks[3], di, d, cfg.param_dtype),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * NGROUPS * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _causal_conv(cfg: ModelConfig, xbc, conv_w, conv_b):
    """Depthwise causal conv over the sequence (width w), via shifted adds
    in the JAX package's order."""
    w = cfg.ssm_conv_width
    out = torch.zeros_like(xbc)
    for i in range(w):
        shift = w - 1 - i
        shifted = F.pad(xbc, (0, 0, shift, 0))[:, :xbc.shape[1]]
        out = out + shifted * conv_w[i]
    return F.silu(out + conv_b)


def _gated_norm(y, z, scale):
    yf = (y * F.silu(z.float())).float()
    ms = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-6) * scale.float()).to(y.dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """The SSD scan: x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,G,N].

    Returns y [B,S,H,P] float32; float32 state math throughout.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    nc = s // q
    assert s % q == 0, (s, q)

    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Bf = B.float().reshape(b, nc, q, -1, n)               # [b,nc,q,G,n]
    Cf = C.float().reshape(b, nc, q, -1, n)
    Bf = Bf.expand(b, nc, q, h, n) if Bf.shape[3] == 1 else Bf
    Cf = Cf.expand(b, nc, q, h, n) if Cf.shape[3] == 1 else Cf

    dA = dtf * A                                            # [b,nc,q,h]
    seg = torch.cumsum(dA, dim=2)                           # running log-decay
    # intra-chunk ("diagonal block"): attention-like causal matmul
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # [b,nc,qi,qj,h]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    # exp(-inf) = 0 above the diagonal: the same values as JAX's
    # where(causal, exp(rel), 0), whose gradient there is 0 * exp(rel),
    # NaN once a chunk's log-decay spans past float32's exp range (~88)
    decay = torch.exp(torch.where(causal, rel, float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * decay
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores, dtf, xf)

    # per-chunk input state contribution
    tail = seg[:, :, -1:, :] - seg                          # decay to chunk end
    contrib = torch.einsum("bcjhn,bcjh,bcjhp->bchnp",
                           Bf * torch.exp(tail)[..., None], dtf, xf)
    chunk_decay = torch.exp(seg[:, :, -1, :])               # [b,nc,h]

    # inter-chunk sequential state pass
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + contrib[:, c]
    prev_states = torch.stack(prev, dim=1)                  # [b,nc,h,n,p]

    # off-diagonal: contribution of carried-in state to each position
    y_off = torch.einsum("bcihn,bchnp->bcihp",
                         Cf * torch.exp(seg)[..., None], prev_states)
    return (y_diag + y_off).reshape(b, s, h, p)


def ssm_forward(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence Mamba2 block: x [B,S,d] -> y [B,S,d]."""
    b, s, _ = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt = _split_proj(cfg, x @ params["in_proj"])
    xbc = _causal_conv(cfg, xbc, params["conv_w"], params["conv_b"])
    di = cfg.d_inner
    xs = xbc[..., :di].reshape(b, s, h, p)
    Bm = xbc[..., di:di + NGROUPS * n].reshape(b, s, NGROUPS, n)
    Cm = xbc[..., di + NGROUPS * n:].reshape(b, s, NGROUPS, n)
    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    # pad the sequence to a chunk multiple (tail padding is causal-safe:
    # padded x is zero so it contributes nothing to states or outputs)
    q = cfg.ssm_chunk
    pad = (-s) % q
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    y = ssd_scan(xs.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                 Cm.contiguous(), q)[:, :s]
    xs = xs[:, :s]
    y = y + params["D"][:, None] * xs.float()
    y = _gated_norm(y.reshape(b, s, di).to(x.dtype), z, params["norm"])
    return y @ params["out_proj"]


def ssm_decode(params, cfg: ModelConfig, x, conv_state, ssm_state):
    """One-token recurrent step.

    x: [B,1,d]; conv_state: [B, w-1, conv_ch]; ssm_state: [B,H,N,P].
    Returns (y [B,1,d], new_conv_state, new_ssm_state).
    """
    b = x.shape[0]
    h, p, n, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ params["in_proj"])  # [B, .]
    # causal conv via stored last w-1 inputs
    hist = torch.cat([conv_state, xbc[:, None]], dim=1)       # [B,w,ch]
    conv_out = torch.einsum("bwc,wc->bc", hist, params["conv_w"]) \
        + params["conv_b"]
    conv_out = F.silu(conv_out)
    new_conv_state = hist[:, 1:]

    xs = conv_out[..., :di].reshape(b, h, p)
    Bm = conv_out[..., di:di + NGROUPS * n].reshape(b, NGROUPS, n)
    Cm = conv_out[..., di + NGROUPS * n:].reshape(b, NGROUPS, n)
    Bm = Bm.expand(b, h, n) if NGROUPS == 1 else Bm
    Cm = Cm.expand(b, h, n) if NGROUPS == 1 else Cm
    dt = softplus(dt.float() + params["dt_bias"])             # [B,H]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                    # [B,H]
    xf = xs.float()
    new_state = (ssm_state * dA[..., None, None] +
                 torch.einsum("bhn,bh,bhp->bhnp", Bm.float(), dt, xf))
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), new_state)
    y = y + params["D"][:, None] * xf
    y = _gated_norm(y.reshape(b, di).to(x.dtype), z, params["norm"])
    return (y @ params["out_proj"])[:, None], new_conv_state, new_state

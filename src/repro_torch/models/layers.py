"""Shared neural building blocks (PyTorch port of ``repro.models.layers``):
norms, the SwiGLU MLP, the tied embedding, RoPE.

Convention as in JAX: every layer is ``init(key, cfg, ...) -> params dict``
and ``apply(params, x, ...) -> y`` on plain dicts of tensors in the JAX
layouts ([in, out] dense weights).  Initialisers draw through
:mod:`repro_torch.rng`, so the same key gives the JAX package's numbers on
any device.  The RMSNorm of :func:`norm_apply` and :func:`rms_norm` is
kernel 8 (:mod:`repro_torch.kernels.rmsnorm`).
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.config import ModelConfig, unported


def dense_init(key: torch.Tensor, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return (rng.normal(key, (d_in, d_out)) * scale).to(dtype)


# -------------------------------------------------------------------- norm --
def norm_init(cfg: ModelConfig, d: int, device=None):
    if cfg.norm != "rmsnorm":
        raise unported(f"norm={cfg.norm!r}", "A.1a")
    return {"scale": torch.ones((d,), dtype=cfg.param_dtype, device=device)}


def norm_apply(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise unported(f"norm={cfg.norm!r}", "A.1a")
    return rmsnorm(x, params["scale"], 1e-6)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x, scale, eps)


# --------------------------------------------------------------------- MLP --
def mlp_init(key: torch.Tensor, cfg: ModelConfig, d: int, d_ff: int):
    if cfg.mlp != "swiglu":
        raise unported(f"mlp={cfg.mlp!r}", "A.1d")
    k1, k2, k3 = rng.split(key, 3).unbind(0)
    return {"gate": dense_init(k1, d, d_ff, cfg.param_dtype),
            "up": dense_init(k2, d, d_ff, cfg.param_dtype),
            "down": dense_init(k3, d_ff, d, cfg.param_dtype)}


def mlp_apply(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp != "swiglu":
        raise unported(f"mlp={cfg.mlp!r}", "A.1d")
    h = torch.nn.functional.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


# -------------------------------------------------------------- embeddings --
def embed_init(key: torch.Tensor, cfg: ModelConfig):
    scale = cfg.d_model ** -0.5
    tbl = rng.normal(key, (cfg.padded_vocab, cfg.d_model)) * scale
    return {"table": tbl.to(cfg.param_dtype)}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied unembedding on the PADDED vocab; pad ids masked to -1e9."""
    logits = x @ params["table"].T                       # [..., padded_vocab]
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits


# -------------------------------------------------------------------- RoPE --
def rope_freqs(cfg: ModelConfig, dim: int, device=None) -> torch.Tensor:
    half = dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                  device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S]; rotates halves (not
    interleaved pairs), as the JAX package does."""
    angles = positions[..., None].float() * freqs        # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

"""Shared neural building blocks (PyTorch port of ``repro.models.layers``):
norms, the SwiGLU and GELU MLPs, the tied embedding, RoPE, M-RoPE and
the token cross entropy.

Convention as in JAX: every layer is ``init(key, cfg, ...) -> params dict``
and ``apply(params, x, ...) -> y`` on plain dicts of tensors in the JAX
layouts ([in, out] dense weights).  Initialisers draw through
:mod:`repro_torch.rng`, so the same key gives the JAX package's numbers on
any device.  The RMSNorm of :func:`norm_apply` and :func:`rms_norm` is
kernel 8 (:mod:`repro_torch.kernels.rmsnorm`); OLMo's nonparametric
LayerNorm is plain torch, as JAX computes it outside any Pallas kernel.
Under a model mesh (``cfg`` a :class:`repro_torch.models.parallel.
LocalConfig`) the embedding, the unembedding and the MLP's ``down`` (but
a MoE shared expert's, whole on every rank) go through
:mod:`repro_torch.models.parallel`'s collectives.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import parallel
from repro_torch.models.config import ModelConfig


def dense_init(key: torch.Tensor, d_in: int, d_out: int,
               dtype: torch.dtype, block=None) -> torch.Tensor:
    """The [d_in, d_out] weight, or its ``block`` (``rng.normal``'s)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return (rng.normal(key, (d_in, d_out), block=block) * scale).to(dtype)


# -------------------------------------------------------------------- norm --
def norm_init(cfg: ModelConfig, d: int, device=None):
    if cfg.norm == "nonparametric_ln":
        return {}                                   # OLMo: no scale, no bias
    return {"scale": torch.ones((d,), dtype=cfg.param_dtype, device=device)}


def nonparametric_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without scale or bias in float32: the biased variance
    (``jnp.var``), not torch's default ``correction=1``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_apply(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "nonparametric_ln":
        return nonparametric_ln(x)
    return rmsnorm(x, params["scale"], 1e-6)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x, scale, eps)


# --------------------------------------------------------------------- MLP --
def mlp_init(key: torch.Tensor, cfg: ModelConfig, d: int, d_ff: int,
             place=None):
    """``place``: the blocks a rank draws (``parallel.draw_plan``)."""
    def draw(k, name, d_in, d_out):
        return dense_init(k, d_in, d_out, cfg.param_dtype,
                          parallel.block(place, name, (d_in, d_out)))

    if cfg.mlp == "swiglu":
        k1, k2, k3 = rng.split(key, 3).unbind(0)
        return {"gate": draw(k1, "gate", d, d_ff),
                "up": draw(k2, "up", d, d_ff),
                "down": draw(k3, "down", d_ff, d)}
    k1, k2 = rng.split(key).unbind(0)
    return {"up": draw(k1, "up", d, d_ff), "down": draw(k2, "down", d_ff, d)}


def mlp_apply(cfg: ModelConfig, params, x: torch.Tensor,
              row_parallel: bool = True) -> torch.Tensor:
    """SwiGLU, or GELU in ``jax.nn.gelu``'s default tanh form (torch's
    default is the erf form).  ``row_parallel=False``: the weights are
    whole on every rank (MoE's shared expert), so ``down``'s product is
    not summed over the model group."""
    if cfg.mlp == "swiglu":
        h = torch.nn.functional.silu(x @ params["gate"]) * (x @ params["up"])
    else:
        h = torch.nn.functional.gelu(x @ params["up"], approximate="tanh")
    if not row_parallel:
        return h @ params["down"]
    return parallel.row_matmul(cfg, h, params["down"])


# -------------------------------------------------------------- embeddings --
def embed_init(key: torch.Tensor, cfg: ModelConfig, place=None):
    scale = cfg.d_model ** -0.5
    shape = (cfg.padded_vocab, cfg.d_model)
    tbl = rng.normal(key, shape,
                     block=parallel.block(place, "table", shape)) * scale
    return {"table": tbl.to(cfg.param_dtype)}


def embed_apply(params, tokens: torch.Tensor,
                cfg: ModelConfig | None = None) -> torch.Tensor:
    return parallel.embed(cfg, params["table"], tokens)


def unembed_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied unembedding on the PADDED vocab; pad ids masked to -1e9.  Under
    a model mesh: the rank's vocab shard, its pad ids found by their
    global index."""
    table = params["table"]
    logits = x @ table.T                       # [..., padded_vocab (shard)]
    if cfg.padded_vocab != cfg.vocab:
        lo = parallel.vocab_offset(cfg, table.shape[0])
        pad = torch.arange(lo, lo + table.shape[0], device=x.device) \
            >= cfg.vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits


# -------------------------------------------------------------------- RoPE --
def rope_freqs(cfg: ModelConfig, dim: int, device=None) -> torch.Tensor:
    half = dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                  device=device), expo)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of x [..., S, H, D] by angles [..., S, D/2]."""
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S]; rotates halves (not
    interleaved pairs), as the JAX package does."""
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, cfg: ModelConfig,
                dim: int) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the rotary dims split into (t, h, w) sections, each
    rotated by its own position stream.

    x: [B, S, H, D]; positions3: [3, B, S] (temporal, height, width ids).
    """
    half = dim // 2
    sec = cfg.mrope_sections
    if sum(sec) != half:
        raise ValueError(f"mrope_sections {sec} must sum to half the head "
                         f"dim {half}")
    freqs = rope_freqs(cfg, dim, device=x.device)              # [half]
    sec_id = torch.as_tensor(np.repeat(np.arange(3), np.asarray(sec)),
                             device=x.device)
    pos = positions3[sec_id]                                   # [half, B, S]
    return _rotate(x, pos.permute(1, 2, 0).float() * freqs)


# ------------------------------------------------------------------- loss --
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL in float32: logsumexp minus the gold logit; labels
    [B, T] int, logits [B, T, V]; ``mask`` [B, T] weights the tokens (the
    mean over its sum, at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)

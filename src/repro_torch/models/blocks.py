"""Residual blocks (PyTorch port of ``repro.models.blocks``): dense
(attention + MLP) and ssm (Mamba2).

Each kind exposes init / apply / decode with the JAX package's uniform
signature, so the LM assembly can walk the stacked per-layer params.  The
MoE block is not ported yet (ROADMAP.md A.1c).
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.models import attention, layers, ssm
from repro_torch.models.config import ModelConfig, unported


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _check_attention(cfg: ModelConfig) -> None:
    if cfg.attention == "mla":
        raise unported("MLA attention", "A.1c")


# ------------------------------------------------------------------ dense --
def dense_block_init(key: torch.Tensor, cfg: ModelConfig,
                     d_ff: int | None = None):
    _check_attention(cfg)
    k1, k2 = rng.split(key).unbind(0)
    return {"norm1": layers.norm_init(cfg, cfg.d_model, key.device),
            "attn": attention.attn_init(k1, cfg),
            "norm2": layers.norm_init(cfg, cfg.d_model, key.device),
            "mlp": layers.mlp_init(k2, cfg, cfg.d_model, d_ff or cfg.d_ff)}


def dense_block_apply(params, cfg: ModelConfig, x, positions):
    _check_attention(cfg)
    h = layers.norm_apply(cfg, params["norm1"], x)
    h = attention.self_attention(params["attn"], cfg, h, positions)
    x = x + h
    h = layers.norm_apply(cfg, params["norm2"], x)
    x = x + layers.mlp_apply(cfg, params["mlp"], h)
    return x, _no_aux(x)


def dense_block_decode(params, cfg: ModelConfig, x, cache, pos: int):
    """The new k/v land in ``cache`` in place (see decode_attention)."""
    _check_attention(cfg)
    h = layers.norm_apply(cfg, params["norm1"], x)
    h, ck, cv = attention.decode_attention(params["attn"], cfg, h,
                                           cache["k"], cache["v"], pos)
    x = x + h
    h = layers.norm_apply(cfg, params["norm2"], x)
    x = x + layers.mlp_apply(cfg, params["mlp"], h)
    return x, {"k": ck, "v": cv}


# -------------------------------------------------------------------- ssm --
def ssm_block_init(key: torch.Tensor, cfg: ModelConfig):
    return {"norm": layers.norm_init(cfg, cfg.d_model, key.device),
            "ssm": ssm.ssm_init(key, cfg)}


def ssm_block_apply(params, cfg: ModelConfig, x, positions):
    del positions
    h = layers.norm_apply(cfg, params["norm"], x)
    return x + ssm.ssm_forward(params["ssm"], cfg, h), _no_aux(x)


def ssm_block_decode(params, cfg: ModelConfig, x, cache, pos: int):
    del pos
    h = layers.norm_apply(cfg, params["norm"], x)
    y, conv_s, ssm_s = ssm.ssm_decode(params["ssm"], cfg, h,
                                      cache["conv"], cache["state"])
    return x + y, {"conv": conv_s, "state": ssm_s}


BLOCK_INIT = {"dense": dense_block_init, "ssm": ssm_block_init}
BLOCK_APPLY = {"dense": dense_block_apply, "ssm": ssm_block_apply}
BLOCK_DECODE = {"dense": dense_block_decode, "ssm": ssm_block_decode}

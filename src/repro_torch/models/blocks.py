"""Residual blocks (PyTorch port of ``repro.models.blocks``): dense
(attention + MLP), moe (attention + MoE) and ssm (Mamba2); the attention of
the first two is GQA or, for DeepSeek-V2, MLA.

Each kind exposes init / apply / decode with the JAX package's uniform
signature, so the LM assembly can walk the stacked per-layer params.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.models import attention, layers, mla, moe, parallel, ssm
from repro_torch.models.config import ModelConfig


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_init(key: torch.Tensor, cfg: ModelConfig, place=None):
    place = parallel.scope(place, "attn")
    return (mla.mla_init(key, cfg, place) if cfg.attention == "mla"
            else attention.attn_init(key, cfg, place=place))


def _attn_apply(params, cfg: ModelConfig, h, positions):
    if cfg.attention == "mla":
        return mla.mla_self_attention(params, cfg, h, positions)
    return attention.self_attention(params, cfg, h, positions)


def _attn_decode(params, cfg: ModelConfig, h, cache, pos: int):
    """The new entries land in ``cache`` in place (see decode_attention)."""
    if cfg.attention == "mla":
        h, ckv, kpe = mla.mla_decode_attention(params, cfg, h, cache["ckv"],
                                               cache["kpe"], pos)
        return h, {"ckv": ckv, "kpe": kpe}
    h, ck, cv = attention.decode_attention(params, cfg, h, cache["k"],
                                           cache["v"], pos)
    return h, {"k": ck, "v": cv}


# ------------------------------------------------------------------ dense --
def dense_block_init(key: torch.Tensor, cfg: ModelConfig,
                     d_ff: int | None = None, place=None):
    """``place``: the blocks a rank draws (``parallel.draw_plan``)."""
    k1, k2 = rng.split(key).unbind(0)
    return {"norm1": layers.norm_init(cfg, cfg.d_model, key.device),
            "attn": _attn_init(k1, cfg, place),
            "norm2": layers.norm_init(cfg, cfg.d_model, key.device),
            "mlp": layers.mlp_init(k2, cfg, cfg.d_model, d_ff or cfg.d_ff,
                                   parallel.scope(place, "mlp"))}


def dense_block_apply(params, cfg: ModelConfig, x, positions):
    h = layers.norm_apply(cfg, params["norm1"], x)
    x = x + _attn_apply(params["attn"], cfg, h, positions)
    h = layers.norm_apply(cfg, params["norm2"], x)
    x = x + layers.mlp_apply(cfg, params["mlp"], h)
    return x, _no_aux(x)


def dense_block_decode(params, cfg: ModelConfig, x, cache, pos: int):
    h = layers.norm_apply(cfg, params["norm1"], x)
    h, new_cache = _attn_decode(params["attn"], cfg, h, cache, pos)
    x = x + h
    h = layers.norm_apply(cfg, params["norm2"], x)
    x = x + layers.mlp_apply(cfg, params["mlp"], h)
    return x, new_cache


# -------------------------------------------------------------------- moe --
def moe_block_init(key: torch.Tensor, cfg: ModelConfig, place=None):
    """``place``: the blocks a rank draws (``parallel.draw_plan``)."""
    k1, k2 = rng.split(key).unbind(0)
    return {"norm1": layers.norm_init(cfg, cfg.d_model, key.device),
            "attn": _attn_init(k1, cfg, place),
            "norm2": layers.norm_init(cfg, cfg.d_model, key.device),
            "moe": moe.moe_init(k2, cfg, parallel.scope(place, "moe"))}


def moe_block_apply(params, cfg: ModelConfig, x, positions):
    h = layers.norm_apply(cfg, params["norm1"], x)
    x = x + _attn_apply(params["attn"], cfg, h, positions)
    h = layers.norm_apply(cfg, params["norm2"], x)
    y, aux = moe.moe_apply(params["moe"], cfg, h)
    return x + y, aux


def moe_block_decode(params, cfg: ModelConfig, x, cache, pos: int):
    h = layers.norm_apply(cfg, params["norm1"], x)
    h, new_cache = _attn_decode(params["attn"], cfg, h, cache, pos)
    x = x + h
    h = layers.norm_apply(cfg, params["norm2"], x)
    y, _ = moe.moe_apply(params["moe"], cfg, h)
    return x + y, new_cache


# -------------------------------------------------------------------- ssm --
def ssm_block_init(key: torch.Tensor, cfg: ModelConfig, place=None):
    """``place`` draws nothing in blocks here: JAX's rule keeps every SSM
    leaf (and both norms) whole on every model rank."""
    del place
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


BLOCK_INIT = {"dense": dense_block_init, "moe": moe_block_init,
              "ssm": ssm_block_init}
BLOCK_APPLY = {"dense": dense_block_apply, "moe": moe_block_apply,
               "ssm": ssm_block_apply}
BLOCK_DECODE = {"dense": dense_block_decode, "moe": moe_block_decode,
                "ssm": ssm_block_decode}

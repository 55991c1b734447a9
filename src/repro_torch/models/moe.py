"""Mixture-of-Experts layer with grouped capacity-based dispatch (PyTorch
port of ``repro.models.moe``).

Tokens are routed in GROUPS of ``moe_group_size`` (``x.reshape(g, tg, d)``
over ``b * s``, b-major, as in JAX: the grouping decides which tokens a
full expert drops), top-k by router probability, each (token, choice) given
a slot by its priority within its expert and dropped past the capacity.
Two dispatch modes, as in JAX: the one-hot einsums ([G, Tg, E, C] dispatch
and combine) and the gather / scatter of token indices.  Shared experts
(DeepSeek-V2) and the load-balance aux loss are kept.

The router, softmax and expert products are plain torch: JAX computes them
outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

# Leaves moe_init makes float32 whatever cfg.dtype (api.cast_params keeps
# them so).
FLOAT32_LEAVES = ("router",)


def moe_init(key: torch.Tensor, cfg: ModelConfig):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    ks = rng.split(key, 5).unbind(0)
    scale = (2.0 / (d + f)) ** 0.5
    p = {
        "router": dense_init(ks[0], d, e, torch.float32),
        "gate": (rng.normal(ks[1], (e, d, f)) * scale).to(cfg.param_dtype),
        "up": (rng.normal(ks[2], (e, d, f)) * scale).to(cfg.param_dtype),
        "down": (rng.normal(ks[3], (e, f, d)) * scale).to(cfg.param_dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(ks[4], cfg, d,
                               cfg.n_shared_experts * cfg.d_ff_expert)
    return p


def _capacity(cfg: ModelConfig, tg: int) -> int:
    c = int(tg * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return min(max(c, cfg.moe_top_k), tg)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    oh = F.one_hot(idx.long().clamp(0, n), n + 1)[..., :n]
    return oh.to(dtype)


def route(params, cfg: ModelConfig, xg: torch.Tensor):
    """Routing of grouped tokens xg [G, Tg, d]: (top_p [G, Tg, k] (the
    renormalised weights), top_i [G, Tg, k], slot [G, Tg, k], keep
    [G, Tg, k], aux).  The top-k order is ``lax.top_k``'s: descending,
    the lower expert first on a tie (a stable descending sort)."""
    g, tg, _ = xg.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = xg.float() @ params["router"]                     # [G,Tg,E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]              # [G,Tg,k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (fraction-of-tokens * mean-prob per expert)
    me = probs.mean(dim=(0, 1))                                # [E]
    ce = _one_hot(top_i[..., 0], e, torch.float32).mean(dim=(0, 1))
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)

    cap = _capacity(cfg, tg)
    # slot position of each (token, choice) within its expert, by priority
    sel = _one_hot(top_i, e, torch.int32)                      # [G,Tg,k,E]
    pos = torch.cumsum(sel.reshape(g, tg * k, e), dim=1) - 1
    slot = (pos.reshape(g, tg, k, e) * sel).sum(-1)            # [G,Tg,k]
    return top_p, top_i, slot, slot < cap, aux


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    tg = min(cfg.moe_group_size, t)
    g = t // tg
    xg = x.reshape(g, tg, d)
    dt = cfg.param_dtype
    top_p, top_i, slot, keep, aux = route(params, cfg, xg)
    cap = _capacity(cfg, tg)

    if cfg.moe_dispatch == "gather":
        # token index of each (group, expert, slot); tg = an empty slot
        # (the pad row), and a dropped choice's write lands in the column
        # past cap, which is cut off
        safe_slot = torch.where(keep, slot, cap)
        gi = torch.arange(g, device=x.device)[:, None, None]
        flat = (gi * e + top_i) * (cap + 1) + safe_slot        # [G,Tg,k]
        ti = torch.arange(tg, device=x.device)[None, :, None].expand(g, tg, k)
        token_idx = torch.full((g * e * (cap + 1),), tg, dtype=torch.int64,
                               device=x.device)
        token_idx[flat.reshape(-1)] = ti.reshape(-1)
        token_idx = token_idx.reshape(g, e, cap + 1)[..., :cap]
        xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
        xin = torch.gather(xg_pad, 1, token_idx.reshape(g, e * cap, 1)
                           .expand(g, e * cap, d)).reshape(g, e, cap, d)
    else:
        slot_oh = _one_hot(torch.where(keep, slot, cap), cap, dt)
        exp_oh = _one_hot(top_i, e, dt)                        # [G,Tg,k,E]
        dispatch = torch.einsum("gtke,gtkc->gtec", exp_oh,
                                slot_oh * keep[..., None].to(dt))
        xin = torch.einsum("gtec,gtd->gecd", dispatch, xg)     # [G,E,C,d]

    h = (F.silu(torch.einsum("gecd,edf->gecf", xin, params["gate"]))
         * torch.einsum("gecd,edf->gecf", xin, params["up"]))
    xout = torch.einsum("gecf,efd->gecd", h, params["down"])   # [G,E,C,d]

    if cfg.moe_dispatch == "gather":
        # combine: gather each (token, choice)'s expert output and blend
        flat = xout.reshape(g, e * cap, d)
        idx = top_i * cap + torch.clamp(slot, max=cap - 1)     # [G,Tg,k]
        vals = torch.gather(flat, 1, idx.reshape(g, tg * k, 1)
                            .expand(g, tg * k, d)).reshape(g, tg, k, d)
        w = (top_p * keep).to(vals.dtype)                      # [G,Tg,k]
        y = torch.einsum("gtkd,gtk->gtd", vals, w)
    else:
        combine = torch.einsum("gtke,gtkc,gtk->gtec", exp_oh, slot_oh,
                               (top_p * keep).to(dt))
        y = torch.einsum("gtec,gecd->gtd", combine, xout)

    if cfg.n_shared_experts:
        y = y + mlp_apply(cfg, params["shared"], xg)
    return y.reshape(b, s, d), aux

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

Under a model mesh (expert parallelism) a rank holds the experts
``parallel.expert_block(cfg)``: every rank routes every token over all E
experts with the replicated router, in the same order as without a mesh,
dispatches to and runs only its own, and the model group sums their
contributions in float32, rounded once (``parallel.row_einsum``).  The
shared experts are whole on every rank, so their output is added after
that sum.  Under a data axis the data group's rows are routed together
(``parallel.gather_data``), in the groups JAX forms over the whole batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.models import parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

# Leaves moe_init makes float32 whatever cfg.dtype (api.cast_params keeps
# them so).
FLOAT32_LEAVES = ("router",)


def moe_init(key: torch.Tensor, cfg: ModelConfig, place=None):
    """The layer's weights; ``place``: the blocks a rank draws
    (``parallel.draw_plan``: its experts, the shared expert whole)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    ks = rng.split(key, 5).unbind(0)
    scale = (2.0 / (d + f)) ** 0.5

    def expert_leaf(k, name, shape):
        return (rng.normal(k, shape, block=parallel.block(place, name, shape))
                * scale).to(cfg.param_dtype)

    p = {
        "router": dense_init(ks[0], d, e, torch.float32,
                             parallel.block(place, "router", (d, e))),
        "gate": expert_leaf(ks[1], "gate", (e, d, f)),
        "up": expert_leaf(ks[2], "up", (e, d, f)),
        "down": expert_leaf(ks[3], "down", (e, f, d)),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(ks[4], cfg, d,
                               cfg.n_shared_experts * cfg.d_ff_expert,
                               parallel.scope(place, "shared"))
    return p


def _capacity(cfg: ModelConfig, tg: int) -> int:
    c = int(tg * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return min(max(c, cfg.moe_top_k), tg)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    oh = F.one_hot(idx.long().clamp(0, n), n + 1)[..., :n]
    return oh.to(dtype)


def router(params, xg: torch.Tensor):
    """The router on grouped tokens xg [G, Tg, d]: (probs [G, Tg, E] in
    float32, the experts ranked by them [G, Tg, E]).  The ranking is
    ``lax.top_k``'s order: descending, the lower expert first on a tie
    (a stable descending sort)."""
    probs = torch.softmax(xg.float() @ params["router"], dim=-1)
    return probs, torch.sort(probs, dim=-1, descending=True,
                             stable=True).indices


def route(params, cfg: ModelConfig, xg: torch.Tensor):
    """Routing of grouped tokens xg [G, Tg, d]: the top ``moe_top_k`` of
    :func:`router`'s ranking, assigned (:func:`assign`)."""
    probs, ranked = router(params, xg)
    return assign(cfg, probs, ranked[..., :cfg.moe_top_k])


def assign(cfg: ModelConfig, probs: torch.Tensor, top_i: torch.Tensor):
    """The tokens' chosen experts top_i [G, Tg, k] under the router's
    probs [G, Tg, E]: (top_p [G, Tg, k] (their probabilities renormalised
    over the k), top_i, slot [G, Tg, k] (each choice's place in its
    expert, by priority), keep [G, Tg, k] (within the capacity), aux)."""
    g, tg, k = top_i.shape
    e = cfg.n_experts
    top_p = probs.gather(-1, top_i)
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
    x_all, mine_rows = parallel.gather_data(cfg, x)
    b, s, d = x_all.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    tg = min(cfg.moe_group_size, t)
    g = t // tg
    xg = x_all.reshape(g, tg, d)
    dt = cfg.param_dtype
    top_p, top_i, slot, keep, aux = route(params, cfg, xg)
    cap = _capacity(cfg, tg)
    lo, el = parallel.expert_block(cfg)
    if el != e:
        # the rank's experts [lo, lo + el) by their local index; a choice
        # of another rank's expert is dropped here (its weight 0, its
        # slot the cut-off column) and summed in from that rank
        local = top_i - lo
        mine = (local >= 0) & (local < el)
        top_i, keep = torch.where(mine, local, 0), keep & mine

    if cfg.moe_dispatch == "gather":
        # token index of each (group, expert, slot); tg = an empty slot
        # (the pad row), and a dropped choice's write lands in the column
        # past cap, which is cut off
        safe_slot = torch.where(keep, slot, cap)
        gi = torch.arange(g, device=x.device)[:, None, None]
        flat = (gi * el + top_i) * (cap + 1) + safe_slot       # [G,Tg,k]
        ti = torch.arange(tg, device=x.device)[None, :, None].expand(g, tg, k)
        token_idx = torch.full((g * el * (cap + 1),), tg, dtype=torch.int64,
                               device=x.device)
        token_idx[flat.reshape(-1)] = ti.reshape(-1)
        token_idx = token_idx.reshape(g, el, cap + 1)[..., :cap]
        xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
        xin = torch.gather(xg_pad, 1, token_idx.reshape(g, el * cap, 1)
                           .expand(g, el * cap, d)).reshape(g, el, cap, d)
    else:
        slot_oh = _one_hot(torch.where(keep, slot, cap), cap, dt)
        exp_oh = _one_hot(top_i, el, dt)                       # [G,Tg,k,E]
        dispatch = torch.einsum("gtke,gtkc->gtec", exp_oh,
                                slot_oh * keep[..., None].to(dt))
        xin = torch.einsum("gtec,gtd->gecd", dispatch, xg)     # [G,E,C,d]

    h = (F.silu(torch.einsum("gecd,edf->gecf", xin, params["gate"]))
         * torch.einsum("gecd,edf->gecf", xin, params["up"]))
    xout = torch.einsum("gecf,efd->gecd", h, params["down"])   # [G,E,C,d]

    if cfg.moe_dispatch == "gather":
        # combine: gather each (token, choice)'s expert output and blend
        flat = xout.reshape(g, el * cap, d)
        idx = top_i * cap + torch.clamp(slot, max=cap - 1)     # [G,Tg,k]
        vals = torch.gather(flat, 1, idx.reshape(g, tg * k, 1)
                            .expand(g, tg * k, d)).reshape(g, tg, k, d)
        w = (top_p * keep).to(vals.dtype)                      # [G,Tg,k]
        y = parallel.row_einsum(cfg, "gtkd,gtk->gtd", vals, w)
    else:
        combine = torch.einsum("gtke,gtkc,gtk->gtec", exp_oh, slot_oh,
                               (top_p * keep).to(dt))
        y = parallel.row_einsum(cfg, "gtec,gecd->gtd", combine, xout)

    if cfg.n_shared_experts:
        y = y + mlp_apply(cfg, params["shared"], xg, row_parallel=False)
    return y.reshape(b, s, d)[mine_rows], aux

"""Mobility models (PyTorch port of ``repro.core.mobility``).

Paper §II-B uses Random Direction (RD): each round every user draws a fresh
heading ``d ~ U[0, 2 pi)``, moves at speed ``v`` for the round duration, and
reflects specularly off the boundary of the L x L area.  The registry
``MOBILITY_MODELS`` holds the JAX package's four models in its order:

  * ``rd``           — Random Direction (the paper's default);
  * ``waypoint``     — Random Waypoint: move toward a uniform target at
    speed v, pause ``pause_s`` seconds on arrival, then draw a new target
    (the rest of the arrival round is forfeited);
  * ``gauss_markov`` — the AR(1) velocity ``v_t = a v_{t-1} + sqrt(1 - a^2)
    u_t`` with a fresh RD draw ``u_t`` and memory ``a = gm_memory``; the
    carried velocity flips at a wall;
  * ``static``       — users never move.

Every model shares the JAX package's step signature

    step_fn(key, pos, aux, area, dt, speed, pause_s, gm_memory)
        -> (new_pos, new_aux)

and ``aux`` (``vel``, ``target``, ``pause_s``) is drawn exactly as the JAX
package draws it, so the PRNG streams stay aligned.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import const, rng
from repro_torch.core.types import MobilityState, WirelessConfig


def _reflect(x: torch.Tensor, length: float) -> torch.Tensor:
    """Fold unbounded coordinates back into [0, length]: the triangle wave
    ``length - |mod(x, 2 length) - length|``."""
    return length - torch.abs(torch.remainder(x, 2.0 * length) - length)


def _fold_slope(x: torch.Tensor, length: float) -> torch.Tensor:
    """d reflect(x) / dx in {-1, +1}: the sign a carried velocity picks up
    when the unbounded coordinate ``x`` folds back into [0, length]."""
    return torch.where(torch.remainder(x, 2.0 * length) < length, 1.0, -1.0)


def _rd_velocity(key: torch.Tensor, n: int, speed) -> torch.Tensor:
    """[N, 2] fresh Random-Direction velocity: uniform heading, |v| = speed."""
    theta = rng.uniform(key, (n,), 0.0, 2.0 * math.pi)
    return speed * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def init_positions(key: torch.Tensor, cfg: WirelessConfig) -> MobilityState:
    """Uniform users + uniform BSs in the L x L area (paper §IV)."""
    ku, kb = rng.split(key)
    return MobilityState(
        user_pos=rng.uniform(ku, (cfg.n_users, 2), 0.0, cfg.area_m),
        bs_pos=rng.uniform(kb, (cfg.n_bs, 2), 0.0, cfg.area_m))


def grid_bs_positions(key: torch.Tensor, n_bs: int,
                      area_m: float) -> torch.Tensor:
    """[M, 2] BSs on a near-square jittered grid covering the area."""
    cols = int(np.ceil(np.sqrt(n_bs)))
    rows = (n_bs + cols - 1) // cols
    xs = (np.arange(n_bs) % cols + 0.5) / cols * area_m
    ys = (np.arange(n_bs) // cols + 0.5) / rows * area_m
    grid = torch.as_tensor(np.stack([xs, ys], axis=-1), dtype=torch.float32,
                           device=key.device)
    jitter = rng.uniform(key, (n_bs, 2), -0.05, 0.05) * area_m
    return torch.clamp(grid + jitter, 0.0, area_m)


def init_positions_grid_bs(key: torch.Tensor,
                           cfg: WirelessConfig) -> MobilityState:
    """Users uniform; BSs on a jittered grid."""
    ku, kb = rng.split(key)
    return MobilityState(
        user_pos=rng.uniform(ku, (cfg.n_users, 2), 0.0, cfg.area_m),
        bs_pos=grid_bs_positions(kb, cfg.n_bs, cfg.area_m))


def init_aux(key: torch.Tensor, n_users: int, cfg: WirelessConfig,
             speed_mps=None) -> dict:
    """Kinematic state shared by every model of the JAX registry."""
    v = cfg.speed_mps if speed_mps is None else speed_mps
    kv, kt = rng.split(key)
    return {
        "vel": _rd_velocity(kv, n_users, v),
        "target": rng.uniform(kt, (n_users, 2), 0.0, cfg.area_m),
        "pause_s": torch.zeros((n_users,), device=key.device),
    }


def _step_rd(key, pos, aux, area, dt, speed, pause_s, gm_memory):
    delta = _rd_velocity(key, pos.shape[0], speed) * dt
    return _reflect(pos + delta, area), aux


def _step_static(key, pos, aux, area, dt, speed, pause_s, gm_memory):
    return pos, aux


def _step_gauss_markov(key, pos, aux, area, dt, speed, pause_s, gm_memory):
    u = _rd_velocity(key, pos.shape[0], speed)
    a = gm_memory
    vel = a * aux["vel"] + torch.sqrt(torch.clamp(
        const(1.0 - a * a, torch.float32, pos.device),
        min=0.0)) * u
    unfolded = pos + vel * dt
    # momentum survives the bounce: flip by the fold slope at the endpoint
    new_vel = vel * _fold_slope(unfolded, area)
    return _reflect(unfolded, area), {**aux, "vel": new_vel}


def _step_waypoint(key, pos, aux, area, dt, speed, pause_s, gm_memory):
    target, pause = aux["target"], aux["pause_s"]
    to_t = target - pos
    dist = torch.linalg.norm(to_t, dim=-1)
    paused = pause > 0.0
    # a host speed multiplies in double (as a Python float in jax), a
    # tensor knob in float32 (as the sweep's traced knob)
    reach = const(speed * dt, torch.float32, pos.device)
    arrive = ~paused & (dist <= reach)
    step_len = torch.where(paused, 0.0, torch.minimum(reach, dist))
    direction = to_t / torch.clamp(dist, min=1e-9)[:, None]
    new_pos = pos + direction * step_len[:, None]
    new_target = torch.where(arrive[:, None],
                             rng.uniform(key, tuple(pos.shape), 0.0, area),
                             target)
    new_pause = torch.where(
        arrive, const(pause_s, pos.dtype, pos.device),
        torch.clamp(pause - dt, min=0.0))
    return new_pos, {**aux, "target": new_target, "pause_s": new_pause}


# name -> step function; the order is the JAX registry's (its lax.switch
# branch index, :func:`model_index`).
MOBILITY_MODELS: dict = {
    "rd": _step_rd,
    "waypoint": _step_waypoint,
    "gauss_markov": _step_gauss_markov,
    "static": _step_static,
}


def register_mobility_model(name: str, step_fn) -> None:
    """Add a custom model with the shared step signature; it is usable in
    a ScenarioSpec and the sweeps at once."""
    if name in MOBILITY_MODELS:
        raise ValueError(f"mobility model {name!r} already registered")
    MOBILITY_MODELS[name] = step_fn


def model_index(name: str) -> int:
    """Stable integer id of a registered model (its registry position)."""
    try:
        return list(MOBILITY_MODELS).index(name)
    except ValueError:
        raise ValueError(f"unknown mobility model {name!r}; choose from "
                         f"{tuple(MOBILITY_MODELS)}") from None


def step_named(name: str, key: torch.Tensor, pos: torch.Tensor, aux: dict,
               cfg: WirelessConfig, speed_mps=None, pause_s: float = 0.0,
               gm_memory: float = 0.75) -> tuple[torch.Tensor, dict]:
    """One round of the model ``name``."""
    if name not in MOBILITY_MODELS:
        raise ValueError(f"unknown mobility model {name!r}; choose from "
                         f"{tuple(MOBILITY_MODELS)}")
    v = cfg.speed_mps if speed_mps is None else speed_mps
    return MOBILITY_MODELS[name](key, pos, aux, cfg.area_m,
                                 cfg.round_duration_s, v, pause_s, gm_memory)


def step_switch(model_id: int, key: torch.Tensor, pos: torch.Tensor,
                aux: dict, area: float, dt: float, speed, pause_s,
                gm_memory) -> tuple[torch.Tensor, dict]:
    """One round of the model with registry id ``model_id``.

    The JAX sweep evaluates every model under ``lax.switch`` and keeps the
    selected branch's output; a sweep cell of the port has one model, so
    it dispatches on the host and runs only that branch."""
    models = list(MOBILITY_MODELS.values())
    if not 0 <= int(model_id) < len(models):
        raise ValueError(f"mobility model id {model_id} out of range "
                         f"[0, {len(models)})")
    return models[int(model_id)](key, pos, aux, area, dt, speed, pause_s,
                                 gm_memory)


def step(key: torch.Tensor, state: MobilityState, cfg: WirelessConfig,
         speed_mps: float | None = None) -> MobilityState:
    """Advance one communication round of RD mobility (paper default)."""
    v = cfg.speed_mps if speed_mps is None else speed_mps
    theta = rng.uniform(key, (state.user_pos.shape[0],), 0.0, 2.0 * math.pi)
    disp = v * cfg.round_duration_s
    delta = disp * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    return MobilityState(user_pos=_reflect(state.user_pos + delta,
                                           cfg.area_m),
                         bs_pos=state.bs_pos)


def trajectory(key: torch.Tensor, state: MobilityState, cfg: WirelessConfig,
               n_rounds: int) -> torch.Tensor:
    """[n_rounds, N, 2] RD positions over a whole run, one key a round
    from ``split(key, n_rounds)``."""
    keys = rng.split(key, n_rounds)
    pos, out = state.user_pos, []
    for r in range(n_rounds):
        pos = step(keys[r], MobilityState(user_pos=pos, bs_pos=state.bs_pos),
                   cfg).user_pos
        out.append(pos)
    return torch.stack(out)

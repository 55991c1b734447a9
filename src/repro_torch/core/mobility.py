"""Mobility models (PyTorch port of ``repro.core.mobility``).

Paper §II-B uses Random Direction (RD): each round every user draws a fresh
heading ``d ~ U[0, 2 pi)``, moves at speed ``v`` for the round duration, and
reflects specularly off the boundary of the L x L area.  ``static`` keeps
every user in place.  Other models of the JAX registry are not ported yet;
naming one raises.

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

from repro_torch import rng
from repro_torch.core.types import MobilityState, WirelessConfig


def _reflect(x: torch.Tensor, length: float) -> torch.Tensor:
    """Fold unbounded coordinates back into [0, length]: the triangle wave
    ``length - |mod(x, 2 length) - length|``."""
    return length - torch.abs(torch.remainder(x, 2.0 * length) - length)


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


MOBILITY_MODELS: dict = {
    "rd": _step_rd,
    "static": _step_static,
}


def step_named(name: str, key: torch.Tensor, pos: torch.Tensor, aux: dict,
               cfg: WirelessConfig, speed_mps=None, pause_s: float = 0.0,
               gm_memory: float = 0.75) -> tuple[torch.Tensor, dict]:
    """One round of the model ``name``."""
    if name not in MOBILITY_MODELS:
        raise ValueError(f"mobility model {name!r} is not ported yet; "
                         f"choose from {tuple(MOBILITY_MODELS)}")
    v = cfg.speed_mps if speed_mps is None else speed_mps
    return MOBILITY_MODELS[name](key, pos, aux, cfg.area_m,
                                 cfg.round_duration_s, v, pause_s, gm_memory)

"""Shared dataclasses for the wireless FL control plane (PyTorch port).

Units follow the paper, as in the JAX package: powers are spectral
densities in dBm/MHz, bandwidth in MHz, the model size ``S`` in Mbit,
latency in seconds, area in metres, speed in m/s.  The state classes are
plain dataclasses of tensors; the round engine passes them from step to
step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """Static parameters of the multi-BS wireless FL system (paper §IV)."""

    n_users: int = 50
    n_bs: int = 8
    area_m: float = 1000.0          # L: users/BSs live in an L x L square
    noise_dbm_mhz: float = -114.0   # N0 noise PSD
    tx_dbm_mhz: float = 14.0        # p^max transmit PSD
    model_mbit: float = 0.5         # S: uplink payload per client (Mbit)
    bs_bandwidth_mhz: float = 1.0   # B_k, homogeneous default (Fig. 2/4)
    tcomp_min_s: float = 0.10       # local computation latency ~ U(min, max)
    tcomp_max_s: float = 0.11
    speed_mps: float = 20.0         # v: Random Direction speed
    round_duration_s: float = 1.0   # dt used by the mobility integrator
    rho1: float = 0.1               # Eq. (8g) historical participation rate
    rho2: float = 0.5               # Eq. (8h) per-round participation rate

    def __post_init__(self):
        if not (self.n_users > 0 and self.n_bs > 0):
            raise ValueError("n_users and n_bs must be positive")
        if not (0.0 <= self.rho1 <= 1.0 and 0.0 <= self.rho2 <= 1.0):
            raise ValueError("rho1 and rho2 must lie in [0, 1]")
        if not self.tcomp_max_s >= self.tcomp_min_s >= 0.0:
            raise ValueError("need tcomp_max_s >= tcomp_min_s >= 0")


@dataclasses.dataclass
class SchedulingProblem:
    """One round's inputs to a scheduler.

    snr [N, M] linear uplink SNR; tcomp [N] local compute latency (s);
    bs_bw [M] per-BS bandwidth (MHz); coeff [N, M] ``S / log2(1 + snr)``
    (MHz*s); necessary [N] bool, users Eq. (8g) forces in;
    min_participants, the Eq. (8h) floor ``ceil(rho2 * N)``;
    p_deliver, the optional [N] estimate of each user's probability of
    delivering its update (the fault layer's pre-scheduling observable,
    which ``dagsa-r`` discounts the SNR by); ``None`` in the perfect world;
    payload_mbit, the optional [N] per-user uplink payload s_k (Mbit) of a
    compressed uplink.  ``coeff`` is already payload-scaled, so this field
    is bookkeeping only; ``None`` means every user uploads ``model_mbit``.
    """

    snr: torch.Tensor
    tcomp: torch.Tensor
    bs_bw: torch.Tensor
    coeff: torch.Tensor
    necessary: torch.Tensor
    min_participants: int
    p_deliver: Optional[torch.Tensor] = None
    payload_mbit: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ScheduleResult:
    """One round's decision: assign [N, M] bool, selected [N] bool, bw [N]
    MHz (0 if unscheduled), bs_time [M] t_k^* (0 for an empty BS) and the
    round latency t_round = max_k bs_time."""

    assign: torch.Tensor
    selected: torch.Tensor
    bw: torch.Tensor
    bs_time: torch.Tensor
    t_round: torch.Tensor

    def participation(self) -> torch.Tensor:
        return self.selected.float()


@dataclasses.dataclass
class MobilityState:
    """Positions of users [N, 2] and BSs [M, 2] in metres."""

    user_pos: torch.Tensor
    bs_pos: torch.Tensor

    def distances(self) -> torch.Tensor:
        """[N, M] user->BS euclidean distance in metres (floored at 1 m)."""
        d = torch.linalg.vector_norm(
            self.user_pos[:, None, :] - self.bs_pos[None, :, :], dim=-1)
        return torch.clamp(d, min=1.0)


# ----------------------------------------------- round-step state slots --
@dataclasses.dataclass(frozen=True)
class WorldState:
    """Where everyone is and the mobility model's kinematic aux state."""

    pos: torch.Tensor       # [N, 2] user positions (metres)
    mob_aux: dict


@dataclasses.dataclass(frozen=True)
class ClientState:
    """Per-client bookkeeping the server carries across rounds."""

    counts: torch.Tensor    # [N] f32 Eq. (8g) participation counts
    prev_bs: Optional[torch.Tensor] = None  # [N] i32 last round's serving
                                            # BS (hierarchical and faulty
                                            # runs: handover detection)


@dataclasses.dataclass(frozen=True)
class ServerState:
    """The global model (a dict of parameter tensors); on hierarchical
    runs the per-BS edge models and the data mass each aggregated since
    the last global sync; on buffered-async runs the in-flight event
    queue (``repro_torch.fl.rounds.async_queue_init``).  ``None`` where
    the feature is off."""

    params: Any
    edge_params: Any = None                     # leaves [M, ...]
    edge_weight: Optional[torch.Tensor] = None  # [M] f32
    queue: Optional[tuple] = None               # (comp, tick, idx, size, upd)


@dataclasses.dataclass(frozen=True)
class SchedulerState:
    """Per-user running estimates of the stateful online schedulers
    (``repro_torch.core.scheduler.STATEFUL_SCHEDULERS``); one layout
    serves every policy, each reads the fields it needs:

      n_obs:     [N] f32 rounds the user was scheduled (observations)
      rate_sum:  [N] f32 summed observed best-BS spectral efficiency
      tcomp_sum: [N] f32 summed observed compute latency
      sel_count: [N] f32 selection counts (biased-adaptive's deficit)
      ewma:      [N] f32 exponentially weighted rate average (PF)
      ptr:       [] int32 round-robin window start
      t:         [] f32 rounds elapsed (UCB's exploration clock)
    """

    n_obs: torch.Tensor
    rate_sum: torch.Tensor
    tcomp_sum: torch.Tensor
    sel_count: torch.Tensor
    ewma: torch.Tensor
    ptr: torch.Tensor
    t: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RoundState:
    """The full round-step state: one slot per concern + the PRNG key.
    ``sched`` is the stateful scheduler's estimates (None for the
    others)."""

    world: WorldState
    clients: ClientState
    server: ServerState
    sched: Optional[SchedulerState]
    key: torch.Tensor       # [2] int64 threefry key (repro_torch.rng)

"""Wireless channel: 3GPP-style path loss + Rayleigh fading (PyTorch port
of ``repro.core.channel``).

Paper Eq. (4): uplink rate ``r = B log2(1 + p |h|^2 / N0)`` with
``PL(dB) = 128.1 + 37.6 log10(D_km)``.  Powers are spectral densities, so
the SNR does not depend on the allocated bandwidth.  Of the JAX
package's hooks only the per-user payload (the compressed uplink) is
ported: no shadowing or heterogeneity yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch import rng
from repro_torch.core.types import (MobilityState, SchedulingProblem,
                                    WirelessConfig)


def path_loss_db(dist_m: torch.Tensor) -> torch.Tensor:
    """128.1 + 37.6 log10(D) with D in km (paper §II-C)."""
    return 128.1 + 37.6 * torch.log10(torch.clamp(dist_m, min=1.0) / 1000.0)


def mean_snr(dist_m: torch.Tensor, cfg: WirelessConfig) -> torch.Tensor:
    """Linear mean SNR (large-scale only): 10^((p - N0 - PL)/10)."""
    snr_db = cfg.tx_dbm_mhz - cfg.noise_dbm_mhz - path_loss_db(dist_m)
    return torch.pow(10.0, snr_db / 10.0)


def sample_snr(key: torch.Tensor, dist_m: torch.Tensor,
               cfg: WirelessConfig) -> torch.Tensor:
    """Rayleigh-faded linear SNR: |h|^2 ~ Exp(1) on top of the mean SNR."""
    gain = rng.exponential(key, tuple(dist_m.shape))
    return mean_snr(dist_m, cfg) * gain


def spectral_efficiency(snr: torch.Tensor) -> torch.Tensor:
    """log2(1 + SNR), bits/s/Hz."""
    return torch.log2(1.0 + snr)


def bandwidth_time_coeff(snr: torch.Tensor, cfg: WirelessConfig,
                         payload_mbit: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """c_{i,k} = s_i / log2(1 + snr_{i,k})  [MHz * s].

    ``payload_mbit`` [N] is each user's uplink payload s_i (compressed
    uplink); ``None`` keeps the uniform ``cfg.model_mbit`` exactly.
    """
    se = torch.clamp(spectral_efficiency(snr), min=1e-9)
    if payload_mbit is None:
        return cfg.model_mbit / se
    return payload_mbit.float()[:, None] / se


def sample_tcomp(key: torch.Tensor, cfg: WirelessConfig) -> torch.Tensor:
    """Per-user local computation latency ~ U(tmin, tmax) (paper §IV)."""
    return rng.uniform(key, (cfg.n_users,), cfg.tcomp_min_s, cfg.tcomp_max_s)


def make_problem(key: torch.Tensor, state: MobilityState, cfg: WirelessConfig,
                 part_counts: torch.Tensor, round_idx: int,
                 bs_bw: torch.Tensor | None = None,
                 payload_mbit: torch.Tensor | None = None
                 ) -> SchedulingProblem:
    """Assemble one round's SchedulingProblem from the physical state.

    ``necessary`` is Eq. (8g) against the post-round floor: user i must
    participate if sitting out would leave its count below
    ``rho1 * (round_idx + 1)`` (computed in float32, as the JAX engine
    does).  ``payload_mbit`` [N] replaces the uniform payload S in the
    bandwidth-time coefficients (see :func:`bandwidth_time_coeff`).
    """
    k_snr, k_tc = rng.split(key)
    snr = sample_snr(k_snr, state.distances(), cfg)
    tcomp = sample_tcomp(k_tc, cfg)
    coeff = bandwidth_time_coeff(snr, cfg, payload_mbit=payload_mbit)
    dev = part_counts.device
    if bs_bw is None:
        bs_bw = torch.full((cfg.n_bs,), cfg.bs_bandwidth_mhz, device=dev)
    floor = (torch.tensor(cfg.rho1, dtype=torch.float32, device=dev)
             * torch.tensor(float(round_idx + 1), device=dev))
    necessary = part_counts < floor
    return SchedulingProblem(
        snr=snr, tcomp=tcomp, bs_bw=bs_bw, coeff=coeff, necessary=necessary,
        min_participants=int(math.ceil(cfg.rho2 * cfg.n_users)),
        payload_mbit=payload_mbit)

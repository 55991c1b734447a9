"""Scheduler registry (PyTorch port of ``repro.core.scheduler.schedule``).

Ported: the host greedy ``dagsa`` (Algorithm 1, the JAX package's
default), ``dagsa_jit``, their delivery-discounted twins ``dagsa-r`` and
``dagsa-r-host``, and the paper's baselines ``rs``, ``ub``,
``fedcs_low``, ``fedcs_high`` and ``sa``.  The stateful online policies
of the JAX registry are a later slice of the port (ROADMAP.md, queue A,
"Other schedulers"); naming one raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import baselines, dagsa, dagsa_jit
from repro_torch.core.types import (ScheduleResult, SchedulingProblem,
                                    WirelessConfig)

SCHEDULERS = ("dagsa", "dagsa_jit", "dagsa-r", "dagsa-r-host", "rs", "ub",
              "fedcs_low", "fedcs_high", "sa")

# Schedulers whose decisions come from host numpy (seeded by ``seed``)
# rather than from the round's PRNG key.
HOST_SCHEDULERS = ("dagsa", "dagsa-r-host")

# the JAX registry's other names, each a later slice of the port
LATER = ("ucb", "biased-adaptive", "rr", "pf")

# FedCS time thresholds from paper §IV.
FEDCS_LOW_S = 0.6
FEDCS_HIGH_S = 1.0


def check_scheduler(name: str) -> None:
    if name in SCHEDULERS:
        return
    if name in LATER:
        raise ValueError(f"scheduler {name!r} is not ported to repro_torch "
                         f"yet (ROADMAP.md queue A, 'Other schedulers'); "
                         f"choose from {SCHEDULERS}")
    raise ValueError(f"unknown scheduler {name!r}; choose from {SCHEDULERS}")


def delivery_discounted(problem: SchedulingProblem) -> SchedulingProblem:
    """The ``dagsa-r`` transform: each user's SNR row times its estimated
    delivery probability.  DAGSA reads the SNR only as a ranking score
    (the latency math runs on ``coeff``), and a per-user scale keeps each
    user's best BS.  A problem without ``p_deliver`` is returned as is."""
    if problem.p_deliver is None:
        return problem
    p = torch.clamp(problem.p_deliver, 0.0, 1.0)
    return dataclasses.replace(problem, snr=problem.snr * p[..., None])


def schedule(name: str, problem: SchedulingProblem, cfg: WirelessConfig,
             key: torch.Tensor, seed: int = 0) -> ScheduleResult:
    """Dispatch one round of scheduling by algorithm name: the host
    schedulers draw from ``seed`` (numpy), the others from ``key``
    (threefry; ``fedcs_*`` and ``sa`` draw nothing)."""
    check_scheduler(name)
    if name == "dagsa":
        return dagsa.dagsa_schedule(problem, seed=seed)
    if name == "dagsa_jit":
        return dagsa_jit.dagsa_schedule_jit(problem, key)
    if name == "dagsa-r":
        return dagsa_jit.dagsa_schedule_jit(delivery_discounted(problem), key)
    if name == "dagsa-r-host":
        return dagsa.dagsa_schedule(delivery_discounted(problem), seed=seed)
    if name == "rs":
        return baselines.rs_schedule(problem, key, cfg.rho2)
    if name == "ub":
        return baselines.ub_schedule(problem, key, cfg.rho2)
    if name == "fedcs_low":
        return baselines.fedcs_schedule(problem, FEDCS_LOW_S)
    if name == "fedcs_high":
        return baselines.fedcs_schedule(problem, FEDCS_HIGH_S)
    return baselines.sa_schedule(problem)

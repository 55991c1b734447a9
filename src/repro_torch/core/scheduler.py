"""Scheduler registry (PyTorch port of ``repro.core.scheduler.schedule``).

``dagsa`` (the host greedy of Algorithm 1, the JAX package's default) and
``dagsa_jit`` are ported so far.  The other schedulers of the JAX registry
are later slices of the port (ROADMAP.md, queue A, "Other schedulers");
naming one raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import dagsa, dagsa_jit
from repro_torch.core.types import (ScheduleResult, SchedulingProblem,
                                    WirelessConfig)

SCHEDULERS = ("dagsa", "dagsa_jit")

# the JAX registry's other names, each a later slice of the port
LATER = ("dagsa-r", "dagsa-r-host", "rs", "ub", "fedcs_low", "fedcs_high",
         "sa", "ucb", "biased-adaptive", "rr", "pf")


def check_scheduler(name: str) -> None:
    if name in SCHEDULERS:
        return
    if name in LATER:
        raise ValueError(f"scheduler {name!r} is not ported to repro_torch "
                         f"yet (ROADMAP.md queue A, 'Other schedulers'); "
                         f"choose from {SCHEDULERS}")
    raise ValueError(f"unknown scheduler {name!r}; choose from {SCHEDULERS}")


def schedule(name: str, problem: SchedulingProblem, cfg: WirelessConfig,
             key: torch.Tensor, seed: int = 0) -> ScheduleResult:
    """Dispatch one round of scheduling by algorithm name: ``dagsa`` draws
    from ``seed`` (numpy), ``dagsa_jit`` from ``key`` (threefry)."""
    check_scheduler(name)
    if name == "dagsa":
        return dagsa.dagsa_schedule(problem, seed=seed)
    return dagsa_jit.dagsa_schedule_jit(problem, key)

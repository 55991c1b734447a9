"""Scheduler registry (PyTorch port of ``repro.core.scheduler.schedule``).

Only ``dagsa_jit`` is ported so far.  The other schedulers of the JAX
registry are later slices of the port (ROADMAP.md, queue A, "Other
schedulers"); naming one raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import dagsa_jit
from repro_torch.core.types import (ScheduleResult, SchedulingProblem,
                                    WirelessConfig)

SCHEDULERS = ("dagsa_jit",)

# the JAX registry's other names, each a later slice of the port
LATER = ("dagsa", "dagsa-r", "dagsa-r-host", "rs", "ub", "fedcs_low",
         "fedcs_high", "sa", "ucb", "biased-adaptive", "rr", "pf")


def check_scheduler(name: str) -> None:
    if name in SCHEDULERS:
        return
    if name in LATER:
        raise ValueError(f"scheduler {name!r} is not ported to repro_torch "
                         f"yet (ROADMAP.md queue A, 'Other schedulers'); "
                         f"choose from {SCHEDULERS}")
    raise ValueError(f"unknown scheduler {name!r}; choose from {SCHEDULERS}")


def schedule(name: str, problem: SchedulingProblem, cfg: WirelessConfig,
             key: torch.Tensor) -> ScheduleResult:
    """Dispatch one round of scheduling by algorithm name."""
    check_scheduler(name)
    return dagsa_jit.dagsa_schedule_jit(problem, key)

"""Round latency assembly: paper Eq. (3)-(5), plus the deadline-truncated
variant of the fault model (PyTorch port of ``repro.core.latency``).

t_round = max_i a_i (tcomp_i + t_up_i);  t_up_i = c_{i,k(i)} / B_i.
Download latency is negligible (paper §II-C) and omitted, as in Eq. (9).
A compressed uplink's per-user payload s_i is already inside c_{i,k}, so
nothing here reads the payload but :func:`uplink_bits`.

Under a round deadline T_dl (``repro_torch.fl.faults.FaultSpec.
deadline_s``) the server stops waiting: t_round = min(T_dl, slowest
scheduled client), and late clients are dropped from the aggregation
(:func:`deadline_round_latency`, :func:`on_time`).
"""
from __future__ import annotations

import torch

from repro_torch import const
from repro_torch.core.types import ScheduleResult, SchedulingProblem


def uplink_bits(delivered: torch.Tensor, payload_mbit) -> torch.Tensor:
    """Total uplink traffic (bits) of one round's delivered updates:
    ``delivered`` [N] bool, ``payload_mbit`` a scalar or [N] s_k (decimal
    Mbit)."""
    p = const(payload_mbit, torch.float32, delivered.device)
    return (delivered.float() * p.expand(delivered.shape)).sum() * 1e6


def upload_latency(problem: SchedulingProblem,
                   result: ScheduleResult) -> torch.Tensor:
    """[N] per-user upload latency under the decided assignment and
    bandwidth (0 for an unscheduled user)."""
    c_user = torch.where(result.assign, problem.coeff, 0.0).sum(dim=1)
    return torch.where(result.selected,
                       c_user / torch.clamp(result.bw, min=1e-12), 0.0)


def round_latency(problem: SchedulingProblem,
                  result: ScheduleResult) -> torch.Tensor:
    """Eq. (3) from first principles (cross-checks ``result.t_round``)."""
    t_user = problem.tcomp + upload_latency(problem, result)
    return torch.where(result.selected, t_user, 0.0).max()


def per_user_latency(problem: SchedulingProblem, result: ScheduleResult,
                     tcomp: torch.Tensor | None = None) -> torch.Tensor:
    """[N] realized end-to-end latency of each scheduled user; ``tcomp``
    overrides the nominal compute times (the straggler-stretched ones).
    An unscheduled user reports its compute time only."""
    t_c = problem.tcomp if tcomp is None else tcomp
    return t_c + upload_latency(problem, result)


def deadline_round_latency(t_user: torch.Tensor, selected: torch.Tensor,
                           deadline_s) -> torch.Tensor:
    """Deadline-truncated Eq. (3): the slowest scheduled client or the
    deadline, whichever comes first; 0 for an empty selection."""
    slowest = torch.where(selected, t_user, 0.0).max()
    return torch.clamp(slowest, max=deadline_s)


def on_time(t_user: torch.Tensor, deadline_s) -> torch.Tensor:
    """[N] bool: the update arrives before the server stops waiting."""
    return t_user <= deadline_s


def completion_times(problem: SchedulingProblem, result: ScheduleResult,
                     now, tcomp: torch.Tensor | None = None) -> torch.Tensor:
    """[N] absolute instant each scheduled user's update lands,
    ``now + tcomp_i + t_up_i``; ``inf`` for an unscheduled user (the
    buffered-async engine's "never completes" sentinel)."""
    t_user = per_user_latency(problem, result, tcomp=tcomp)
    return torch.where(result.selected, now + t_user, torch.inf)

"""Scheduler registry and participation bookkeeping (PyTorch port of
``repro.core.scheduler``).

The host greedy ``dagsa`` (Algorithm 1, the JAX package's default),
``dagsa_jit``, their delivery-discounted twins ``dagsa-r`` and
``dagsa-r-host``, the paper's baselines ``rs``, ``ub``, ``fedcs_low``,
``fedcs_high`` and ``sa``, and the stateful online policies ``ucb``,
``biased-adaptive``, ``rr`` and ``pf``, which carry per-user running
estimates (a :class:`SchedulerState`) from round to round.
:func:`schedule_batch` schedules a fleet of same-shape problems at once.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import baselines, channel, dagsa, dagsa_jit
from repro_torch.core.types import (ScheduleResult, SchedulerState,
                                    SchedulingProblem, WirelessConfig)

# Stateful online policies: per-user running estimates instead of the
# perfect CSI DAGSA assumes.
STATEFUL_SCHEDULERS = ("ucb", "biased-adaptive", "rr", "pf")

SCHEDULERS = ("dagsa", "dagsa_jit", "dagsa-r", "dagsa-r-host", "rs", "ub",
              "fedcs_low", "fedcs_high", "sa") + STATEFUL_SCHEDULERS

# Schedulers with a fleet-batched entry point (see schedule_batch).
BATCH_SCHEDULERS = ("dagsa_jit", "dagsa-r", "rs", "ub", "fedcs_low",
                    "fedcs_high", "sa") + STATEFUL_SCHEDULERS

# Schedulers whose decisions come from host numpy (seeded by ``seed``)
# rather than from the round's PRNG key.
HOST_SCHEDULERS = ("dagsa", "dagsa-r-host")

# FedCS time thresholds from paper §IV.
FEDCS_LOW_S = 0.6
FEDCS_HIGH_S = 1.0

# Stateful-policy constants (the JAX package's EQUATIONS.md, "UCB index").
UCB_C = 1.0          # exploration weight of the UCB bonus
PF_EWMA = 0.1        # proportional-fair rate-average step
BIASED_T0 = 10.0     # biased-adaptive: rounds until the deficit term
                     # carries half the score weight


def check_scheduler(name: str) -> None:
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; choose from "
                         f"{SCHEDULERS}")


@dataclasses.dataclass
class ParticipationState:
    """Eq. (8g) history: how many rounds each user has participated."""

    counts: torch.Tensor     # [N] float32
    round_idx: int

    @staticmethod
    def init(n_users: int, device=None) -> "ParticipationState":
        return ParticipationState(counts=torch.zeros((n_users,),
                                                     device=device),
                                  round_idx=0)

    def update(self, result: ScheduleResult) -> "ParticipationState":
        return ParticipationState(counts=self.counts + result.participation(),
                                  round_idx=self.round_idx + 1)


def delivery_discounted(problem: SchedulingProblem) -> SchedulingProblem:
    """The ``dagsa-r`` transform: each user's SNR row times its estimated
    delivery probability.  DAGSA reads the SNR only as a ranking score
    (the latency math runs on ``coeff``), and a per-user scale keeps each
    user's best BS.  A problem without ``p_deliver`` is returned as is."""
    if problem.p_deliver is None:
        return problem
    p = torch.clamp(problem.p_deliver, 0.0, 1.0)
    return dataclasses.replace(problem, snr=problem.snr * p[..., None])


# ------------------------------------------------ stateful online policies --
def scheduler_state_init(name: str, n_users: int,
                         device=None) -> SchedulerState | None:
    """Fresh estimates for a stateful policy, None for the others; every
    policy shares the one layout."""
    if name not in STATEFUL_SCHEDULERS:
        return None
    z = torch.zeros((n_users,), dtype=torch.float32, device=device)
    return SchedulerState(
        n_obs=z, rate_sum=z, tcomp_sum=z, sel_count=z, ewma=z,
        ptr=torch.zeros((), dtype=torch.int32, device=device),
        t=torch.zeros((), dtype=torch.float32, device=device))


def _best_se(problem: SchedulingProblem) -> torch.Tensor:
    """[..., N] observed best-BS spectral efficiency, log2(1 + max_k snr)."""
    return channel.spectral_efficiency(problem.snr.float().amax(dim=-1))


def scheduler_state_update(state: SchedulerState, problem: SchedulingProblem,
                           selected: torch.Tensor) -> SchedulerState:
    """The observation update every stateful policy shares: scheduling a
    user reveals its rate and compute draw this round, so its sums and
    counts advance only where ``selected``; the round clock ``t`` and the
    round-robin window always advance."""
    sel = selected.float()
    se = _best_se(problem)
    n = state.n_obs.shape[-1]
    k = int(problem.min_participants)
    return SchedulerState(
        n_obs=state.n_obs + sel,
        rate_sum=state.rate_sum + sel * se,
        tcomp_sum=state.tcomp_sum + sel * problem.tcomp.float(),
        sel_count=state.sel_count + sel,
        ewma=(1.0 - PF_EWMA) * state.ewma + PF_EWMA * se * sel,
        ptr=((state.ptr + k) % n).to(torch.int32),
        t=state.t + 1.0)


def _select_topk(score: torch.Tensor, necessary: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Top-k users by score with the Eq. (8g) necessary users forced in
    (+inf score, and the union covers k < #necessary); a stable sort
    breaks score ties by user index."""
    n = score.shape[-1]
    boosted = torch.where(necessary, torch.inf, score)
    order = torch.argsort(-boosted, dim=-1, stable=True)
    ranks = torch.arange(n, dtype=torch.int32,
                         device=score.device).expand_as(order)
    rank = torch.empty_like(ranks).scatter_(-1, order, ranks)
    return necessary | (rank < k)


def _stateful_score(name: str, problem: SchedulingProblem,
                    cfg: WirelessConfig, state: SchedulerState, k: int,
                    n: int) -> torch.Tensor:
    if name == "ucb":
        # optimism in the face of latency: 1 / (estimated per-user
        # latency) + exploration bonus; unobserved users first
        n_obs = torch.clamp(state.n_obs, min=1.0)
        mu_se = state.rate_sum / n_obs
        mu_tc = state.tcomp_sum / n_obs
        bbar = problem.bs_bw.float().mean(dim=-1, keepdim=True)
        t_est = mu_tc + cfg.model_mbit / torch.clamp(bbar * mu_se, min=1e-9)
        bonus = UCB_C * torch.sqrt(2.0 * torch.log(state.t + 2.0) / n_obs)
        return torch.where(state.n_obs > 0.0, 1.0 / t_est + bonus, torch.inf)
    if name == "biased-adaptive":
        # over-sample strong channels early; as t grows, weight shifts to
        # each user's selection-count deficit against the fair share k/n
        se = _best_se(problem)
        strength = se / (se.amax(dim=-1, keepdim=True) + 1e-9)
        deficit = (k / n) * state.t - state.sel_count
        dnorm = deficit / (deficit.abs().amax(dim=-1, keepdim=True) + 1e-9)
        wt = state.t / (state.t + BIASED_T0)
        return (1.0 - wt) * strength + wt * dnorm
    if name == "pf":
        # proportional fair: instantaneous rate over its EWMA average
        return _best_se(problem) / torch.clamp(state.ewma, min=1e-6)
    raise ValueError(f"unknown stateful scheduler {name!r}; choose from "
                     f"{STATEFUL_SCHEDULERS}")


def schedule_stateful(name: str, problem: SchedulingProblem,
                      cfg: WirelessConfig, key: torch.Tensor,
                      state: SchedulerState
                      ) -> tuple[ScheduleResult, SchedulerState]:
    """One round of a stateful policy: score -> top-k -> optimal bandwidth.

    Every policy selects Eq. (8h)'s ``min_participants`` users (plus the
    Eq. (8g) necessary ones), puts each on its best-SNR BS and solves Eq.
    (11) exactly; they differ only in the selection score.  ``key`` is
    unused (the policies are deterministic given the state).  A problem
    with a leading fleet axis is scheduled whole."""
    del key
    n = problem.snr.shape[-2]
    k = int(problem.min_participants)
    if name == "rr":
        # a sliding window of k users, advancing by k each round
        idx = (torch.arange(n, dtype=torch.int32,
                            device=problem.snr.device) - state.ptr) % n
        selected = (idx < k) | problem.necessary
    else:
        score = _stateful_score(name, problem, cfg, state, k, n)
        selected = _select_topk(score, problem.necessary, k)
    assign = baselines._best_bs_assign(problem.snr, selected)
    result = baselines._optimal_result(problem, assign)
    return result, scheduler_state_update(state, problem, result.selected)


def schedule(name: str, problem: SchedulingProblem, cfg: WirelessConfig,
             key: torch.Tensor, seed: int = 0) -> ScheduleResult:
    """Dispatch one round of scheduling by algorithm name: the host
    schedulers draw from ``seed`` (numpy), the others from ``key``
    (threefry; ``fedcs_*``, ``sa`` and the stateful policies draw
    nothing).  A stateful policy starts from fresh state here (round 0);
    the round engines carry its state through :func:`schedule_stateful`."""
    check_scheduler(name)
    if name in STATEFUL_SCHEDULERS:
        state = scheduler_state_init(name, problem.snr.shape[-2],
                                     device=problem.snr.device)
        return schedule_stateful(name, problem, cfg, key, state)[0]
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


def schedule_batch(name: str, problems, keys: torch.Tensor,
                   **kwargs) -> ScheduleResult:
    """Schedule a fleet of same-shape problems at once: ``problems`` a
    stacked :class:`SchedulingProblem` (leading fleet axis) or a sequence
    of them, ``keys`` [F, 2].  Extra kwargs reach the batched greedy
    (``method``, ``iters``, ``selection_block``, ``snr_scale``); the
    others take ``cfg``.  Decisions match the per-problem scheduler with
    the same keys; the stateful policies start from fresh state."""
    if name not in BATCH_SCHEDULERS:
        raise ValueError(f"unknown batch scheduler {name!r}; "
                         f"choose from {BATCH_SCHEDULERS}")
    if not isinstance(problems, SchedulingProblem):
        problems = dagsa_jit.stack_problems(problems)
    if name == "dagsa_jit":
        return dagsa_jit.dagsa_schedule_batch(problems, keys, **kwargs)
    if name == "dagsa-r":
        return dagsa_jit.dagsa_schedule_batch(delivery_discounted(problems),
                                              keys, **kwargs)
    cfg = kwargs.pop("cfg", None) or WirelessConfig()
    if kwargs:
        raise TypeError(f"schedule_batch({name!r}) got unexpected kwargs "
                        f"{sorted(kwargs)}")
    return _schedule_batch_generic(name, problems, keys, cfg)


def _schedule_batch_generic(name: str, problems: SchedulingProblem,
                            keys: torch.Tensor,
                            cfg: WirelessConfig) -> ScheduleResult:
    """The fleet through the baselines' and the stateful policies' own
    tensor code, which takes the leading axis (kernel 3 once on [F, N, M],
    kernel 1 once on the F x M rows; one threefry draw a key)."""
    return schedule(name, problems, cfg, keys)

"""Baseline schedulers from paper §IV: RS, UB, FedCS (Low/High), SA
(PyTorch port of ``repro.core.baselines``).

Every baseline puts a user on its best-channel BS, ``argmax_k snr``
(the lowest index on a tie, as ``jnp.argmax``): kernel ``best_bs_argmax``
on the card, its plain version on the CPU.  RS and SA then split each
BS's bandwidth optimally (Eq. (11)-(12), kernel ``bandwidth_solve``); UB
and FedCS split it evenly.
"""
from __future__ import annotations

import torch

from repro_torch import const, rng
from repro_torch.core import bandwidth
from repro_torch.core.types import ScheduleResult, SchedulingProblem
from repro_torch.kernels.select_topk import best_bs_argmax

# FedCS evaluates its candidate prefixes this many at a time, so each BS
# holds O(N x 64) values rather than an [N, N] matrix (as in the JAX
# package's lax.map batch).
FEDCS_CHUNK = 64


def _best_bs_assign(snr: torch.Tensor,
                    selected: torch.Tensor) -> torch.Tensor:
    """[..., N, M] one-hot of argmax_k snr, zeroed for unselected users
    (a leading fleet axis: one kernel launch for the fleet)."""
    best = best_bs_argmax(snr.float().contiguous()).long()
    bs = torch.arange(snr.shape[-1], device=snr.device)
    return (best[..., None] == bs) & selected[..., None]


def _optimal_result(problem: SchedulingProblem,
                    assign: torch.Tensor) -> ScheduleResult:
    t_k, user_bw = bandwidth.solve_all(problem.coeff, problem.tcomp, assign,
                                       problem.bs_bw)
    return ScheduleResult(assign=assign, selected=assign.any(dim=-1),
                          bw=user_bw, bs_time=t_k, t_round=t_k.amax(dim=-1))


def _uniform_result(problem: SchedulingProblem,
                    assign: torch.Tensor) -> ScheduleResult:
    """Even bandwidth split inside each BS (UB / FedCS)."""
    n_per_bs = assign.sum(dim=-2)                            # [..., M]
    per_user = problem.bs_bw / torch.clamp(n_per_bs, min=1)  # [..., M]
    user_bw = torch.where(assign, per_user[..., None, :], 0.0).sum(dim=-1)
    t_k = bandwidth.uniform_time(problem.coeff, problem.tcomp, assign,
                                 problem.bs_bw)
    return ScheduleResult(assign=assign, selected=assign.any(dim=-1),
                          bw=user_bw, bs_time=t_k, t_round=t_k.amax(dim=-1))


def _bernoulli_with_necessary(key: torch.Tensor, problem: SchedulingProblem,
                              p: float) -> torch.Tensor:
    """Random participation at rate p; Eq. (8g)-necessary users always in.
    Keys [F, 2] draw a fleet's [F, N] at once (one draw a key)."""
    sel = rng.bernoulli(key, p, (problem.snr.shape[-2],))
    return sel | problem.necessary


def rs_schedule(problem: SchedulingProblem, key: torch.Tensor,
                p: float) -> ScheduleResult:
    """Randomly Select: bernoulli(p) users, best-channel BS, OPTIMAL bw."""
    selected = _bernoulli_with_necessary(key, problem, p)
    return _optimal_result(problem, _best_bs_assign(problem.snr, selected))


def ub_schedule(problem: SchedulingProblem, key: torch.Tensor,
                p: float) -> ScheduleResult:
    """Uniform Bandwidth: bernoulli(p) users, best-channel BS, EVEN bw."""
    selected = _bernoulli_with_necessary(key, problem, p)
    return _uniform_result(problem, _best_bs_assign(problem.snr, selected))


def sa_schedule(problem: SchedulingProblem) -> ScheduleResult:
    """Select All: everyone participates, best-channel BS, OPTIMAL bw."""
    selected = torch.ones(problem.snr.shape[:-1], dtype=torch.bool,
                          device=problem.snr.device)
    return _optimal_result(problem, _best_bs_assign(problem.snr, selected))


def fedcs_schedule(problem: SchedulingProblem,
                   threshold_s: float) -> ScheduleResult:
    """FedCS [Nishio & Yonetani 2019] extended to multi-BS (paper §IV).

    Each user is a candidate only at its best-channel BS.  Each BS admits
    candidates in descending-SNR order (a stable sort: equal SNRs keep
    user order; non-candidates sort last through -inf) while the round
    time under an EVEN split stays <= threshold: with j admitted users,
    t(j) = max_{i<=j} (tcomp_i + c_i * j / B_k), and the BS takes the
    largest feasible j.  t(j) is a masked max over the sorted prefix,
    :data:`FEDCS_CHUNK` positions at a time for every BS (and every
    problem of a leading fleet axis) at once.
    """
    snr, coeff, tcomp, bs_bw = (problem.snr, problem.coeff, problem.tcomp,
                                problem.bs_bw)
    n = snr.shape[-2]
    dev = snr.device
    cand = _best_bs_assign(snr, torch.ones(snr.shape[:-1], dtype=torch.bool,
                                           device=dev))       # [..., N, M]
    sort_key = torch.where(cand, snr, -torch.inf)
    order = torch.argsort(-sort_key, dim=-2, stable=True)     # [..., N, M]
    c_s = torch.gather(coeff, -2, order)
    tc_s = torch.gather(tcomp[..., None].expand_as(order), -2, order)
    is_cand = torch.gather(cand, -2, order)
    pos = torch.arange(n, device=dev)
    thr = const(threshold_s, torch.float32, dev)
    t_for_j = []
    for j0 in range(0, n, FEDCS_CHUNK):
        js = pos[j0:j0 + FEDCS_CHUNK]                         # [C]
        jj = (js + 1).to(coeff.dtype)[:, None, None]
        # t(j+1) over the first j+1 sorted candidates: tc + c * (j+1) / bw
        vals = (tc_s[..., None, :, :] + c_s[..., None, :, :] * jj
                / bs_bw[..., None, None, :])                  # [..., C, N, M]
        live = (is_cand[..., None, :, :]
                & (pos[None, :, None] <= js[:, None, None]))
        t_for_j.append(torch.where(live, vals, -torch.inf).amax(dim=-2))
    t_for_j = torch.cat(t_for_j, dim=-2)                      # [..., N, M]
    counts = pos + 1
    n_cand = is_cand.sum(dim=-2)
    feasible = ((t_for_j <= thr)
                & (counts[:, None] <= n_cand[..., None, :]))
    n_take = torch.where(feasible, counts[:, None], 0).amax(dim=-2)  # [..., M]
    take_sorted = pos[:, None] < n_take[..., None, :]
    take = torch.zeros_like(cand).scatter(-2, order, take_sorted)
    return _uniform_result(problem, take & cand)

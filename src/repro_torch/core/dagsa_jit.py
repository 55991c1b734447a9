"""DAGSA-X: the greedy of Algorithm 1 as tensor steps (PyTorch port of
``repro.core.dagsa_jit``, one problem at a time).

The JAX ``lax.while_loop`` becomes a host loop over torch ops with one host
sync per greedy step, for the loop condition.  Each step calls the
selection kernel ``masked_bs_argmax`` once and the ``bandwidth_solve``
kernel once on the M trial rows (each BS with its candidate added); step 1
calls ``best_bs_argmax`` once.  Decisions follow the JAX greedy exactly:

* the PRNG is consumed as there: ``key, krand = split(key)`` on every
  iteration when M > 1, whether or not the forced BS is used;
* ties go to the lowest index, and the greedy scores candidates by
  ``where(feasible, cand_val, -inf)``.

Inside the loop the state is kept BS-major (``assign_t`` [M, N]) so the
trial rows need no transpose.

The SNR plane may be float32, bfloat16 or int8 dB codes with a per-BS
``snr_scale`` (the sweeps' compact channel storage): both selection
kernels apply the scale before they compare, so the candidates' values
then live in the dB domain, which orders them as the linear SNR does.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.core import bandwidth
from repro_torch.core.types import ScheduleResult, SchedulingProblem
from repro_torch.kernels.bandwidth_solve import bandwidth_solve
from repro_torch.kernels.select_topk import best_bs_argmax, masked_bs_argmax


def _bs_times_with_candidate(coeff_t, tcomp, assign_t, bs_bw, cand, t_bs,
                             method="newton", iters=None):
    """t_k^* if BS k additionally got its candidate user cand[k]: the M
    trial rows in one ``bandwidth_solve`` call, warm-started at ``t_bs``."""
    m = bs_bw.shape[0]
    trial = assign_t.clone()
    trial[torch.arange(m, device=trial.device), cand.long()] = True
    return bandwidth_solve(coeff_t, tcomp, trial, bs_bw, lo=t_bs,
                           method=method, iters=iters)


def _schedule(snr, coeff, tcomp, bs_bw, necessary, min_participants: int,
              key, method="newton", iters=None, snr_scale=None,
              loop_coeff=None):
    """The greedy on one problem.  ``loop_coeff`` is the coefficient plane
    the candidate solves after the first read (None: ``coeff``): the JAX
    sweep's bf16 plane, whose rounding XLA keeps only inside its greedy
    loop (ROADMAP C.10)."""
    n, m = snr.shape
    dev = snr.device
    coeff_t = coeff.T.contiguous()                              # [M, N]
    loop_t = coeff_t if loop_coeff is None else loop_coeff.T.contiguous()
    snr = snr.contiguous()

    # -- step 1: necessary users to their best-channel BS ------------------
    best_bs = best_bs_argmax(snr, snr_scale)
    bs_ids = torch.arange(m, device=dev)
    assign_t = (best_bs[None, :] == bs_ids[:, None]) & necessary[None, :]
    remaining = ~necessary
    t_bs = bandwidth_solve(coeff_t, tcomp, assign_t, bs_bw, method=method,
                           iters=iters)
    t_star = t_bs.max()

    def candidates(c_t):
        cand, cand_val = masked_bs_argmax(snr, remaining, snr_scale)
        t_with = _bs_times_with_candidate(c_t, tcomp, assign_t, bs_bw,
                                          cand, t_bs, method=method,
                                          iters=iters)
        return cand, cand_val, t_with

    cand, cand_val, t_with = candidates(coeff_t)
    while True:
        has_cand = remaining.any()
        feasible = (t_with <= t_star) & has_cand
        any_feasible = feasible.any()
        need_more = assign_t.any(dim=0).sum() < min_participants
        if not bool(has_cand & (any_feasible | need_more)):     # host sync
            break
        # pick the feasible BS whose candidate has the best channel;
        # otherwise force-add to a random BS and raise the threshold (8h)
        score = torch.where(feasible, cand_val, -torch.inf)
        k_greedy = torch.argmax(score)
        if m > 1:
            key, krand = rng.split(key).unbind(dim=-2)
            k_forced = rng.randint(krand, (), 0, m).long()
        else:
            k_forced = torch.zeros((), dtype=torch.long, device=dev)
        k_star = torch.where(any_feasible, k_greedy, k_forced)
        i_star = cand[k_star].long()
        # the loop condition held, so this step adds (i_star, k_star)
        assign_t[k_star, i_star] = True
        remaining[i_star] = False
        t_new = t_with[k_star]
        # the accepted candidate evaluation IS the BS's new optimal time
        t_bs[k_star] = t_new
        t_star = torch.where(any_feasible, t_star, torch.maximum(t_star, t_new))
        cand, cand_val, t_with = candidates(loop_t)

    assign = assign_t.T.contiguous()
    t_k, user_bw = bandwidth.solve_all(coeff, tcomp, assign, bs_bw,
                                       method=method, iters=iters)
    return assign, assign.any(dim=1), user_bw, t_k, t_k.max()


def dagsa_schedule_jit(problem: SchedulingProblem, key: torch.Tensor,
                       method: str = "newton",
                       iters: int | None = None) -> ScheduleResult:
    """One round of DAGSA on ``problem`` with the PRNG key ``key`` [2]."""
    assign, selected, bw, t_k, t_round = _schedule(
        problem.snr, problem.coeff, problem.tcomp, problem.bs_bw,
        problem.necessary, int(problem.min_participants), key,
        method=method, iters=iters)
    return ScheduleResult(assign=assign, selected=selected, bw=bw,
                          bs_time=t_k, t_round=t_round)

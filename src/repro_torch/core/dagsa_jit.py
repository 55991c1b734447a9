"""DAGSA-X: the greedy of Algorithm 1 as tensor steps (PyTorch port of
``repro.core.dagsa_jit``), over one problem or a fleet of them.

The JAX package vmaps a ``lax.while_loop`` over a fleet of problems; the
port runs one loop for the whole fleet, for as many steps as the fleet's
longest greedy, through :func:`repro_torch.kernels.graph_while.
device_while`: a host loop with one host sync a greedy step (``live.any()``,
the loop condition), or, in a round captured into a CUDA graph, a WHILE
node whose test the device makes.  Each step calls the selection kernel
``masked_bs_argmax`` once on the fleet's [F, N, M] planes and the
``bandwidth_solve`` kernel once on its F x M trial rows (each BS with its
candidate added); step 1 calls ``best_bs_argmax`` once.  A single problem
is the fleet of one (:func:`_schedule`), so one greedy body serves both.

Decisions follow the vmapped JAX greedy exactly:

* each problem evaluates its own loop condition, and once it is false the
  problem's whole state stops changing, its PRNG key included (vmap over
  ``while_loop`` selects the old state for a finished problem);
* the PRNG is consumed as there: ``key, krand = split(key)`` on every
  step of a running problem when M > 1, whether or not the forced BS is
  used;
* ties go to the lowest index, and the greedy scores candidates by
  ``where(feasible, cand_val, -inf)``.

Inside the loop the state is kept BS-major (``assign_t`` [F, M, N]) so the
trial rows need no transpose.

The SNR plane may be float32, bfloat16 or int8 dB codes with a per-BS
``snr_scale`` (the sweeps' compact channel storage): both selection
kernels apply the scale before they compare, so the candidates' values
then live in the dB domain, which orders them as the linear SNR does.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import rng
from repro_torch.core import bandwidth
from repro_torch.core.types import ScheduleResult, SchedulingProblem
from repro_torch.kernels import graph_while, select_topk
from repro_torch.kernels.bandwidth_solve import bandwidth_solve


def _bs_times_with_candidate(coeff_t, tcomp, assign_t, bs_bw, cand, t_bs,
                             method="newton", iters=None):
    """t_k^* if BS k additionally got its candidate user cand[f, k]: the
    fleet's F x M trial rows in one ``bandwidth_solve`` call, warm-started
    at ``t_bs``."""
    f, m = bs_bw.shape
    dev = assign_t.device
    trial = assign_t.clone()
    trial.index_put_((torch.arange(f, device=dev)[:, None],
                      torch.arange(m, device=dev)[None, :], cand.long()),
                     torch.ones((), dtype=torch.bool, device=dev))
    return bandwidth_solve(coeff_t, tcomp, trial, bs_bw, lo=t_bs,
                           method=method, iters=iters)


def _selection(snr, snr_scale, selection_block):
    """Algorithm 1's two argmaxes: the kernels (their plain versions on
    the CPU), or on CPU tensors with a ``selection_block`` the chunked
    twins, which stream [block, M] user blocks with the same decisions.
    On CUDA the kernels stream the plane already, so the block changes
    nothing there."""
    if selection_block is not None and not snr.is_cuda:
        def best_bs(s):
            return select_topk.best_bs_argmax_chunked(s, selection_block,
                                                      snr_scale)

        def cands(s, rem):
            return select_topk.masked_bs_argmax_chunked(
                s, rem, selection_block, snr_scale)
        return best_bs, cands
    return (lambda s: select_topk.best_bs_argmax(s, snr_scale),
            lambda s, rem: select_topk.masked_bs_argmax(s, rem, snr_scale))


def _schedule_batch(snr, coeff, tcomp, bs_bw, necessary,
                    min_participants: int, keys, method="newton",
                    iters=None, selection_block=None, snr_scale=None,
                    loop_coeff=None):
    """The greedy on a fleet: snr/coeff [F, N, M], tcomp/necessary [F, N],
    bs_bw [F, M], keys [F, 2], snr_scale [F, M] or None.  ``loop_coeff``
    ([F, N, M] or None: ``coeff``) is the coefficient plane the candidate
    solves read after the first: the JAX sweep's bf16 plane, whose
    rounding XLA keeps only inside its greedy loop (ROADMAP C.10).
    Returns (assign [F, N, M], selected [F, N], bw [F, N], t_k [F, M],
    t_round [F])."""
    f, n, m = snr.shape
    dev = snr.device
    fi = torch.arange(f, device=dev)
    coeff_t = coeff.transpose(1, 2).contiguous()                # [F, M, N]
    loop_t = (coeff_t if loop_coeff is None
              else loop_coeff.transpose(1, 2).contiguous())
    snr = snr.contiguous()
    keys = keys.clone()                     # the loop advances it in place
    best_bs_of, cands_of = _selection(snr, snr_scale, selection_block)

    # -- step 1: necessary users to their best-channel BS ------------------
    best_bs = best_bs_of(snr)                                   # [F, N]
    bs_ids = torch.arange(m, device=dev)
    assign_t = ((best_bs[:, None, :] == bs_ids[None, :, None])
                & necessary[:, None, :])                        # [F, M, N]
    remaining = ~necessary
    t_bs = bandwidth_solve(coeff_t, tcomp, assign_t, bs_bw, method=method,
                           iters=iters)                         # [F, M]
    t_star = t_bs.amax(dim=-1)                                  # [F]

    def candidates(c_t):
        cand, cand_val = cands_of(snr, remaining)               # [F, M]
        t_with = _bs_times_with_candidate(c_t, tcomp, assign_t, bs_bw,
                                          cand, t_bs, method=method,
                                          iters=iters)
        return cand, cand_val, t_with

    cand, cand_val, t_with = candidates(coeff_t)
    live = torch.ones((f,), dtype=torch.bool, device=dev)

    # the loop state the condition hands the step, in place: a captured
    # pass replays on the same addresses
    feasible = torch.zeros((f, m), dtype=torch.bool, device=dev)
    any_feasible = torch.zeros((f,), dtype=torch.bool, device=dev)

    def cond():
        """The loop condition each problem evaluates (into ``feasible``,
        ``any_feasible`` and ``live``): a finished problem stays finished
        (its state is frozen, as vmap over while_loop freezes it)."""
        has_cand = remaining.any(dim=-1)
        feasible.copy_((t_with <= t_star[:, None]) & has_cand[:, None])
        any_feasible.copy_(feasible.any(dim=-1))
        need_more = assign_t.any(dim=1).sum(dim=-1) < min_participants
        live.logical_and_(has_cand & (any_feasible | need_more))
        return live.any()

    def step():
        """One greedy step of every live problem, in place."""
        # pick the feasible BS whose candidate has the best channel;
        # otherwise force-add to a random BS and raise the threshold (8h)
        score = torch.where(feasible, cand_val, -torch.inf)
        k_greedy = torch.argmax(score, dim=-1)
        if m > 1:
            new_keys, krand = rng.split(keys).unbind(dim=-2)
            keys.copy_(torch.where(live[:, None], new_keys, keys))
            k_forced = rng.randint(krand, (), 0, m).long()
        else:
            k_forced = torch.zeros((f,), dtype=torch.long, device=dev)
        k_star = torch.where(any_feasible, k_greedy, k_forced)
        i_star = cand.gather(1, k_star[:, None])[:, 0].long()
        # a live problem adds (i_star, k_star); the others write back what
        # they hold
        assign_t[fi, k_star, i_star] = assign_t[fi, k_star, i_star] | live
        remaining[fi, i_star] = remaining[fi, i_star] & ~live
        t_new = t_with.gather(1, k_star[:, None])[:, 0]
        # the accepted candidate evaluation IS the BS's new optimal time
        t_bs[fi, k_star] = torch.where(live, t_new, t_bs[fi, k_star])
        t_star.copy_(torch.where(live & ~any_feasible,
                                 torch.maximum(t_star, t_new), t_star))
        for buf, new in zip((cand, cand_val, t_with), candidates(loop_t)):
            buf.copy_(new)

    # a host read of the test a pass, or, on a stream that is capturing a
    # round, a WHILE node whose test the device makes
    graph_while.device_while(cond, step)

    assign = assign_t.transpose(1, 2).contiguous()              # [F, N, M]
    t_k, user_bw = bandwidth.solve_all(coeff, tcomp, assign, bs_bw,
                                       method=method, iters=iters)
    return assign, assign.any(dim=-1), user_bw, t_k, t_k.amax(dim=-1)


def _schedule(snr, coeff, tcomp, bs_bw, necessary, min_participants: int,
              key, method="newton", iters=None, selection_block=None,
              snr_scale=None, loop_coeff=None):
    """The greedy on one problem: the fleet of one."""
    out = _schedule_batch(
        snr[None], coeff[None], tcomp[None], bs_bw[None], necessary[None],
        min_participants, key[None], method=method, iters=iters,
        selection_block=selection_block,
        snr_scale=None if snr_scale is None else snr_scale[None],
        loop_coeff=None if loop_coeff is None else loop_coeff[None])
    return tuple(x[0] for x in out)


def dagsa_schedule_jit(problem: SchedulingProblem, key: torch.Tensor,
                       method: str = "newton", iters: int | None = None,
                       selection_block: int | None = None) -> ScheduleResult:
    """One round of DAGSA on ``problem`` with the PRNG key ``key`` [2]."""
    assign, selected, bw, t_k, t_round = _schedule(
        problem.snr, problem.coeff, problem.tcomp, problem.bs_bw,
        problem.necessary, int(problem.min_participants), key,
        method=method, iters=iters, selection_block=selection_block)
    return ScheduleResult(assign=assign, selected=selected, bw=bw,
                          bs_time=t_k, t_round=t_round)


# --------------------------------------------------------------- batched --
def stack_problems(problems: Sequence[SchedulingProblem]) -> SchedulingProblem:
    """Stack a fleet of same-shape problems along a new leading axis.
    ``min_participants`` must agree across the fleet, and ``p_deliver`` be
    set on all problems or none, as in the JAX package."""
    mins = {int(p.min_participants) for p in problems}
    if len(mins) != 1:
        raise ValueError(f"fleet min_participants must agree, got {mins}")
    have_p = [p.p_deliver is not None for p in problems]
    if any(have_p) and not all(have_p):
        raise ValueError("fleet p_deliver must be set on all problems or "
                         "none")
    return SchedulingProblem(
        snr=torch.stack([p.snr for p in problems]),
        tcomp=torch.stack([p.tcomp for p in problems]),
        bs_bw=torch.stack([p.bs_bw for p in problems]),
        coeff=torch.stack([p.coeff for p in problems]),
        necessary=torch.stack([p.necessary for p in problems]),
        min_participants=mins.pop(),
        p_deliver=(torch.stack([p.p_deliver for p in problems])
                   if all(have_p) else None))


def dagsa_schedule_batch(problems, keys: torch.Tensor, method: str = "newton",
                         iters: int | None = None,
                         selection_block: int | None = None,
                         snr_scale: torch.Tensor | None = None
                         ) -> ScheduleResult:
    """DAGSA-X over a fleet of problems in one host loop.

    ``problems``: a stacked :class:`SchedulingProblem` (a leading fleet
    axis on every tensor field) or a sequence of same-shape problems;
    ``keys`` [F, 2], one a problem; ``snr_scale`` [F, M] when the planes
    hold int8 dB codes.  Returns a ScheduleResult with a leading fleet
    axis on every field, whose decisions equal
    :func:`dagsa_schedule_jit` a problem with the same keys."""
    if not isinstance(problems, SchedulingProblem):
        problems = stack_problems(problems)
    assign, selected, bw, t_k, t_round = _schedule_batch(
        problems.snr, problems.coeff, problems.tcomp, problems.bs_bw,
        problems.necessary, int(problems.min_participants), keys,
        method=method, iters=iters, selection_block=selection_block,
        snr_scale=snr_scale)
    return ScheduleResult(assign=assign, selected=selected, bw=bw,
                          bs_time=t_k, t_round=t_round)

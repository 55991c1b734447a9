"""DAGSA — Delay-Aware Greedy Search Algorithm (paper Algorithm 1), the
host greedy (PyTorch port of ``repro.core.dagsa``; the reading of the
listing and the steps are documented there).

  1. C <- users whose historical participation would violate Eq. (8g);
     place each on its best-channel BS.
  2. t* <- max_k T(S_k), the delay threshold implied by step 1.
  3. One greedy pass: each BS keeps adding its best-channel remaining user
     while its optimal time T(S_k u {i}) stays <= t*.
  4. While Eq. (8h) (>= N*rho2 participants) fails, force-add the best user
     of a uniformly random BS, raise t* to that BS's new time, go to 3.
  5. Final bandwidth split via Eq. (12) on every BS.

Steps 1-4 are numpy in float64 on the host, as in the JAX package, so the
two packages take the same decisions from the same problem and seed: one
``numpy.random.Generator`` seeded from ``seed`` is the only entropy (the
step-1 shuffle and the step-4 BS draw; a single-BS problem draws
nothing), ties go to the lowest index (``np.argmax``), and per-BS times
are cached and warm-start every candidate's Eq. (11) solve.  Step 5 runs
:func:`repro_torch.core.bandwidth.solve_all` in float32 on the problem's
device: the ``bandwidth_solve`` kernel on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bandwidth
from repro_torch.core.types import ScheduleResult, SchedulingProblem


def _bs_time_np(coeff: np.ndarray, tcomp: np.ndarray, mask: np.ndarray,
                bw: float, method: str = "newton", iters: int | None = None,
                lo_hint: float = 0.0, tol: float = 1e-9) -> float:
    """Numpy Eq. (11) solve for one BS (the JAX package's mirror of
    ``bandwidth.bs_time``).

    Safeguarded Newton by default (early exit at relative KKT tolerance
    ``tol``); ``method="bisect"`` is the fixed 60-iteration bisection.
    ``lo_hint`` tightens the lower bracket: the BS's previous t_k^* when
    evaluating a superset of its users.
    """
    default = bandwidth.default_iters(method)   # rejects unknown methods
    if not mask.any():
        return 0.0
    if iters is None:
        iters = default
    c = coeff[mask]
    tc = tcomp[mask]
    tmax = float(tc.max())
    hi = tmax + float(c.sum()) / max(bw, 1e-12) + 1e-9
    lo = min(max(tmax, lo_hint), hi)
    if method == "bisect":
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            demand = float(np.sum(c / np.maximum(mid - tc, 1e-12)))
            if demand > bw:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)
    t = hi
    for _ in range(iters):
        r = 1.0 / np.maximum(t - tc, 1e-12)
        inv = c * r
        f = float(inv.sum()) - bw
        if abs(f) <= tol * max(bw, 1e-12):
            break
        if f > 0:
            lo = t
        else:
            hi = t
        df = -float(np.sum(inv * r))
        t_newton = t - f / min(df, -1e-12)
        t = t_newton if lo < t_newton < hi else 0.5 * (lo + hi)
    return t


def dagsa_schedule(problem: SchedulingProblem,
                   seed: int = 0) -> ScheduleResult:
    """Run Algorithm 1 on one round's problem; the result lies on the
    problem's device."""
    snr = problem.snr.detach().cpu().numpy().astype(np.float64)
    coeff = problem.coeff.detach().cpu().numpy().astype(np.float64)
    tcomp = problem.tcomp.detach().cpu().numpy().astype(np.float64)
    bs_bw = problem.bs_bw.detach().cpu().numpy().astype(np.float64)
    necessary = problem.necessary.detach().cpu().numpy().astype(bool)
    n, m = snr.shape
    rng = np.random.default_rng(seed)   # the ONLY entropy source below

    assign = np.zeros((n, m), dtype=bool)
    remaining = np.ones(n, dtype=bool)
    t_bs = np.zeros(m)                  # cached per-BS optimal times t_k^*

    def bs_time(k: int) -> float:
        return _bs_time_np(coeff[:, k], tcomp, assign[:, k], float(bs_bw[k]),
                           lo_hint=t_bs[k])

    def bs_time_with(k: int, i: int) -> float:
        trial = assign[:, k].copy()
        trial[i] = True
        # warm start: adding a user can only raise t_k^* (f is monotone).
        return _bs_time_np(coeff[:, k], tcomp, trial, float(bs_bw[k]),
                           lo_hint=t_bs[k])

    # -- Step 1: necessary users (Eq. 8g) to their best-channel BS ----------
    nec_idx = np.flatnonzero(necessary)
    rng.shuffle(nec_idx)                       # "Random select i in C"
    for i in nec_idx:
        k = int(np.argmax(snr[i]))
        assign[i, k] = True
        remaining[i] = False

    # -- Step 2: automated threshold ----------------------------------------
    for k in range(m):
        t_bs[k] = bs_time(k)
    t_star = float(t_bs.max(initial=0.0))

    def fill_pass(t_star: float) -> None:
        """One greedy pass: each BS absorbs best-channel users under t*."""
        for k in range(m):
            while remaining.any():
                cand = np.where(remaining, snr[:, k], -np.inf)
                i = int(np.argmax(cand))
                t_trial = bs_time_with(k, i)
                if t_trial > t_star:
                    break
                assign[i, k] = True
                remaining[i] = False
                t_bs[k] = t_trial          # reuse the accepted evaluation

    # -- Steps 3-4: fill, then raise the threshold until Eq. (8h) holds -----
    fill_pass(t_star)
    while int(assign.any(axis=1).sum()) < problem.min_participants \
            and remaining.any():
        # a single-BS problem's draw is determined: it consumes no entropy
        # (as in the JAX package and dagsa_jit)
        k = int(rng.integers(m)) if m > 1 else 0
        cand = np.where(remaining, snr[:, k], -np.inf)
        i = int(np.argmax(cand))
        t_bs[k] = bs_time_with(k, i)
        assign[i, k] = True
        remaining[i] = False
        t_star = max(t_star, t_bs[k])
        fill_pass(t_star)

    # -- Step 5: final optimal bandwidth (Eq. 12), on the problem's device --
    dev = problem.snr.device
    assign_t = torch.from_numpy(assign).to(dev)
    t_k, user_bw = bandwidth.solve_all(
        torch.from_numpy(coeff).to(device=dev, dtype=torch.float32),
        torch.from_numpy(tcomp).to(device=dev, dtype=torch.float32),
        assign_t, torch.from_numpy(bs_bw).to(device=dev, dtype=torch.float32))
    return ScheduleResult(assign=assign_t, selected=assign_t.any(dim=1),
                          bw=user_bw, bs_time=t_k, t_round=t_k.max())

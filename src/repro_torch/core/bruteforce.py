"""Exact (brute-force) solver for small instances of problem (13)
(PyTorch port of ``repro.core.bruteforce``).

For N users x M BSs it enumerates every (selection, assignment), M + 1
choices per user ("off" or one BS), prunes by the participation
constraints, solves Eq. (11) per BS with the host greedy's numpy mirror
(:func:`repro_torch.core.dagsa._bs_time_np`) and keeps the minimum round
time.  Host numpy in float64, as in the JAX package; tractable to about
N = 10, M = 3.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.dagsa import _bs_time_np
from repro_torch.core.types import SchedulingProblem


def optimal_schedule(problem: SchedulingProblem) -> tuple[float, np.ndarray]:
    """Returns (t_round*, assign [N, M]) of the exact optimum."""
    snr = problem.snr.detach().cpu().numpy()
    coeff = problem.coeff.detach().cpu().numpy().astype(np.float64)
    tcomp = problem.tcomp.detach().cpu().numpy().astype(np.float64)
    bs_bw = problem.bs_bw.detach().cpu().numpy().astype(np.float64)
    necessary = problem.necessary.detach().cpu().numpy().astype(bool)
    n, m = snr.shape
    if n * (m + 1) > 1 << 22 or (m + 1) ** n > 4_000_000:
        raise ValueError(f"instance too large for brute force: {n}x{m}")

    best_t = np.inf
    best_assign = np.zeros((n, m), dtype=bool)
    for choice in itertools.product(range(m + 1), repeat=n):
        ch = np.asarray(choice)
        selected = ch > 0
        if selected.sum() < problem.min_participants:
            continue
        if (necessary & ~selected).any():
            continue
        t_round = 0.0
        ok = True
        for k in range(m):
            mask = ch == (k + 1)
            if not mask.any():
                continue
            t_k = _bs_time_np(coeff[:, k], tcomp, mask, float(bs_bw[k]))
            t_round = max(t_round, t_k)
            if t_round >= best_t:
                ok = False
                break
        if ok and t_round < best_t:
            best_t = t_round
            best_assign = np.zeros((n, m), dtype=bool)
            for i, c in enumerate(ch):
                if c > 0:
                    best_assign[i, c - 1] = True
    return float(best_t), best_assign

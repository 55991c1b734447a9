"""Optimal single-BS bandwidth allocation — paper Eq. (10)-(12) (PyTorch
port of ``repro.core.bandwidth``; the derivation is in that module).

For the scheduled set S_k of BS k the KKT conditions give

    f(t) := sum_{i in S_k} c_i / (t - tcomp_i) = B_k      (Eq. 11)
    B_i^* = c_i / (t_k^* - tcomp_i)                        (Eq. 12)

with t_k^* the unique root right of ``max tcomp``.  Every solve here goes
through :func:`repro_torch.kernels.bandwidth_solve.bandwidth_solve`, one
row per BS: the hand-written kernel on CUDA tensors, its plain torch
version on CPU tensors (:func:`uniform_time`, the baselines' even split,
has no solve).  The kernel masks the denominator where the JAX
``bs_time`` masks it one step later; a masked-in user sees the same
arithmetic, so the root is the same.
"""
from __future__ import annotations

import math

import torch

_BISECT_ITERS = 60
_NEWTON_ITERS = 16
_METHODS = ("newton", "bisect")


def default_iters(method: str) -> int:
    """Iteration budget reaching float32 KKT tolerance for ``method``."""
    if method == "newton":
        return _NEWTON_ITERS
    if method == "bisect":
        return _BISECT_ITERS
    raise ValueError(f"unknown method {method!r}; choose from {_METHODS}")


def bs_time(coeff: torch.Tensor, tcomp: torch.Tensor, mask: torch.Tensor,
            bw: torch.Tensor, iters: int | None = None,
            method: str = "newton",
            lo_hint: torch.Tensor | None = None) -> torch.Tensor:
    """Solve Eq. (11) for one BS: coeff/tcomp/mask [N], bw scalar ->
    t_k^* (scalar), 0.0 if the BS is empty.  ``lo_hint`` is a known lower
    bound on the root (the BS's previous t_k^*).  Leading axes (a fleet
    of BSs: coeff/mask [..., N], tcomp [N] or [..., N], bw [...]) solve
    in the same one launch."""
    from repro_torch.kernels.bandwidth_solve import bandwidth_solve
    lead, n = coeff.shape[:-1], coeff.shape[-1]
    k = math.prod(lead)
    tc = tcomp.float()
    if tc.dim() > 1:
        tc = tc.reshape(k, n)
    lo = None if lo_hint is None else lo_hint.reshape(k).float()
    return bandwidth_solve(coeff.float().reshape(k, n), tc,
                           mask.reshape(k, n), bw.reshape(k).float(), lo=lo,
                           iters=iters, method=method).reshape(lead)


def allocate(coeff: torch.Tensor, tcomp: torch.Tensor, mask: torch.Tensor,
             bw: torch.Tensor, iters: int | None = None,
             method: str = "newton") -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (12) for one BS: (t_k^*, B_i [N]), B_i = 0 when unscheduled;
    with leading fleet axes as :func:`bs_time` takes them."""
    t = bs_time(coeff, tcomp, mask, bw, iters=iters, method=method)
    bi = torch.where(mask, coeff / torch.clamp(t[..., None] - tcomp,
                                               min=1e-12), 0.0)
    return t, bi


def solve_all(coeff: torch.Tensor, tcomp: torch.Tensor, assign: torch.Tensor,
              bs_bw: torch.Tensor, iters: int | None = None,
              method: str = "newton") -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (11)-(12) for every BS in one kernel launch.

    coeff [N, M], tcomp [N], assign [N, M] bool (row-sum <= 1), bs_bw [M]
    -> (bs_time [M] with 0 for an empty BS, user_bw [N] summed over the
    single assigned BS).  A fleet (coeff/assign [F, N, M], tcomp [F, N],
    bs_bw [F, M]) gives [F, M] and [F, N] from one launch on its F x M
    rows.
    """
    from repro_torch.kernels.bandwidth_solve import bandwidth_solve
    t_k = bandwidth_solve(coeff.transpose(-1, -2).contiguous(), tcomp,
                          assign.transpose(-1, -2).contiguous(), bs_bw,
                          iters=iters, method=method)
    denom = torch.clamp(t_k[..., None, :] - tcomp[..., :, None], min=1e-12)
    bi = torch.where(assign, coeff / denom, 0.0)            # [..., N, M]
    return t_k, bi.sum(dim=-1)


def uniform_time(coeff: torch.Tensor, tcomp: torch.Tensor,
                 mask: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Round time under an EVEN bandwidth split (the UB / FedCS
    baselines): max over a BS's users of tcomp + c / (B_k / n), 0 for an
    empty BS.  coeff/mask [N] with bw a scalar for one BS, or [..., N, M]
    with bw [..., M] for every BS at once (reduced over users)."""
    one_bs = coeff.dim() == 1
    users = 0 if one_bs else -2
    n_sel = mask.sum(dim=users)
    per_user_bw = torch.clamp(bw / torch.clamp(n_sel, min=1), min=1e-12)
    if one_bs:
        t_users = tcomp + coeff / per_user_bw
    else:
        t_users = tcomp[..., None] + coeff / per_user_bw[..., None, :]
    t = torch.where(mask, t_users, 0.0).amax(dim=users)
    return torch.where(n_sel > 0, t, 0.0)

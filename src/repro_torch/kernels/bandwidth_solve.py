"""Batched Eq. (11) root-finder: one t_k^* per row of a [K, U] problem.

PyTorch port of ``repro.kernels.bandwidth_solve``.  On CUDA tensors the
wrapper launches the hand-written kernel ``csrc/bandwidth_solve.cu`` (one
block per row); on CPU tensors it runs :func:`bandwidth_solve_plain`, the
same iteration in torch ops.  The two methods, the bracket and the
warm-start ``lo`` follow :mod:`repro_torch.core.bandwidth`.
"""
from __future__ import annotations

import torch

from repro_torch.core.bandwidth import default_iters
from repro_torch.kernels import _lib


def bandwidth_solve_plain(coeff: torch.Tensor, tcomp: torch.Tensor,
                          mask: torch.Tensor, bw: torch.Tensor,
                          lo: torch.Tensor | None = None,
                          iters: int | None = None,
                          method: str = "newton") -> torch.Tensor:
    """The kernel's arithmetic in torch ops (its CPU path and oracle)."""
    method_default = default_iters(method)       # rejects unknown methods
    iters = method_default if iters is None else iters
    c = coeff.float()
    tc = tcomp.float().expand_as(c)
    m = mask.bool()
    bw = bw.float()
    any_user = m.any(dim=-1)
    csum = (c * m).sum(dim=-1)
    tmax = torch.where(m, tc, -torch.inf).amax(dim=-1)
    tmax = torch.where(any_user, tmax, 0.0)
    hi = tmax + csum / torch.clamp(bw, min=1e-12) + 1e-9
    lo = torch.zeros_like(hi) if lo is None else lo.float()
    lo = torch.minimum(torch.maximum(lo, tmax), hi)

    def f_df(t):
        r = 1.0 / torch.clamp(t[:, None] - tc, min=1e-12)
        inv = torch.where(m, c * r, 0.0)
        return inv.sum(dim=-1) - bw, -(inv * r).sum(dim=-1)

    if method == "bisect":
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            too_fast = f_df(mid)[0] > 0
            lo, hi = torch.where(too_fast, mid, lo), torch.where(too_fast, hi, mid)
        t = 0.5 * (lo + hi)
    else:
        t = hi
        for _ in range(iters):
            f, df = f_df(t)
            below = f > 0                          # t left of the root
            lo = torch.where(below, t, lo)
            hi = torch.where(below, hi, t)
            t_newton = t - f / torch.clamp(df, max=-1e-12)
            safe = (t_newton > lo) & (t_newton < hi)
            t = torch.where(safe, t_newton, 0.5 * (lo + hi))
    return torch.where(any_user, t, 0.0)


def bandwidth_solve(coeff: torch.Tensor, tcomp: torch.Tensor,
                    mask: torch.Tensor, bw: torch.Tensor,
                    lo: torch.Tensor | None = None,
                    iters: int | None = None,
                    method: str = "newton") -> torch.Tensor:
    """coeff/mask [K, U], tcomp [U] (shared by every row) or [K, U], bw and
    the optional warm start lo [K] -> t* [K] float32 (0 for an empty row).

    CUDA operands must be float32 (mask bool) and contiguous.
    """
    operands = [coeff, tcomp, mask, bw] + ([] if lo is None else [lo])
    index = _lib.cuda_index(*operands)
    if index is None:
        return bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo,
                                     iters=iters, method=method)
    method_default = default_iters(method)
    iters = method_default if iters is None else iters
    k, u = coeff.shape
    _lib.require(coeff, "coeff", torch.float32, (k, u))
    if tcomp.dim() == 1:
        _lib.require(tcomp, "tcomp", torch.float32, (u,))
        tc_stride = 0
    else:
        _lib.require(tcomp, "tcomp", torch.float32, (k, u))
        tc_stride = u
    _lib.require(mask, "mask", torch.bool, (k, u))
    _lib.require(bw, "bw", torch.float32, (k,))
    if lo is None:
        lo = torch.zeros((k,), dtype=torch.float32, device=coeff.device)
    _lib.require(lo, "lo", torch.float32, (k,))
    out = torch.empty((k,), dtype=torch.float32, device=coeff.device)
    _lib.launch("bandwidth_solve_f32", index, coeff.data_ptr(),
                tcomp.data_ptr(), tc_stride, mask.data_ptr(), bw.data_ptr(),
                lo.data_ptr(), out.data_ptr(), k, u, iters,
                int(method == "bisect"))
    _lib.LAUNCHES["bandwidth_solve"] += 1
    return out

"""Batched Eq. (11) root-finder: one t_k^* per row of a [K, U] problem.

PyTorch port of ``repro.kernels.bandwidth_solve``.  On CUDA tensors the
wrapper launches the hand-written kernel ``csrc/bandwidth_solve.cu`` on
the path :func:`bandwidth_plan` picks by the row length; on CPU tensors it
runs :func:`bandwidth_solve_plain`, the same iteration in torch ops.  The
two methods, the bracket and the warm-start ``lo`` follow
:mod:`repro_torch.core.bandwidth`.  bfloat16 ``coeff`` / ``tcomp`` are
upcast to float32 first, as the JAX wrapper does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.bandwidth import default_iters
from repro_torch.kernels import _lib

WARP_MAX_USERS = 256       # 8 users a lane in registers
CLUSTER_THREADS = 512      # threads of a cluster-path block (16 warps)
SLICE_USERS = 16384        # users a cluster-path block takes, at most 8 ...
MAX_SLICES = 8             # ... blocks a row (a portable cluster)
GRID_BLOCKS = 256          # blocks in flight: two an SM on 128 of the 132
SMEM_PAIRS = 12288         # (c, tc) pairs a block keeps on chip: 96 KB
VEC_USERS = 8              # users a wide (8-byte) mask load covers


class BwPlan(NamedTuple):
    """The kernel's launch: ``path`` "warp" (one warp a row,
    ``users_per_lane`` users a lane in registers) or "cluster" (``slices``
    blocks a row, one cluster; "block" when slices is 1) with ``slice``
    users a block, of whose masked-in pairs a block keeps SMEM_PAIRS in
    shared memory."""
    path: str
    users_per_lane: int = 0
    slices: int = 0
    slice: int = 0


@functools.lru_cache(maxsize=256)     # called once a launch, on the host
def bandwidth_plan(k: int, u: int) -> BwPlan:
    """The path for K rows of U users (thresholds from the card sweep in
    PERF.md, chip_smoke.py's ``bandwidth_variants``).

    - "warp": U <= 256; ``users_per_lane`` = the power of two of users a
      lane holds (1-8).
    - "block": one block a row when U <= SLICE_USERS or K > 128: the
      row's masked-in pairs in shared memory (SMEM_PAIRS a block, the
      rest spilled to a buffer in global memory).
    - "cluster": 2-8 blocks a row, one cluster: a slice of about
      SLICE_USERS users a block, as many slices as keep K x slices within
      GRID_BLOCKS (two blocks an SM), so the row's blocks run at once.

    A slice is a multiple of 8 users, so the wide loads stay aligned.
    """
    if u <= WARP_MAX_USERS:
        return BwPlan("warp", users_per_lane=_lib.pow2_ceil(max(1, -(-u // 32))))
    fill = 1 << max(0, (GRID_BLOCKS // max(1, k)).bit_length() - 1)
    slices = min(MAX_SLICES, _lib.pow2_ceil(-(-u // SLICE_USERS)), fill)
    slice_ = -(-u // (slices * VEC_USERS)) * VEC_USERS
    return BwPlan("block" if slices == 1 else "cluster", slices=slices,
                  slice=slice_)


def pair_capacity(plan: BwPlan, vec: bool) -> tuple[int, int]:
    """(pairs of shared memory a warp, pairs of global spill a warp) of a
    compacted cluster-path launch: a warp holds at most every user it
    loads, so the two together are that count (no prefix sum needed)."""
    per_unit = VEC_USERS if vec else 1
    units = -(-plan.slice // per_unit)
    warps = CLUSTER_THREADS // 32
    users_per_warp = -(-units // CLUSTER_THREADS) * 32 * per_unit
    on_chip = min(users_per_warp, SMEM_PAIRS // warps // 32 * 32)
    return on_chip, users_per_warp - on_chip


def _row_tcomp(tcomp: torch.Tensor, k: int) -> torch.Tensor:
    """tcomp [U], [K, U] or [G, U] (each of the G rows shared by K / G
    consecutive rows) -> a tensor that broadcasts against [K, U]."""
    if tcomp.dim() == 2 and tcomp.shape[0] != k:
        g = tcomp.shape[0]
        if g == 0 or k % g:
            raise ValueError(f"tcomp has {g} rows, which do not divide the "
                             f"{k} rows of coeff")
        return tcomp.repeat_interleave(k // g, dim=0)
    return tcomp


def bandwidth_solve_plain(coeff: torch.Tensor, tcomp: torch.Tensor,
                          mask: torch.Tensor, bw: torch.Tensor,
                          lo: torch.Tensor | None = None,
                          iters: int | None = None,
                          method: str = "newton") -> torch.Tensor:
    """The kernel's arithmetic in torch ops (its CPU path and oracle) on
    [K, U] rows."""
    method_default = default_iters(method)       # rejects unknown methods
    iters = method_default if iters is None else iters
    c = coeff.float()
    tc = _row_tcomp(tcomp.float(), c.shape[0]).expand_as(c)
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


def _flatten_fleet(coeff, tcomp, mask, bw, lo):
    """[F, K, U] fleet operands -> the [F K, U] rows of one solve (views
    of contiguous operands): tcomp [F, U] stays one vector a problem."""
    f, k, u = coeff.shape
    tc = tcomp if tcomp.dim() == 2 else tcomp.reshape(f * k, u)
    return (coeff.reshape(f * k, u), tc, mask.reshape(f * k, u),
            bw.reshape(f * k), None if lo is None else lo.reshape(f * k))


def bandwidth_solve_fleet_plain(coeff: torch.Tensor, tcomp: torch.Tensor,
                                mask: torch.Tensor, bw: torch.Tensor,
                                lo: torch.Tensor | None = None,
                                iters: int | None = None,
                                method: str = "newton") -> torch.Tensor:
    """The plain version over a leading fleet axis: coeff/mask [F, K, U],
    tcomp [F, U] or [F, K, U], bw and lo [F, K] -> [F, K]; row for row
    the arithmetic of :func:`bandwidth_solve_plain`."""
    f, k = coeff.shape[:2]
    return bandwidth_solve_plain(
        *_flatten_fleet(coeff, tcomp, mask, bw, lo), iters=iters,
        method=method).reshape(f, k)


def _upcast(t: torch.Tensor) -> torch.Tensor:
    # compact channel storage may hand us bf16 coeff / tcomp: solve in f32
    return t.float() if t.dtype == torch.bfloat16 else t


def bandwidth_solve(coeff: torch.Tensor, tcomp: torch.Tensor,
                    mask: torch.Tensor, bw: torch.Tensor,
                    lo: torch.Tensor | None = None,
                    iters: int | None = None,
                    method: str = "newton") -> torch.Tensor:
    """coeff/mask [K, U], tcomp [U] (shared by every row), [K, U] or [G, U]
    (each row shared by K / G consecutive rows), bw and the optional warm
    start lo [K] -> t* [K] float32 (0 for an empty row).

    With a leading fleet axis, coeff/mask [F, K, U], tcomp [F, U] or [F,
    K, U], bw and lo [F, K] -> [F, K]: the F x K rows in one launch, each
    problem's tcomp read in place by its K rows.

    CUDA operands must be contiguous, coeff and tcomp float32 or bfloat16
    (upcast), mask bool, bw and lo float32.
    """
    if coeff.dim() == 3:
        f, k = coeff.shape[:2]
        return bandwidth_solve(*_flatten_fleet(coeff, tcomp, mask, bw, lo),
                               iters=iters, method=method).reshape(f, k)
    operands = [coeff, tcomp, mask, bw] + ([] if lo is None else [lo])
    index = _lib.cuda_index(*operands)
    if index is None:
        return bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo,
                                     iters=iters, method=method)
    k, u = coeff.shape
    return solve_cuda(index, _upcast(coeff), _upcast(tcomp), mask, bw, lo,
                      iters, method, bandwidth_plan(k, u))


def solve_cuda(index: int, coeff: torch.Tensor, tcomp: torch.Tensor,
               mask: torch.Tensor, bw: torch.Tensor, lo: torch.Tensor | None,
               iters: int | None, method: str, plan: BwPlan) -> torch.Tensor:
    """One launch of the kernel on ``plan`` (the wrapper passes
    :func:`bandwidth_plan`'s; the card sweep passes others)."""
    method_default = default_iters(method)
    iters = method_default if iters is None else iters
    k, u = coeff.shape
    _lib.require(coeff, "coeff", torch.float32, (k, u))
    if tcomp.dim() == 1:
        _lib.require(tcomp, "tcomp", torch.float32, (u,))
        tc_stride, rows_per_tc = 0, 1
    else:
        g = tcomp.shape[0]
        if g == 0 or k % g:
            raise ValueError(f"tcomp has {g} rows, which do not divide the "
                             f"{k} rows of coeff")
        _lib.require(tcomp, "tcomp", torch.float32, (g, u))
        tc_stride, rows_per_tc = u, k // g
    _lib.require(mask, "mask", torch.bool, (k, u))
    _lib.require(bw, "bw", torch.float32, (k,))
    if lo is None:
        lo = torch.zeros((k,), dtype=torch.float32, device=coeff.device)
    _lib.require(lo, "lo", torch.float32, (k,))
    out = torch.empty((k,), dtype=torch.float32, device=coeff.device)
    if k == 0:
        return out
    cp, tp, mp = coeff.data_ptr(), tcomp.data_ptr(), mask.data_ptr()
    bisect = int(method == "bisect")
    if plan.path == "warp":
        _lib.launch("bandwidth_solve_warp_f32", index, cp, tp, tc_stride,
                    rows_per_tc, mp, bw.data_ptr(), lo.data_ptr(),
                    out.data_ptr(), k, u, iters, bisect,
                    plan.users_per_lane)
    else:
        vec = u % VEC_USERS == 0 and (cp | tp | mp) % 16 == 0
        on_chip, spill_per_warp = pair_capacity(plan, vec)
        # pairs past shared memory: a buffer of the call's own from the
        # caching allocator (stream-ordered, so graph capture and other
        # streams are safe); 8 bytes a user of the slice past 96 KB a
        # block, 786 MB at [100, 1e6], whatever the mask's density
        n_warps = k * plan.slices * (CLUSTER_THREADS // 32)
        spill = torch.empty((n_warps * spill_per_warp * 8,),
                            dtype=torch.uint8, device=coeff.device)
        _lib.launch("bandwidth_solve_cluster_f32", index, cp, tp, tc_stride,
                    rows_per_tc, mp, bw.data_ptr(), lo.data_ptr(),
                    out.data_ptr(), k, u, iters, bisect, plan.slices,
                    plan.slice, int(vec), on_chip, spill_per_warp,
                    spill.data_ptr())
    _lib.LAUNCHES["bandwidth_solve"] += 1
    return out

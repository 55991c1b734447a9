"""DAGSA's selection argmaxes (Algorithm 1 steps 1 and 3).

PyTorch port of ``repro.kernels.select_topk``.  On CUDA tensors the
wrappers launch the hand-written kernels in ``csrc/select_topk.cu``; on CPU
tensors they run the plain versions below, the dense oracles of
``repro.kernels.ref``.  Both follow ``jnp.argmax``: the lowest index wins a
tie, and an all-masked column gives ``(0, -inf)``.  float32 storage only;
the bf16/int8 planes and the per-BS dequantisation ``scale`` of the JAX
kernels are not ported yet.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

_BLOCK_ELEMS = 65536        # snr entries one pass-1 block scans
_MAX_BS = 1024
_LOADS_IN_FLIGHT = 8        # per lane, in best_bs_argmax's kernel


def masked_bs_argmax_plain(snr: torch.Tensor, remaining: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    vals = torch.where(remaining[:, None], snr.float(), -torch.inf)
    return (torch.argmax(vals, dim=0).to(torch.int32),
            torch.amax(vals, dim=0))


def best_bs_argmax_plain(snr: torch.Tensor) -> torch.Tensor:
    return torch.argmax(snr.float(), dim=1).to(torch.int32)


def _pass1_shape(m: int) -> tuple[int, int]:
    """(threads, rows_per_block) of pass 1: threads is a multiple of m, so
    each thread keeps one column while the block reads contiguous rows."""
    subs = max(1, 256 // m)
    rows = max(subs, (_BLOCK_ELEMS // m) // subs * subs)
    return m * subs, rows


@functools.lru_cache(maxsize=256)     # called once a launch, on the host
def best_bs_plan(m: int) -> tuple[int, int, int]:
    """(lanes, chunks, rows) of best_bs_argmax's kernel for M BSs: a group
    of ``lanes`` lanes (a power of two, at most a warp) reads a row's
    columns side by side, so 32 / lanes rows share a warp; each lane issues
    ``chunks`` column loads for each of ``rows`` rows (chunks x rows = 8
    loads in flight) before it compares.  A group's merge costs shuffles
    whatever its width, so lanes is as few as 8 loads a lane allow."""
    lanes = min(32, _lib.pow2_ceil(-(-m // _LOADS_IN_FLIGHT)))
    chunks = min(_LOADS_IN_FLIGHT, _lib.pow2_ceil(-(-m // lanes)))
    return lanes, chunks, _LOADS_IN_FLIGHT // chunks


def masked_bs_argmax(snr: torch.Tensor, remaining: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """snr [N, M] float32, remaining [N] bool -> (cand [M] int32, best [M]
    float32): the best remaining user per BS and its SNR (-inf where no
    user remains)."""
    index = _lib.cuda_index(snr, remaining)
    if index is None:
        return masked_bs_argmax_plain(snr, remaining)
    n, m = snr.shape
    _lib.require(snr, "snr", torch.float32, (n, m))
    _lib.require(remaining, "remaining", torch.bool, (n,))
    if not (n >= 1 and 1 <= m <= _MAX_BS):
        raise ValueError(f"masked_bs_argmax needs N >= 1 and 1 <= M <= "
                         f"{_MAX_BS}, got {(n, m)}")
    threads, rows = _pass1_shape(m)
    n_blocks = -(-n // rows)
    dev = snr.device
    part_val = torch.empty((n_blocks, m), dtype=torch.float32, device=dev)
    part_idx = torch.empty((n_blocks, m), dtype=torch.int32, device=dev)
    cand = torch.empty((m,), dtype=torch.int32, device=dev)
    best = torch.empty((m,), dtype=torch.float32, device=dev)
    _lib.launch("masked_bs_argmax_f32", index, snr.data_ptr(),
                remaining.data_ptr(), n, m, threads, rows,
                part_val.data_ptr(), part_idx.data_ptr(), cand.data_ptr(),
                best.data_ptr())
    _lib.LAUNCHES["masked_bs_argmax"] += 1
    return cand, best


def best_bs_argmax(snr: torch.Tensor) -> torch.Tensor:
    """snr [N, M] float32 -> [N] int32 best-channel BS per user."""
    index = _lib.cuda_index(snr)
    if index is None:
        return best_bs_argmax_plain(snr)
    n, m = snr.shape
    _lib.require(snr, "snr", torch.float32, (n, m))
    if m < 1:
        raise ValueError("best_bs_argmax needs M >= 1")
    out = snr.new_empty((n,), dtype=torch.int32)
    if n == 0:
        return out
    _lib.launch("best_bs_argmax_f32", index, snr.data_ptr(), n, m,
                *best_bs_plan(m), out.data_ptr())
    _lib.LAUNCHES["best_bs_argmax"] += 1
    return out

"""DAGSA's selection argmaxes (Algorithm 1 steps 1 and 3).

PyTorch port of ``repro.kernels.select_topk``.  On CUDA tensors the
wrappers launch the hand-written kernels in ``csrc/select_topk.cu``; on CPU
tensors they run the plain versions below, the dense oracles of
``repro.kernels.ref``.  Both follow ``jnp.argmax``: the lowest index wins a
tie, and an all-masked column gives ``(0, -inf)``.  ``masked_bs_argmax``
takes the SNR as float32, bfloat16 or int8 codes with an optional per-BS
dequantisation ``scale`` (applied before any compare, as the Pallas kernel
does); ``best_bs_argmax`` takes float32 (its bf16/int8 + scale inputs are
ROADMAP B.0.2).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _lib

# snr entries a masked_bs_argmax block scans (the card sweep in PERF.md:
# float32 fastest at ~32k, bfloat16 and int8 at ~64k)
_BLOCK_ELEMS = {torch.float32: 32768, torch.bfloat16: 65536,
                torch.int8: 65536}
_TILES_IN_FLIGHT = 8        # a thread's loads before it compares
_MAX_BS = 1024
_LOADS_IN_FLIGHT = 8        # per lane, in best_bs_argmax's kernel
# masked_bs_argmax's storage types: (entry-point suffix, codes a 4-byte word)
_SNR_KINDS = {torch.float32: ("f32", 1), torch.bfloat16: ("bf16", 2),
              torch.int8: ("i8", 4)}
_MASKED_ENTRY = {t: f"masked_bs_argmax_{kind}"
                 for t, (kind, _) in _SNR_KINDS.items()}


def masked_bs_argmax_plain(snr: torch.Tensor, remaining: torch.Tensor,
                           scale: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    vals = snr.float()
    if scale is not None:
        vals = vals * scale.float()
    vals = torch.where(remaining[:, None], vals, -torch.inf)
    return (torch.argmax(vals, dim=0).to(torch.int32),
            torch.amax(vals, dim=0))


def best_bs_argmax_plain(snr: torch.Tensor) -> torch.Tensor:
    return torch.argmax(snr.float(), dim=1).to(torch.int32)


@functools.lru_cache(maxsize=256)     # called once a launch, on the host
def masked_bs_plan(n: int, m: int, dtype: torch.dtype,
                   aligned: bool) -> tuple[int, int, int, int, int]:
    """(codes a load, threads, rows a tile, rows a block, blocks) of
    masked_bs_argmax's kernel for an [N, M] plane of ``dtype``;
    ``aligned``: the plane starts on a 4-byte boundary.

    A thread loads one 4-byte word (1 float32, 2 bfloat16 or 4 int8 codes;
    one code when not aligned) from each tile of ``threads x codes``
    consecutive entries, which is a whole number of rows, so the thread's
    columns stay put: threads is a multiple of M / gcd(M, codes), about
    256 (fewer when one step covers N: [50, 8] takes 56).  A block takes
    rows in steps of 8 tiles (the loads in flight),
    about 32,768 float32 or 65,536 bfloat16 / int8 entries; N x M up to
    that is one block, which writes the result itself."""
    v = _SNR_KINDS[dtype][1] if aligned else 1
    base = m // math.gcd(m, v)              # threads of the smallest tile
    base_rows = base * v // m               # ... and its rows
    # about 256 threads; fewer when one step of 8 tiles covers N (the
    # block's merge then takes fewer rounds)
    few = -(-(-(-n // _TILES_IN_FLIGHT)) // base_rows)
    threads = base * max(1, min(256 // base, few))
    rows_per_tile = threads * v // m
    step = _TILES_IN_FLIGHT * rows_per_tile
    rows = -(-(_BLOCK_ELEMS[dtype] // m) // step) * step
    return v, threads, rows_per_tile, rows, -(-n // rows)


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


def masked_bs_argmax(snr: torch.Tensor, remaining: torch.Tensor,
                     scale: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """snr [N, M] float32, bfloat16 or int8, remaining [N] bool, optional
    scale [M] -> (cand [M] int32, best [M] float32): per BS the best
    remaining user of ``f32(snr) * scale`` and that value (-inf where no
    user remains).  One launch; it allocates only the two outputs."""
    operands = (snr, remaining) if scale is None else (snr, remaining, scale)
    index = _lib.cuda_index(*operands)
    if index is None:
        return masked_bs_argmax_plain(snr, remaining, scale)
    n, m = snr.shape
    if snr.dtype not in _SNR_KINDS:
        raise TypeError(f"snr must be float32, bfloat16 or int8, got "
                        f"{snr.dtype}")
    _lib.require(snr, "snr", snr.dtype, (n, m))
    _lib.require(remaining, "remaining", torch.bool, (n,))
    if scale is not None:
        scale = scale.float()
        _lib.require(scale, "scale", torch.float32, (m,))
    if not (1 <= n < 2 ** 31 and 1 <= m <= _MAX_BS):
        raise ValueError(f"masked_bs_argmax needs 1 <= N < 2^31 and 1 <= M "
                         f"<= {_MAX_BS}, got {(n, m)}")
    sp = snr.data_ptr()
    return masked_cuda(index, snr, remaining, scale,
                       masked_bs_plan(n, m, snr.dtype, sp % 4 == 0))


def masked_cuda(index: int, snr: torch.Tensor, remaining: torch.Tensor,
                scale: torch.Tensor | None,
                plan: tuple[int, int, int, int, int]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of masked_bs_argmax's kernel on ``plan`` (the wrapper
    passes :func:`masked_bs_plan`'s; the card sweep passes others) on
    validated operands."""
    n, m = snr.shape
    v, threads, rows_per_tile, rows, blocks = plan
    work = 0 if blocks == 1 else _lib.workspace(
        "masked_bs_argmax", index, (16 * m + 1) * 8).data_ptr()
    cand = torch.empty((m,), dtype=torch.int32, device=snr.device)
    best = torch.empty((m,), dtype=torch.float32, device=snr.device)
    _lib.launch(_MASKED_ENTRY[snr.dtype], index, snr.data_ptr(), int(v > 1),
                remaining.data_ptr(),
                0 if scale is None else scale.data_ptr(), n, m, threads,
                rows_per_tile, rows, work, cand.data_ptr(), best.data_ptr())
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

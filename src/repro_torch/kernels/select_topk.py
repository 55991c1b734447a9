"""DAGSA's selection argmaxes (Algorithm 1 steps 1 and 3).

PyTorch port of ``repro.kernels.select_topk``.  On CUDA tensors the
wrappers launch the hand-written kernels in ``csrc/select_topk.cu``; on CPU
tensors they run the plain versions below, the dense oracles of
``repro.kernels.ref``.  Both follow ``jnp.argmax``: the lowest index wins a
tie, and an all-masked column gives ``(0, -inf)``.  ``masked_bs_argmax``
takes the SNR as float32, bfloat16 or int8 codes with an optional per-BS
dequantisation ``scale`` (applied before any compare, as the Pallas
kernels do); so does ``best_bs_argmax``, whose row argmax must compare the
scaled values, since dequantisation keeps order only within a column.

Both take a leading fleet axis too (``[F, N, M]`` planes with ``[F, N]``
masks and ``[F, M]`` scales, DAGSA's batched greedy): one launch for the
whole fleet, and the plain versions reduce over the same trailing axes.
The ``*_chunked`` twins stream user blocks in plain torch, as the JAX
package's ``--user-chunk`` CPU path does.
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
_WORDS_IN_FLIGHT = 4        # best_bs_argmax's 16-byte loads a lane
_MAX_SCALED_BS = 12288      # a scale row in 48 KB of shared memory
# masked_bs_argmax's storage types: (entry-point suffix, codes a 4-byte word)
_SNR_KINDS = {torch.float32: ("f32", 1), torch.bfloat16: ("bf16", 2),
              torch.int8: ("i8", 4)}
_MASKED_ENTRY = {t: f"masked_bs_argmax_{kind}"
                 for t, (kind, _) in _SNR_KINDS.items()}


def _scaled(snr: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    vals = snr.float()
    return vals if scale is None else vals * scale.float()[..., None, :]


def masked_bs_argmax_plain(snr: torch.Tensor, remaining: torch.Tensor,
                           scale: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """snr [..., N, M], remaining [..., N], scale [..., M] -> cand and best
    [..., M] (the leading axes a fleet)."""
    vals = torch.where(remaining[..., None], _scaled(snr, scale), -torch.inf)
    return (torch.argmax(vals, dim=-2).to(torch.int32),
            torch.amax(vals, dim=-2))


def best_bs_argmax_plain(snr: torch.Tensor,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """snr [..., N, M], scale [..., M] -> [..., N]."""
    return torch.argmax(_scaled(snr, scale), dim=-1).to(torch.int32)


def masked_bs_argmax_chunked(snr: torch.Tensor, remaining: torch.Tensor,
                             block: int, scale: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version in blocks of ``block`` users ([..., block, M]
    temporaries; the last block padded with masked-out rows): a first
    maximum a block, then the first block holding the largest, so ties
    go to the lowest user as in the dense version, bit for bit."""
    n, m = snr.shape[-2:]
    b = min(int(block), n)
    vals, idxs = [], []
    for i0 in range(0, n, b):
        i, v = masked_bs_argmax_plain(snr[..., i0:i0 + b, :],
                                      remaining[..., i0:i0 + b], scale)
        vals.append(v)
        idxs.append(i.long() + i0)
    vals, idxs = torch.stack(vals, dim=-2), torch.stack(idxs, dim=-2)
    kb = torch.argmax(vals, dim=-2, keepdim=True)          # [..., 1, M]
    return (idxs.gather(-2, kb).squeeze(-2).to(torch.int32),
            vals.gather(-2, kb).squeeze(-2))


def best_bs_argmax_chunked(snr: torch.Tensor, block: int,
                           scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain per-user best BS in blocks of ``block`` users."""
    n = snr.shape[-2]
    b = min(int(block), n)
    return torch.cat([best_bs_argmax_plain(snr[..., i0:i0 + b, :], scale)
                      for i0 in range(0, n, b)], dim=-1)


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
def best_bs_plan(m: int, dtype: torch.dtype = torch.float32
                 ) -> tuple[int, int, int]:
    """(lanes, chunks, rows) of best_bs_argmax's kernel for M BSs of
    ``dtype``: a group of ``lanes`` lanes (a power of two, at most a warp)
    reads a row's 16-byte words side by side, so 32 / lanes rows share a
    warp; each lane issues ``chunks`` word loads for each of ``rows`` rows
    (chunks x rows = 4) before it compares.  A group's merge costs
    shuffles whatever its width, so lanes is as few as four words a lane
    allow, over the words a row touches (a row off 16 bytes touches one
    more)."""
    if dtype not in _SNR_KINDS:
        raise TypeError(f"snr must be float32, bfloat16 or int8, got {dtype}")
    row_bytes = m * torch.empty((), dtype=dtype).element_size()
    words = -(-row_bytes // 16) + (1 if row_bytes % 16 else 0)
    lanes = min(32, _lib.pow2_ceil(-(-words // _WORDS_IN_FLIGHT)))
    chunks = min(_WORDS_IN_FLIGHT, _lib.pow2_ceil(-(-words // lanes)))
    return lanes, chunks, _WORDS_IN_FLIGHT // chunks


_MAX_FLEET = 65535          # problems of a launch: grid axis y


def _fleet_shape(snr: torch.Tensor) -> tuple[int, int, int]:
    """(F, N, M) of an [N, M] plane (F = 1) or an [F, N, M] fleet."""
    if snr.dim() == 2:
        return (1,) + tuple(snr.shape)
    if snr.dim() == 3:
        f = snr.shape[0]
        if not 1 <= f <= _MAX_FLEET:
            raise ValueError(f"a fleet needs 1 <= F <= {_MAX_FLEET}, got {f}")
        return tuple(snr.shape)
    raise ValueError(f"snr must be [N, M] or [F, N, M], got "
                     f"{tuple(snr.shape)}")


def _check_snr(snr: torch.Tensor) -> None:
    if snr.dtype not in _SNR_KINDS:
        raise TypeError(f"snr must be float32, bfloat16 or int8, got "
                        f"{snr.dtype}")
    _lib.require(snr, "snr", snr.dtype, tuple(snr.shape))


def masked_bs_argmax(snr: torch.Tensor, remaining: torch.Tensor,
                     scale: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """snr [N, M] float32, bfloat16 or int8, remaining [N] bool, optional
    scale [M] -> (cand [M] int32, best [M] float32): per BS the best
    remaining user of ``f32(snr) * scale`` and that value (-inf where no
    user remains).  A fleet, snr [F, N, M] with remaining [F, N] and scale
    [F, M], gives [F, M] each.  One launch; it allocates only the two
    outputs."""
    operands = (snr, remaining) if scale is None else (snr, remaining, scale)
    index = _lib.cuda_index(*operands)
    if index is None:
        return masked_bs_argmax_plain(snr, remaining, scale)
    f, n, m = _fleet_shape(snr)
    _check_snr(snr)
    lead = tuple(snr.shape[:-2])
    _lib.require(remaining, "remaining", torch.bool, lead + (n,))
    if scale is not None:
        scale = scale.float()
        _lib.require(scale, "scale", torch.float32, lead + (m,))
    if not (1 <= n < 2 ** 31 and 1 <= m <= _MAX_BS):
        raise ValueError(f"masked_bs_argmax needs 1 <= N < 2^31 and 1 <= M "
                         f"<= {_MAX_BS}, got {(n, m)}")
    # a word load needs every problem's plane on a 4-byte boundary
    aligned = (snr.data_ptr() % 4 == 0
               and (f == 1 or n * m * snr.element_size() % 4 == 0))
    return masked_cuda(index, snr, remaining, scale,
                       masked_bs_plan(n, m, snr.dtype, aligned))


def masked_cuda(index: int, snr: torch.Tensor, remaining: torch.Tensor,
                scale: torch.Tensor | None,
                plan: tuple[int, int, int, int, int]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of masked_bs_argmax's kernel on ``plan`` (the wrapper
    passes :func:`masked_bs_plan`'s; the card sweep passes others) on
    validated operands, [N, M] or an [F, N, M] fleet."""
    f, n, m = _fleet_shape(snr)
    v, threads, rows_per_tile, rows, blocks = plan
    # a problem's M keys and its ticket, each on a 128-byte line
    work = 0 if blocks == 1 else _lib.workspace(
        "masked_bs_argmax", index, f * 16 * (m + 1) * 8).data_ptr()
    out_shape = tuple(snr.shape[:-2]) + (m,)
    cand = torch.empty(out_shape, dtype=torch.int32, device=snr.device)
    best = torch.empty(out_shape, dtype=torch.float32, device=snr.device)
    _lib.launch(_MASKED_ENTRY[snr.dtype], index, snr.data_ptr(), int(v > 1),
                remaining.data_ptr(),
                0 if scale is None else scale.data_ptr(), n, m, f, threads,
                rows_per_tile, rows, work, cand.data_ptr(), best.data_ptr())
    _lib.LAUNCHES["masked_bs_argmax"] += 1
    return cand, best


def best_bs_argmax(snr: torch.Tensor,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """snr [N, M] float32, bfloat16 or int8, optional scale [M] -> [N]
    int32: per user the best BS of ``f32(snr) * scale`` (the lowest index
    on a tie).  A fleet, snr [F, N, M] with scale [F, M], gives [F, N].
    One launch; it allocates only the output."""
    operands = (snr,) if scale is None else (snr, scale)
    index = _lib.cuda_index(*operands)
    if index is None:
        return best_bs_argmax_plain(snr, scale)
    f, n, m = _fleet_shape(snr)
    _check_snr(snr)
    if m < 1:
        raise ValueError("best_bs_argmax needs M >= 1")
    if scale is not None:
        scale = scale.float().contiguous()
        _lib.require(scale, "scale", torch.float32,
                     tuple(snr.shape[:-2]) + (m,))
        if m > _MAX_SCALED_BS:
            raise ValueError(f"best_bs_argmax with a scale needs M <= "
                             f"{_MAX_SCALED_BS}, got {m}")
    out = snr.new_empty(tuple(snr.shape[:-1]), dtype=torch.int32)
    if n == 0:
        return out
    # the kernel reads 16-byte words from the plane's base rounded down to
    # 16 bytes; ``lead`` codes of that first word precede the plane (and
    # problem f starts f N M codes after the first, at its own offset)
    size = snr.element_size()
    lead = snr.data_ptr() % 16 // size
    sp = 0 if scale is None else scale.data_ptr()
    _lib.launch(f"best_bs_argmax_{_SNR_KINDS[snr.dtype][0]}", index,
                snr.data_ptr() - lead * size, lead, sp, n, m, f,
                *best_bs_plan(m, snr.dtype), out.data_ptr())
    _lib.LAUNCHES["best_bs_argmax"] += 1
    return out

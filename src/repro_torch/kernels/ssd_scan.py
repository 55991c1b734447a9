"""Mamba2 SSD chunked scan (PyTorch port of ``repro.kernels.ssd_scan``).

On CUDA tensors :func:`ssd_scan` launches the hand-written kernels in
``csrc/ssd_scan.cu`` (a block per (batch, head, P slice) walking the
chunks with the state on chip: bfloat16 on the tensor cores, float32 on
the CUDA cores); on CPU tensors it runs :func:`ssd_scan_plain`, the
model's own ``repro_torch.models.ssm.ssd_chunked`` (the oracle
``repro.kernels.ref.ssd_scan`` delegates the same way).

x [B, S, H, P] and B/C [B, S, G, N] float32 or bfloat16 (one dtype), dt
[B, S, H] and A [H] float32, S a multiple of ``chunk``.  The result is
float32 whatever x's dtype, as the model's path computes it.  The kernels
take a chunk that is a multiple of 16 up to 128, N a multiple of 8 up to
128 and P a multiple of 32 (:func:`ssd_plan` raises on anything else).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

SMEM_LIMIT = 232_448      # dynamic shared memory a block may take (H100)
MAX_STATE = 128           # N: the state tiles the kernels hold
P_SLICES = (64, 32)       # head columns a block, widest first


def ssd_scan_plain(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk)


def _smem_bytes(kind: str, q: int, n: int, ps: int) -> int:
    """A block's dynamic shared memory (``smem_bytes_mma`` /
    ``smem_bytes_simt`` in the source)."""
    if kind == "bf16":
        np_, ldx = -(-n // 16) * 16, ps + 8
        ldn = np_ + 8
        return 2 * q * ldx + 4 * q * ldn + 4 * q + 4 * np_ * ldx + 12 * q
    lj = min(q, 32) + 4
    return 4 * (ps * (q + 4) + 2 * q * (n + 4) + q * lj + ps * (n + 4)
                + 4 * q)


@functools.lru_cache(maxsize=64)      # called once a launch, on the host
def ssd_plan(kind: str, q: int, n: int, p: int) -> int:
    """The P slice (head columns a block) of the kernel for ``kind``
    ("f32" or "bf16") at chunk ``q``, state ``n`` and head width ``p``:
    the widest that divides P and whose tiles fit a block's shared memory
    (a narrower slice recomputes the scores: slower in the card sweep,
    PERF.md).  Raises ValueError for a shape the kernels do not take.
    """
    if not (16 <= q <= 128 and q % 16 == 0):
        raise ValueError(f"ssd_scan kernels need a chunk that is a multiple "
                         f"of 16 up to 128, got {q}")
    if not (8 <= n <= MAX_STATE and n % 8 == 0):
        raise ValueError(f"ssd_scan kernels need a state N that is a "
                         f"multiple of 8 up to {MAX_STATE}, got {n}")
    for ps in P_SLICES:
        if p % ps == 0 and _smem_bytes(kind, q, n, ps) <= SMEM_LIMIT:
            return ps
    raise ValueError(f"ssd_scan kernels need P a multiple of 32 whose tiles "
                     f"fit {SMEM_LIMIT} bytes of shared memory, got P={p} at "
                     f"chunk={q}, N={n}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy on a 16-byte boundary (the kernels' vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """-> y [B, S, H, P] float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_scan needs S a multiple of the chunk, got "
                         f"S={s}, chunk={chunk}")
    index = _lib.cuda_index(x, dt, A, B, C)
    if index is None:
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    kind = _lib.float_kind(x, "x")
    if g < 1 or h % g:
        raise ValueError(f"ssd_scan needs H a multiple of G, got H={h}, G={g}")
    _lib.require(x, "x", x.dtype, (b, s, h, p))
    _lib.require(dt, "dt", torch.float32, (b, s, h))
    _lib.require(A, "A", torch.float32, (h,))
    _lib.require(B, "B", x.dtype, (b, s, g, n))
    _lib.require(C, "C", x.dtype, (b, s, g, n))
    ps = ssd_plan(kind, chunk, n, p)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    x, B, C = _aligned(x), _aligned(B), _aligned(C)
    _lib.launch(f"ssd_scan_{kind}", index, x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), b, s,
                h, g, n, p, chunk, ps)
    _lib.LAUNCHES["ssd_scan"] += 1
    return y

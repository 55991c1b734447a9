"""Mamba2 SSD chunked scan (PyTorch port of ``repro.kernels.ssd_scan``).

On CUDA tensors :func:`ssd_scan` launches the hand-written kernel in
``csrc/ssd_scan.cu`` (one block per (batch, head) walking the chunks with
the state in shared memory); on CPU tensors it runs :func:`ssd_scan_plain`,
the model's own ``repro_torch.models.ssm.ssd_chunked`` (the oracle
``repro.kernels.ref.ssd_scan`` delegates the same way).

x [B, S, H, P] and B/C [B, S, G, N] float32 or bfloat16 (one dtype), dt
[B, S, H] and A [H] float32, S a multiple of ``chunk``.  The result is
float32 whatever x's dtype, as the model's path computes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

SMEM_LIMIT = 232_448      # dynamic shared memory a block may take (H100)


def ssd_scan_plain(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk)


def _smem_bytes(q: int, n: int, p: int) -> int:
    """The kernel's dynamic shared memory (``smem_floats`` in the source)."""
    return 4 * (q * p + 2 * q * (n + 1) + q * q + n * p + 4 * q)


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
    smem = _smem_bytes(chunk, n, p)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan tiles need {smem} bytes of shared memory "
                         f"at chunk={chunk}, N={n}, P={p}; a block may take "
                         f"{SMEM_LIMIT}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    _lib.launch(f"ssd_scan_{kind}", index, x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), b, s,
                h, g, n, p, chunk)
    _lib.LAUNCHES["ssd_scan"] += 1
    return y

"""RMSNorm over the last axis (PyTorch port of ``repro.kernels.rmsnorm``).

On CUDA tensors :func:`rmsnorm` launches the hand-written kernel in
``csrc/rmsnorm.cu``; on CPU tensors it runs :func:`rmsnorm_plain`, the
oracle ``repro.kernels.ref.rmsnorm``.  Both compute in float32,
``(x * rsqrt(mean(x^2) + eps)) * scale``, and return x's dtype.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _lib

# The kernel's paths (csrc/rmsnorm.cu), by the code its entry points take.
PATHS = {"rows": 0, "wide": 1, "scalar": 2}
VEC_BYTES = 16          # one vector load or store
MAX_VECS_PER_LANE = 16  # the register limit of the "rows" path


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=256)     # called once a launch, on the host
def rmsnorm_plan(dtype: torch.dtype, d: int,
                 aligned: bool) -> tuple[str, int, int]:
    """(path, lanes per row, vectors per lane) of the kernel for rows of
    ``d`` entries of ``dtype``; ``aligned``: x and scale start on a 16-byte
    boundary.

    - "rows": 16-byte vectors and the row held in registers; a group of
      ``lanes`` lanes (a power of two, at most a warp) takes a row, each
      lane up to ``vectors per lane`` (a power of two) vectors of it, so
      32 / lanes rows share a warp.  For d a multiple of the vector width
      and at most 32 x 16 vectors (2,048 float32, 4,096 bfloat16).
    - "wide": 16-byte vectors, one block a row and two passes over it;
      for longer rows.
    - "scalar": element loads, one warp a row; for d not a multiple of
      the vector width or a base not 16-byte aligned.
    """
    per_vec = VEC_BYTES // dtype.itemsize
    if not aligned or d % per_vec:
        return "scalar", 32, 1
    vecs = d // per_vec
    if vecs > 32 * MAX_VECS_PER_LANE:
        return "wide", 0, 0
    lanes = min(32, _lib.pow2_ceil(vecs))
    return "rows", lanes, _lib.pow2_ceil(-(-vecs // lanes))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D] float32 or bfloat16, scale [D] of x's dtype -> [..., D]."""
    index = _lib.cuda_index(x, scale)
    if index is None:
        return rmsnorm_plain(x, scale, eps)
    kind = _lib.float_kind(x, "x")
    d = x.shape[-1]
    _lib.require(x, "x", x.dtype, x.shape)
    _lib.require(scale, "scale", x.dtype, (d,))
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    xp, sp = x.data_ptr(), scale.data_ptr()
    path, lanes, vecs = rmsnorm_plan(x.dtype, d, (xp | sp) % VEC_BYTES == 0)
    _lib.launch(f"rmsnorm_{kind}", index, xp, sp, out.data_ptr(), rows, d,
                float(eps), PATHS[path], lanes, vecs)
    _lib.LAUNCHES["rmsnorm"] += 1
    return out

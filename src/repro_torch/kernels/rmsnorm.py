"""RMSNorm over the last axis (PyTorch port of ``repro.kernels.rmsnorm``).

On CUDA tensors :func:`rmsnorm` launches the hand-written kernel in
``csrc/rmsnorm.cu``; on CPU tensors it runs :func:`rmsnorm_plain`, the
oracle ``repro.kernels.ref.rmsnorm``.  Both compute in float32,
``(x * rsqrt(mean(x^2) + eps)) * scale``, and return x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D] float32 or bfloat16, scale [D] of x's dtype -> [..., D]."""
    if not _lib.on_cuda(x, scale):
        return rmsnorm_plain(x, scale, eps)
    d = x.shape[-1]
    kind = _lib.float_kind(x, "x")
    _lib.require(x, "x", x.dtype, tuple(x.shape))
    _lib.require(scale, "scale", x.dtype, (d,))
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        rc = getattr(_lib.library(), f"rmsnorm_{kind}")(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
            float(eps), _lib.stream(x))
    _lib.check(rc, "rmsnorm")
    _lib.LAUNCHES["rmsnorm"] += 1
    return out

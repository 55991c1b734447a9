"""Masked FedAvg (paper Eq. 2) with the per-leaf weighted sum in a kernel.

PyTorch port of ``repro.kernels.fedavg_reduce.fedavg_reduce``.  The weight
math stays here, as in the JAX wrapper: the finite-update mask, the Eq. (2)
weights ``a_i |D_i|``, the optional per-client multipliers, the norm-clip
reweighting identity, the division by the total and the empty-selection
guard.  Each leaf's ``sum_n w[n] * screen(x[n, :])`` is :func:`reduce_leaf`:
the hand-written kernel ``csrc/fedavg_reduce.cu`` on CUDA tensors, the
plain torch sum on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.fl.server import (clip_scales, fedavg_weights,
                                   finite_update_mask)
from repro_torch.kernels import _lib
from repro_torch.tree import Params, tree_map


def reduce_leaf_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    xf = torch.where(torch.isfinite(xf), xf, 0.0)
    return (w.float()[:, None] * xf).sum(dim=0)


def reduce_leaf(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [N] float32, x [N, D] float32 -> [D] float32 weighted sum of the
    screened rows (non-finite entries count as 0)."""
    if not _lib.on_cuda(w, x):
        return reduce_leaf_plain(w, x)
    n, d = x.shape
    _lib.require(w, "w", torch.float32, (n,))
    _lib.require(x, "x", torch.float32, (n, d))
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        rc = lib.fedavg_reduce_f32(w.data_ptr(), x.data_ptr(), n, d,
                                   out.data_ptr(), _lib.stream(x))
    _lib.check(rc, "fedavg_reduce")
    _lib.LAUNCHES["fedavg_reduce"] += 1
    return out


def fedavg_reduce(global_params: Params, client_params: Params,
                  selected: torch.Tensor, data_sizes: torch.Tensor,
                  clip_norm=None,
                  weights: torch.Tensor | None = None) -> Params:
    """Same contract as :func:`repro_torch.fl.server.fedavg`: client leaves
    [N, ...], selected [N] bool, data_sizes [N]; one :func:`reduce_leaf`
    per leaf."""
    ok = finite_update_mask(client_params)
    w, _ = fedavg_weights(selected & ok, data_sizes)
    if weights is not None:
        w = w * weights.float()
    total = w.sum()
    if clip_norm is not None:
        v = w * clip_scales(global_params, client_params, clip_norm)
        v_total = v.sum()
    else:
        v, v_total = w, total
    safe_total = torch.clamp(total, min=1e-9)

    def agg(g, c):
        n = c.shape[0]
        s = reduce_leaf(v, c.reshape(n, -1).float().contiguous())
        if clip_norm is not None:
            s = s + (total - v_total) * g.float().reshape(-1)
        avg = (s / safe_total).to(c.dtype).reshape(c.shape[1:])
        return torch.where(total > 0, avg, g)

    return tree_map(agg, global_params, client_params)

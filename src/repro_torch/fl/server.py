"""Server-side aggregation — paper Eq. (2), masked weighted FedAvg (PyTorch
port of ``repro.fl.server``, single tier).

Parameters are dicts of tensors (nested one level, as the CNN's); client
parameters carry a leading ``[N]`` axis.  The weighted sum accumulates in
float32 and is cast back to the leaf dtype once.  A client whose update has
any NaN/Inf gets zero weight AND has its values zeroed before the sum,
because ``0 * NaN = NaN``.  With ``clip_norm`` each update's L2 distance
from the global model is clipped through the reweighting identity
``ref + sum_i w_i s_i (x_i - ref) / sum_i w_i``, still one weighted sum.

:func:`fedavg` is the plain version; the round engine aggregates through
:func:`repro_torch.kernels.fedavg_reduce.fedavg_reduce`, whose per-leaf sum
is a CUDA kernel on the card.
"""
from __future__ import annotations

import torch

from repro_torch.tree import Params, tree_leaves, tree_map


def fedavg_weights(selected: torch.Tensor, data_sizes: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) client weights a_i |D_i| (float32) and their total."""
    w = selected.float() * data_sizes.float()
    return w, w.sum()


def finite_update_mask(client_params: Params) -> torch.Tensor:
    """[N] bool: client i's update is finite in every leaf entry."""
    leaves = tree_leaves(client_params)
    ok = torch.ones((leaves[0].shape[0],), dtype=torch.bool,
                    device=leaves[0].device)
    for c in leaves:
        ok = ok & torch.isfinite(c.float()).reshape(c.shape[0], -1).all(dim=1)
    return ok


def _screen(c: torch.Tensor) -> torch.Tensor:
    """Zero the non-finite entries of a leaf (f32)."""
    cf = c.float()
    return torch.where(torch.isfinite(cf), cf, 0.0)


def clip_scales(ref_params: Params, client_params: Params,
                clip_norm) -> torch.Tensor:
    """[N] per-client norm-clip factors s_i = min(1, clip / ||x_i - ref||)."""
    sq = 0.0
    for r, c in zip(tree_leaves(ref_params), tree_leaves(client_params)):
        rf = r.float()
        if rf.dim() < c.dim():          # shared reference -> broadcast over N
            rf = rf[None]
        delta = _screen(c) - rf
        sq = sq + torch.square(delta).reshape(c.shape[0], -1).sum(dim=1)
    norm = torch.sqrt(sq)
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


def fedavg(global_params: Params, client_params: Params,
           selected: torch.Tensor, data_sizes: torch.Tensor, clip_norm=None,
           weights: torch.Tensor | None = None) -> Params:
    """w^n = sum_i a_i |D_i| w_i / sum_i a_i |D_i|  (Eq. 2).

    Keeps the global model when nothing was selected (or every selected
    update was screened out).  ``weights`` is an optional [N] per-client
    multiplier on the Eq. (2) weight.
    """
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
        vb = v.reshape((-1,) + (1,) * (c.dim() - 1))
        acc = (vb * _screen(c)).sum(dim=0)
        if clip_norm is not None:
            acc = acc + (total - v_total) * g.float()
        avg = (acc / safe_total).to(c.dtype)
        return torch.where(total > 0, avg, g)

    return tree_map(agg, global_params, client_params)

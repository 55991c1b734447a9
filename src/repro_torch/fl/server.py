"""Server-side aggregation — paper Eq. (2), masked weighted FedAvg (PyTorch
port of ``repro.fl.server``).

Two granularities share the math: :func:`fedavg`, the single-tier Eq. (2),
and :func:`fedavg_segmented`, the hierarchical edge step (Eq. (2) per BS
over the ``[N, M]`` assignment; a BS that aggregated nobody keeps its edge
model), whose edge models :func:`edge_global_sync` mixes into the global
model every ``tau_global`` rounds.  The buffered-async engine multiplies
the Eq. (2) weights by :func:`staleness_weights`.

Parameters are dicts of tensors (nested one level, as the CNN's); client
parameters carry a leading ``[N]`` axis.  The weighted sum accumulates in
float32 and is cast back to the leaf dtype once.  A client whose update has
any NaN/Inf gets zero weight AND has its values zeroed before the sum,
because ``0 * NaN = NaN``.  With ``clip_norm`` each update's L2 distance
from the global model is clipped through the reweighting identity
``ref + sum_i w_i s_i (x_i - ref) / sum_i w_i``, still one weighted sum.

:func:`fedavg` and :func:`fedavg_segmented` are the plain versions; the
round engine aggregates through
:mod:`repro_torch.kernels.fedavg_reduce`, whose per-leaf sums are CUDA
kernels on the card.
"""
from __future__ import annotations

import torch

from repro_torch import const
from repro_torch.tree import Params, tree_leaves, tree_map


def fedavg_weights(selected: torch.Tensor, data_sizes: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (2) client weights a_i |D_i| (float32) and their total."""
    w = selected.float() * data_sizes.float()
    return w, w.sum()



def staleness_weights(staleness: torch.Tensor, alpha) -> torch.Tensor:
    """Polynomial staleness discount w(s) = (1 + s)^(-alpha) in float32.

    ``staleness`` counts whole aggregation ticks between an update's
    dispatch and its delivery; a same-tick delivery (s = 0) weighs
    exactly 1.0 for every alpha (``pow(1, y) == 1``), and ``alpha = 0``
    disables the discount (``pow(x, -0.0) == 1``).
    """
    s = torch.as_tensor(staleness).float()
    return torch.pow(1.0 + s, -const(float(alpha), torch.float32, s.device))

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


def segment_weights(assign: torch.Tensor, data_sizes: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(client, BS) Eq. (2) weights a_{i,k} |D_i| ([N, M] float32) and
    the per-BS totals ([M])."""
    w = assign.float() * data_sizes.float()[:, None]
    return w, w.sum(dim=0)


def fedavg_segmented(edge_params: Params, client_params: Params,
                     assign: torch.Tensor, data_sizes: torch.Tensor,
                     clip_norm=None) -> Params:
    """Per-BS edge aggregation: Eq. (2) restricted to each BS's users.

    Edge leaves [M, ...], client leaves [N, ...], assign [N, M] bool.  A BS
    with no (finite) assigned update keeps its edge model.  With
    ``clip_norm`` each update's deviation is measured against its assigned
    BS's edge model.
    """
    ok = finite_update_mask(client_params)
    w, totals = segment_weights(assign & ok[:, None], data_sizes)
    if clip_norm is not None:
        client_bs = assign.to(torch.int8).argmax(dim=1)   # 0 for unassigned
        ref = tree_map(lambda e: e[client_bs], edge_params)
        v = w * clip_scales(ref, client_params, clip_norm)[:, None]
        v_totals = v.sum(dim=0)
    else:
        v, v_totals = w, totals
    safe = torch.clamp(totals, min=1e-9)

    def agg(e, c):
        n = c.shape[0]
        acc = v.t() @ _screen(c).reshape(n, -1)                 # [M, D]
        if clip_norm is not None:
            acc = acc + (totals - v_totals)[:, None] \
                * e.float().reshape(e.shape[0], -1)
        avg = (acc / safe[:, None]).to(c.dtype).reshape(e.shape)
        keep = (totals > 0).reshape((-1,) + (1,) * (e.dim() - 1))
        return torch.where(keep, avg, e)

    return tree_map(agg, edge_params, client_params)


def edge_global_sync(global_params: Params, edge_params: Params,
                     edge_weight: torch.Tensor) -> Params:
    """Tier 2 of hierarchical Eq. (2): the edge models weighted by the data
    mass each aggregated since the last sync ([M]).  Keeps the global model
    when nothing was aggregated anywhere."""
    total = edge_weight.sum()
    safe = torch.clamp(total, min=1e-9)

    def agg(g, e):
        wb = edge_weight.reshape((-1,) + (1,) * (e.dim() - 1))
        acc = (wb * e.float()).sum(dim=0)
        return torch.where(total > 0, (acc / safe).to(g.dtype), g)

    return tree_map(agg, global_params, edge_params)

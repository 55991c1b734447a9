"""Masked FedAvg (paper Eq. 2) with the per-leaf weighted sums in kernels.

PyTorch port of ``repro.kernels.fedavg_reduce``: :func:`fedavg_reduce`
(single tier) and :func:`fedavg_segment_reduce` (the hierarchical edge
step, M edge models in one pass).  The weight math stays here, as in the
JAX wrappers: the finite-update mask, the Eq. (2) weights ``a_i |D_i|``,
the optional per-client multipliers, the norm-clip reweighting identity,
the division by the totals and the empty-selection / empty-BS guards.

Each leaf's sum is :func:`reduce_leaf` (``sum_n w[n] * screen(x[n, :])``)
or :func:`segment_reduce_leaf` (``w.T @ screen(x)``): the hand-written
kernels of ``csrc/fedavg_reduce.cu`` on CUDA tensors, the plain torch
versions on CPU tensors.  Both take ``x`` as float32 or as the int8 codes
of the compressed uplink (:mod:`repro_torch.kernels.compress_topk`), and
count int8 launches under their own :data:`~repro_torch.kernels._lib.
LAUNCHES` keys.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.fl.server import (clip_scales, fedavg_weights,
                                   finite_update_mask, segment_weights)
from repro_torch.kernels import _lib
from repro_torch.tree import Params, tree_map

_X_DTYPES = (torch.float32, torch.int8)

# reduce_leaf's kernel paths (csrc/fedavg_reduce.cu), by the code its entry
# points take, and the numbers its plan works with, chosen by a sweep on
# the H100 over 50-1,000 clients of the fc1 leaf (PERF.md).
REDUCE_PATHS = {"vector": 0, "scalar": 1}
VEC_BYTES = 16            # one vector load: 4 float32 or 16 int8 codes
REDUCE_THREADS = 128      # lanes a block of the vector path
MIN_SPLITS = 2            # client ranges a column block: a cluster of 2
MAX_SPLITS = 8            # to a portable cluster of 8
TARGET_BLOCKS = 528       # about four blocks an SM on the H100's 132
MIN_SPLIT_ROWS = 12       # fewest clients a split may get
# the fewest clients at which the vector path beat the scalar one
VECTOR_MIN_CLIENTS = {torch.float32: 100, torch.int8: 200}


def _screened(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.where(torch.isfinite(xf), xf, 0.0)


def reduce_leaf_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (w.float()[:, None] * _screened(x)).sum(dim=0)


def segment_reduce_leaf_plain(w: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    return w.float().t() @ _screened(x)


def _x_kind(x: torch.Tensor) -> str:
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x must be float32 or int8, got {x.dtype}")
    return "i8" if x.dtype == torch.int8 else "f32"


@functools.lru_cache(maxsize=256)     # called once a launch, on the host
def reduce_plan(dtype: torch.dtype, n: int, d: int,
                aligned: bool) -> tuple[str, int]:
    """(path, splits) of :func:`reduce_leaf`'s kernel for x [n, d] of
    ``dtype``; ``aligned``: x starts on a 16-byte boundary.

    - "vector": 16-byte loads, a lane a vector of columns; the clients
      split into ``splits`` contiguous ranges (a power of two from
      :data:`MIN_SPLITS` to :data:`MAX_SPLITS`), doubled while the grid
      has fewer than :data:`TARGET_BLOCKS` blocks and each range keeps at
      least :data:`MIN_SPLIT_ROWS` clients; the ranges' sums are added in
      range order over a thread-block cluster.  For rows of whole vectors
      on an aligned base and at least :data:`VECTOR_MIN_CLIENTS` clients.
    - "scalar": a column a thread, one range; for any other x.
    """
    per_vec = VEC_BYTES // dtype.itemsize
    if not aligned or d % per_vec or n < VECTOR_MIN_CLIENTS[dtype]:
        return "scalar", 1
    blocks = -(-(d // per_vec) // REDUCE_THREADS)
    splits = MIN_SPLITS
    while (splits < MAX_SPLITS and blocks * splits < TARGET_BLOCKS
           and n // (2 * splits) >= MIN_SPLIT_ROWS):
        splits *= 2
    return "vector", splits


def reduce_leaf(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [N] float32, x [N, D] float32 or int8 -> [D] float32 weighted sum
    of the screened rows (non-finite entries count as 0)."""
    index = _lib.cuda_index(w, x)
    if index is None:
        return reduce_leaf_plain(w, x)
    n, d = x.shape
    kind = _x_kind(x)
    _lib.require(w, "w", torch.float32, (n,))
    _lib.require(x, "x", x.dtype, (n, d))
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    xp = x.data_ptr()
    path, splits = reduce_plan(x.dtype, n, d, xp % VEC_BYTES == 0)
    _lib.launch(f"fedavg_reduce_{kind}", index, w.data_ptr(), xp, n, d,
                out.data_ptr(), REDUCE_PATHS[path], splits)
    _lib.LAUNCHES["fedavg_reduce_int8" if kind == "i8"
                  else "fedavg_reduce"] += 1
    return out


def segment_reduce_leaf(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [N, M] float32, x [N, D] float32 or int8 -> [M, D] float32 per-BS
    weighted sums of the screened rows."""
    index = _lib.cuda_index(w, x)
    if index is None:
        return segment_reduce_leaf_plain(w, x)
    n, d = x.shape
    m = w.shape[1] if w.dim() == 2 else -1
    kind = _x_kind(x)
    _lib.require(w, "w", torch.float32, (n, m))
    _lib.require(x, "x", x.dtype, (n, d))
    out = torch.empty((m, d), dtype=torch.float32, device=x.device)
    _lib.launch(f"fedavg_segment_reduce_{kind}", index, w.data_ptr(),
                x.data_ptr(), n, m, d, out.data_ptr())
    _lib.LAUNCHES["fedavg_segment_reduce_int8" if kind == "i8"
                  else "fedavg_segment_reduce"] += 1
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


def fedavg_segment_reduce(edge_params: Params, client_params: Params,
                          assign: torch.Tensor, data_sizes: torch.Tensor,
                          clip_norm=None) -> Params:
    """Same contract as :func:`repro_torch.fl.server.fedavg_segmented`:
    edge leaves [M, ...], client leaves [N, ...], assign [N, M] bool; one
    :func:`segment_reduce_leaf` per leaf.  ``clip_norm`` clips each
    update's deviation from its assigned BS's edge model."""
    ok = finite_update_mask(client_params)
    w, totals = segment_weights(assign & ok[:, None], data_sizes)
    if clip_norm is not None:
        client_bs = assign.to(torch.int8).argmax(dim=1)   # 0 for unassigned
        ref = tree_map(lambda e: e[client_bs], edge_params)
        v = w * clip_scales(ref, client_params, clip_norm)[:, None]
        v_totals = v.sum(dim=0)
    else:
        v, v_totals = w, totals
    v = v.contiguous()
    safe = torch.clamp(totals, min=1e-9)

    def agg(e, c):
        n = c.shape[0]
        s = segment_reduce_leaf(v, c.reshape(n, -1).float().contiguous())
        if clip_norm is not None:
            s = s + (totals - v_totals)[:, None] \
                * e.float().reshape(e.shape[0], -1)
        avg = (s / safe[:, None]).to(c.dtype).reshape(e.shape)
        keep = (totals > 0).reshape((-1,) + (1,) * (e.dim() - 1))
        return torch.where(keep, avg, e)

    return tree_map(agg, edge_params, client_params)

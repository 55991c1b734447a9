"""Compressed-uplink client updates: top-k sparsify + int8 stochastic round
(PyTorch port of ``repro.kernels.compress_topk``).

Each client sends only the top-k largest-magnitude entries of its model
DELTA ``params_i - ref``, each optionally stochastically rounded to int8
against a per-client, per-leaf scale:

* **Threshold**: the k-th largest ``|delta|`` per client row
  (:func:`topk_threshold`, ``torch.topk`` outside the kernel as
  ``lax.top_k`` is in JAX).  Survivors are ``|x| >= thresh``, so magnitude
  ties at the threshold all survive.
* **Sparsify + quantize**: :func:`sparsify_quantize`, one elementwise pass
  given the per-row threshold and scale and external uniform noise ``u``
  (``q = clip(floor(x / scale + u), -127, 127)``): the hand-written kernel
  ``csrc/sparsify_quantize.cu`` on CUDA tensors, the plain version on CPU
  tensors, bit-identical to each other and to the JAX package's.
* **Decompress + accumulate**: the per-client dequant scale folds into the
  Eq. (2) weights, so the FedAvg reductions of
  :mod:`repro_torch.kernels.fedavg_reduce` consume the int8 codes as they
  are; the in-kernel int8 -> float32 conversion is the decompression, and
  no dense [N, model] float32 reconstruction exists.

Payload accounting (Eq. (1)'s ``s_k``): a sparse update costs
``k * (value_bits + 32)`` bits per leaf (32-bit indices); ``topk_frac=1``
sends dense values only.  The chunked twins (``*_chunked``, plain torch,
``compress_delta_tree(block=)``) bound the temporaries to a block of
features or clients and give the dense results bit for bit, as the JAX
package's do.
"""
from __future__ import annotations

import math

import torch

from repro_torch import const, rng
from repro_torch.fl.server import fedavg_weights, segment_weights
from repro_torch.kernels import _lib
from repro_torch.kernels.fedavg_reduce import reduce_leaf, segment_reduce_leaf
from repro_torch.tree import Params, tree_leaves, tree_map, tree_unflatten

QMAX = 127.0           # int8 code range [-127, 127] (symmetric; -128 unused)
INDEX_BITS = 32        # per-entry position cost of a sparse payload


# ------------------------------------------------------------ payload model --
def nominal_k(d: int, topk_frac: float) -> int:
    """Entries kept per d-sized leaf row: ceil(frac * d), at least 1."""
    return max(1, min(d, math.ceil(topk_frac * d)))


def payload_bits(params: Params, topk_frac: float, quantize: bool) -> int:
    """Nominal per-client uplink bits for one update of ``params``: value +
    32-bit index per kept entry when sparse, values only when dense."""
    value_bits = 8 if quantize else 32
    total = 0
    for leaf in tree_leaves(params):
        d = math.prod(leaf.shape) if leaf.shape else 1
        if topk_frac >= 1.0:
            total += d * value_bits
        else:
            total += nominal_k(d, topk_frac) * (value_bits + INDEX_BITS)
    return total


def compression_ratio(params: Params, topk_frac: float,
                      quantize: bool) -> float:
    """compressed bits / dense float32 bits: the factor the Eq. (1) payload
    ``s_k`` scales by."""
    dense = payload_bits(params, 1.0, quantize=False)
    return payload_bits(params, topk_frac, quantize) / dense


# -------------------------------------------------------------- thresholds --
def topk_threshold(x: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] -> ([N] k-th largest |x| per row, [N] row max |x|)."""
    vals = torch.topk(x.float().abs(), k, dim=1).values
    return vals[:, -1].contiguous(), vals[:, 0].contiguous()


def topk_threshold_chunked(x: torch.Tensor, k: int, block: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Feature-blocked twin of :func:`topk_threshold`, bit-exact: each
    block of ``block`` features keeps its ``min(k, block)`` largest |x|,
    then the k-th largest of those candidates is the dense k-th value
    (every global top-k entry is a candidate of its block; the rule
    compares values, so ties resolve as in the dense version)."""
    n, d = x.shape
    ax = x.float().abs()
    pad = (-d) % block
    if pad:
        # |x| >= 0, so the -1 padding never enters the top-k (k <= d)
        ax = torch.nn.functional.pad(ax, (0, pad), value=-1.0)
    cand = torch.topk(ax.reshape(n, -1, block), min(k, block),
                      dim=-1).values.reshape(n, -1)
    vals = torch.topk(cand, k, dim=1).values
    return vals[:, -1].contiguous(), vals[:, 0].contiguous()


def quant_scale(rowmax: torch.Tensor) -> torch.Tensor:
    """Per-row int8 step: max|x| / 127, 1.0 on all-zero rows.  The divisor
    is a tensor: torch may turn a division by a Python scalar into a
    multiplication by its reciprocal, which rounds differently."""
    return torch.where(rowmax > 0.0, rowmax / torch.full_like(rowmax, QMAX),
                       1.0)


# ----------------------------------------------------- sparsify + quantize --
def sparsify_quantize_plain(x: torch.Tensor, thresh: torch.Tensor,
                            scale: torch.Tensor, u: torch.Tensor | None, *,
                            quantize: bool) -> torch.Tensor:
    xf = x.float()
    xf = torch.where(torch.isfinite(xf), xf, 0.0)
    mask = xf.abs() >= thresh[:, None]
    if quantize:
        q = torch.clamp(torch.floor(xf / scale[:, None] + u), -QMAX, QMAX)
        return torch.where(mask, q, 0.0).to(torch.int8)
    return torch.where(mask, xf, 0.0)


def sparsify_quantize_chunked(x: torch.Tensor, thresh: torch.Tensor,
                              scale: torch.Tensor, u: torch.Tensor | None, *,
                              quantize: bool, block: int) -> torch.Tensor:
    """Client-blocked twin of the plain version: the same elementwise rule
    on [block, D] slabs, so the codes are the dense codes bit for bit."""
    outs = []
    for i0 in range(0, x.shape[0], block):
        sl = slice(i0, i0 + block)
        outs.append(sparsify_quantize_plain(
            x[sl], thresh[sl], scale[sl], None if u is None else u[sl],
            quantize=quantize))
    return torch.cat(outs)


def sparsify_quantize(x: torch.Tensor, thresh: torch.Tensor,
                      scale: torch.Tensor, u: torch.Tensor | None, *,
                      quantize: bool) -> torch.Tensor:
    """x [N, D] float32 + per-row thresh/scale [N] + noise u [N, D] (only
    read when ``quantize``) -> codes [N, D]: int8 when ``quantize``, masked
    float32 values otherwise.  Non-finite entries screen to 0 first."""
    if quantize and u is None:
        raise ValueError("quantize=True needs the rounding noise u")
    args = (x, thresh, scale) + ((u,) if quantize else ())
    index = _lib.cuda_index(*args)
    if index is None:
        return sparsify_quantize_plain(x, thresh, scale, u, quantize=quantize)
    n, d = x.shape
    _lib.require(x, "x", torch.float32, (n, d))
    _lib.require(thresh, "thresh", torch.float32, (n,))
    _lib.require(scale, "scale", torch.float32, (n,))
    if quantize:
        _lib.require(u, "u", torch.float32, (n, d))
    out = torch.empty((n, d), device=x.device,
                      dtype=torch.int8 if quantize else torch.float32)
    _lib.launch("sparsify_quantize_f32", index, x.data_ptr(),
                thresh.data_ptr(), scale.data_ptr(),
                u.data_ptr() if quantize else None, n, d, int(quantize),
                out.data_ptr())
    _lib.LAUNCHES["sparsify_quantize"] += 1
    return out


# --------------------------------------------------------- tree-level API --
def compress_delta_tree(delta: Params, topk_frac: float, *, quantize: bool,
                        key: torch.Tensor | None = None,
                        block: int | None = None) -> tuple[Params, Params]:
    """Compress every [N, ...] leaf of a client-delta tree.

    Returns ``(codes, scales)``: codes keep the leaf shapes (int8 when
    ``quantize``), scales are [N] float32 dequant steps (ones when not
    quantizing).  Leaf i (sorted-key order) rounds with the noise
    ``uniform(fold_in(key, i), [N, D])``, as in the JAX package.
    ``block`` takes the chunked twins: the thresholds in feature blocks
    (leaves wider than ``block``) and, on CPU tensors, the codes in
    client blocks (the kernel streams them on CUDA); same results.
    """
    if quantize and key is None:
        raise ValueError("quantize=True needs a PRNG key for the "
                         "stochastic rounding noise")
    codes, scales = [], []
    for i, leaf in enumerate(tree_leaves(delta)):
        n = leaf.shape[0]
        xf = leaf.reshape(n, -1).float()
        xf = torch.where(torch.isfinite(xf), xf, 0.0).contiguous()
        d = xf.shape[1]
        k = nominal_k(d, topk_frac)
        if block is not None and block < d:
            thresh, rowmax = topk_threshold_chunked(xf, k, block)
        else:
            thresh, rowmax = topk_threshold(xf, k)
        if quantize:
            scale = quant_scale(rowmax)
            u = rng.uniform(rng.fold_in(key, i), tuple(xf.shape))
        else:
            scale = torch.ones((n,), dtype=torch.float32, device=xf.device)
            u = None
        if block is not None and not xf.is_cuda:
            q = sparsify_quantize_chunked(xf, thresh, scale, u,
                                          quantize=quantize, block=block)
        else:
            q = sparsify_quantize(xf, thresh, scale, u, quantize=quantize)
        codes.append(q.reshape(leaf.shape))
        scales.append(scale)
    return tree_unflatten(delta, codes), tree_unflatten(delta, scales)


def decompress_tree(codes: Params, scales: Params) -> Params:
    """Dense reconstruction ``scale_i * q_i``: the buffered-async engine's
    round trip at dispatch, and the oracles (the fused reductions never
    build it)."""
    return tree_map(
        lambda q, s: q.float() * s.reshape((-1,) + (1,) * (q.dim() - 1)),
        codes, scales)


def compressed_clip_scales(codes: Params, scales: Params,
                           clip_norm) -> torch.Tensor:
    """[N] norm-clip factors min(1, clip / ||delta_i||) from the codes:
    ||delta_i||^2 = sum_leaf scale^2 * sum |q|^2."""
    sq = 0.0
    for q, s in zip(tree_leaves(codes), tree_leaves(scales)):
        qf = q.float()
        sq = sq + torch.square(s) * torch.square(qf).reshape(
            q.shape[0], -1).sum(dim=1)
    norm = torch.sqrt(sq)
    cv = const(float(clip_norm), torch.float32, norm.device)
    return torch.clamp(cv / torch.clamp(norm, min=1e-12), max=1.0)


# ----------------------------------------- decompress-fused aggregation --
def fedavg_decompress_reduce(global_params: Params, codes: Params,
                             scales: Params, selected: torch.Tensor,
                             data_sizes: torch.Tensor, *,
                             weights: torch.Tensor | None = None,
                             clip_norm=None) -> Params:
    """Single-tier Eq. (2) over compressed deltas:
    ``g + sum_i w_i c_i scale_i q_i / sum_i w_i`` with w_i the masked
    Eq. (2) weights (times the optional ``weights``) and c_i the optional
    compressed-domain clip factor; one :func:`reduce_leaf` per leaf over
    the codes, with the dequant scale folded into the weights.  Empty
    selection keeps the global model."""
    w, total = fedavg_weights(selected, data_sizes)
    if weights is not None:
        w = w * weights.float()
        total = w.sum()
    if clip_norm is not None:
        w = w * compressed_clip_scales(codes, scales, clip_norm)
    safe_total = torch.clamp(total, min=1e-9)

    def agg(g, q, s):
        n = q.shape[0]
        acc = reduce_leaf((w * s).contiguous(), q.reshape(n, -1).contiguous())
        new = g + (acc / safe_total).to(g.dtype).reshape(g.shape)
        return torch.where(total > 0, new, g)

    return tree_map(agg, global_params, codes, scales)


def fedavg_decompress_segment_reduce(edge_params: Params, codes: Params,
                                     scales: Params, assign: torch.Tensor,
                                     serving: torch.Tensor,
                                     data_sizes: torch.Tensor, *,
                                     clip_norm=None) -> Params:
    """Hierarchical edge Eq. (2) over compressed deltas, one pass per leaf.

    Client i's delta is relative to its SERVING cell's edge model, its
    upload aggregates into its ASSIGNED BS:

        edge'[m] = (sum_i w_im e[serving_i] + sum_i w_im scale_i q_i)
                   / sum_i w_im.

    The second term is :func:`segment_reduce_leaf` over the codes with the
    dequant scale folded into the [N, M] weights; the first contracts the
    [M, M] cross-mass ``cross[m, m'] = sum_{i: serving_i = m'} w_im`` with
    the edge models (a plain product, as XLA computes it in JAX).  The
    totals are taken before the clip scaling, the cross-mass after it.
    Empty BSs keep their edge model.
    """
    m = assign.shape[1]
    w, totals = segment_weights(assign, data_sizes)           # [N, M], [M]
    if clip_norm is not None:
        w = w * compressed_clip_scales(codes, scales, clip_norm)[:, None]
    serve_1h = (serving.long()[:, None]
                == torch.arange(m, device=serving.device)).float()
    cross = w.t() @ serve_1h                                  # [M, M]
    safe = torch.clamp(totals, min=1e-9)

    def agg(e, q, s):
        n = q.shape[0]
        acc = segment_reduce_leaf((w * s[:, None]).contiguous(),
                                  q.reshape(n, -1).contiguous())  # [M, D]
        base = cross @ e.float().reshape(m, -1)                    # [M, D]
        avg = ((base + acc) / safe[:, None]).to(e.dtype).reshape(e.shape)
        keep = (totals > 0).reshape((-1,) + (1,) * (e.dim() - 1))
        return torch.where(keep, avg, e)

    return tree_map(agg, edge_params, codes, scales)

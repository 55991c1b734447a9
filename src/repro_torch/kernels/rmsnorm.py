"""RMSNorm over the last axis (PyTorch port of ``repro.kernels.rmsnorm``).

On CUDA tensors :func:`rmsnorm` launches the hand-written kernel in
``csrc/rmsnorm.cu``; on CPU tensors it runs :func:`rmsnorm_plain`, the
oracle ``repro.kernels.ref.rmsnorm``.  Both compute in float32,
``(x * rsqrt(mean(x^2) + eps)) * scale``, and return x's dtype.

Gradients: where autograd records the call (grad enabled and an input
requiring it), :func:`rmsnorm` goes through an ``autograd.Function`` whose
backward is :func:`rmsnorm_bwd`, the hand-written kernels of the same
source on CUDA tensors, the plain version's autograd on CPU tensors.
Otherwise it launches the forward directly, as the serving path always
does.
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


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, index):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps, index)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D] float32 or bfloat16, scale [D] of x's dtype -> [..., D]."""
    index = _lib.cuda_index(x, scale)
    if index is None:
        return rmsnorm_plain(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x.contiguous(), scale.contiguous(), eps, index)
    return _forward(x, scale, eps, index)


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float,
             index: int) -> torch.Tensor:
    """The forward kernel's launch (the serving path's direct call)."""
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


# The backward's routes (csrc/rmsnorm.cu), by the code its entry points take.
BWD_ROUTES = {"rows": 0, "scalar": 1}
BWD_BLOCK = 256         # threads a block of the "rows" route (or a row's)
BWD_MAX_LANES = 512     # threads a row of the "rows" route
BWD_MAX_VECS_PER_LANE = 4   # its register budget: x, g, scale, accumulators
# Blocks of the "rows" route, each one partial row of dscale: enough to
# cover the 132 SMs several times, few enough that the partial rows stay
# small beside x and g (at least BWD_BLOCK_ROWS rows a block).
BWD_MAX_BLOCKS = 256
BWD_BLOCK_ROWS = 16
# Rows the "scalar" route sums into one partial row of dscale (more where
# the rows would need more than the grid's 65,535 chunks).
BWD_CHUNK_ROWS = 256


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-6):
    """(dx, dscale): autograd of :func:`rmsnorm_plain` given g =
    dL/dout."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(True)
        ss = scale.detach().requires_grad_(True)
        return torch.autograd.grad(rmsnorm_plain(xs, ss, eps), (xs, ss), g)


@functools.lru_cache(maxsize=256)     # called once a launch, on the host
def rmsnorm_bwd_plan(dtype: torch.dtype, d: int,
                     aligned: bool) -> tuple[str, int, int]:
    """(route, threads per row, vectors per lane) of the backward for rows
    of ``d`` entries of ``dtype``; ``aligned``: x, scale, g and dx start on
    a 16-byte boundary.

    - "rows": one pass, 16-byte vectors, the row in registers: a group of
      ``threads`` (a power of two) takes a row, each lane up to
      ``BWD_MAX_VECS_PER_LANE`` vectors of it, as few lanes as that
      allows: 32 / threads rows a warp up to a warp, whole warps a row
      past it, at most ``BWD_MAX_LANES`` (16,384 bfloat16, 8,192
      float32).  For d a multiple of the vector width.
    - "scalar": element loads, a warp a row, x and g read twice; for d not
      a multiple of the vector width, a base off 16-byte alignment, or a
      row past the "rows" route.
    """
    per_vec = VEC_BYTES // dtype.itemsize
    if aligned and d % per_vec == 0:
        vecs = d // per_vec
        lanes = _lib.pow2_ceil(-(-vecs // BWD_MAX_VECS_PER_LANE))
        if lanes <= BWD_MAX_LANES:
            return "rows", lanes, -(-vecs // lanes)
    return "scalar", 32, 1


def rmsnorm_bwd_parts(route: str, lanes: int, rows: int) -> int:
    """The partial rows of dscale a call sums: the "rows" route's blocks
    (``max(lanes, BWD_BLOCK) / lanes`` rows a block at a time, and at
    least ``BWD_BLOCK_ROWS`` rows a block, at most ``BWD_MAX_BLOCKS``
    blocks), or the "scalar" route's chunks of rows."""
    if route == "rows":
        per_block = max(max(lanes, BWD_BLOCK) // lanes, BWD_BLOCK_ROWS)
        return min(-(-rows // per_block), BWD_MAX_BLOCKS)
    return -(-rows // max(BWD_CHUNK_ROWS, -(-rows // 65535)))


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6):
    """The gradients (dx in x's dtype, dscale in scale's) of ``out =
    rmsnorm(x, scale, eps)`` given g = dL/dout.

    With r = rsqrt(mean(x^2) + eps) recomputed from x:
    dx = r (g s) - x r^3 mean(g s x) and dscale = sum over rows of g x r.
    On CUDA (csrc/rmsnorm.cu), the route of :func:`rmsnorm_bwd_plan`:
    "rows" reads x and g once and writes dx in one pass that also sums
    each block's partial row of dscale; "scalar" takes a warp a row with
    element loads, then sums the partial rows from x and g again.  A
    second launch adds the partial rows in a fixed order (no atomics), so
    two runs agree bit for bit."""
    index = _lib.cuda_index(x, scale, g)
    if index is None:
        return rmsnorm_bwd_plain(x, scale, g, eps)
    kind = _lib.float_kind(x, "x")
    d = x.shape[-1]
    _lib.require(x, "x", x.dtype, x.shape)
    _lib.require(scale, "scale", x.dtype, (d,))
    _lib.require(g, "g", x.dtype, x.shape)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, dscale.zero_()
    ptrs = (x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr())
    route, lanes, vecs = rmsnorm_bwd_plan(
        x.dtype, d, (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % VEC_BYTES == 0)
    parts = rmsnorm_bwd_parts(route, lanes, rows)
    work = torch.empty((parts * d + (rows if route == "scalar" else 0),),
                       dtype=torch.float32, device=x.device)
    _lib.launch(f"rmsnorm_bwd_{kind}", index, *ptrs, dscale.data_ptr(),
                work.data_ptr(), rows, d, float(eps), BWD_ROUTES[route],
                lanes, vecs, parts)
    _lib.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale

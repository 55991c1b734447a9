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

Gradients: where autograd records the call (grad enabled and an input
requiring it), :func:`ssd_scan` goes through an ``autograd.Function``
whose backward is :func:`ssd_scan_bwd`, the hand-written kernels of
``csrc/ssd_scan_bwd.cu`` on CUDA tensors.  Otherwise it launches the
forward directly, as the serving path always does.  On CPU tensors the
plain version's autograd differentiates it.
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


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, index):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk, index)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, B, C, dy.contiguous(), ctx.chunk)
        return (*grads, None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """-> y [B, S, H, P] float32."""
    s = x.shape[1]
    if s % chunk:
        raise ValueError(f"ssd_scan needs S a multiple of the chunk, got "
                         f"S={s}, chunk={chunk}")
    index = _lib.cuda_index(x, dt, A, B, C)
    if index is None:
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        return _SSDScan.apply(x.contiguous(), dt.contiguous(), A.contiguous(),
                              B.contiguous(), C.contiguous(), chunk, index)
    return _forward(x, dt, A, B, C, chunk, index)


def _check_operands(x, dt, A, B, C) -> str:
    """The kernels' storage kind of x, B, C; raises on what they do not
    take."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    kind = _lib.float_kind(x, "x")
    if g < 1 or h % g:
        raise ValueError(f"ssd_scan needs H a multiple of G, got H={h}, G={g}")
    _lib.require(x, "x", x.dtype, (b, s, h, p))
    _lib.require(dt, "dt", torch.float32, (b, s, h))
    _lib.require(A, "A", torch.float32, (h,))
    _lib.require(B, "B", x.dtype, (b, s, g, n))
    _lib.require(C, "C", x.dtype, (b, s, g, n))
    return kind


def _forward(x, dt, A, B, C, chunk: int, index: int) -> torch.Tensor:
    """The forward kernel's launch (the serving path's direct call)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    kind = _check_operands(x, dt, A, B, C)
    ps = ssd_plan(kind, chunk, n, p)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    x, B, C = _lib.aligned(x), _lib.aligned(B), _lib.aligned(C)
    _lib.launch(f"ssd_scan_{kind}", index, x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), b, s,
                h, g, n, p, chunk, ps)
    _lib.LAUNCHES["ssd_scan"] += 1
    return y


# ------------------------------------------------------------- backward --
BWD_TILE = 16             # chunk positions a warp (or a SIMT block) owns
BWD_STATE_SLICE = 32      # head columns a block of the SIMT state pass
BWD_MMA_MAX_P = 128       # head columns the tensor-core local pass holds


def _bwd_smem_bytes(q: int, n: int, p: int, route: str) -> int:
    """A block's dynamic shared memory in the local pass of ``route``.

    "mma" (``local_mma_smem`` in csrc/ssd_scan_bwd.cu): the chunk's x, dy
    as bf16 hi and lo, and B and C in bf16 tiles (rows padded by 8; N
    rounded up to 16), the [N, P] state or state gradient in float32
    (padded), seg and dt, and 64 floats of block sums.  "simt"
    (``local_smem``): float32 tiles of the chunk's seg and dt, two [16, N]
    and two [16, P] tiles (rows padded by 4), the [N, P] state (padded),
    eight [16, 16] partial score tiles, three [16, 16] score tiles
    (padded), the [16, P] and [16, N] accumulators, a [16, N] buffer and a
    [16] sum."""
    if route == "mma":
        lp, np_ = p + 8, -(-n // 16) * 16
        return 2 * (3 * q * lp + 2 * q * (np_ + 8)) + 4 * (np_ * lp + 2 * q
                                                           + 64)
    t = BWD_TILE
    return 4 * (2 * q + 2 * t * (n + 4) + 2 * t * (p + 4) + n * (p + 4)
                + 8 * t * t + 3 * t * (t + 4) + t * p + 2 * t * n + t)


@functools.lru_cache(maxsize=64)      # called once a launch, on the host
def ssd_bwd_plan(kind: str, q: int, n: int, p: int) -> tuple[str, int]:
    """(route, shared bytes) of the backward's local pass for ``kind``
    ("f32" or "bf16") at chunk ``q``, state ``n`` and head width ``p``:
    "mma" (bf16 on the tensor cores, P up to 128 while the chunk's tiles
    fit a block) or "simt" (float32 FMAs: every float32 shape, and a bf16
    one past the tensor-core pass).  Raises ValueError for a shape the
    backward kernels do not take (the forward's shapes, while the SIMT
    pass's [N, P] state tile fits a block's shared memory: P up to 256 at
    N = 128)."""
    if not (16 <= q <= 128 and q % 16 == 0):
        raise ValueError(f"ssd_scan_bwd kernels need a chunk that is a "
                         f"multiple of 16 up to 128, got {q}")
    if not (8 <= n <= MAX_STATE and n % 8 == 0):
        raise ValueError(f"ssd_scan_bwd kernels need a state N that is a "
                         f"multiple of 8 up to {MAX_STATE}, got {n}")
    if p >= 32 and p % BWD_STATE_SLICE == 0:
        if kind == "bf16" and p <= BWD_MMA_MAX_P:
            smem = _bwd_smem_bytes(q, n, p, "mma")
            if smem <= SMEM_LIMIT:
                return "mma", smem
        smem = _bwd_smem_bytes(q, n, p, "simt")
        if smem <= SMEM_LIMIT:
            return "simt", smem
    raise ValueError(f"ssd_scan_bwd kernels need P a multiple of 32 whose "
                     f"tiles fit {SMEM_LIMIT} bytes of shared memory, got "
                     f"P={p} at chunk={q}, N={n}")


def _bwd_scratch_floats(b: int, s: int, h: int, n: int, p: int,
                        q: int) -> int:
    """Floats of the backward's one scratch buffer (``carve`` in
    csrc/ssd_scan_bwd.cu, each part rounded up to 4): the chunk-entry
    states and state gradients [2, B, H, nc, N, P], per-head dB and dC
    [2, B, S, H, N], seg's gradient parts [3, B, S, H], two floats a
    (batch, head, chunk), and (bf16 route) seg [B, H, S] and exp(seg_last)
    [B, H, nc]."""
    nc = s // q

    def up4(v):
        return -(-v // 4) * 4

    return (up4(2 * b * h * nc * n * p) + up4(2 * b * s * h * n)
            + up4(3 * b * s * h) + up4(2 * b * h * nc) + up4(b * h * s)
            + b * h * nc)


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk: int):
    """(dx, ddt, dA, dB, dC) of ``y = ssd_scan(x, dt, A, B, C, chunk)``
    given dy = dL/dy, in the inputs' dtypes: the kernels' passes step by
    step in float32.

    Per (batch, head), chunk positions i, j, seg_i = sum_{k<=i} a dt_k,
    L_ij = exp(seg_i - seg_j) for i >= j (else 0), D_ij = dy_i . x_j,
    e_j = exp(seg_last - seg_j) and G = dL/dS of the state leaving the
    chunk (S_c the state entering it):

    1. states forward: S_{c+1} = exp(seg_last) S_c + sum_j e_j dt_j B_j x_j^T;
    2. state gradients in reverse: G_{c-1} = exp(seg_last) G_c
       + sum_i exp(seg_i) C_i dy_i^T, G of the last chunk 0;
    3. chunk-local: dx_j = dt_j sum_{i>=j} (C_i . B_j) L_ij dy_i
       + dt_j e_j G^T B_j, dB_j = dt_j sum_{i>=j} L_ij D_ij C_i
       + dt_j e_j G x_j, dC_i = sum_{j<=i} L_ij dt_j D_ij B_j
       + exp(seg_i) S_c dy_i, and ddt_j = sum_{i>=j} (C_i . B_j) L_ij D_ij
       + e_j beta_j (beta_j = B_j^T G x_j) before the seg term; the
       gradient of seg as its per-position parts: rpart_i (the row sums
       of T_ij = (C_i . B_j) L_ij dt_j D_ij and exp(seg_i) (C_i S_c) .
       dy_i), cpart_j (minus the column sums of T and u_j = e_j dt_j
       beta_j) and the chunk's constant of the last position,
       sum_j u_j + exp(seg_last) <G, S_c>;
    4. ordered sums: R_j = sum_{k>=j} dseg_k (a reverse cumulative sum),
       ddt_j += a R_j, dA = sum over batches, chunks and positions of
       dt_j R_j, and dB, dC summed over each group's heads.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q, hg = chunk, h // g
    nc = s // q
    if s % q:
        raise ValueError(f"ssd_scan_bwd needs S a multiple of the chunk, "
                         f"got S={s}, chunk={chunk}")
    f32 = torch.float32
    xf = x.to(f32).reshape(b, nc, q, h, p)
    dyf = dy.to(f32).reshape(b, nc, q, h, p)
    dtf = dt.to(f32).reshape(b, nc, q, h)
    Bf = B.to(f32).repeat_interleave(hg, dim=2).reshape(b, nc, q, h, n)
    Cf = C.to(f32).repeat_interleave(hg, dim=2).reshape(b, nc, q, h, n)
    a = A.to(f32)
    seg = torch.cumsum(dtf * a, dim=2)                      # [b,nc,q,h]
    last = seg[:, :, -1]                                    # [b,nc,h]
    e = torch.exp(last[:, :, None] - seg)                   # e_j
    es = torch.exp(seg)
    decay = torch.exp(last)[..., None, None]                # [b,nc,h,1,1]

    # 1. the state entering each chunk
    contrib = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bf, e * dtf, xf)
    state = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    states = []
    for c in range(nc):
        states.append(state)
        state = decay[:, c] * state + contrib[:, c]
    Sc = torch.stack(states, dim=1)                         # [b,nc,h,n,p]
    # 2. the gradient of the state leaving each chunk
    back = torch.einsum("bcihn,bcih,bcihp->bchnp", Cf, es, dyf)
    grad = torch.zeros_like(state)
    grads = [grad] * nc
    for c in range(nc - 1, 0, -1):
        grad = decay[:, c] * grad + back[:, c]
        grads[c - 1] = grad
    Gs = torch.stack(grads, dim=1)                          # [b,nc,h,n,p]

    # 3. chunk-local gradients
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # [b,nc,i,j,h]
    L = torch.exp(torch.where(causal, rel, float("-inf")))
    M = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * L      # (C_i.B_j) L_ij
    D = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)         # dy_i . x_j
    LD, MD = L * D, M * D
    dtj = dtf[:, :, None]                                   # dt_j [.,1,j,h]
    dx = dtf[..., None] * (
        torch.einsum("bcijh,bcihp->bcjhp", M, dyf)
        + e[..., None] * torch.einsum("bcjhn,bchnp->bcjhp", Bf, Gs))
    gx = torch.einsum("bcjhp,bchnp->bcjhn", xf, Gs)         # G x_j
    dBh = dtf[..., None] * (torch.einsum("bcijh,bcihn->bcjhn", LD, Cf)
                            + e[..., None] * gx)
    sdy = torch.einsum("bchnp,bcihp->bcihn", Sc, dyf)       # S_c dy_i
    dCh = (torch.einsum("bcijh,bcjhn->bcihn", LD * dtj, Bf)
           + es[..., None] * sdy)
    beta = (Bf * gx).sum(-1)                                # [b,nc,q,h]
    T = MD * dtj
    ddt = MD.sum(2) + e * beta
    u = e * dtf * beta
    rpart = T.sum(3) + es * (Cf * sdy).sum(-1)
    cpart = -T.sum(2) - u
    const = u.sum(2) + torch.exp(last) * (Gs * Sc).sum((-1, -2))

    # 4. ordered sums
    dseg = rpart + cpart
    R = torch.flip(torch.cumsum(torch.flip(dseg, [2]), 2), [2]) \
        + const[:, :, None]
    ddt = ddt + a * R
    dA = (dtf * R).sum((0, 1, 2))
    dB = dBh.reshape(b, s, g, hg, n).sum(3)
    dC = dCh.reshape(b, s, g, hg, n).sum(3)
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h).to(
        dt.dtype), dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype))


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                 chunk: int):
    """The gradients (dx, ddt, dA, dB, dC) of ``y = ssd_scan(x, dt, A, B,
    C, chunk)`` given dy = dL/dy [B, S, H, P] float32, in the inputs'
    dtypes.

    On CUDA the kernels of csrc/ssd_scan_bwd.cu run in order, each a pass
    of :func:`ssd_scan_bwd_plain`: the chunk-entry states forward and the
    state gradients in reverse (bf16: each chunk's terms on the tensor
    cores, then one scan along the chunks; float32: a block per (batch,
    head, 32 head columns, direction) walking the chunks); the
    chunk-local gradients (bf16: a block per (batch, head, chunk) on the
    tensor cores; float32, or a bf16 head wider than the tensor-core pass
    holds: SIMT blocks of 16 rows or 16 columns of a chunk) into float32
    per-head dB and dC and per-position parts of seg's gradient; then the
    ordered sums (dB and dC over each group's heads, the reverse cumulative
    sum into ddt and a dA part a chunk), and dA over batches and chunks.
    No atomics: two runs agree bit for bit."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_scan_bwd needs S a multiple of the chunk, "
                         f"got S={s}, chunk={chunk}")
    index = _lib.cuda_index(x, dt, A, B, C, dy)
    if index is None:
        return ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk)
    kind = _check_operands(x, dt, A, B, C)
    _lib.require(dy, "dy", torch.float32, (b, s, h, p))
    route, smem = ssd_bwd_plan(kind, chunk, n, p)
    dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    if dx.numel() == 0 or dB.numel() == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_()
    scratch = torch.empty(_bwd_scratch_floats(b, s, h, n, p, chunk),
                          dtype=torch.float32, device=x.device)
    x, B, C, dy = (_lib.aligned(t) for t in (x, B, C, dy))
    _lib.launch(f"ssd_scan_bwd_{kind}", index, x.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), scratch.data_ptr(), b, s, h, g, n, p, chunk,
                int(route == "mma"), smem)
    _lib.LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC

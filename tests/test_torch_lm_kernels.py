"""The port's LM kernels (7 flash_attention, 8 rmsnorm, 9 ssd_scan) against
the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version; here that plain version is
held against the Pallas kernel in interpret mode (as tests/test_kernels.py
runs it) and against ``repro.kernels.ref``, at that file's shapes and
tolerances: float32 rmsnorm 1e-6, flash 2e-5, ssd 2e-4; bfloat16 2e-2,
2e-2, 5e-2.  Inputs are numpy draws from a seed, cast to bfloat16 the same
way (round to nearest even) on both sides.  The CUDA kernels themselves
run only on the card (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import rmsnorm as krn  # noqa: E402
from repro_torch.kernels import ssd_scan as kss  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"rmsnorm": {"float32": 1e-6, "bfloat16": 2e-2},
       "flash": {"float32": 2e-5, "bfloat16": 2e-2},
       "ssd": {"float32": 2e-4, "bfloat16": 5e-2}}


def _both(a: np.ndarray, dtype: str):
    """The same array as a JAX and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.tensor(a).to(td)


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, dtype=np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------------ rmsnorm --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 256), (1000, 512),
                                   (2, 16, 2048)])
def test_rmsnorm_matches_pallas_and_oracle(shape, dtype):
    rs = np.random.default_rng(sum(shape))
    xj, xt = _both(rs.normal(size=shape).astype(np.float32), dtype)
    sj, st = _both((1.0 + 0.1 * rs.normal(size=shape[-1:])).astype(
        np.float32), dtype)
    before = dict(_lib.LAUNCHES)
    got = krn.rmsnorm(xt, st)
    assert _lib.LAUNCHES == before              # CPU tensors: plain version
    assert got.dtype == DTYPES[dtype][1] and got.shape == xt.shape
    tol = TOL["rmsnorm"][dtype]
    _close(got, j_rmsnorm(xj, sj, interpret=True), tol)
    _close(got, ref.rmsnorm(xj, sj), tol)


# The CUDA kernel's path for rows of d entries: (path, lanes per row,
# vectors per lane); "aligned": x and scale start on a 16-byte boundary.
@pytest.mark.parametrize("dtype,d,aligned,want", [
    ("float32", 2048, True, ("rows", 32, 16)),
    ("bfloat16", 2048, True, ("rows", 32, 8)),
    ("bfloat16", 4096, True, ("rows", 32, 16)),
    ("float32", 4096, True, ("wide", 0, 0)),
    ("bfloat16", 8192, True, ("wide", 0, 0)),
    ("bfloat16", 128, True, ("rows", 16, 1)),
    ("float32", 128, True, ("rows", 32, 1)),
    ("bfloat16", 64, True, ("rows", 8, 1)),
    ("float32", 64, True, ("rows", 16, 1)),
    ("bfloat16", 200, True, ("rows", 32, 1)),
    ("float32", 200, True, ("rows", 32, 2)),
    ("float32", 4, True, ("rows", 1, 1)),
    ("bfloat16", 2048, False, ("scalar", 32, 1)),
    ("float32", 2048, False, ("scalar", 32, 1)),
    ("bfloat16", 100, True, ("scalar", 32, 1)),
    ("float32", 6, True, ("scalar", 32, 1)),
])
def test_rmsnorm_plan(dtype, d, aligned, want):
    td = DTYPES[dtype][1]
    plan = krn.rmsnorm_plan(td, d, aligned)
    assert plan == want
    path, lanes, vecs = plan
    if path == "rows":
        per_vec = krn.VEC_BYTES // td.itemsize
        assert lanes * vecs * per_vec >= d                 # the row fits
        assert lanes * vecs * per_vec < 2 * d or lanes == 1 or vecs == 1
        assert vecs <= krn.MAX_VECS_PER_LANE


def _rows_path(x: torch.Tensor, scale: torch.Tensor, lanes: int, vecs: int,
               eps: float = 1e-6) -> torch.Tensor:
    """csrc/rmsnorm.cu's "rows" path on the CPU: lane j of a row's group sums
    the squares of its 16-byte vectors j, j + lanes, ... (each vector by
    fused multiply-adds: float64, rounded to float32 each step), the group
    totals by xor shuffles, and (x * r) * scale rounds once to x's dtype."""
    rows, d = x.shape
    per_vec = krn.VEC_BYTES // x.element_size()
    nvec = d // per_vec
    xf = x.float().reshape(rows, nvec, per_vec)
    lane_ss = torch.zeros((rows, lanes), dtype=torch.float32)
    for k in range(vecs):
        for j in range(min(lanes, nvec - k * lanes)):
            vs = torch.zeros(rows, dtype=torch.float64)
            for e in range(per_vec):
                f = xf[:, j + k * lanes, e].double()
                vs = (f * f + vs).float().double()
            lane_ss[:, j] += vs.float()
    o = lanes // 2
    while o:
        lane_ss = lane_ss + lane_ss[:, torch.arange(lanes) ^ o]
        o //= 2
    assert torch.equal(lane_ss, lane_ss[:, :1].expand(rows, lanes))
    r = torch.rsqrt(lane_ss[:, :1] / d + eps)
    return ((xf.reshape(rows, d) * r) * scale.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 200, 2048])
def test_rmsnorm_rows_path_order_within_gate(d, dtype):
    """The kernel's summation order and rounding meet the Pallas kernel's
    gate: the "rows" path emulated against Pallas (interpret) and the jnp
    oracle."""
    rs = np.random.default_rng(d)
    xj, xt = _both(rs.normal(size=(13, d)).astype(np.float32), dtype)
    sj, st = _both((1.0 + 0.1 * rs.normal(size=(d,))).astype(np.float32),
                   dtype)
    path, lanes, vecs = krn.rmsnorm_plan(xt.dtype, d, True)
    assert path == "rows"
    got = _rows_path(xt, st, lanes, vecs)
    tol = TOL["rmsnorm"][dtype]
    _close(got, j_rmsnorm(xj, sj, interpret=True), tol)
    _close(got, ref.rmsnorm(xj, sj), tol)


# ---------------------------------------------------------- flash attention --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 256, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 512, 4, 1, 128),    # MQA, d=128
    (1, 128, 2, 2, 128),    # single kv block
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_oracle(b, s, h, kv, d, dtype,
                                                   causal):
    rs = np.random.default_rng(b * s + h * kv + d)
    qj, qt = _both(rs.normal(size=(b, s, h, d)).astype(np.float32), dtype)
    kj, kt = _both(rs.normal(size=(b, s, kv, d)).astype(np.float32), dtype)
    vj, vt = _both(rs.normal(size=(b, s, kv, d)).astype(np.float32), dtype)
    got = kfa.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == DTYPES[dtype][1]
    tol = TOL["flash"][dtype]
    _close(got, j_flash(qj, kj, vj, causal=causal, q_block=128, kv_block=128,
                        interpret=True), tol)
    _close(got, ref.flash_attention(qj, kj, vj, causal=causal), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_matches_oracle(causal):
    """S = T = 200: no multiple of the Pallas blocks, which assert on it;
    the oracle only."""
    rs = np.random.default_rng(200)
    q, k, v = (rs.normal(size=(2, 200, 4, 64)).astype(np.float32)
               for _ in range(3))
    got = kfa.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal)
    _close(got, ref.flash_attention(q, k, v, causal=causal),
           TOL["flash"]["float32"])


def _flash_bf16_kernel_arithmetic(q, k, v, causal, tile=64):
    """What csrc/flash_attention.cu's bfloat16 (wgmma) kernel computes, in
    plain torch: float32 scores of the bf16 q and k, the scale applied to
    the scores (exp2 form, log2(e) folded in), an online softmax over
    64-key tiles, P rounded to bf16 before P V with float32 accumulation,
    the row sum of the unrounded P, and acc / max(ell, 1e-30) in bf16."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    sl2 = torch.tensor((1.0 / d ** 0.5) * 1.4426950408889634,
                       dtype=torch.float32)
    qf = q.float().reshape(b, s, kv, h // kv, d)
    m = torch.full((b, kv, h // kv, s, 1), -torch.inf)
    ell = torch.zeros_like(m)
    acc = torch.zeros((b, kv, h // kv, s, d))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, t, tile):
        kt, vt = k[:, k0:k0 + tile].float(), v[:, k0:k0 + tile].float()
        sc = torch.einsum("bskgd,btkd->bkgst", qf, kt)
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
            sc = torch.where(keys <= rows, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * sl2)
        p = torch.exp2(sc * sl2 - m_new * sl2)
        ell = alpha * ell + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bkgst,btkd->bkgsd",
                                         p.bfloat16().float(), vt)
        m = m_new
    out = (acc / torch.clamp(ell, min=1e-30)).bfloat16()
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_kernel_rounding_within_gate(d, causal):
    """The bf16 kernel's extra rounding (P to bf16 before P V, tile by
    tile) stays inside the bf16 gate of 2e-2 against the jnp oracle and
    the Pallas kernel in interpret mode."""
    rs = np.random.default_rng(1000 + d + causal)
    qj, qt = _both(rs.normal(size=(2, 256, 4, d)).astype(np.float32),
                   "bfloat16")
    kj, kt = _both(rs.normal(size=(2, 256, 4, d)).astype(np.float32),
                   "bfloat16")
    vj, vt = _both(rs.normal(size=(2, 256, 4, d)).astype(np.float32),
                   "bfloat16")
    got = _flash_bf16_kernel_arithmetic(qt, kt, vt, causal)
    tol = TOL["flash"]["bfloat16"]
    _close(got, ref.flash_attention(qj, kj, vj, causal=causal), tol)
    _close(got, j_flash(qj, kj, vj, causal=causal, q_block=128, kv_block=128,
                        interpret=True), tol)


def test_flash_attention_refuses_causal_with_s_not_t():
    """The kernel's causal mask is start-aligned, the oracle's end-aligned:
    they agree only when S == T, so the wrapper refuses the rest on any
    device."""
    q = torch.zeros((1, 4, 2, 64))
    k = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="S == T"):
        kfa.flash_attention(q, k, k, causal=True)
    assert kfa.flash_attention(q, k, k, causal=False).shape == q.shape


# ----------------------------------------------------------------- ssd scan --
def _ssd_case(seed, b, s, h, p, n, dtype):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rs.normal(size=(b, s, h)))).astype(np.float32)
    A = (-np.exp(rs.normal(size=(h,)) * 0.5)).astype(np.float32)
    B = rs.normal(size=(b, s, 1, n)).astype(np.float32)
    C = rs.normal(size=(b, s, 1, n)).astype(np.float32)
    xj, xt = _both(x, dtype)
    Bj, Bt = _both(B, dtype)
    Cj, Ct = _both(C, dtype)
    return ((xj, jnp.asarray(dt), jnp.asarray(A), Bj, Cj),
            (xt, torch.tensor(dt), torch.tensor(A), Bt, Ct))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 4, 64, 16, 64),
    (1, 128, 2, 32, 8, 32),
    (1, 512, 3, 64, 64, 128),
    (1, 128, 1, 128, 128, 128),   # mamba2-2.7b head shape
    (1, 192, 2, 64, 16, 48),      # a chunk that is not a multiple of 32
])
def test_ssd_scan_matches_pallas_and_oracle(b, s, h, p, n, chunk, dtype):
    jin, tin = _ssd_case(b * s + h + n, b, s, h, p, n, dtype)
    got = kss.ssd_scan(*tin, chunk)
    assert got.dtype == torch.float32          # the model's path is f32
    tol = TOL["ssd"][dtype]
    _close(got, j_ssd(*jin, chunk=chunk, interpret=True), tol)
    _close(got, ref.ssd_scan(*jin, chunk=chunk), tol)


def test_ssd_scan_chunk_boundaries_are_invisible():
    _, tin = _ssd_case(5, 1, 256, 2, 32, 16, "float32")
    np.testing.assert_allclose(kss.ssd_scan(*tin, 32).numpy(),
                               kss.ssd_scan(*tin, 128).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_ssd_scan_refuses_a_ragged_sequence():
    _, tin = _ssd_case(6, 1, 96, 2, 32, 16, "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        kss.ssd_scan(*tin, 64)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("q,n,p,want", [
    (128, 64, 64, 64),      # Zamba2-1.2B
    (128, 128, 64, 64),     # mamba2-2.7b: state 128 at chunk 128
    (128, 128, 128, 64),    # P = 128 in two slices
    (32, 16, 32, 32),       # the reduced configs
    (32, 8, 32, 32),
    (64, 16, 64, 64),
    (48, 64, 64, 64),       # not a multiple of 32: a 16-wide last block
])
def test_ssd_plan(kind, q, n, p, want):
    ps = kss.ssd_plan(kind, q, n, p)
    assert ps == want
    assert kss._smem_bytes(kind, q, n, ps) <= kss.SMEM_LIMIT


def test_ssd_smem_bytes_follow_the_tiles():
    """The sizes the kernels' sources compute (smem_bytes_mma / _simt),
    at Zamba2's and mamba2-2.7b's shapes: state 128 fits a block's 232,448
    bytes at chunk 128 in both."""
    assert kss._smem_bytes("bf16", 128, 64, 64) == 75_776
    assert kss._smem_bytes("bf16", 128, 128, 64) == 126_976
    assert kss._smem_bytes("f32", 128, 64, 64) == 141_312
    assert kss._smem_bytes("f32", 128, 128, 64) == 223_232


@pytest.mark.parametrize("q,n,p,match", [
    (128, 256, 64, "state N"), (128, 12, 64, "state N"),
    (40, 64, 64, "chunk"), (256, 64, 64, "chunk"), (128, 64, 40, "P a multiple")])
def test_ssd_plan_refuses_what_the_kernels_lack(q, n, p, match):
    for kind in ("f32", "bf16"):
        with pytest.raises(ValueError, match=match):
            kss.ssd_plan(kind, q, n, p)


def _hi_lo(t):
    """What the bf16 kernel feeds the tensor cores for a float32 operand:
    bf16(t) + bf16(t - bf16(t))."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def _bf16_once(t):
    return t.to(torch.bfloat16).float()


def _exact(t):
    return t


def _ssd_kernel_model(x, dt, A, B, C, q, rnd):
    """The CUDA kernels' arithmetic, chunk by chunk for each (batch, head):
    seg summed in position order with dt*A rounded first; the scores
    (C_i . B_j) exp(seg_i - seg_j) dt_j; the carried-in term exp(seg_i) *
    (C_i . state); the state pass decay * state + (B w)^T x, w_j =
    exp(seg_Q - seg_j) dt_j.  ``rnd`` is what a float32 operand of a
    product (scores, B w, state) becomes: itself in the float32 kernel, its
    hi + lo bf16 pair in the bf16 one."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    x, B, C = x.float(), B.float(), C.float()
    y = torch.zeros((b, s, h, p))
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool))
    for bi in range(b):
        for hi in range(h):
            st = torch.zeros((n, p))
            for c0 in range(0, s, q):
                xs, d = x[bi, c0:c0 + q, hi], dt[bi, c0:c0 + q, hi]
                bs, cs = B[bi, c0:c0 + q, 0], C[bi, c0:c0 + q, 0]
                seg = torch.zeros(q)
                run = torch.zeros((), dtype=torch.float32)
                for i in range(q):
                    run = run + d[i] * A[hi]
                    seg[i] = run
                sc = torch.where(tril, (cs @ bs.T) * torch.exp(
                    seg[:, None] - seg[None, :]) * d[None, :], 0.0)
                y[bi, c0:c0 + q, hi] = (torch.exp(seg)[:, None]
                                        * (cs @ rnd(st)) + rnd(sc) @ xs)
                w = torch.exp(seg[-1] - seg) * d
                st = torch.exp(seg[-1]) * st + rnd(bs * w[:, None]).T @ xs
    return y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 4, 64, 16, 64),
    (1, 128, 2, 32, 8, 32),
    (1, 512, 3, 64, 64, 128),
    (1, 128, 1, 128, 128, 128),   # mamba2-2.7b head shape
])
def test_ssd_kernel_order_and_rounding_within_gate(b, s, h, p, n, chunk,
                                                   dtype):
    """The kernels' order, chunk states and state pass (and, in bf16, the
    hi + lo operands of the tensor-core products) meet the Pallas kernel's
    gate against Pallas (interpret) and the jnp oracle."""
    jin, tin = _ssd_case(b * s + h + n, b, s, h, p, n, dtype)
    got = _ssd_kernel_model(*tin, chunk,
                            _hi_lo if dtype == "bfloat16" else _exact)
    tol = TOL["ssd"][dtype]
    _close(got, j_ssd(*jin, chunk=chunk, interpret=True), tol)
    _close(got, ref.ssd_scan(*jin, chunk=chunk), tol)


def test_ssd_one_bf16_rounding_of_the_scores_eats_the_gate():
    """Why the bf16 kernel splits its float32 operands: with one bf16
    rounding of each, the error reaches more than a third of the 5e-2 gate
    already at one head of Zamba2's width, where hi + lo stays below 1%."""
    _, tin = _ssd_case(3, 1, 512, 2, 64, 64, "bfloat16")
    want = kss.ssd_scan_plain(*tin, 128)
    lim = 5e-2 + 5e-2 * want.abs()
    split = _ssd_kernel_model(*tin, 128, _hi_lo)
    assert float(((split - want).abs() / lim).max()) < 0.01
    single = _ssd_kernel_model(*tin, 128, _bf16_once)
    assert float(((single - want).abs() / lim).max()) > 0.33


def test_wrappers_refuse_mixed_devices():
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError):
        krn.rmsnorm(x, torch.ones(64, device="meta"))

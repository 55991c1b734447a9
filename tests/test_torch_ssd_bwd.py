"""Kernel 9's backward (``ssd_scan_bwd``) on the CPU: its plain version,
the kernels' passes in PyTorch, against the JAX package's gradient.

The JAX package has no backward for its Pallas ``ssd_scan``: JAX trains by
differentiating the jnp ``ssd_chunked``, which ``repro.kernels.ref.ssd_scan``
delegates to, so the oracle is ``jax.vjp`` of that reference (jitted).  All
five gradients (dx, ddt, dA, dB, dC) are held within 1e-4 (float32) or
5e-2 (bfloat16, bfloat16 gradients on both sides) of each gradient's
largest magnitude, at the shapes of tests/test_torch_lm_kernels.py.

dt there is drawn at the model's scale (``ssm_init`` puts softplus(dt_bias)
in [0.001, 0.1]).  At that file's larger dt (softplus of a standard normal)
a chunk's log-decay spans past float32's exp range, and the oracle's
gradient of dt and A is NaN: jnp's ``where(causal, exp(rel), 0)`` passes
0 * inf back from the masked triangle.  There the plain backward is held to
torch's autograd of the port's ``ssd_scan_plain``, whose masked triangle is
exp(-inf) = 0, within 1e-5 of the largest of the five gradients.  The CUDA kernels run only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``); the last tests check
that the card's data (``chip_smoke.ssd_bwd_inputs``) let a fault in the
carry between chunks show.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ssd_scan as kss  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (b, s, h, p, n, chunk): tests/test_torch_lm_kernels.py's ssd shapes
SHAPES = [
    (2, 256, 4, 64, 16, 64),
    (1, 128, 2, 32, 8, 32),
    (1, 512, 3, 64, 64, 128),
    (1, 128, 1, 128, 128, 128),   # mamba2-2.7b head shape
    (1, 192, 2, 64, 16, 48),      # a chunk that is not a multiple of 32
]


def _draws(seed, b, s, h, p, n, g=1, dt_scale=0.1):
    """x, dt, A, B, C, dy as float32 numpy arrays (dt_scale 1: the forward
    tests' dt)."""
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rs.normal(size=(b, s, h))))).astype(
        np.float32)
    A = (-np.exp(rs.normal(size=(h,)) * 0.5)).astype(np.float32)
    B = rs.normal(size=(b, s, g, n)).astype(np.float32)
    C = rs.normal(size=(b, s, g, n)).astype(np.float32)
    dy = rs.normal(size=(b, s, h, p)).astype(np.float32)
    return x, dt, A, B, C, dy


def _torch_inputs(arrays, dtype="float32"):
    """x, B and C in ``dtype`` (rounded to nearest even), the rest
    float32."""
    td = DTYPES[dtype][1]
    x, dt, A, B, C, dy = (torch.tensor(a) for a in arrays)
    return x.to(td), dt, A, B.to(td), C.to(td), dy


def _assert_grads(got, want, tol):
    """Each gradient finite and within ``tol`` of its largest magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g, dtype=np.float32)
        w = np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape, i
        assert np.isfinite(g).all() and np.isfinite(w).all(), i
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (i, err)


def _assert_grads_shared(got, want, tol):
    """Every gradient finite and within ``tol`` of the largest magnitude
    among them (``chip_smoke._grads_err``'s scale): dA is a sum over every
    position whose terms cancel, so two float32 evaluations of it differ
    by ~2e-5 of its own largest entry (both, against float64)."""
    got = [np.asarray(g, dtype=np.float32) for g in got]
    want = [np.asarray(w, dtype=np.float32) for w in want]
    scale = max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert np.isfinite(g).all() and np.isfinite(w).all(), i
        err = np.abs(g - w).max() / scale
        assert err <= tol, (i, err)


def _jax_grads(arrays, dtype, chunk):
    """jax.vjp of the reference scan, jitted: (dx, ddt, dA, dB, dC)."""
    jd = DTYPES[dtype][0]
    x, dt, A, B, C, dy = arrays

    @jax.jit
    def grads(x, dt, A, B, C, dy):
        _, vjp = jax.vjp(lambda *a: ref.ssd_scan(*a, chunk=chunk),
                         x, dt, A, B, C)
        return vjp(dy)

    return grads(jnp.asarray(x).astype(jd), jnp.asarray(dt),
                 jnp.asarray(A), jnp.asarray(B).astype(jd),
                 jnp.asarray(C).astype(jd), jnp.asarray(dy))


def _torch_autograd(x, dt, A, B, C, dy, chunk):
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
    y = kss.ssd_scan_plain(*leaves, chunk)
    return torch.autograd.grad(y, leaves, dy)


def _np(grads):
    return [t.float().numpy() for t in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_scan_bwd_matches_jax_vjp(b, s, h, p, n, chunk, dtype):
    arrays = _draws(b * s + h + n, b, s, h, p, n)
    tin = _torch_inputs(arrays, dtype)
    before = dict(_lib.LAUNCHES)
    got = kss.ssd_scan_bwd(*tin, chunk)
    assert _lib.LAUNCHES == before              # CPU tensors: plain version
    td = DTYPES[dtype][1]
    assert [t.dtype for t in got] == [td, torch.float32, torch.float32, td,
                                      td]
    want = _jax_grads(arrays, dtype, chunk)
    assert [str(w.dtype) for w in want] == [dtype, "float32", "float32",
                                            dtype, dtype]
    _assert_grads(_np(got), want, TOL[dtype])


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_scan_bwd_matches_autograd_past_exp_range(b, s, h, p, n, chunk):
    """At the forward tests' dt the plain backward stays finite and equals
    autograd of the plain forward within 1e-5 of the largest gradient."""
    tin = _torch_inputs(_draws(b * s + h + n, b, s, h, p, n, dt_scale=1.0))
    _assert_grads_shared(_np(kss.ssd_scan_bwd(*tin, chunk)),
                         _np(_torch_autograd(*tin, chunk)), 1e-5)


def test_ssd_scan_bwd_groups_sum_their_heads():
    """G = 2: the gradients of B and C are the per-head gradients of the
    scan on B and C repeated to the heads, summed over each group."""
    b, s, h, p, n, g, chunk = 2, 128, 4, 32, 16, 2, 32
    x, dt, A, B, C, dy = _torch_inputs(_draws(3, b, s, h, p, n, g=g))
    got = kss.ssd_scan_bwd(x, dt, A, B, C, dy, chunk)
    rep = kss.ssd_scan_bwd(x, dt, A, B.repeat_interleave(h // g, dim=2),
                           C.repeat_interleave(h // g, dim=2), dy, chunk)
    summed = [t.reshape(b, s, g, h // g, n).sum(3) for t in rep[3:]]
    _assert_grads(_np(got), _np(rep[:3]) + _np(summed), 1e-6)
    _assert_grads_shared(_np(got)[:3], _np(_torch_autograd(
        x, dt, A, B.repeat_interleave(h // g, dim=2),
        C.repeat_interleave(h // g, dim=2), dy, chunk))[:3], 1e-5)


def test_ssd_scan_bwd_chunk_boundaries_are_invisible():
    """Chunk 32 and chunk 128 give the same gradients on the same inputs."""
    tin = _torch_inputs(_draws(5, 1, 256, 2, 32, 16))
    _assert_grads(_np(kss.ssd_scan_bwd(*tin, 32)),
                  _np(kss.ssd_scan_bwd(*tin, 128)), 1e-4)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("q,n,p,bf16_route", [
    (128, 64, 64, "mma"),       # Zamba2-1.2B
    (128, 128, 64, "mma"),      # mamba2-2.7b
    (128, 128, 256, "simt"),    # the widest head at state 128
    (32, 16, 32, "mma"),        # the reduced configs
    (48, 64, 64, "mma"),
    (16, 8, 32, "mma"),
    (128, 64, 128, "mma"),      # the tensor-core pass's widest head
    (128, 120, 96, "mma"),      # N off 16, its tiles near the limit
    (128, 128, 128, "simt"),    # past its shared memory
])
def test_ssd_bwd_plan_takes_the_forward_shapes(kind, q, n, p, bf16_route):
    """Float32 runs the SIMT local pass; bfloat16 the tensor-core pass
    where its tiles fit (P up to 128), else the SIMT one."""
    route, smem = kss.ssd_bwd_plan(kind, q, n, p)
    assert route == (bf16_route if kind == "bf16" else "simt")
    assert smem == kss._bwd_smem_bytes(q, n, p, route) <= kss.SMEM_LIMIT


def test_ssd_bwd_scratch_holds_every_part():
    """The one scratch buffer: each part rounded up to 4 floats."""
    b, s, h, n, p, q = 2, 384, 3, 24, 32, 128
    parts = [2 * b * h * 3 * n * p, 2 * b * s * h * n, 3 * b * s * h,
             2 * b * h * 3, b * h * s]
    assert kss._bwd_scratch_floats(b, s, h, n, p, q) == sum(
        -(-v // 4) * 4 for v in parts) + b * h * 3


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("q,n,p,match", [
    (144, 64, 64, "chunk"), (40, 64, 64, "chunk"),
    (128, 256, 64, "state N"), (128, 12, 64, "state N"),
    (128, 64, 48, "P a multiple of 32"), (128, 128, 512, "fit"),
])
def test_ssd_bwd_plan_refuses(kind, q, n, p, match):
    with pytest.raises(ValueError, match=match):
        kss.ssd_bwd_plan(kind, q, n, p)


@pytest.mark.parametrize("chunks", [1, 2])
def test_one_chunk_memory_is_the_scan_up_to_two_chunks(chunks):
    """chip_smoke's scan with the state carried one chunk only equals the
    scan while the sequence holds at most two chunks."""
    x, dt, A, B, C, _ = _torch_inputs(_draws(7, 2, 32 * chunks, 4, 32, 16))
    torch.testing.assert_close(
        chip_smoke._ssd_one_chunk_memory(x, dt, A, B, C, 32),
        kss.ssd_scan_plain(x, dt, A, B, C, 32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("large_dt", [False, True])
def test_card_draw_shows_the_carry_between_chunks(large_dt):
    """The card's kernel 9 backward rows draw at the model's scale
    (chip_smoke.ssd_bwd_inputs): there the gradients move by far more than
    the bfloat16 tolerance when the state carries one chunk only.  At the
    forward tests' large dt a 128-chunk's decay underflows and they move
    by less than the float32 tolerance."""
    gen = torch.Generator().manual_seed(0)
    draw = chip_smoke.ssd_bwd_inputs(gen, "cpu", 1, 512, 8, 32, 16,
                                     torch.float32, large_dt=large_dt)
    share = chip_smoke.ssd_carry_share(*draw, 128)
    if large_dt:
        assert share < 1e-4
    else:
        assert share >= chip_smoke.SSD_CARRY_MARGIN * 2e-2

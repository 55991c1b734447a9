"""Kernel 8's backward (``rmsnorm_bwd``) on the CPU: its plain version
against the JAX package's gradient, and the CUDA kernel's routes.

The JAX package has no backward for its Pallas ``rmsnorm``: JAX trains by
differentiating the jnp norm, so the oracle is jitted ``jax.vjp`` of
``repro.kernels.ref.rmsnorm``.  ``rmsnorm_bwd_plain``, which the card
holds the kernel to (tests/test_torch_cuda.py, ``chip_smoke.py``), is held
to it here within 1e-5 (float32) or 2e-2 (bfloat16: both sides round
once from float32) of each gradient's largest magnitude, on inputs drawn
with numpy from a seed.  The plan tests fix which route the kernel takes
at the forward's widths and the training paths' widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import rmsnorm as krn  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


SHAPES = [(3, 40, 128), (17, 202), (24, 1024)]


def _draws(shape):
    """x, scale, g as float32 numpy arrays, from a seed per shape."""
    rs = np.random.default_rng(sum(shape))
    return (rs.normal(size=shape).astype(np.float32),
            (1.0 + 0.1 * rs.normal(size=shape[-1:])).astype(np.float32),
            rs.normal(size=shape).astype(np.float32))


@jax.jit
def _jax_grads(cases):
    """jax.vjp of the reference norm for every case in one compile."""
    return [jax.vjp(ref.rmsnorm, x, scale)[1](g) for x, scale, g in cases]


@pytest.fixture(scope="module")
def jax_want():
    """dtype -> the oracle's (dx, dscale) for each of SHAPES."""
    return {dtype: _jax_grads([tuple(jnp.asarray(a).astype(jd)
                                     for a in _draws(shape))
                               for shape in SHAPES])
            for dtype, (jd, _) in DTYPES.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_rmsnorm_bwd_plain_matches_jax_vjp(case, dtype, jax_want):
    td = DTYPES[dtype][1]
    before = dict(_lib.LAUNCHES)
    got = krn.rmsnorm_bwd(*(torch.tensor(a).to(td)
                            for a in _draws(SHAPES[case])))
    assert _lib.LAUNCHES == before              # CPU tensors: plain version
    for name, a, b in zip(("dx", "dscale"), got, jax_want[dtype][case]):
        assert a.dtype == td and a.shape == b.shape, name
        b = np.asarray(b, dtype=np.float32)
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err <= TOL[dtype], (name, err)


# (route, threads a row, vectors a lane) for rows of d entries; "aligned":
# x, scale, g and dx start on a 16-byte boundary.
@pytest.mark.parametrize("dtype,d,aligned,want", [
    ("bfloat16", 128, True, ("rows", 4, 4)),       # qk_norm: 8 rows a warp
    ("float32", 128, True, ("rows", 8, 4)),
    ("bfloat16", 64, True, ("rows", 2, 4)),
    ("bfloat16", 200, True, ("rows", 8, 4)),
    ("float32", 200, True, ("rows", 16, 4)),
    ("bfloat16", 384, True, ("rows", 16, 3)),      # whisper-tiny
    ("float32", 4, True, ("rows", 1, 1)),
    ("bfloat16", 1024, True, ("rows", 32, 4)),     # qwen3-0.6b
    ("float32", 1024, True, ("rows", 64, 4)),      # two warps a row
    ("bfloat16", 2048, True, ("rows", 64, 4)),     # zamba2-1.2b
    ("bfloat16", 2560, True, ("rows", 128, 3)),    # mamba2-2.7b
    ("float32", 2560, True, ("rows", 256, 3)),
    ("bfloat16", 8192, True, ("rows", 256, 4)),
    ("float32", 8192, True, ("rows", 512, 4)),
    ("bfloat16", 16384, True, ("rows", 512, 4)),
    ("float32", 16384, True, ("scalar", 32, 1)),   # past the register route
    ("bfloat16", 1024, False, ("scalar", 32, 1)),
    ("float32", 128, False, ("scalar", 32, 1)),
    ("bfloat16", 100, True, ("scalar", 32, 1)),
    ("float32", 6, True, ("scalar", 32, 1)),
])
def test_rmsnorm_bwd_plan(dtype, d, aligned, want):
    td = DTYPES[dtype][1]
    plan = krn.rmsnorm_bwd_plan(td, d, aligned)
    assert plan == want
    route, lanes, vecs = plan
    if route == "rows":
        per_vec = krn.VEC_BYTES // td.itemsize
        assert lanes * vecs * per_vec >= d > lanes * (vecs - 1) * per_vec
        assert vecs <= krn.BWD_MAX_VECS_PER_LANE
        assert lanes <= krn.BWD_MAX_LANES and lanes & (lanes - 1) == 0
        groups = max(lanes, krn.BWD_BLOCK) // lanes   # rows a block at once
        # the block's partial rows in shared memory, under the 48 KB a
        # launch takes without an attribute
        assert groups == 1 or groups * d * 4 <= 48 * 1024


@pytest.mark.parametrize("route,lanes,rows", [
    ("rows", 4, 65536), ("rows", 4, 32771), ("rows", 32, 4096),
    ("rows", 64, 4096), ("rows", 128, 4096), ("rows", 512, 9),
    ("rows", 4, 37), ("scalar", 32, 20000), ("scalar", 32, 5),
    ("scalar", 32, 10 ** 8),
])
def test_rmsnorm_bwd_parts(route, lanes, rows):
    """Every block of the "rows" route has rows to walk, at least
    BWD_BLOCK_ROWS and its groups' worth where the rows allow, and there
    are at most BWD_MAX_BLOCKS; the "scalar" route's chunks stay within
    the grid's 65,535."""
    parts = krn.rmsnorm_bwd_parts(route, lanes, rows)
    if route == "rows":
        groups = max(lanes, krn.BWD_BLOCK) // lanes
        per_block = max(groups, krn.BWD_BLOCK_ROWS)
        assert 1 <= parts <= krn.BWD_MAX_BLOCKS
        assert (parts - 1) * groups < rows
        assert parts == krn.BWD_MAX_BLOCKS or \
            parts * per_block >= rows > (parts - 1) * per_block
    else:
        chunk = -(-rows // parts)
        assert parts <= 65535 and -(-rows // chunk) == parts

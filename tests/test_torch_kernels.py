"""The port's FL kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version; here that plain version is
held against the Pallas kernel in interpret mode (as the JAX package's own
tests run it) and against ``repro.kernels.ref``.  Index outputs must be
exactly equal; float outputs agree within rtol=1e-5 (the reductions sum in
another order).  The CUDA kernels themselves run only on the card:
tests/test_torch_cuda.py and ``chip_smoke.py`` hold them against the plain
versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.bandwidth_solve import bandwidth_solve as j_bw  # noqa: E402
from repro.kernels.fedavg_reduce import _reduce_leaf as j_reduce_leaf  # noqa: E402
from repro.kernels.fedavg_reduce import fedavg_reduce as j_fedavg  # noqa: E402
from repro.kernels.select_topk import best_bs_argmax as j_best  # noqa: E402
from repro.kernels.select_topk import masked_bs_argmax as j_masked  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import bandwidth_solve as kb  # noqa: E402
from repro_torch.kernels import fedavg_reduce as kf  # noqa: E402
from repro_torch.kernels import select_topk as ks  # noqa: E402
from tests.test_torch_slice import cap_torch_threads  # noqa: E402

cap_torch_threads()

T = torch.from_numpy


def _bw_case(seed, k, u):
    rs = np.random.default_rng(seed)
    snr = (10.0 ** rs.uniform(-1, 4, (k, u))).astype(np.float32)
    coeff = (0.5 / np.log2(1.0 + snr)).astype(np.float32)
    tcomp = rs.uniform(0.10, 0.11, (u,)).astype(np.float32)
    mask = rs.random((k, u)) < 0.4
    mask[k // 2] = False                          # an empty row
    bw = rs.uniform(0.5, 1.5, (k,)).astype(np.float32)
    return coeff, tcomp, mask, bw


@pytest.mark.parametrize("method", ["newton", "bisect"])
@pytest.mark.parametrize("k,u,seed", [(8, 50, 0), (11, 37, 1), (3, 200, 2)])
def test_bandwidth_solve_matches_pallas_and_oracle(method, k, u, seed):
    coeff, tcomp, mask, bw = _bw_case(seed, k, u)
    tc_rows = np.broadcast_to(tcomp, (k, u)).copy()
    want = np.asarray(j_bw(coeff, tc_rows, mask, bw, method=method,
                           interpret=True))
    oracle = np.asarray(ref.bandwidth_solve(coeff, tc_rows, mask, bw,
                                            method=method))
    shared = kb.bandwidth_solve(T(coeff), T(tcomp), T(mask), T(bw),
                                method=method).numpy()
    per_row = kb.bandwidth_solve(T(coeff), T(tc_rows), T(mask), T(bw),
                                 method=method).numpy()
    np.testing.assert_allclose(shared, want, rtol=1e-5)
    np.testing.assert_allclose(shared, oracle, rtol=1e-5)
    np.testing.assert_array_equal(shared, per_row)
    assert shared[k // 2] == 0.0 and want[k // 2] == 0.0


def test_bandwidth_solve_warm_start_lo():
    coeff, tcomp, mask, bw = _bw_case(3, 8, 50)
    tc_rows = np.broadcast_to(tcomp, (8, 50)).copy()
    cold = kb.bandwidth_solve(T(coeff), T(tcomp), T(mask), T(bw)).numpy()
    lo = (cold * np.float32(0.9)).astype(np.float32)
    lo[1] = 1e6                                  # above hi: clipped to hi
    want = np.asarray(j_bw(coeff, tc_rows, mask, bw, lo=lo, interpret=True))
    got = kb.bandwidth_solve(T(coeff), T(tcomp), T(mask), T(bw),
                             lo=T(lo)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    keep = np.arange(8) != 1                     # a lo below the root is inert
    np.testing.assert_allclose(got[keep], cold[keep], rtol=1e-5)


@pytest.mark.parametrize("method", ["newton", "bisect"])
def test_bandwidth_solve_bf16_matches_pallas(method):
    """bf16 coeff and tcomp are solved in float32, as the JAX wrapper
    upcasts them (the CUDA wrapper upcasts before its launch)."""
    coeff, tcomp, mask, bw = _bw_case(4, 8, 50)
    tc_rows = np.broadcast_to(tcomp, (8, 50)).copy()
    c16 = T(coeff).to(torch.bfloat16)
    t16 = T(tc_rows).to(torch.bfloat16)
    want = np.asarray(j_bw(jnp.asarray(c16.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(t16.float().numpy()).astype(jnp.bfloat16),
        mask, bw, method=method, interpret=True))
    got = kb.bandwidth_solve(c16, t16, T(mask), T(bw), method=method)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), kb.bandwidth_solve(c16.float(), t16.float(), T(mask),
                                        T(bw), method=method).numpy())


_SLICE = kb.SLICE_USERS


# bandwidth_plan at each path's boundaries: (K, U, path, users a lane or
# slices, slice users).  Slices: about SLICE_USERS users each, at most 8,
# and K x slices within GRID_BLOCKS.
@pytest.mark.parametrize("k,u,path,width,slice_", [
    (8, 0, "warp", 1, 0), (8, 1, "warp", 1, 0), (8, 32, "warp", 1, 0),
    (8, 33, "warp", 2, 0), (8, 64, "warp", 2, 0), (8, 65, "warp", 4, 0),
    (8, 256, "warp", 8, 0), (8, 257, "block", 1, 264),
    (33, 4097, "block", 1, 4104), (8, _SLICE, "block", 1, _SLICE),
    (8, _SLICE + 1, "cluster", 2, _SLICE // 2 + 8),
    (33, 4 * _SLICE, "cluster", 4, _SLICE),
    (8, 8 * _SLICE, "cluster", 8, _SLICE),
    (8, 8 * _SLICE + 1, "cluster", 8, _SLICE + 8),
    (1, 1_000_000, "cluster", 8, 125000),
    (100, 1_000_000, "cluster", 2, 500000),
    (128, 1_000_000, "cluster", 2, 500000),
    (129, 1_000_000, "block", 1, 1_000_000)])
def test_bandwidth_plan(k, u, path, width, slice_):
    plan = kb.bandwidth_plan(k, u)
    assert plan.path == path
    if path == "warp":
        assert plan.users_per_lane == width and 32 * width >= u
        return
    assert (plan.slices, plan.slice) == (width, slice_)
    assert plan.slice % kb.VEC_USERS == 0 and plan.slices * plan.slice >= u
    assert (plan.slices - 1) * plan.slice < u     # no slice left empty
    assert k * plan.slices <= max(kb.GRID_BLOCKS, k)


@pytest.mark.parametrize("k,u", [(8, 257), (8, 4097), (8, 16384),
                                 (8, 16385), (8, 131073), (100, 1_000_000),
                                 (1, 1_000_000)])
@pytest.mark.parametrize("vec", [False, True])
def test_bandwidth_pair_capacity_holds_every_user(k, u, vec):
    """A warp's shared-memory and spill regions together hold every user
    the warp loads (csrc/bandwidth_solve.cu: warp w of a 512-thread block
    loads units w*32 .. w*32+31 of every 512, 8 users a unit when vec),
    and shared memory stays within the block's SMEM_PAIRS."""
    plan = kb.bandwidth_plan(k, u)
    on_chip, spill = kb.pair_capacity(plan, vec)
    per_unit = kb.VEC_USERS if vec else 1
    units = -(-plan.slice // per_unit)
    threads = kb.CLUSTER_THREADS
    most = max(sum(1 for j in range(units) if (j % threads) // 32 == w)
               for w in range(threads // 32)) * per_unit
    assert on_chip + spill >= most
    assert on_chip * threads // 32 <= kb.SMEM_PAIRS and on_chip % 32 == 0
    assert spill == 0 or on_chip == kb.SMEM_PAIRS // (threads // 32)
    if most <= kb.SMEM_PAIRS // (threads // 32):
        assert spill == 0                        # all on chip


def _snr_with_ties(seed, n, m):
    rs = np.random.default_rng(seed)
    snr = (10.0 ** rs.uniform(-1, 5, (n, m))).astype(np.float32)
    snr[n // 3] = snr[n // 5]                    # tied users
    snr[:, m - 1] = snr[:, 0]                    # tied BSs
    snr[7, 2] = snr[:, 2].max()                  # a tie at a column's max
    rem = rs.random(n) < 0.5
    return snr, rem


@pytest.mark.parametrize("n,m,seed", [(50, 8, 0), (37, 5, 1), (130, 3, 2)])
def test_masked_bs_argmax_matches_pallas_exactly(n, m, seed):
    snr, rem = _snr_with_ties(seed, n, m)
    rem[7] = True
    for mask in (rem, np.zeros(n, bool), np.eye(1, n, n - 1, dtype=bool)[0]):
        ji, jv = j_masked(snr, mask, user_block=16)      # 16 ∤ n
        ri, rv = ref.masked_bs_argmax(snr, mask)
        ti, tv = ks.masked_bs_argmax(T(snr), T(mask))
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    _, tv = ks.masked_bs_argmax(T(snr), T(np.zeros(n, bool)))
    assert np.isneginf(tv.numpy()).all()


def _quantize_snr_int8(snr):
    """numpy port of repro.core.channel.quantize_snr_int8's formula."""
    db = (10.0 * np.log10(np.maximum(snr, 1e-12))).astype(np.float32)
    scale = (np.maximum(np.abs(db).max(axis=0), 1e-6) / 127.0).astype(
        np.float32)
    q = np.clip(np.round(db / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def _storage(snr, dtype):
    """(jax array, torch tensor) of the same codes: f32, bf16 (exactly
    representable values, so both sides hold the same bits) or int8."""
    if dtype == "int8":
        return snr, T(snr)
    t = T(snr)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    return snr, t


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,m,seed", [(50, 8, 0), (37, 5, 1), (130, 3, 2),
                                      (200, 33, 3)])
def test_masked_bs_argmax_quantized_matches_pallas_exactly(dtype, n, m, seed):
    """f32, bf16 and int8 storage with a per-BS scale (one column's scale
    negative, so the raw codes order the other way), ties, all-masked and
    one-user masks: indices and values equal the Pallas kernel's."""
    snr, rem = _snr_with_ties(seed, n, m)
    q, scale = _quantize_snr_int8(snr)
    scale[m // 2] = -scale[m // 2]
    codes = q if dtype == "int8" else (snr if dtype == "f32" else
                                       snr.astype(np.float32))
    jx, tx = _storage(codes, dtype)
    for mask in (rem, np.zeros(n, bool), np.eye(1, n, n - 1, dtype=bool)[0]):
        for sc in (scale, None):
            ji, jv = j_masked(jx, mask, scale=sc, user_block=16,
                              interpret=True)
            ti, tv = ks.masked_bs_argmax(tx, T(mask),
                                         None if sc is None else T(sc))
            assert ti.dtype == torch.int32 and tv.dtype == torch.float32
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if dtype == "int8":                          # codes tie within a column
        assert (np.sort(q[:, 0])[1:] == np.sort(q[:, 0])[:-1]).any()


@pytest.mark.parametrize("n,m,seed", [(50, 8, 0), (37, 5, 1), (130, 3, 2)])
def test_best_bs_argmax_matches_pallas_exactly(n, m, seed):
    snr, _ = _snr_with_ties(seed, n, m)
    got = ks.best_bs_argmax(T(snr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_best(snr, user_block=16)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.best_bs_argmax(snr)))


@pytest.mark.parametrize("dtype,aligned", [
    (torch.float32, True), (torch.bfloat16, True), (torch.bfloat16, False),
    (torch.int8, True), (torch.int8, False)])
def test_masked_bs_plan_is_launchable(dtype, aligned):
    """Every M gives a launch csrc/select_topk.cu takes: a tile of threads
    x codes entries is a whole number of rows (a thread's columns stay
    put), at most 1024 threads, a block a whole number of 8-tile steps, and
    N x M up to the block's entries (32,768 float32, 65,536 bf16 / int8)
    one block."""
    for m in range(1, 1025):
        n = max(1, ks._BLOCK_ELEMS[dtype] // m)
        v, threads, rpt, rows, blocks = ks.masked_bs_plan(n, m, dtype,
                                                          aligned)
        assert v == (1 if not aligned else {torch.float32: 1,
                                            torch.bfloat16: 2,
                                            torch.int8: 4}[dtype])
        assert threads * v == rpt * m and 1 <= threads <= 1024
        assert rows % (8 * rpt) == 0 and blocks == 1
        assert ks.masked_bs_plan(2 * rows + 1, m, dtype, aligned)[4] >= 2


@pytest.mark.parametrize("n,m,dtype,want", [
    (50, 8, torch.float32, (1, 56, 7, 4144, 1)),
    (37, 5, torch.float32, (1, 25, 5, 6560, 1)),
    (1, 1, torch.float32, (1, 1, 1, 32768, 1)),
    (1_000_000, 100, torch.float32, (1, 200, 2, 336, 2977)),
    (1_000_000, 33, torch.float32, (1, 231, 7, 1008, 993)),
    (1_000_000, 100, torch.bfloat16, (2, 250, 5, 680, 1471)),
    (1_000_000, 100, torch.int8, (4, 250, 10, 720, 1389)),
    (1_000_000, 33, torch.int8, (4, 231, 28, 2016, 497)),
    (1, 1, torch.int8, (4, 1, 4, 65536, 1)),
    (70000, 8, torch.int8, (4, 256, 128, 8192, 9))])
def test_masked_bs_plan(n, m, dtype, want):
    assert ks.masked_bs_plan(n, m, dtype, True) == want


def _ordered_key(v):
    u = np.asarray(v, np.float32).reshape(-1) + np.float32(0.0)
    u = u.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)


def test_masked_bs_packed_key_orders_value_then_lowest_index():
    """The kernel's per-column atomicMax key: the value as an order-
    preserving integer above the complement of the index; its max is the
    (largest value, lowest index) candidate, and it unpacks to both."""
    rs = np.random.default_rng(0)
    vals = np.concatenate([rs.standard_normal(200).astype(np.float32),
                           np.float32([0.0, -0.0, -np.inf, np.inf, 3.0, 3.0,
                                       -1e-38, 1e-38])])
    idx = rs.permutation(len(vals)).astype(np.int64)
    idx[-1] = 2 ** 31 - 1                       # a block with no user
    keys = (_ordered_key(vals) << np.uint64(32)) | (
        ~idx.astype(np.uint32)).astype(np.uint64)
    top = keys.max()
    best = vals.max()
    want_i = idx[vals == best].min()
    assert (~np.uint32(top & np.uint64(0xffffffff))) == want_i
    k = np.uint32(top >> np.uint64(32))
    bits = (k & np.uint32(0x7fffffff)) if k & np.uint32(0x80000000) else ~k
    assert np.uint32(bits).view(np.float32) == best
    # -0 and +0 tie (the lowest index wins), as in jnp.argmax
    z = _ordered_key(np.float32([0.0, -0.0]))
    assert z[0] == z[1]


# The launch shape of best_bs_argmax's CUDA kernel on a float32 plane:
# (lanes per row, 16-byte word loads a lane makes per row and pass, rows
# in flight per lane group).
@pytest.mark.parametrize("m,want", [(1, (1, 2, 2)), (2, (1, 2, 2)),
                                    (3, (1, 2, 2)), (4, (1, 1, 4)),
                                    (8, (1, 2, 2)), (9, (1, 4, 1)),
                                    (31, (4, 4, 1)), (32, (2, 4, 1)),
                                    (33, (4, 4, 1)), (100, (8, 4, 1)),
                                    (257, (32, 4, 1)), (1024, (32, 4, 1))])
def test_best_bs_plan(m, want):
    assert ks.best_bs_plan(m) == want


def test_best_bs_plan_is_launchable():
    """Every M and type gives a shape csrc/select_topk.cu instantiates: a
    power-of-two group of at most a warp, 4 words in flight a lane, 4
    word loads unless the group is one lane, and one pass over the words
    a row touches unless the row needs more than a warp's 128 words."""
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        size = torch.empty((), dtype=dtype).element_size()
        for m in range(1, 4097):
            lanes, chunks, rows = ks.best_bs_plan(m, dtype)
            words = -(-m * size // 16) + (1 if m * size % 16 else 0)
            assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
            assert chunks * rows == 4 and chunks in (1, 2, 4)
            assert lanes == 1 or chunks == 4
            assert lanes * chunks >= words or lanes == 32


def _lane_group_argmax(snr: np.ndarray, lanes: int, off: int = 0
                       ) -> np.ndarray:
    """best_bs_argmax's CUDA kernel in numpy: lane j of a row's group reads
    the row's 16-byte words j, j + lanes, ... of the plane (4 float32 each;
    the plane starts ``off`` codes into its first word) and keeps the
    first maximum of its codes (M while it has none); the group takes the
    largest value, then the lowest column holding it, and a row with no
    column taken gives 0."""
    n, m = snr.shape
    best = np.full((n, lanes), -np.inf, np.float32)
    idx = np.full((n, lanes), m, np.int64)
    for r in range(n):
        e0 = off + r * m
        for c in range(m):                      # a lane's codes rise
            j = ((e0 + c) // 4 - e0 // 4) % lanes
            if snr[r, c] > best[r, j]:
                best[r, j], idx[r, j] = snr[r, c], c
    top = best.max(axis=1, keepdims=True)
    i = np.where(best == top, idx, np.iinfo(np.int32).max).min(axis=1)
    return np.where(i < m, i, 0).astype(np.int32)


@pytest.mark.parametrize("m", [1, 2, 3, 8, 31, 32, 33, 100, 257])
def test_best_bs_lane_groups_match_pallas_exactly(m):
    """The kernel's lane-group order on ties: a row's maximum repeated in
    one lane's words (c and c + 4 lanes), in two lanes' (c and c + 4), in
    one word (c and c + 1), a row of one value throughout and a row of
    -inf, each to its lowest column, on a plane 16-byte aligned and one
    that starts 1-3 codes into its first word."""
    n = 37
    rs = np.random.default_rng(m)
    snr = (10.0 ** rs.uniform(-1, 5, (n, m))).astype(np.float32)
    snr[:, m - 1] = snr[:, 0]                    # tied BSs
    lanes = ks.best_bs_plan(m)[0]
    top = snr.max(axis=1) * np.float32(2)
    for r in range(n - 1):
        c = r % m
        c2 = c + (4 * lanes, 4, 1, m)[r % 4]      # same lane / next / word
        if c2 < m:
            snr[r, c] = snr[r, c2] = top[r]
    snr[n - 1] = np.float32(5.0)
    snr[n - 2] = -np.inf                         # torch.argmax gives 0
    want = np.asarray(j_best(snr, user_block=16))
    for off in range(4):
        np.testing.assert_array_equal(_lane_group_argmax(snr, lanes, off),
                                      want)
    np.testing.assert_array_equal(want, np.asarray(ref.best_bs_argmax(snr)))
    np.testing.assert_array_equal(ks.best_bs_argmax(T(snr)).numpy(), want)


def _fleet_params(seed, n):
    rs = np.random.default_rng(seed)
    g = {"a": {"w": rs.normal(size=(3, 3, 1, 4)).astype(np.float32),
               "b": rs.normal(size=(4,)).astype(np.float32)},
         "f": {"w": rs.normal(size=(20, 7)).astype(np.float32)}}
    c = {k: {leaf: (v[None] + rs.normal(size=(n,) + v.shape))
             .astype(np.float32) for leaf, v in sub.items()}
         for k, sub in g.items()}
    return g, c


def _to_torch(tree):
    return {k: {leaf: T(np.array(v)) for leaf, v in sub.items()}
            for k, sub in tree.items()}


@pytest.mark.parametrize("case", ["plain", "poisoned", "clip", "weights",
                                  "empty"])
def test_fedavg_reduce_matches_pallas_and_oracle(case):
    n = 13                                       # not a multiple of 8
    g, c = _fleet_params(4, n)
    rs = np.random.default_rng(5)
    sel = rs.random(n) < 0.6
    sizes = rs.integers(10, 50, n).astype(np.int32)
    kwargs = {}
    if case == "poisoned":
        sel[[2, 5]] = True
        c["a"]["w"][2, 0, 0, 0, 1] = np.nan
        c["f"]["w"][5, 3, 3] = np.inf
    if case == "clip":
        kwargs["clip_norm"] = 2.5
    if case == "weights":
        kwargs["weights"] = rs.uniform(0.2, 1.0, n).astype(np.float32)
    if case == "empty":
        sel[:] = False
    want = j_fedavg(g, c, sel, sizes, client_block=8, feature_block=128,
                    interpret=True, **kwargs)
    oracle = ref.fedavg_reduce(g, c, sel, sizes, **kwargs)
    t_kwargs = {k: (T(v) if isinstance(v, np.ndarray) else v)
                for k, v in kwargs.items()}
    got = kf.fedavg_reduce(_to_torch(g), _to_torch(c), T(sel), T(sizes),
                           **t_kwargs)
    for k in g:
        for leaf in g[k]:
            out = got[k][leaf].numpy()
            assert np.isfinite(out).all()
            np.testing.assert_allclose(out, np.asarray(want[k][leaf]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(out, np.asarray(oracle[k][leaf]),
                                       rtol=1e-5, atol=1e-6)
            if case == "empty":
                np.testing.assert_array_equal(out, g[k][leaf])


@pytest.mark.parametrize("dtype,n,d,aligned,want", [
    (torch.float32, 50, 100352, True, ("scalar", 1)),    # the main fc1 leaf
    (torch.float32, 1000, 100352, True, ("vector", 4)),  # the fleet leaf
    (torch.int8, 50, 100352, True, ("scalar", 1)),
    (torch.int8, 1000, 100352, True, ("vector", 8)),
    (torch.float32, 100, 100352, True, ("vector", 4)),
    (torch.int8, 100, 100352, True, ("scalar", 1)),      # below 200 clients
    (torch.int8, 200, 100352, True, ("vector", 8)),
    (torch.float32, 1000, 512, True, ("vector", 8)),     # one column block
    (torch.float32, 1000, 512, False, ("scalar", 1)),    # base off 16 bytes
    (torch.float32, 500, 7, True, ("scalar", 1)),        # ragged d
    (torch.int8, 500, 1000, True, ("scalar", 1)),        # d % 16 != 0
    (torch.int8, 500, 1008, True, ("vector", 8)),
    (torch.float32, 200, 1_100_000, True, ("vector", 2)),  # >= 528 blocks
    (torch.int8, 200, 1_100_000, True, ("vector", 2)),
])
def test_reduce_plan(dtype, n, d, aligned, want):
    assert kf.reduce_plan(dtype, n, d, aligned) == want


def _split_ranges(n, splits):
    """The client ranges [r0, r1) of the vector path's splits, in the
    order their sums are added (csrc/fedavg_reduce.cu: ceil(n / splits)
    clients a split)."""
    per = -(-n // splits)
    return [(min(n, s * per), min(n, (s + 1) * per)) for s in range(splits)]


@pytest.mark.parametrize("n", [100, 127, 200, 201, 333, 1000, 4097])
def test_reduce_plan_splits_cover_the_clients(n):
    """The vector path splits into a power of two from a cluster of 2 to
    one of 8 (the scalar path into one range), and the ranges tile [0, n)
    in order with none empty."""
    for dtype in (torch.float32, torch.int8):
        for d in (16, 512, 100352):
            path, splits = kf.reduce_plan(dtype, n, d, True)
            assert path == ("vector" if n >= kf.VECTOR_MIN_CLIENTS[dtype]
                            else "scalar")
            assert splits in ((2, 4, 8) if path == "vector" else (1,))
            ranges = _split_ranges(n, splits)
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(a < b for a, b in ranges)
            assert all(ranges[i][1] == ranges[i + 1][0]
                       for i in range(splits - 1))
            if splits > 1:
                assert n // splits >= kf.MIN_SPLIT_ROWS


def _vector_path_sum(w, x, splits):
    """The vector path's order, in numpy: each split's clients in order by
    fused multiply-adds (float64, rounded to float32 each step), then the
    splits' sums added in split order in float32."""
    xs = np.where(np.isfinite(x), x, 0).astype(np.float64)
    parts = []
    for r0, r1 in _split_ranges(x.shape[0], splits):
        acc = np.zeros(x.shape[1], np.float32)
        for i in range(r0, r1):
            acc = (np.float64(w[i]) * xs[i] + acc).astype(np.float32)
        parts.append(acc)
    total = parts[0]
    for part in parts[1:]:
        total = (total + part).astype(np.float32)
    return total


@pytest.mark.parametrize("dtype,n,d", [(np.float32, 100, 4096),
                                       (np.float32, 1000, 512),
                                       (np.int8, 1000, 2048),
                                       (np.int8, 200, 2048)])
def test_vector_path_split_order_within_gate(dtype, n, d):
    """The client split's grouping meets the rtol=1e-5 gate against the
    Pallas kernel (interpret) on the plan's own splits, poisoned entries
    included."""
    rs = np.random.default_rng(n + d)
    if dtype == np.int8:
        x = rs.integers(-127, 128, (n, d)).astype(np.int8)
    else:
        x = rs.normal(size=(n, d)).astype(np.float32)
        x[3, d // 2], x[7, 0] = np.nan, np.inf
    w = rs.random(n).astype(np.float32)
    path, splits = kf.reduce_plan(T(x).dtype, n, d, True)
    assert path == "vector" and splits > 1
    got = _vector_path_sum(w, x, splits)
    want = np.asarray(j_reduce_leaf(w.reshape(-1, 1), x, 8, 512, True))
    scale = (w[:, None] * np.abs(np.where(np.isfinite(x), x, 0)
                                 .astype(np.float32))).sum(axis=0)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-6).all()
    # the plain version (the CPU route) is held to the same gate
    plain = kf.reduce_leaf(T(w), T(x)).numpy()
    assert (np.abs(plain - want) <= 1e-5 * scale + 1e-6).all()


def test_int8_codes_through_the_float_mantissa_are_exact():
    """The vector path turns a code c into float(0x4B000000 | (c ^ 0x80))
    - (2^23 + 128): exactly c for every int8."""
    codes = np.arange(-128, 128).astype(np.int8)
    biased = (codes.view(np.uint8) ^ 0x80).astype(np.uint32)
    f = (np.uint32(0x4B000000) | biased).view(np.float32)
    np.testing.assert_array_equal(f - np.float32(8388736.0),
                                  codes.astype(np.float32))


def test_reduce_leaf_screens_non_finite_entries():
    x = torch.tensor([[1.0, float("nan")], [float("inf"), 2.0]])
    w = torch.tensor([0.5, 0.25])
    np.testing.assert_array_equal(kf.reduce_leaf(w, x).numpy(), [0.5, 0.5])


def test_wrappers_refuse_mixed_devices():
    snr = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        ks.masked_bs_argmax(snr, torch.zeros(4, dtype=torch.bool,
                                             device="meta"))
    assert _lib.on_cuda(snr) is False

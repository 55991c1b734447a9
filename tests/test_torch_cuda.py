"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Indices must match exactly; floats within rtol=1e-5 (sums in another
order; for a reduction, relative to the sum of its terms' magnitudes).
The LM kernels (7-9) are held to the float32 / bfloat16 tolerances that
tests/test_kernels.py grants their Pallas counterparts: rmsnorm 1e-6 /
2e-2, flash attention 2e-5 / 2e-2, the SSD scan 2e-4 / 5e-2.
"""
import dataclasses
import gc
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.core import dagsa_jit  # noqa: E402
from repro_torch.core.types import SchedulingProblem  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.fl.server import segment_weights  # noqa: E402
from repro_torch.kernels import _lib, graph_while  # noqa: E402
from repro_torch.kernels import bandwidth_solve as kb  # noqa: E402
from repro_torch.kernels import compress_topk as ct  # noqa: E402
from repro_torch.kernels import fedavg_reduce as kf  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import rmsnorm as krn  # noqa: E402
from repro_torch.kernels import select_topk as ks  # noqa: E402
from repro_torch.kernels import ssd_scan as kss  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rs(seed):
    return np.random.default_rng(seed)


def _bw_inputs(rs, k, u, dev, density=0.4):
    snr = 10.0 ** rs.uniform(-1, 4, (k, u))
    coeff = torch.tensor(0.5 / np.log2(1 + snr), dtype=torch.float32,
                         device=dev)
    tcomp = torch.tensor(rs.uniform(0.1, 0.11, u), dtype=torch.float32,
                         device=dev)
    mask = torch.tensor(rs.random((k, u)) < density, device=dev)
    bw = torch.tensor(rs.uniform(0.5, 1.5, k), dtype=torch.float32,
                      device=dev)
    lo = torch.tensor(rs.uniform(0.0, 0.3, k), dtype=torch.float32,
                      device=dev)
    return coeff, tcomp, mask, bw, lo


# Every boundary of bandwidth_plan: the warp path's users a lane (32, 33,
# 256), the block path (257, 4097, 16384) and the cluster path's slices
# (16385: 2, 131072: 8 on chip, 131073: 8 with a spill).
@pytest.mark.parametrize("k,u", [(8, 50), (1, 1), (33, 1000), (100, 4097),
                                 (8, 32), (8, 33), (8, 256), (8, 257),
                                 (4, 16384), (4, 16385), (3, 131072),
                                 (3, 131073)])
@pytest.mark.parametrize("method", ["newton", "bisect"])
def test_bandwidth_solve(dev, k, u, method):
    rs = _rs(k * u)
    coeff, tcomp, mask, bw, lo = _bw_inputs(rs, k, u, dev)
    mask[k // 2] = False                        # an empty row -> 0
    if k >= 3:
        mask[0] = False                         # a single-user row
        mask[0, u // 2] = True
        lo[2] = 1e6                             # a warm start above hi
    for tc in (tcomp, tcomp.expand(k, u).contiguous()):
        got = kb.bandwidth_solve(coeff, tc, mask, bw, lo=lo, method=method)
        want = kb.bandwidth_solve_plain(coeff, tc, mask, bw, lo=lo,
                                        method=method)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        assert got[k // 2].item() == 0.0


@pytest.mark.parametrize("density", [0.01, 0.3])
@pytest.mark.parametrize("method", ["newton", "bisect"])
def test_bandwidth_solve_fleet_rows(dev, density, method):
    """Fleet rows at reduced K: [4, 1e6] with ~1e4 users a row and with
    30% (pairs spilled past shared memory); the plan (8 slices) and the
    plans of 64, 100 and 200 rows (4 and 2 slices, one block a row), each
    against plain and bit-identical over two runs."""
    k, u = 4, 1_000_000
    coeff, tcomp, mask, bw, lo = _bw_inputs(_rs(7), k, u, dev, density)
    mask[1] = False
    lo[2] = 1e6
    want = kb.bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo,
                                    method=method)
    plan = kb.bandwidth_plan(k, u)
    assert plan.path == "cluster" and plan.slices == 8
    others = [kb.bandwidth_plan(rows, u) for rows in (64, 100, 200)]
    assert [p.slices for p in others] == [4, 2, 1]
    for p in [plan] + others:
        runs = [kb.solve_cuda(0, coeff, tcomp, mask, bw, lo, None, method, p)
                for _ in range(2)]
        torch.testing.assert_close(runs[0], want, rtol=1e-5, atol=1e-7)
        assert torch.equal(runs[0], runs[1])
        assert runs[0][1].item() == 0.0


def test_bandwidth_solve_bf16_upcast(dev):
    coeff, tcomp, mask, bw, lo = _bw_inputs(_rs(3), 8, 50, dev)
    c16, t16 = coeff.to(torch.bfloat16), tcomp.to(torch.bfloat16)
    got = kb.bandwidth_solve(c16, t16, mask, bw, lo=lo)
    assert got.dtype == torch.float32
    assert torch.equal(got, kb.bandwidth_solve(c16.float(), t16.float(),
                                               mask, bw, lo=lo))
    with pytest.raises(TypeError):
        kb.bandwidth_solve(coeff.half(), tcomp, mask, bw)


@pytest.mark.parametrize("n,m", [(50, 8), (1, 1), (37, 5), (70000, 100),
                                 (3000, 300), (1001, 1), (1001, 2), (1001, 3),
                                 (1001, 31), (1001, 32), (1001, 33),
                                 (999, 257), (1001, 1024)])
def test_selection_argmaxes(dev, n, m):
    rs = _rs(n + m)
    snr = torch.tensor(10.0 ** rs.uniform(-1, 5, (n, m)), dtype=torch.float32,
                       device=dev)
    snr[n // 3] = snr[n // 5]
    snr[:, m - 1] = snr[:, 0]
    for rem in (torch.tensor(rs.random(n) < 0.5, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev),
                torch.ones(n, dtype=torch.bool, device=dev)):
        for got, want in zip(ks.masked_bs_argmax(snr, rem),
                             ks.masked_bs_argmax_plain(snr, rem)):
            assert torch.equal(got, want)
    assert torch.equal(ks.best_bs_argmax(snr), ks.best_bs_argmax_plain(snr))


def _quantized(n, m, dtype, dev, seed):
    """snr codes of ``dtype`` (int8 dB codes, or bf16 / f32 values with
    ties) and a per-BS scale with one negative entry."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int8:
        snr = torch.randint(-127, 128, (n, m), generator=gen, device=dev,
                            dtype=torch.int8)
    else:
        snr = (torch.rand((n, m), generator=gen, device=dev) * 8.0).round()
        snr = snr.to(dtype)                     # few values: many ties
    scale = torch.rand((m,), generator=gen, device=dev) + 0.05
    scale[m // 2] = -scale[m // 2]
    rem = torch.rand((n,), generator=gen, device=dev) < 0.5
    return snr, scale, rem


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 50, 70000, 1_000_000])
@pytest.mark.parametrize("m", [1, 8, 33, 100])
def test_masked_bs_argmax_quantized(dev, dtype, n, m):
    snr, scale, rem = _quantized(n, m, dtype, dev, n + m)
    for r in (rem, torch.zeros_like(rem), torch.ones_like(rem)):
        for sc in (scale, None):
            for got, want in zip(ks.masked_bs_argmax(snr, r, sc),
                                 ks.masked_bs_argmax_plain(snr, r, sc)):
                assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_masked_bs_argmax_unaligned(dev, dtype):
    """A plane off 4-byte alignment takes one code a load."""
    n, m = 7001, 33
    snr, scale, rem = _quantized(n, m, dtype, dev, 1)
    off = torch.empty(n * m + 1, dtype=dtype, device=dev)[1:].view(n, m)
    off.copy_(snr)
    assert off.data_ptr() % 4 != 0
    for got, want in zip(ks.masked_bs_argmax(off, rem, scale),
                         ks.masked_bs_argmax_plain(snr, rem, scale)):
        assert torch.equal(got, want)


def test_masked_bs_argmax_ticket_resets(dev):
    """The last block resets the keys and the ticket: three calls in a row,
    a call after one that raised, and a CUDA graph replayed five times all
    give the same result (one launch a call)."""
    n, m = 70000, 100                           # 107 blocks
    assert ks.masked_bs_plan(n, m, torch.float32, True)[4] > 1
    snr = torch.rand((n, m), device=dev)
    rem = torch.rand((n,), device=dev) < 0.5
    want = ks.masked_bs_argmax_plain(snr, rem)
    before = _lib.LAUNCHES["masked_bs_argmax"]
    for _ in range(3):
        got = ks.masked_bs_argmax(snr, rem)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _lib.LAUNCHES["masked_bs_argmax"] == before + 3
    with pytest.raises(ValueError):
        ks.masked_bs_argmax(snr, rem[:-1])
    got = ks.masked_bs_argmax(snr, rem)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    outs, counted = _replayed(lambda: torch.stack(
        [t.float() for t in ks.masked_bs_argmax(snr, rem)]), reps=1)
    assert counted == {"masked_bs_argmax": 1}
    assert torch.equal(outs[0], torch.stack([w.float() for w in want]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cand, best = ks.masked_bs_argmax(snr, rem)
    for _ in range(5):
        cand.zero_()
        best.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(cand, want[0]) and torch.equal(best, want[1])
    got = ks.masked_bs_argmax(snr, rem)         # eager again after the graph
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_masked_bs_argmax_graph_workspaces(dev):
    """A captured call owns its keys and ticket: a graph captured at M = 8,
    then eager calls at M = 100 on the capture stream (which grow that
    stream's cached workspace), then two graphs captured on the same
    default capture stream at M = 100; all three replayed at once on three
    streams, five times, give the plain results."""
    n = 70000
    assert ks.masked_bs_plan(n, 8, torch.float32, True)[4] > 1
    gen = torch.Generator(device=dev).manual_seed(5)
    small = torch.rand((n, 8), generator=gen, device=dev)
    big = torch.rand((n, 100), generator=gen, device=dev)
    rems = [torch.rand((n,), generator=gen, device=dev) < 0.5
            for _ in range(3)]
    cases = [(small, rems[0]), (big, rems[1]), (big, rems[2])]
    wants = [ks.masked_bs_argmax_plain(snr, r) for snr, r in cases]
    graphs, outs = [], []

    def capture(snr, rem):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(ks.masked_bs_argmax(snr, rem))
        graphs.append(graph)

    capture(*cases[0])
    with torch.cuda.stream(torch.cuda.graph.default_capture_stream):
        for _ in range(2):
            got = ks.masked_bs_argmax(big, rems[1])
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, wants[1]))
    capture(*cases[1])
    capture(*cases[2])
    streams = [torch.cuda.Stream() for _ in graphs]
    for _ in range(5):
        for out in outs:
            for t in out:
                t.zero_()
        torch.cuda.synchronize()
        for graph, stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, wants):
            assert all(torch.equal(g, w) for g, w in zip(out, want))


@pytest.mark.parametrize("n,d", [(50, 100352), (13, 1000), (1, 7)])
def test_fedavg_reduce_leaf(dev, n, d):
    x = torch.randn((n, d), device=dev)
    x[0, d // 2] = float("nan")
    x[n - 1, 0] = float("inf")
    w = torch.rand((n,), device=dev)
    got, want = kf.reduce_leaf(w, x), kf.reduce_leaf_plain(w, x)
    scale = kf.reduce_leaf_plain(w, x.abs())
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.parametrize("n,d", [(50, 100352), (13, 1000), (1, 7)])
def test_fedavg_reduce_leaf_int8(dev, n, d):
    x = torch.randint(-127, 128, (n, d), dtype=torch.int8, device=dev)
    w = torch.rand((n,), device=dev)
    before = _lib.LAUNCHES["fedavg_reduce_int8"]
    got, want = kf.reduce_leaf(w, x), kf.reduce_leaf_plain(w, x)
    assert _lib.LAUNCHES["fedavg_reduce_int8"] == before + 1
    scale = kf.reduce_leaf_plain(w, x.float().abs())
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def _reduce_case(gen, dev, dtype, n, d, offset=0):
    """x [n, d] (``offset`` elements past a 16-byte boundary), poisoned
    with NaN / +-Inf where float, and w [n] with a zero weight."""
    if dtype == torch.int8:
        buf = torch.randint(-127, 128, (n * d + offset,), generator=gen,
                            device=dev, dtype=torch.int8)
    else:
        buf = torch.randn((n * d + offset,), generator=gen, device=dev)
    x = buf[offset:].view(n, d)
    if dtype == torch.float32:
        x[0, d // 2] = float("nan")
        x[n - 1, 0] = float("inf")
        x[n // 2, d - 1] = float("-inf")
    w = torch.rand((n,), generator=gen, device=dev)
    w[min(1, n - 1)] = 0.0
    return w, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("n,d,offset", [
    (1000, 100352, 0), (200, 100352, 0), (100, 4096, 0), (333, 4112, 0),
    (1000, 512, 0),                                   # one column block
    (300, 1, 0), (300, 3, 0), (300, 15, 0), (300, 17, 0),  # ragged d
    (300, 4096, 1), (300, 4096, 2),                   # unaligned bases
    (300, 4096, 4),              # aligned in float32, not in int8
    (200, 1_100_000, 0),         # >= 528 column blocks: the fewest splits
])
def test_fedavg_reduce_paths(dev, dtype, n, d, offset):
    """Both paths of kernel 4 (the plan's pick) against plain, NaN / Inf
    screened, two calls bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(n + d + offset)
    w, x = _reduce_case(gen, dev, dtype, n, d, offset)
    aligned = x.data_ptr() % 16 == 0
    path, splits = kf.reduce_plan(dtype, n, d, aligned)
    vector = (aligned and d % (16 // x.element_size()) == 0
              and n >= kf.VECTOR_MIN_CLIENTS[dtype])
    assert path == ("vector" if vector else "scalar")
    assert splits > 1 if vector else splits == 1
    got = kf.reduce_leaf(w, x)
    assert torch.equal(got, kf.reduce_leaf(w, x))
    want = kf.reduce_leaf_plain(w, x)
    scale = kf.reduce_leaf_plain(w, torch.where(torch.isfinite(
        x.float()), x.float(), 0.0).abs())
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())


def test_fedavg_reduce_graph_capture(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    for dtype, n, d in ((torch.float32, 1000, 100352),
                        (torch.int8, 1000, 100352),
                        (torch.float32, 50, 100352)):
        w, x = _reduce_case(gen, dev, dtype, n, d)
        key = "fedavg_reduce_int8" if dtype == torch.int8 else "fedavg_reduce"
        outs, counted = _replayed(lambda: kf.reduce_leaf(w, x))
        assert counted == {key: 3}
        want = kf.reduce_leaf(w, x)
        assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("n,m,d", [(50, 8, 100352), (13, 5, 1000),
                                   (300, 100, 777), (1, 1, 7)])
def test_segment_reduce_leaf(dev, dtype, n, m, d):
    if dtype == torch.int8:
        x = torch.randint(-127, 128, (n, d), dtype=torch.int8, device=dev)
    else:
        x = torch.randn((n, d), device=dev)
        x[0, d // 2] = float("nan")
        x[n - 1, 0] = float("-inf")
    w = torch.rand((n, m), device=dev) * (torch.rand((n, m), device=dev)
                                          < 0.5)
    w[:, m // 2] = 0.0                           # an empty BS column
    key = ("fedavg_segment_reduce_int8" if dtype == torch.int8
           else "fedavg_segment_reduce")
    before = _lib.LAUNCHES[key]
    got = kf.segment_reduce_leaf(w, x)
    assert _lib.LAUNCHES[key] == before + 1
    want = kf.segment_reduce_leaf_plain(w, x)
    scale = kf.segment_reduce_leaf_plain(w, x.float().abs())
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    assert bool((got[m // 2] == 0).all())


def _onehot_weights(n, m, dev, seed):
    """What segment_weights gives for a random assignment: one BS a client,
    ~10% of clients unassigned (all-zero rows), BS m // 2 empty."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bs = torch.randint(0, m, (n,), generator=gen, device=dev)
    bs[bs == m // 2] = (m // 2 + 1) % m
    assigned = torch.rand((n,), generator=gen, device=dev) >= 0.1
    assign = torch.nn.functional.one_hot(bs, m).bool() & assigned[:, None]
    sizes = torch.randint(50, 150, (n,), generator=gen, device=dev)
    w, _ = segment_weights(assign, sizes)
    return w.contiguous()


def _segment_check(w, x):
    m = w.shape[1]
    key = ("fedavg_segment_reduce_int8" if x.dtype == torch.int8
           else "fedavg_segment_reduce")
    before = _lib.LAUNCHES[key]
    got = kf.segment_reduce_leaf(w, x)
    assert _lib.LAUNCHES[key] == before + 1
    want = kf.segment_reduce_leaf_plain(w, x)
    scale = kf.segment_reduce_leaf_plain(w, x.float().abs())
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    return got


def _leaf(n, d, dtype, dev):
    if dtype == torch.int8:
        return torch.randint(-127, 128, (n, d), dtype=torch.int8, device=dev)
    x = torch.randn((n, d), device=dev)
    x[0, d // 2] = float("nan")
    x[n - 1, 0] = float("-inf")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("n,m,d", [(1000, 100, 4099), (1000, 8, 4099),
                                   (1000, 100, 4096)])
def test_segment_reduce_leaf_onehot(dev, dtype, n, m, d):
    """The path's weights: one BS a client, unassigned clients and an
    empty BS; each BS tile walks only its own clients."""
    w = _onehot_weights(n, m, dev, seed=n + m + d)
    assert bool(((w != 0).sum(dim=1) <= 1).all())
    assert bool((w.sum(dim=1) == 0).any())
    got = _segment_check(w, _leaf(n, d, dtype, dev))
    assert bool((got[m // 2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_segment_reduce_leaf_fully_dense(dev, dtype):
    """Every client in every BS tile: no client is skipped."""
    gen = torch.Generator(device=dev).manual_seed(64)
    w = torch.rand((64, 100), generator=gen, device=dev) + 0.1
    _segment_check(w, _leaf(64, 1027, dtype, dev))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n,d,k", [(50, 100352, 10036), (13, 1000, 7),
                                   (70000, 3, 1)])
def test_sparsify_quantize_exact(dev, quantize, n, d, k):
    x = torch.randn((n, d), device=dev)
    x[0] = 0.25                                  # a row of magnitude ties
    x[0, -1] = -0.25
    x[1] = 0.0                                   # an all-zero row
    x[n - 1, 0] = float("nan")
    xs = torch.where(torch.isfinite(x), x, 0.0)
    thresh, rowmax = ct.topk_threshold(xs, k)
    scale = ct.quant_scale(rowmax) if quantize else torch.ones_like(rowmax)
    u = torch.rand((n, d), device=dev) if quantize else None
    got = ct.sparsify_quantize(x, thresh, scale, u, quantize=quantize)
    want = ct.sparsify_quantize_plain(x, thresh, scale, u,
                                      quantize=quantize)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert bool((got[0] != 0).all())             # every tie survives
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("m", [1, 2, 3, 8, 31, 32, 33, 100, 257, 1024])
def test_best_bs_argmax_ties_and_unaligned(dev, m):
    """Exact ties inside one lane's words (c and c + 4 lanes), across
    lanes (c and c + 4) and inside one word (c and c + 1), a row of one
    value and one of -inf, odd N, and an snr 4 bytes off 16-byte
    alignment, read in place; each eager call adds one launch."""
    n = 2049
    rs = _rs(m)
    snr = torch.tensor(10.0 ** rs.uniform(-1, 5, (n, m)), dtype=torch.float32,
                       device=dev)
    lanes = ks.best_bs_plan(m)[0]
    top = snr.max(dim=1).values * 2
    for r in range(0, n - 1, 7):
        c = r % m
        c2 = c + (4 * lanes, 4, 1)[r % 3]
        if c2 < m:
            snr[r, c] = snr[r, c2] = top[r]
    snr[n - 1] = 5.0
    snr[n - 2] = float("-inf")                  # torch.argmax gives 0
    want = ks.best_bs_argmax_plain(snr)
    before = _lib.LAUNCHES["best_bs_argmax"]
    assert torch.equal(ks.best_bs_argmax(snr), want)
    assert _lib.LAUNCHES["best_bs_argmax"] == before + 1
    off = torch.empty(n * m + 1, device=dev)[1:].view(n, m)
    off.copy_(snr)
    assert off.data_ptr() % 16 == 4
    assert torch.equal(ks.best_bs_argmax(off), want)
    assert _lib.LAUNCHES["best_bs_argmax"] == before + 2


def _replayed(fn, reps=3):
    """``reps`` calls of ``fn`` captured in one CUDA graph: the outputs of
    a replay, and the launches counted while capturing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(_lib.LAUNCHES)
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(reps)]
    counted = {k: v - before[k] for k, v in _lib.LAUNCHES.items()
               if v != before[k]}
    for o in outs:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return outs, counted


def test_graph_capture_matches_eager(dev):
    snr = torch.rand((1001, 33), device=dev)
    outs, counted = _replayed(lambda: ks.best_bs_argmax(snr))
    assert counted == {"best_bs_argmax": 3}
    want = ks.best_bs_argmax(snr)
    assert all(torch.equal(o, want) for o in outs)
    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype, shape in ((torch.bfloat16, (4, 2048)),   # the three paths
                         (torch.float32, (37, 128)),
                         (torch.bfloat16, (3, 8192)),
                         (torch.bfloat16, (5, 100))):
        x = _normal(gen, shape, dev, dtype)
        scale = (1.0 + 0.1 * _normal(gen, shape[-1:], dev)).to(dtype)
        outs, counted = _replayed(lambda: krn.rmsnorm(x, scale))
        assert counted == {"rmsnorm": 3}
        want = krn.rmsnorm(x, scale)
        assert all(torch.equal(o, want) for o in outs)


def test_wrappers_validate_and_count(dev):
    before = _lib.LAUNCHES["best_bs_argmax"]
    ks.best_bs_argmax(torch.rand((5, 3), device=dev))
    assert _lib.LAUNCHES["best_bs_argmax"] == before + 1
    with pytest.raises(TypeError):
        ks.best_bs_argmax(torch.rand((5, 3), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        ks.best_bs_argmax(torch.rand((3, 5), device=dev).T)
    with pytest.raises(ValueError):
        ks.masked_bs_argmax(torch.rand((5, 3), device=dev),
                            torch.ones(5, dtype=torch.bool))


def test_dagsa_on_card_matches_cpu(dev):
    for seed in range(10):
        rs = _rs(seed)
        n, m = 50, 8
        snr = (10.0 ** rs.uniform(0, 4, (n, m))
               * rs.exponential(size=(n, m))).astype(np.float32)
        coeff = (0.5 / np.maximum(np.log2(1 + snr), 1e-9)).astype(np.float32)
        arrays = dict(snr=snr, coeff=coeff,
                      tcomp=rs.uniform(0.1, 0.11, n).astype(np.float32),
                      bs_bw=np.ones(m, np.float32),
                      necessary=rs.random(n) < 0.2)
        key = torch.tensor([0, seed])
        res = {}
        for d in ("cpu", dev):
            prob = SchedulingProblem(
                min_participants=int(math.ceil(0.5 * n)),
                **{k: torch.tensor(v, device=d) for k, v in arrays.items()})
            res[str(d)] = dagsa_jit.dagsa_schedule_jit(prob, key.to(d))
        cpu, gpu = res["cpu"], res[str(dev)]
        assert torch.equal(cpu.assign, gpu.assign.cpu())
        torch.testing.assert_close(gpu.bs_time.cpu(), cpu.bs_time,
                                   rtol=1e-5, atol=1e-7)


def test_host_dagsa_run_on_card_matches_cpu(dev):
    """FLConfig's default scheduler, the host greedy, on the card: its
    Eq. (12) split launches kernel 1; decisions equal the CPU run's."""
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                   n_test=40, local_epochs=1, batch_size=10, seed=7,
                   scheduler="dagsa")
    _lib.reset_launches()
    gpu = FLSimulation(cfg, device=dev).run(2)
    assert _lib.LAUNCHES["bandwidth_solve"] == 2, _lib.LAUNCHES
    assert _lib.LAUNCHES["fedavg_reduce"] > 0, _lib.LAUNCHES
    cpu = FLSimulation(cfg, device="cpu").run(2)
    for g, c in zip(gpu, cpu):
        assert (g.n_selected, g.min_part_rate) == (c.n_selected,
                                                   c.min_part_rate)
        assert math.isclose(g.t_round, c.t_round, rel_tol=1e-5)
        assert abs(g.test_acc - c.test_acc) <= 1.0 / 40 + 1e-9


def test_small_run_on_card_matches_cpu(dev):
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                   n_test=40, local_epochs=1, batch_size=10, seed=7,
                   scheduler="dagsa_jit")
    _lib.reset_launches()
    gpu = FLSimulation(cfg, device=dev).run(3)
    for name in ("bandwidth_solve", "masked_bs_argmax", "best_bs_argmax",
                 "fedavg_reduce"):                 # the sync path's kernels
        assert _lib.LAUNCHES[name] > 0, _lib.LAUNCHES
    cpu = FLSimulation(cfg, device="cpu").run(3)
    for g, c in zip(gpu, cpu):
        assert (g.n_selected, g.min_part_rate) == (c.n_selected,
                                                   c.min_part_rate)
        assert math.isclose(g.t_round, c.t_round, rel_tol=1e-5)
        assert abs(g.test_acc - c.test_acc) <= 1.0 / 40 + 1e-9


def test_small_hierarchical_compressed_run_on_card_matches_cpu(dev):
    # a tensor-step scheduler: as in JAX, the host greedy's eager mode
    # has no hierarchical aggregation or compressed uplink
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                   n_test=40, local_epochs=1, batch_size=10, seed=7,
                   scheduler="dagsa_jit",
                   aggregation="hierarchical", tau_global=2,
                   compress="topk-int8", topk_frac=0.1)
    _lib.reset_launches()
    gpu = FLSimulation(cfg, device=dev).run(3)
    for name in ("sparsify_quantize", "fedavg_segment_reduce_int8"):
        assert _lib.LAUNCHES[name] > 0, _lib.LAUNCHES
    cpu = FLSimulation(cfg, device="cpu").run(3)
    for g, c in zip(gpu, cpu):
        assert (g.n_selected, g.min_part_rate, g.handover_rate) == \
            (c.n_selected, c.min_part_rate, c.handover_rate)
        assert math.isclose(g.t_round, c.t_round, rel_tol=1e-5)
        assert abs(g.test_acc - c.test_acc) <= 1.0 / 40 + 1e-9



def _tree_on(tree, d):
    return {k: {leaf: v.to(d) for leaf, v in sub.items()}
            for k, sub in tree.items()}


def test_fedavg_reduce_weighted_clip_nan_on_card_matches_cpu(dev):
    """Kernel 4 as the faulty async tick calls it: staleness weights,
    clip_norm, a NaN client, an Inf client and a masked-out client; the
    wrapper on the card against the same call on the CPU (the plain
    version) and against server.fedavg."""
    from repro_torch.fl import server
    from repro_torch.models import cnn
    gen = torch.Generator().manual_seed(3)
    g = cnn.init(torch.tensor([0, 5]), cnn.CNNConfig.paper_scale())
    n = 50
    clients = {k: {leaf: v[None] + 0.05 * torch.randn(
        (n,) + tuple(v.shape), generator=gen) for leaf, v in sub.items()}
        for k, sub in g.items()}
    clients["fc1"]["w"][4, 0, 0] = float("nan")
    clients["conv1"]["b"][9, 1] = float("inf")
    clients["fc2"]["w"][11] *= 1e3                 # clipped
    delivered = torch.rand((n,), generator=gen) < 0.7
    delivered[[4, 9, 11]] = True
    delivered[20] = False
    sizes = torch.randint(50, 150, (n,), generator=gen, dtype=torch.int32)
    weights = server.staleness_weights(torch.randint(0, 3, (n,),
                                                     generator=gen), 0.5)
    want = server.fedavg(g, clients, delivered, sizes, clip_norm=25.0,
                         weights=weights)
    cpu = kf.fedavg_reduce(g, clients, delivered, sizes, clip_norm=25.0,
                           weights=weights)
    before = _lib.LAUNCHES["fedavg_reduce"]
    got = kf.fedavg_reduce(_tree_on(g, dev), _tree_on(clients, dev),
                           delivered.to(dev), sizes.to(dev), clip_norm=25.0,
                           weights=weights.to(dev))
    assert _lib.LAUNCHES["fedavg_reduce"] - before == 8     # a leaf each
    for k in want:
        for leaf in want[k]:
            assert torch.isfinite(got[k][leaf]).all()
            torch.testing.assert_close(got[k][leaf].cpu(), cpu[k][leaf],
                                       rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(got[k][leaf].cpu(), want[k][leaf],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [1, 4, 8, 33])
def test_baselines_best_bs_route_on_card(dev, m):
    """Every baseline's best-BS choice is kernel 3 on the card: equal to
    torch.argmax (lowest index on a tie) and to the CPU run's decisions."""
    from repro_torch.core import baselines
    from repro_torch.core import scheduler as sched
    rs = _rs(m)
    n = 50
    snr = (10.0 ** rs.uniform(0, 4, (n, m))
           * rs.exponential(size=(n, m))).astype(np.float32)
    snr[7] = snr[3]
    snr[:, m - 1] = snr[:, 0]                       # ties go to BS 0
    sel = torch.tensor(rs.random(n) < 0.6)
    before = _lib.LAUNCHES["best_bs_argmax"]
    got = baselines._best_bs_assign(torch.tensor(snr, device=dev),
                                    sel.to(dev))
    assert _lib.LAUNCHES["best_bs_argmax"] == before + 1
    want = torch.nn.functional.one_hot(torch.argmax(torch.tensor(snr), 1),
                                       m).bool() & sel[:, None]
    assert torch.equal(got.cpu(), want)
    arrays = dict(snr=snr,
                  coeff=(0.5 / np.maximum(np.log2(1 + snr), 1e-9)
                         ).astype(np.float32),
                  tcomp=rs.uniform(0.1, 0.11, n).astype(np.float32),
                  bs_bw=np.ones(m, np.float32),
                  necessary=rs.random(n) < 0.2)
    cfg = WirelessConfig(n_users=n, n_bs=m)
    for name in ("rs", "ub", "sa", "fedcs_low", "fedcs_high"):
        res = {}
        for d in ("cpu", dev):
            prob = SchedulingProblem(
                min_participants=25,
                **{k: torch.tensor(v, device=d) for k, v in arrays.items()})
            res[str(d)] = sched.schedule(name, prob, cfg,
                                         torch.tensor([0, m], device=d))
        cpu, gpu = res["cpu"], res[str(dev)]
        assert torch.equal(cpu.assign, gpu.assign.cpu()), name
        torch.testing.assert_close(gpu.bs_time.cpu(), cpu.bs_time,
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("extra", [
    dict(scheduler="fedcs_low"),
    dict(scheduler="dagsa-r", faults="faulty-uplink"),
    dict(scheduler="dagsa_jit", aggregation_async=True, tick_s=0.5,
         staleness_alpha=0.5),
    dict(scheduler="dagsa-r", faults="faulty-uplink", aggregation_async=True,
         tick_s=0.5, staleness_alpha=0.5),
], ids=["engine_fedcs", "engine_faulty", "engine_async",
        "engine_faulty_async"])
def test_small_fault_and_async_runs_on_card_match_cpu(dev, extra):
    """The four golden configs of this slice, 3 rounds on the card and on
    the CPU: counts exact, times within rtol 1e-5."""
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                   n_test=40, local_epochs=1, batch_size=10, seed=7, **extra)
    _lib.reset_launches()
    gpu = FLSimulation(cfg, device=dev).run(3)
    # FedCS splits evenly: no Eq. (11) solve
    needs = ("best_bs_argmax", "fedavg_reduce") + (
        () if extra["scheduler"] == "fedcs_low" else ("bandwidth_solve",))
    for name in needs:
        assert _lib.LAUNCHES[name] > 0, _lib.LAUNCHES
    cpu = FLSimulation(cfg, device="cpu").run(3)
    for g, c in zip(gpu, cpu):
        assert (g.n_selected, g.min_part_rate, g.n_delivered, g.n_inflight,
                g.n_dropped) == (c.n_selected, c.min_part_rate,
                                 c.n_delivered, c.n_inflight, c.n_dropped)
        for f in ("t_round", "delivered_rate", "goodput_mbit_s"):
            a, b = getattr(g, f), getattr(c, f)
            assert math.isclose(a, b, rel_tol=1e-5) or (a != a and b != b), f
        assert abs(g.test_acc - c.test_acc) <= 1.0 / 40 + 1e-9

# ------------------------------------------------ the fused round engine --
def _small_cfg(**extra) -> FLConfig:
    return FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                    n_test=40, local_epochs=1, batch_size=10, seed=7,
                    **{"scheduler": "dagsa_jit", **extra})


def _same_record(a, b) -> bool:
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    return all(da[k] == db[k] or (da[k] != da[k] and db[k] != db[k])
               for k in da)


def test_device_while_node(dev):
    """A WHILE node's body runs as many passes as the device flag asks,
    with no host sync, at each replay of the graph that holds it."""
    x = torch.zeros((), dtype=torch.int32, device=dev)
    lim = torch.full((), 5, dtype=torch.int32, device=dev)
    y = torch.zeros((3,), device=dev)
    g = torch.cuda.CUDAGraph()
    with graph_while.recording() as nodes, torch.cuda.graph(g):
        x.zero_()
        y.zero_()

        def body():
            x.add_(1)
            y.add_(x.float())
        graph_while.device_while(lambda: x < lim, body)
    for n in (5, 0, 7, 5):
        lim.fill_(n)
        g.replay()
        assert int(x) == n and int(nodes[0][0]) == n
        assert y.tolist() == [n * (n + 1) / 2] * 3


@pytest.mark.parametrize("extra", [
    dict(), dict(compute="selected"),
    dict(aggregation="hierarchical", tau_global=2, compress="topk-int8",
         topk_frac=0.1),
    dict(scheduler="dagsa-r", faults="faulty-uplink"), dict(scheduler="ucb"),
], ids=["sync", "selected", "hier_int8", "faulty", "ucb"])
def test_fused_run_equals_step_bit_for_bit(dev, extra):
    """Captured rounds replay the step's kernels: records and parameters
    equal bit for bit, launch counts equal, also across a fused run that
    continues a step run and a step run that continues it."""
    cfg = _small_cfg(**extra)
    step = FLSimulation(cfg, device=dev)
    _lib.reset_launches()
    want = step.run(5, mode="step")
    step_launches = dict(_lib.LAUNCHES)
    fused = FLSimulation(cfg, device=dev)
    _lib.reset_launches()
    got = fused.run(5, mode="fused")
    assert dict(_lib.LAUNCHES) == step_launches
    mixed = FLSimulation(cfg, device=dev)
    got_mixed = (mixed.run(2, mode="step") + mixed.run(2, mode="fused")
                 + mixed.run(1, mode="step"))
    for a, b, c in zip(want, got, got_mixed):
        assert _same_record(a, b) and _same_record(a, c), (a, b, c)
    for sim in (fused, mixed):
        for k in step.params:
            for leaf in step.params[k]:
                assert torch.equal(step.params[k][leaf],
                                   sim.params[k][leaf]), (k, leaf)


def test_fused_capture_failure_raises(dev, monkeypatch):
    """A round that reads the device on the host cannot be captured: the
    run raises, after the warm-up and the capture attempt alone, and does
    not fall back to the host loop."""
    from repro_torch.fl import rounds as fl_rounds
    real = fl_rounds.cnn.accuracy
    calls = []

    def syncing(params, x, y):
        acc = real(params, x, y)
        calls.append(torch.cuda.is_current_stream_capturing())
        float(acc)                      # a host read a capture refuses
        return acc

    monkeypatch.setattr(fl_rounds.cnn, "accuracy", syncing)
    sim = FLSimulation(_small_cfg(), device=dev)
    with pytest.raises(RuntimeError):
        sim.run(2, mode="fused")
    assert calls == [False, True]
    assert sim.round_idx == 0 and sim.fused.n_graphs == 0
    torch.cuda.synchronize()


def _greedy_problem(seed, n, m):
    """test_torch_dagsa's paper-like round (that module imports jax):
    path-loss-spread Rayleigh SNR, S = 0.5 Mbit."""
    rs = np.random.default_rng(seed)
    mean = 10.0 ** rs.uniform(0.0, 4.0, (n, m))
    snr = (mean * rs.exponential(size=(n, m))).astype(np.float32)
    coeff = (np.float32(0.5) / np.maximum(np.log2(1.0 + snr), 1e-9)
             ).astype(np.float32)
    tcomp = rs.uniform(0.10, 0.11, n).astype(np.float32)
    bs_bw = (np.ones(m) if seed % 2 else rs.uniform(0.5, 1.5, m)
             ).astype(np.float32)
    necessary = rs.random(n) < (0.0 if seed % 5 == 0 else 0.2)
    return snr, coeff, tcomp, bs_bw, necessary, int(math.ceil(0.5 * n))


@pytest.mark.parametrize("n,m", [(12, 4), (50, 8), (30, 1), (40, 5)])
def test_captured_greedy_equals_host_loop(dev, n, m):
    """The greedy captured into a CUDA graph (its loop a WHILE node) takes
    the host loop's steps: on test_torch_dagsa's 80 problems, one at a
    time and as a fleet of 20, assignments, selections, bandwidths and
    times bit-equal, the node's passes one a step of the longest greedy."""
    probs = [_greedy_problem(seed, n, m) for seed in range(20)]
    cols = list(zip(*probs))
    keys = torch.stack([torch.tensor([0, seed], dtype=torch.int64)
                        for seed in range(20)]).to(dev)
    for i in list(range(20)) + [None]:
        pick = ((lambda c: torch.from_numpy(np.stack(c)).to(dev))
                if i is None else
                (lambda c, i=i: torch.from_numpy(np.asarray(c[i]))[None]
                 .to(dev)))
        args = tuple(pick(c) for c in cols[:5]) + (
            probs[0][5], keys if i is None else keys[i][None])
        host = dagsa_jit._schedule_batch(*args)
        graph = torch.cuda.CUDAGraph()
        with graph_while.recording() as nodes, torch.cuda.graph(graph):
            loop = dagsa_jit._schedule_batch(*args)
        for o in loop:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for h, g in zip(host, loop):
            assert torch.equal(h, g), f"problem {i} (N={n}, M={m})"
        steps = host[1].sum(dim=-1) - args[4].sum(dim=-1)
        assert len(nodes) == 1 and int(nodes[0][0]) == int(steps.max()), i


def test_fused_params_kept_across_runs_are_unchanged(dev):
    """Parameters a caller keeps from one fused run stay as they were
    while the next run replays (each run hands back its own copy)."""
    sim = FLSimulation(_small_cfg(aggregation="hierarchical", tau_global=2),
                       device=dev)
    sim.run(2, mode="fused")
    kept = sim.params, sim.edge_params
    frozen = [{k: {leaf: p.clone() for leaf, p in sub.items()}
               for k, sub in tree.items()} for tree in kept]
    sim.run(2, mode="fused")
    torch.cuda.synchronize()
    for tree, want in zip(kept, frozen):
        for k in want:
            for leaf in want[k]:
                assert torch.equal(tree[k][leaf], want[k][leaf]), (k, leaf)
    assert any(not torch.equal(sim.params[k][leaf], frozen[0][k][leaf])
               for k in frozen[0] for leaf in frozen[0][k])


def test_second_fused_run_replays(dev):
    """A second run() replays the graph captured by the first: no new
    capture, no call of the round step."""
    sim = FLSimulation(_small_cfg(), device=dev)
    sim.run(2, mode="fused")
    assert sim.fused.n_graphs == 1 and sim.fused.replays == 2
    capture_s = sim.fused.capture_s
    calls = []
    step_fn = sim.fused._step_fn
    sim.fused._step_fn = lambda *a: calls.append(1) or step_fn(*a)
    recs = sim.run(3, mode="fused")
    assert [r.round_idx for r in recs] == [3, 4, 5]
    assert calls == [] and sim.fused.n_graphs == 1
    assert sim.fused.replays == 5 and sim.fused.capture_s == capture_s
    assert len(sim.greedy_steps) == 3 and min(sim.greedy_steps) > 0


_ASYNC = dict(aggregation_async=True, tick_s=0.5, staleness_alpha=0.5)


@pytest.mark.parametrize("extra", [
    dict(_ASYNC), dict(_ASYNC, scheduler="dagsa-r", faults="faulty-uplink"),
    dict(_ASYNC, scheduler="dagsa-r", faults="faulty-uplink",
         compute="selected", select_cap=4),
], ids=["async", "faulty_async", "faulty_async_selected"])
def test_captured_async_run_equals_host_tick_loop(dev, extra):
    """run(5, mode="async") replays captured ticks: counts and records
    equal the host tick loop's over the same state (``_run_host``),
    parameters bit-equal, launch counts equal, one graph and 5 replays."""
    cfg = _small_cfg(**extra)
    host = FLSimulation(cfg, device=dev)
    _lib.reset_launches()
    want = host._run_host(5)
    host_launches = dict(_lib.LAUNCHES)
    sim = FLSimulation(cfg, device=dev)
    _lib.reset_launches()
    got = sim.run(5, mode="async")
    assert dict(_lib.LAUNCHES) == host_launches
    assert sim.fused.n_graphs == 1 and sim.fused.replays == 5
    assert any(r.n_delivered > 0 for r in got)
    for a, b in zip(want, got):
        assert _same_record(a, b), (a, b)
    for k in host.params:
        for leaf in host.params[k]:
            assert torch.equal(host.params[k][leaf], sim.params[k][leaf]), \
                (k, leaf)


def test_async_capture_failure_raises(dev, monkeypatch):
    """A tick that reads the device on the host cannot be captured: the
    async run raises after the warm-up and the capture attempt, and the
    run does not advance."""
    from repro_torch.fl import rounds as fl_rounds
    real = fl_rounds.async_queue_step
    calls = []

    def syncing(*args, **kw):
        out = real(*args, **kw)
        calls.append(torch.cuda.is_current_stream_capturing())
        int(out[4]["n_delivered"])          # a host read a capture refuses
        return out

    monkeypatch.setattr(fl_rounds, "async_queue_step", syncing)
    sim = FLSimulation(_small_cfg(**_ASYNC), device=dev)
    with pytest.raises(RuntimeError):
        sim.run(2, mode="async")
    assert calls == [False, True]
    assert sim.round_idx == 0 and sim.fused.n_graphs == 0
    torch.cuda.synchronize()


_BUCKETS = [
    ("sync", ["paper-default"], dict(), 1, 1),
    ("hier", ["paper-default"], dict(aggregation="hierarchical",
                                     tau_global=2), 1, 2),
    ("faulty_async", ["faulty-uplink"], dict(scheduler="dagsa-r", **_ASYNC),
     1, 1),
    ("ucb", ["paper-default"], dict(scheduler="ucb"), 1, 1),
    ("selected", ["paper-default"], dict(compute="selected", select_cap=4),
     1, 1),
    ("topk_int8", ["paper-default"], dict(compress="topk-int8",
                                          topk_frac=0.1), 1, 1),
    ("int8_plane", ["paper-default"], dict(channel_dtype="int8"), 1, 1),
    ("bf16_plane", ["high-mobility"], dict(channel_dtype="bf16"), 1, 1),
    ("worlds", ["hetero-compute", "non-iid-pathological", "shadowed"],
     dict(user_chunk=5), 2, 1),
]


@pytest.mark.parametrize("names,extra,buckets,graphs",
                         [c[1:] for c in _BUCKETS],
                         ids=[c[0] for c in _BUCKETS])
def test_captured_learning_bucket_equals_host_route(dev, names, extra,
                                                    buckets, graphs,
                                                    monkeypatch):
    """Learning buckets of two seeds a scenario captured and replayed once
    a round: records equal to the sweep's uncaptured route on the card,
    one graph a pattern, each bucket released at its end."""
    from repro_torch.fl import fused
    from repro_torch.launch import sweep

    kw = dict(cfg=WirelessConfig(n_users=12, n_bs=4), n_seeds=2,
              n_rounds=3, n_train=120, n_test=40, local_epochs=1,
              batch_size=10, seed=7, device=dev, **extra)
    engines = []
    real_release = fused.FusedRounds.release

    def release(self):
        engines.append((self.n_graphs, self.replays))
        real_release(self)

    monkeypatch.setattr(fused.FusedRounds, "release", release)
    got = sweep.run_learning_sweep(names, **kw)
    assert engines == [(graphs, 3)] * buckets
    monkeypatch.setattr(sweep, "_run_bucket", sweep._run_bucket_host)
    want = sweep.run_learning_sweep(names, **kw)
    assert chip_smoke._same_json(got, want)


_WIRELESS_BUCKETS = [
    ("f32", ["paper-default", "dense-bs", "sparse-bs"], dict(), 3),
    ("bf16", ["paper-default", "high-mobility"], dict(channel_dtype="bf16"),
     1),
    ("int8", ["paper-default", "high-mobility"], dict(channel_dtype="int8"),
     1),
    ("chunk_shadowed", ["paper-default", "shadowed"], dict(user_chunk=16),
     1),
]


@pytest.mark.parametrize("names,extra,buckets",
                         [c[1:] for c in _WIRELESS_BUCKETS],
                         ids=[c[0] for c in _WIRELESS_BUCKETS])
def test_captured_wireless_bucket_equals_host_route(dev, names, extra,
                                                    buckets, monkeypatch):
    """Wireless buckets at the paper's width (50 users, 2 seeds a
    scenario, 4 rounds) captured and replayed once a round: one graph and
    4 replays a bucket, records JSON-equal to the sweep's uncaptured route
    on the card, derived launches equal to its counted ones, and each
    bucket's WHILE passes equal to its host greedy steps (kernel 2's
    launches less kernel 3's)."""
    from repro_torch.fl import fused
    from repro_torch.launch import sweep

    kw = dict(n_seeds=2, n_rounds=4, seed=7, device=dev, **extra)
    engines, passes, steps = [], [], []
    real_run, real_release = fused.FusedRounds.run, fused.FusedRounds.release

    def run(self, *args):
        state, cols = real_run(self, *args)
        passes.append(int(cols["greedy_steps"].sum()))
        return state, cols

    def release(self):
        engines.append((self.n_graphs, self.replays))
        real_release(self)

    def host_route(*args):
        before = dict(_lib.LAUNCHES)
        out = sweep._run_bucket_host(*args)
        steps.append(sum(sign * (_lib.LAUNCHES[k] - before[k])
                         for sign, k in ((1, "masked_bs_argmax"),
                                         (-1, "best_bs_argmax"))))
        return out

    monkeypatch.setattr(fused.FusedRounds, "run", run)
    monkeypatch.setattr(fused.FusedRounds, "release", release)
    _lib.reset_launches()
    got = sweep.run_sweep(names, **kw)
    captured = dict(_lib.LAUNCHES)
    assert engines == [(1, 4)] * buckets
    monkeypatch.setattr(sweep, "_run_bucket", host_route)
    _lib.reset_launches()
    want = sweep.run_sweep(names, **kw)
    assert chip_smoke._same_json(got, want)
    assert captured == dict(_lib.LAUNCHES)
    assert passes == steps and min(steps) > 0, (passes, steps)


def test_released_buckets_give_their_memory_back(dev, monkeypatch):
    """A released bucket's graphs, the pools of their device loops' bodies
    and the buffers the captures kept go back to the card: over learning
    and wireless sweeps of two buckets each, the memory reserved after
    ``empty_cache`` stays flat.  With the holder's release disabled the
    body pools stay, and the same reading grows (the check sees a
    leak)."""
    from repro_torch.launch import sweep

    names = ["hetero-compute", "non-iid-pathological", "shadowed"]
    kw = dict(cfg=WirelessConfig(n_users=12, n_bs=4), n_seeds=2,
              n_rounds=2, n_train=120, n_test=40, local_epochs=1,
              batch_size=10, seed=7, device=dev)
    # a wireless sweep of two buckets too (4 and 16 BSs)
    wireless = dict(cfg=WirelessConfig(n_users=12, n_bs=4), n_seeds=2,
                    n_rounds=2, seed=7, device=dev)

    def sweeps():
        sweep.run_learning_sweep(names, **kw)
        sweep.run_sweep(["paper-default", "dense-bs", "shadowed"],
                        **wireless)

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    sweeps()                                     # lazy state, workspaces
    base = reserved()
    for _ in range(2):
        sweeps()
    grown = reserved() - base
    monkeypatch.setattr(_lib.Held, "release", lambda self: None)
    for _ in range(2):
        sweeps()
    leaked = reserved() - base - grown
    mib = 1 << 20
    assert grown <= 4 * mib, (grown, leaked)
    assert leaked >= 8 * mib, (grown, leaked)


# ------------------------------------------------ the LM kernels (7-9) --
_TOL = {"rmsnorm": (1e-6, 2e-2), "flash": (2e-5, 2e-2), "ssd": (2e-4, 5e-2)}


def _assert_close(got, want, kernel, dtype):
    tol = _TOL[kernel][dtype == torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _normal(gen, shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2048), (16384, 2048), (4, 1, 2048),
                                   (3, 7, 256), (1000, 512), (33, 64),
                                   (37, 128), (9, 200), (2, 5, 4096),
                                   (7, 8192), (1, 6)])
def test_rmsnorm(dev, dtype, shape):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = _normal(gen, shape, dev, dtype)
    scale = (1.0 + 0.1 * _normal(gen, shape[-1:], dev)).to(dtype)
    before = _lib.LAUNCHES["rmsnorm"]
    got = krn.rmsnorm(x, scale)
    assert _lib.LAUNCHES["rmsnorm"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_close(got, krn.rmsnorm_plain(x, scale), "rmsnorm", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("d", [128, 2048])
def test_rmsnorm_unaligned(dev, dtype, offset, d):
    """Contiguous x and scale whose data_ptr is ``offset`` entries (2 or 4
    bytes in bfloat16, 4 or 8 in float32) off 16-byte alignment: slices
    of larger buffers take the scalar path."""
    gen = torch.Generator(device=dev).manual_seed(d + offset)
    rows = 37
    x = _normal(gen, (rows * d + offset,), dev, dtype)[offset:].view(rows, d)
    scale = (1.0 + 0.1 * _normal(gen, (d + offset,), dev)).to(dtype)[offset:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    before = _lib.LAUNCHES["rmsnorm"]
    got = krn.rmsnorm(x, scale)
    assert _lib.LAUNCHES["rmsnorm"] == before + 1
    _assert_close(got, krn.rmsnorm_plain(x, scale), "rmsnorm", dtype)
    got_x = krn.rmsnorm(x, scale.clone())      # only x off alignment
    _assert_close(got_x, krn.rmsnorm_plain(x, scale), "rmsnorm", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d", [
    (4, 512, 32, 32, 64),     # Zamba2's shared block
    (2, 256, 8, 2, 64),       # GQA 4:1
    (1, 200, 4, 4, 64),       # ragged S = T = 200
    (2, 300, 16, 8, 128),     # GQA G = 2, D = 128 (Qwen3's head)
    (1, 128, 2, 2, 128),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(dev, dtype, b, s, h, kv, d, causal):
    gen = torch.Generator(device=dev).manual_seed(b * s + h)
    q = _normal(gen, (b, s, h, d), dev, dtype)
    k = _normal(gen, (b, s, kv, d), dev, dtype)
    v = _normal(gen, (b, s, kv, d), dev, dtype)
    before = _lib.LAUNCHES["flash_attention"]
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert _lib.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype
    _assert_close(got, kfa.flash_attention_plain(q, k, v, causal=causal),
                  "flash", dtype)


@pytest.mark.parametrize("b,s,t,h,kv,d,causal", [
    (8, 2048, 2048, 32, 32, 64, True),   # Zamba2's long prefill
    (2, 1024, 1024, 16, 8, 128, True),   # D = 128, GQA 2:1
    (1, 65, 65, 4, 4, 64, True),         # one row past a tile
    (2, 65, 65, 4, 2, 128, True),
    (1, 100, 333, 4, 4, 64, False),      # ragged T
    (2, 130, 333, 8, 4, 128, False),
])
def test_flash_attention_bf16_tiles(dev, b, s, t, h, kv, d, causal):
    """The bf16 tensor-core kernel at the prefill shape, D = 128, and ragged
    query and key edges."""
    gen = torch.Generator(device=dev).manual_seed(b * s + t + d)
    q = _normal(gen, (b, s, h, d), dev, torch.bfloat16)
    k = _normal(gen, (b, t, kv, d), dev, torch.bfloat16)
    v = _normal(gen, (b, t, kv, d), dev, torch.bfloat16)
    before = _lib.LAUNCHES["flash_attention"]
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert _lib.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.bfloat16
    _assert_close(got, kfa.flash_attention_plain(q, k, v, causal=causal),
                  "flash", torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,d", [
    (1, 100, 333, 4, 4, 64),
    (4, 1, 80, 6, 6, 64),     # whisper's decode step over a served memory
    (4, 1, 1500, 6, 6, 64),   # ... over 1,500 encoder frames
    (4, 1, 333, 16, 8, 128),  # one query, GQA 2:1
])
def test_flash_attention_cross_shape(dev, dtype, b, s, t, h, kv, d):
    """Non-causal with T != S (keys past a ragged T masked), down to one
    query a sequence (S = 1), as a decode step's cross attention calls
    it."""
    gen = torch.Generator(device=dev).manual_seed(s + t + h)
    q = _normal(gen, (b, s, h, d), dev, dtype)
    k = _normal(gen, (b, t, kv, d), dev, dtype)
    v = _normal(gen, (b, t, kv, d), dev, dtype)
    _assert_close(kfa.flash_attention(q, k, v, causal=False),
                  kfa.flash_attention_plain(q, k, v, causal=False), "flash",
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d", [
    (2, 300, 8, 4, 64),       # ragged S, GQA 2:1
    (1, 512, 16, 8, 128),     # qwen3-0.6b's heads
    (2, 130, 6, 6, 64),       # whisper's MHA
])
@pytest.mark.parametrize("window", [1, 16, 100, "S", "past S"])
def test_flash_attention_window(dev, dtype, b, s, h, kv, d, window):
    """The causal sliding window (key tiles before a query tile's window
    skipped) against the plain version's mask, from one key a query to
    a window at or past S (the plain causal mask)."""
    w = {"S": s, "past S": s + 50}.get(window, window)
    gen = torch.Generator(device=dev).manual_seed(b * s + h + w)
    q = _normal(gen, (b, s, h, d), dev, dtype)
    k = _normal(gen, (b, s, kv, d), dev, dtype)
    v = _normal(gen, (b, s, kv, d), dev, dtype)
    before = _lib.LAUNCHES["flash_attention"]
    got = kfa.flash_attention(q, k, v, causal=True, window=w)
    assert _lib.LAUNCHES["flash_attention"] == before + 1
    want = kfa.flash_attention_plain(q, k, v, causal=True, window=w)
    _assert_close(got, want, "flash", dtype)
    if w >= s:
        _assert_close(got, kfa.flash_attention_plain(q, k, v, causal=True),
                      "flash", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank,rope", [(512, 64), (32, 16)])
def test_rmsnorm_on_mla_latent_slice(dev, dtype, rank, rope):
    """MLA's kv_norm: the latent slice of ``x @ wkv_a`` is a strided view,
    which the kernel refuses; made contiguous, it matches the plain
    version on the view."""
    gen = torch.Generator(device=dev).manual_seed(rank)
    kv_a = _normal(gen, (2, 40, rank + rope), dev, dtype)
    scale = (1.0 + 0.1 * _normal(gen, (rank,), dev)).to(dtype)
    view = kv_a[..., :rank]
    with pytest.raises(ValueError, match="contiguous"):
        krn.rmsnorm(view, scale)
    before = _lib.LAUNCHES["rmsnorm"]
    got = krn.rmsnorm(view.contiguous(), scale)
    assert _lib.LAUNCHES["rmsnorm"] == before + 1
    _assert_close(got, krn.rmsnorm_plain(view, scale), "rmsnorm", dtype)


@pytest.mark.parametrize("arch,required", [
    (arch, required) for arch, _, required in chip_smoke.LM_ARCHS],
    ids=[arch for arch, _, _ in chip_smoke.LM_ARCHS])
def test_lm_config_small_run_on_card_matches_cpu(dev, arch, required):
    """Each reduced float32 config: forward, prefill and 8 cached decode
    steps on the card against the CPU (Whisper also with the encoder's
    memory in the cache), within 1e-4, through the kernels its path
    reaches (chip_smoke.py's check (a))."""
    chip_smoke.check_lm_small(arch, dev, required)


def _ssd_inputs(gen, dev, b, s, h, p, n, dtype, g=1):
    x = _normal(gen, (b, s, h, p), dev, dtype)
    dt = torch.nn.functional.softplus(_normal(gen, (b, s, h), dev))
    A = -torch.exp(_normal(gen, (h,), dev) * 0.5)
    B = _normal(gen, (b, s, g, n), dev, dtype)
    C = _normal(gen, (b, s, g, n), dev, dtype)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (4, 512, 64, 64, 64, 128),     # Zamba2's Mamba2 layer
    (2, 256, 4, 64, 16, 64),
    (1, 128, 2, 32, 8, 32),
    (2, 64, 16, 32, 16, 32),       # the reduced config's shape
])
def test_ssd_scan(dev, dtype, b, s, h, p, n, chunk):
    gen = torch.Generator(device=dev).manual_seed(b * s + h + n)
    x, dt, A, B, C = _ssd_inputs(gen, dev, b, s, h, p, n, dtype)
    before = _lib.LAUNCHES["ssd_scan"]
    got = kss.ssd_scan(x, dt, A, B, C, chunk)
    assert _lib.LAUNCHES["ssd_scan"] == before + 1
    assert got.dtype == torch.float32
    _assert_close(got, kss.ssd_scan_plain(x, dt, A, B, C, chunk), "ssd",
                  dtype)


def test_ssd_scan_groups_and_chunk_continuity(dev):
    """G = 2 groups read by head; chunk 32 equals chunk 128."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x, dt, A, B, C = _ssd_inputs(gen, dev, 1, 256, 4, 32, 16,
                                 torch.float32, g=2)
    y32 = kss.ssd_scan(x, dt, A, B, C, 32)
    y128 = kss.ssd_scan(x, dt, A, B, C, 128)
    plain = kss.ssd_scan_plain(x, dt, A, B.repeat_interleave(2, dim=2),
                               C.repeat_interleave(2, dim=2), 32)
    _assert_close(y32, plain, "ssd", torch.float32)
    _assert_close(y32, y128, "ssd", torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_state128(dev, dtype, chunk, g):
    """State 128 (mamba2-2.7b's) at every chunk, with G = 1 and 2 groups."""
    gen = torch.Generator(device=dev).manual_seed(chunk + g)
    h = 4
    x, dt, A, B, C = _ssd_inputs(gen, dev, 2, 256, h, 64, 128, dtype, g=g)
    got = kss.ssd_scan(x, dt, A, B, C, chunk)
    want = kss.ssd_scan_plain(x, dt, A, B.repeat_interleave(h // g, dim=2),
                              C.repeat_interleave(h // g, dim=2), chunk)
    _assert_close(got, want, "ssd", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [48, 80, 112])
def test_ssd_scan_chunk_not_multiple_of_32(dev, dtype, chunk):
    """A chunk that is a multiple of 16 and not of 32 ends on a 16-wide
    block of score columns.  A run on NaN inputs just before leaves NaN in
    the SMs' shared memory; none of it may reach y."""
    gen = torch.Generator(device=dev).manual_seed(chunk)
    xp, dtp, Ap, Bp, Cp = _ssd_inputs(gen, dev, 4, 128, 64, 64, 64, dtype)
    kss.ssd_scan(torch.full_like(xp, float("nan")), dtp, Ap, Bp, Cp, 128)
    x, dt, A, B, C = _ssd_inputs(gen, dev, 2, 4 * chunk, 8, 64, 64, dtype)
    got = kss.ssd_scan(x, dt, A, B, C, chunk)
    assert bool(torch.isfinite(got).all())
    _assert_close(got, kss.ssd_scan_plain(x, dt, A, B, C, chunk), "ssd",
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_graph_capture(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(21)
    x, dt, A, B, C = _ssd_inputs(gen, dev, 2, 512, 8, 64, 64, dtype)
    outs, counted = _replayed(lambda: kss.ssd_scan(x, dt, A, B, C, 128))
    assert counted == {"ssd_scan": 3}
    want = kss.ssd_scan(x, dt, A, B, C, 128)
    assert all(torch.equal(o, want) for o in outs)
    _assert_close(want, kss.ssd_scan_plain(x, dt, A, B, C, 128), "ssd", dtype)


def test_lm_wrappers_validate(dev):
    q = torch.rand((1, 64, 2, 64), device=dev)
    with pytest.raises(ValueError, match="S == T"):
        kfa.flash_attention(q, q[:, :32], q[:, :32], causal=True)
    with pytest.raises(TypeError):
        kfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        kfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            q, q)
    with pytest.raises(ValueError, match="D in"):
        kfa.flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                            q[..., :32].contiguous())
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention(q, q, q, causal=False, window=16)
    x = torch.rand((8, 256), device=dev)
    with pytest.raises(TypeError):
        krn.rmsnorm(x.double(), torch.ones(256, device=dev).double())
    with pytest.raises(ValueError):
        krn.rmsnorm(x.t(), torch.ones(8, device=dev))
    with pytest.raises(TypeError):
        krn.rmsnorm(x, torch.ones(256, device=dev, dtype=torch.bfloat16))
    gen = torch.Generator(device=dev).manual_seed(0)
    xs, dt, A, B, C = _ssd_inputs(gen, dev, 1, 64, 2, 32, 8, torch.float32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        kss.ssd_scan(xs, dt, A, B, C, 48)
    with pytest.raises(TypeError):
        kss.ssd_scan(xs, dt.double(), A, B, C, 32)
    with pytest.raises(ValueError):
        kss.ssd_scan(xs.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     B, C, 32)
    # past state 128 the kernels' limit is named (state 128 runs:
    # test_ssd_scan_state128)
    x3, dt3, A3, B3, C3 = _ssd_inputs(gen, dev, 1, 128, 1, 64, 256,
                                      torch.float32)
    with pytest.raises(ValueError, match="state N"):
        kss.ssd_scan(x3, dt3, A3, B3, C3, 128)


def test_zamba_small_run_on_card_matches_cpu(dev):
    """The reduced Zamba2 (and a 5-layer variant with a tail group), f32:
    prefill and 8 cached decode steps on the card against the CPU."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.models import api, lm
    from repro_torch.tree import tree_map

    base = get_config("zamba2_1_2b").reduced()
    for cfg in (base, dataclasses.replace(base, n_layers=5)):
        params = api.init_params(rng.PRNGKey(0), cfg)
        toks = rng.randint(rng.PRNGKey(1), (2, 41), 0, cfg.vocab)
        out = {}
        for d in ("cpu", dev):
            p = tree_map(lambda w: w.to(d), params)
            t = toks.to(d)
            _lib.reset_launches()
            logits, _ = lm.forward(p, cfg, {"tokens": t})
            pre = api.prefill_fn(p, cfg, {"tokens": t[:, :40]})
            cache = api.init_cache(cfg, 2, 8, device=d)
            steps = [api.decode_step(p, cfg, cache, t[:, i:i + 1], i)[0]
                     for i in range(8)]
            if str(d) != "cpu":
                for name in ("flash_attention", "rmsnorm", "ssd_scan"):
                    assert _lib.LAUNCHES[name] > 0, _lib.LAUNCHES
            out[str(d)] = [logits, pre, torch.stack(steps)]
        for c, g in zip(out["cpu"], out[str(dev)]):
            torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


def _scaled_plane(rs, n, m, dtype, dev):
    """[n, m] SNR in ``dtype`` with exact ties of ``snr * scale`` inside
    and across the lanes' words, a row of -inf (float planes), a row of
    one code, and the per-BS scale (int8: dB codes and a scale row with
    repeated entries, so equal codes in two columns tie)."""
    if dtype == torch.int8:
        q = rs.integers(-127, 128, (n, m))
        scale = np.repeat(rs.uniform(0.05, 0.5, (m + 1) // 2), 2)[:m]
        for r in range(0, n - 1, 5):
            c = r % m
            c2 = min(m - 1, c + 1 + (r % 3) * 8)
            if scale[c] == scale[c2]:
                q[r, c] = q[r, c2] = 127
        q[n - 1] = 3
        snr = torch.tensor(q, dtype=torch.int8, device=dev)
    else:
        v = 10.0 ** rs.uniform(-1, 4, (n, m))
        scale = rs.uniform(0.5, 2.0, m)
        scale[1::2] = scale[0::2][:m // 2]        # columns 2k, 2k + 1 share
        top = v.max() * 4
        for r in range(0, n - 1, 5):
            c = 2 * ((r // 2) % ((m + 1) // 2))
            if c + 1 < m:
                v[r, c] = v[r, c + 1] = top
        v[n - 1] = 5.0
        if n > 2:
            v[n - 2] = -np.inf                    # torch.argmax gives 0
        snr = torch.tensor(v, dtype=torch.float32, device=dev).to(dtype)
    return snr, torch.tensor(scale, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("n", [7, 2049])
@pytest.mark.parametrize("m", [1, 8, 33, 100])
def test_best_bs_argmax_scaled_planes(dev, dtype, n, m):
    """Kernel 3 on float32, bfloat16 and int8 planes, with and without a
    per-BS scale, against its plain version exactly: ties within a word
    and across words, a row of -inf, ragged N and M, and a plane off
    16-byte alignment; one launch a call."""
    snr, scale = _scaled_plane(_rs(n * m), n, m, dtype, dev)
    for sc in ((scale, None) if dtype != torch.int8 else (scale,)):
        want = ks.best_bs_argmax_plain(snr, sc)
        before = _lib.LAUNCHES["best_bs_argmax"]
        assert torch.equal(ks.best_bs_argmax(snr, sc), want), sc is None
        assert _lib.LAUNCHES["best_bs_argmax"] == before + 1
        buf = torch.empty(n * m + 3, dtype=dtype, device=dev)
        off = buf[3:].view(n, m)
        off.copy_(snr)
        assert off.data_ptr() % 16 != 0
        assert torch.equal(ks.best_bs_argmax(off, sc), want)


def test_best_bs_argmax_validates_scaled_inputs(dev):
    snr = torch.zeros((5, 3), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        ks.best_bs_argmax(snr.to(torch.int16), torch.ones(3, device=dev))
    with pytest.raises(ValueError):
        ks.best_bs_argmax(snr, torch.ones(4, device=dev))
    with pytest.raises(ValueError):
        ks.best_bs_argmax(snr, torch.ones(3))       # scale on the CPU


@pytest.mark.parametrize("channel_dtype", ["f32", "bf16", "int8"])
def test_small_sweep_on_card_matches_cpu(dev, channel_dtype):
    """A small wireless sweep (12 users, 4 BSs, 2 seeds, 3 rounds) of
    paper-default and high-mobility on the card against the CPU:
    ``n_selected`` exact, ``t_round`` within rtol 1e-5 (bf16: 1e-2, since
    one bfloat16 ulp of a coefficient, 0.4%, can round the other way when
    the two devices' float32 SNR differ by an ulp), and kernels 1-3 ran."""
    from repro_torch.launch import sweep

    kw = dict(n_seeds=2, n_rounds=3, cfg=WirelessConfig(n_users=12, n_bs=4),
              seed=7, channel_dtype=channel_dtype)
    names = ["paper-default", "high-mobility"]
    want = sweep.run_sweep(names, device="cpu", **kw)
    _lib.reset_launches()
    got = sweep.run_sweep(names, device=dev, **kw)
    for name in ("bandwidth_solve", "masked_bs_argmax", "best_bs_argmax"):
        assert _lib.LAUNCHES[name] > 0, _lib.LAUNCHES
    rtol = 1e-2 if channel_dtype == "bf16" else 1e-5
    for g, w in zip(got, want):
        assert g["curves"]["n_selected"] == w["curves"]["n_selected"]
        np.testing.assert_allclose(g["curves"]["t_round_s"],
                                   w["curves"]["t_round_s"], rtol=rtol)


# ------------------------------------------------------- the fleet axis ---
def _fleet_planes(f, n, m, dtype, dev, seed):
    """[F, N, M] planes of ``dtype`` (int8 dB codes, or bf16 / f32 values
    with ties), [F, M] scales (one negative a problem) and [F, N] masks."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int8:
        snr = torch.randint(-127, 128, (f, n, m), generator=gen, device=dev,
                            dtype=torch.int8)
    else:
        snr = (torch.rand((f, n, m), generator=gen, device=dev) * 8.0).round()
        snr = snr.to(dtype)                     # few values: many ties
    scale = torch.rand((f, m), generator=gen, device=dev) + 0.05
    scale[:, m // 2] = -scale[:, m // 2]
    rem = torch.rand((f, n), generator=gen, device=dev) < 0.5
    rem[f // 2] = False                         # a problem with no user left
    return snr, scale, rem


# [F, 50, 8]: one block a problem; [3, 7001, 33]: a grid a problem, each
# problem's plane off 4 and 16 bytes (int8 and bf16); [2, 70000, 100]:
# many blocks a problem
@pytest.mark.parametrize("f,n,m", [(36, 50, 8), (3, 7001, 33),
                                   (2, 70000, 100), (5, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_fleet_selection_kernels(dev, f, n, m, dtype):
    """Kernels 2 and 3 on a fleet, one launch each, against their plain
    versions and against F calls on the problems' [N, M] planes."""
    snr, scale, rem = _fleet_planes(f, n, m, dtype, dev, f * n + m)
    for sc in ((scale, None) if dtype != torch.int8 else (scale,)):
        before = dict(_lib.LAUNCHES)
        cand, best = ks.masked_bs_argmax(snr, rem, sc)
        bb = ks.best_bs_argmax(snr, sc)
        assert _lib.LAUNCHES["masked_bs_argmax"] == \
            before["masked_bs_argmax"] + 1
        assert _lib.LAUNCHES["best_bs_argmax"] == before["best_bs_argmax"] + 1
        pc, pb = ks.masked_bs_argmax_plain(snr, rem, sc)
        assert torch.equal(cand, pc) and torch.equal(best, pb)
        assert torch.equal(bb, ks.best_bs_argmax_plain(snr, sc))
        for i in range(f):
            s_i = None if sc is None else sc[i]
            c1, b1 = ks.masked_bs_argmax(snr[i], rem[i], s_i)
            assert torch.equal(cand[i], c1) and torch.equal(best[i], b1)
            assert torch.equal(bb[i], ks.best_bs_argmax(snr[i], s_i))
        assert (cand[f // 2] == 0).all() and torch.isinf(best[f // 2]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_fleet_best_bs_plane_off_alignment(dev, dtype):
    """A fleet whose first plane starts one code past 16 bytes: every
    problem's rows at their own offset, read in place."""
    f, n, m = 4, 333, 7
    snr, scale, _ = _fleet_planes(f, n, m, dtype, dev, 3)
    buf = torch.empty(f * n * m + 1, dtype=dtype, device=dev)
    off = buf[1:].view(f, n, m)
    off.copy_(snr)
    assert off.data_ptr() % 16 != 0
    for sc in (scale, None):
        assert torch.equal(ks.best_bs_argmax(off, sc),
                           ks.best_bs_argmax_plain(snr, sc))


def test_fleet_masked_bs_argmax_under_a_graph(dev):
    """Kernel 2 on a fleet of 4 [70000, 100] problems (107 blocks each,
    each problem its own keys and ticket) captured into a CUDA graph and
    replayed five times, then eager again."""
    f, n, m = 4, 70000, 100
    assert ks.masked_bs_plan(n, m, torch.float32, True)[4] > 1
    gen = torch.Generator(device=dev).manual_seed(8)
    snr = torch.rand((f, n, m), generator=gen, device=dev)
    rem = torch.rand((f, n), generator=gen, device=dev) < 0.5
    want = ks.masked_bs_argmax_plain(snr, rem)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ks.masked_bs_argmax(snr, rem)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        cand, best = ks.masked_bs_argmax(snr, rem)
    for _ in range(5):
        cand.zero_()
        best.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(cand, want[0]) and torch.equal(best, want[1])
    for _ in range(2):
        got = ks.masked_bs_argmax(snr, rem)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("f,k,u", [(36, 8, 50), (4, 8, 300), (2, 4, 20000)])
def test_fleet_bandwidth_solve(dev, f, k, u):
    """Kernel 1 on [F, K, U] rows with tcomp [F, U] (each read by its
    problem's K rows) in one launch, against the plain version and F 2-D
    calls: the warp, block and cluster paths."""
    rs = _rs(f + k + u)
    c, _, mask, bw, lo = _bw_inputs(rs, f * k, u, dev)
    coeff, mask = c.view(f, k, u), mask.view(f, k, u)
    bw, lo = bw.view(f, k), lo.view(f, k)
    tcomp = torch.tensor(rs.uniform(0.1, 0.11, (f, u)), dtype=torch.float32,
                         device=dev)
    mask[1, 0] = False                          # an empty row
    for method in ("newton", "bisect"):
        before = _lib.LAUNCHES["bandwidth_solve"]
        got = kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo, method=method)
        assert _lib.LAUNCHES["bandwidth_solve"] == before + 1
        want = kb.bandwidth_solve_fleet_plain(coeff, tcomp, mask, bw, lo=lo,
                                              method=method)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        for i in range(f):
            one = kb.bandwidth_solve(coeff[i], tcomp[i], mask[i], bw[i],
                                     lo=lo[i], method=method)
            torch.testing.assert_close(got[i], one, rtol=1e-5, atol=1e-7)
        assert got[1, 0].item() == 0.0


@pytest.mark.parametrize("channel_dtype", ["f32", "int8"])
def test_batched_greedy_on_card_matches_cpu(dev, channel_dtype):
    """The fleet greedy on 12 problems of 50 users x 8 BSs: assignments
    equal the CPU's, times rtol 1e-5; one best_bs_argmax launch a call."""
    from repro_torch.core import channel
    f, n, m = 12, 50, 8
    rs = _rs(11)
    snr = (10.0 ** rs.uniform(0, 4, (f, n, m))
           * rs.exponential(size=(f, n, m))).astype(np.float32)
    arrays = dict(tcomp=rs.uniform(0.1, 0.11, (f, n)).astype(np.float32),
                  bs_bw=rs.uniform(0.5, 1.5, (f, m)).astype(np.float32),
                  necessary=rs.random((f, n)) < 0.2)
    keys = torch.stack([torch.tensor([0, s]) for s in range(f)])
    res = {}
    for d in ("cpu", dev):
        t = {k: torch.tensor(v, device=d) for k, v in arrays.items()}
        plane = torch.tensor(snr, device=d)
        scale = None
        if channel_dtype == "int8":
            enc = [channel.encode_channel(p, "int8") for p in plane]
            plane = torch.stack([e[0] for e in enc])
            scale = torch.stack([e[1] for e in enc])
            lin = torch.stack([e[2] for e in enc])
        else:
            lin = plane
        coeff = channel.bandwidth_time_coeff(lin, WirelessConfig())
        before = _lib.LAUNCHES["best_bs_argmax"]
        res[str(d)] = dagsa_jit.dagsa_schedule_batch(
            SchedulingProblem(snr=plane, coeff=coeff, min_participants=25,
                              **t), keys.to(d), snr_scale=scale)
        if d == dev:
            assert _lib.LAUNCHES["best_bs_argmax"] == before + 1
    cpu, gpu = res["cpu"], res[str(dev)]
    assert torch.equal(cpu.assign, gpu.assign.cpu())
    torch.testing.assert_close(gpu.bs_time.cpu(), cpu.bs_time, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("scheduler", ["ucb", "biased-adaptive", "rr", "pf"])
def test_stateful_run_on_card_matches_cpu(dev, scheduler):
    """A stateful policy's small run (12 users, 4 BSs, 3 rounds): decisions
    and the carried estimates on the card equal the CPU's."""
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                   n_test=40, local_epochs=1, batch_size=10, seed=7,
                   scheduler=scheduler)
    _lib.reset_launches()
    gsim = FLSimulation(cfg, device=dev)
    gpu = gsim.run(3)
    for name in ("bandwidth_solve", "best_bs_argmax", "fedavg_reduce"):
        assert _lib.LAUNCHES[name] > 0, _lib.LAUNCHES
    csim = FLSimulation(cfg, device="cpu")
    cpu = csim.run(3)
    for g, c in zip(gpu, cpu):
        assert (g.n_selected, g.min_part_rate) == (c.n_selected,
                                                   c.min_part_rate)
        assert math.isclose(g.t_round, c.t_round, rel_tol=1e-5)
    gs, cs = gsim._state.sched, csim._state.sched
    for field in ("n_obs", "sel_count", "ptr", "t"):
        assert torch.equal(getattr(gs, field).cpu(), getattr(cs, field))
    for field in ("rate_sum", "tcomp_sum", "ewma"):
        torch.testing.assert_close(getattr(gs, field).cpu(),
                                   getattr(cs, field), rtol=1e-6, atol=0.0)


# ------------------------------------------ compute="selected" [cap] rows --
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("n,cap,m,d", [(50, 25, 8, 100352),
                                       (20000, 100, 100, 4608),
                                       (12, 6, 4, 1000), (50, 8, 8, 144)])
def test_fedavg_kernels_on_selected_rows(dev, dtype, n, cap, m, d):
    """Kernels 4 and 5 on the [cap] rows of a selected round (the
    scheduled clients first, padding of weight 0), where the plans key on
    the rows handed, not the fleet's N: against their plain versions."""
    from repro_torch.fl import client
    gen = torch.Generator(device=dev).manual_seed(n + cap)
    selected = torch.rand((n,), generator=gen, device=dev) < 0.3
    idx = client.topk_selected_indices(selected, cap)
    sizes = torch.randint(50, 150, (n,), generator=gen, device=dev)
    bs = torch.randint(0, m, (n,), generator=gen, device=dev)
    assign = torch.nn.functional.one_hot(bs, m).bool() & selected[:, None]
    x = _leaf(cap, d, dtype, dev)
    w = (selected[idx].float() * sizes[idx].float()).contiguous()
    key = "fedavg_reduce_int8" if dtype == torch.int8 else "fedavg_reduce"
    before = _lib.LAUNCHES[key]
    got = kf.reduce_leaf(w, x)
    assert _lib.LAUNCHES[key] == before + 1
    want = kf.reduce_leaf_plain(w, x)
    scale = kf.reduce_leaf_plain(w, torch.where(torch.isfinite(
        x.float()), x.float(), 0.0).abs())
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    ws, _ = segment_weights(assign[idx], sizes[idx])
    _segment_check(ws.contiguous(), x)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("cap,d", [(25, 100352), (100, 4608), (6, 1000)])
def test_sparsify_quantize_on_selected_rows(dev, quantize, cap, d):
    """Kernel 6 on the [cap] client deltas of a selected round: exact."""
    gen = torch.Generator(device=dev).manual_seed(cap + d)
    x = torch.randn((cap, d), generator=gen, device=dev) * 0.01
    x[cap - 1] = 0.0                         # a padding row's zero delta
    k = ct.nominal_k(d, 0.1)
    thresh, rowmax = ct.topk_threshold(x, k)
    scale = ct.quant_scale(rowmax) if quantize else torch.ones_like(rowmax)
    u = (torch.rand((cap, d), generator=gen, device=dev) if quantize
         else None)
    before = _lib.LAUNCHES["sparsify_quantize"]
    got = ct.sparsify_quantize(x, thresh, scale, u, quantize=quantize)
    assert _lib.LAUNCHES["sparsify_quantize"] == before + 1
    assert torch.equal(got, ct.sparsify_quantize_plain(
        x, thresh, scale, u, quantize=quantize))


def test_covering_cap_on_card_equals_full_compute(dev):
    """sync_selected_cover small: a cap of N on the card reproduces the
    compute="full" run on the card, records exactly, the global model
    within rtol 1e-5; and the selected run on the card matches it on the
    CPU."""
    base = dict(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                n_test=40, local_epochs=1, batch_size=10, seed=7,
                scheduler="dagsa_jit")
    full = FLSimulation(FLConfig(**base), device=dev)
    want = full.run(3)
    sel = FLSimulation(FLConfig(**base, compute="selected", select_cap=12),
                       device=dev)
    got = sel.run(3)
    for g, w in zip(got, want):
        assert (g.n_selected, g.min_part_rate, g.t_round, g.wall_clock) == \
            (w.n_selected, w.min_part_rate, w.t_round, w.wall_clock)
        assert abs(g.test_acc - w.test_acc) <= 1.0 / 40 + 1e-9
    for k, sub in sel.params.items():
        for leaf, p in sub.items():
            torch.testing.assert_close(p, full.params[k][leaf], rtol=1e-5,
                                       atol=0.0)
    cut = FLConfig(**base, compute="selected")           # the cap of 6 cuts
    gpu = FLSimulation(cut, device=dev).run(3)
    cpu = FLSimulation(cut, device="cpu").run(3)
    assert any(g.n_selected > 6 for g in gpu)
    for g, c in zip(gpu, cpu):
        assert (g.n_selected, g.min_part_rate) == (c.n_selected,
                                                   c.min_part_rate)
        assert math.isclose(g.t_round, c.t_round, rel_tol=1e-5)
        assert abs(g.test_acc - c.test_acc) <= 1.0 / 40 + 1e-9


def test_world_of_one_shard_paths_on_card_equal_unsharded(dev):
    """run_shard_sweep (an uneven 2 x 3 grid) and shard_schedule_batch (a
    fleet of 5) on a world of one on the card: the same records and the
    same schedules, field for field, as run_sweep and
    dagsa_schedule_batch there."""
    import json

    from repro_torch import rng
    from repro_torch.core import channel, mobility
    from repro_torch.launch import shard_sweep, sweep

    names, kw = ["paper-default", "high-mobility"], dict(n_seeds=3,
                                                         n_rounds=2)
    want = sweep.run_sweep(names, device=dev, **kw)
    got = shard_sweep.run_shard_sweep(names, device=dev, **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    cfg = WirelessConfig()
    probs = []
    for s in range(5):
        k0, k1 = rng.split(rng.fold_in(rng.PRNGKey(0, device=dev),
                                       s)).unbind(0)
        st = mobility.init_positions_grid_bs(k0, cfg)
        probs.append(channel.make_problem(
            k1, st, cfg, torch.ones((cfg.n_users,), device=dev), 0))
    keys = rng.split(rng.PRNGKey(1, device=dev), 5)
    ref = dagsa_jit.dagsa_schedule_batch(probs, keys)
    out = shard_sweep.shard_schedule_batch(probs, keys)
    for field in ("assign", "selected", "bw", "bs_time", "t_round"):
        assert getattr(out, field).device == getattr(ref, field).device
        assert torch.equal(getattr(out, field), getattr(ref, field)), field


# ------------------------------------------------- the backward kernels ----
# A call's gradients within 1e-4 (float32) / 2e-2 (bfloat16) of their
# largest magnitude, against the plain versions' autograd on the card.
_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _assert_grads(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
    chip_smoke._grads_err("grad", got, want, _BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window", [
    (1, 67, 67, 4, 4, 64, True, 0),          # odd S = T, one row past a tile
    (2, 130, 333, 8, 4, 128, False, 0),      # odd S and T, non-causal
    (2, 100, 100, 8, 1, 64, True, 1),        # a window of 1, GQA 8/1
    (1, 300, 300, 16, 8, 128, True, 16),     # qwen3's heads, window 16
    (1, 200, 200, 4, 2, 64, True, 300),      # a window past S
    (4, 1, 80, 6, 6, 64, False, 0),          # one query a sequence
    (2, 75, 300, 6, 6, 64, False, 0),        # whisper's cross attention
    # S and T off the 64-row tiles, G 1 / 8 at D 128, windows across tiles
    (2, 190, 190, 8, 1, 128, True, 0),
    (1, 97, 161, 2, 2, 128, False, 0),
    (2, 250, 250, 4, 2, 64, True, 70),
    (1, 130, 130, 16, 2, 128, True, 33),
])
def test_flash_attention_bwd(dev, dtype, b, s, t, h, kv, d, causal, window):
    gen = torch.Generator(device=dev).manual_seed(b * s + t + h + window)
    q = _normal(gen, (b, s, h, d), dev, dtype)
    k = _normal(gen, (b, t, kv, d), dev, dtype)
    v = _normal(gen, (b, t, kv, d), dev, dtype)
    dout = _normal(gen, (b, s, h, d), dev, dtype)
    out, lse = kfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
    before = _lib.LAUNCHES["flash_attention_bwd"]
    got = kfa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                  window=window)
    assert _lib.LAUNCHES["flash_attention_bwd"] == before + 1
    _assert_grads(got, kfa.flash_attention_bwd_plain(
        q, k, v, out, dout, causal=causal, window=window), dtype)
    again = kfa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                    window=window)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window", [
    (2, 130, 130, 8, 2, 128, True, 0),
    (1, 97, 161, 4, 4, 64, False, 0),
    (1, 200, 200, 16, 2, 128, True, 70),
])
def test_flash_attention_saves_the_row_log_sum_exp(dev, dtype, b, s, t, h,
                                                   kv, d, causal, window):
    """The forward's log-sum-exp for the backward, against torch.logsumexp
    of the plain scores of the same (float32) inputs; the output equals the
    serving call's bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(s + t + window)
    q = _normal(gen, (b, s, h, d), dev, dtype)
    k = _normal(gen, (b, t, kv, d), dev, dtype)
    v = _normal(gen, (b, t, kv, d), dev, dtype)
    out, lse = kfa.flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    torch.testing.assert_close(
        lse, kfa.flash_attention_lse_plain(q.float(), k.float(),
                                           causal=causal, window=window),
        rtol=1e-5, atol=1e-4)
    assert torch.equal(out, kfa.flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 128), (3, 7, 2048), (9, 8192),
                                   (5, 202), (1, 6), (4096, 1024),
                                   (20000, 128), (4096, 2560), (32771, 128)])
def test_rmsnorm_bwd(dev, dtype, shape):
    """The backward over every shape the forward's paths take: the "rows"
    widths, a row of 8,192 (several warps a row), "scalar" widths (202,
    6), rows past one chunk of the dscale reduction, mamba2-2.7b's width
    (three vectors a lane) and rows that end in a ragged last block."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = _normal(gen, shape, dev, dtype)
    scale = (1.0 + 0.1 * _normal(gen, shape[-1:], dev)).to(dtype)
    g = _normal(gen, shape, dev, dtype)
    before = _lib.LAUNCHES["rmsnorm_bwd"]
    got = krn.rmsnorm_bwd(x, scale, g)
    assert _lib.LAUNCHES["rmsnorm_bwd"] == before + 1
    _assert_grads(got, krn.rmsnorm_bwd_plain(x, scale, g), dtype)
    again = krn.rmsnorm_bwd(x, scale, g)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,route", [
    ((37, 128), 0, "rows"), ((4096, 2048), 0, "rows"),
    ((4096, 2560), 0, "rows"), ((9, 8192), 0, "rows"),
    ((5, 202), 0, "scalar"), ((1, 6), 0, "scalar"),
    ((40, 128), 1, "scalar"), ((3, 2048), 1, "scalar")])
def test_rmsnorm_bwd_route(dev, dtype, shape, offset, route, monkeypatch):
    """The route the wrapper reads from its plan: the one-pass "rows"
    route wherever every base is 16-byte aligned and d a multiple of the
    vector width, the "scalar" route at odd widths (202, 6) and off
    alignment (offset 1); the gradients agree with the plain version's
    either way."""
    plans, plan = [], krn.rmsnorm_bwd_plan

    def spy(*args):
        plans.append(plan(*args))
        return plans[-1]

    rows, d = shape
    gen = torch.Generator(device=dev).manual_seed(rows + d + offset)
    x = _normal(gen, (rows * d + offset,), dev, dtype)[offset:].view(rows, d)
    scale = (1.0 + 0.1 * _normal(gen, (d,), dev)).to(dtype)
    g = _normal(gen, shape, dev, dtype)
    monkeypatch.setattr(krn, "rmsnorm_bwd_plan", spy)
    got = krn.rmsnorm_bwd(x, scale, g)
    assert [p[0] for p in plans] == [route]
    _assert_grads(got, krn.rmsnorm_bwd_plain(x, scale, g), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_autograd_non_contiguous_and_unaligned(dev, dtype, offset):
    """Autograd through the wrapper on a non-contiguous slice (MLA's
    latent rows), and the backward on a base off 16-byte alignment (its
    element loads): gradients of x and scale against the plain
    version's."""
    gen = torch.Generator(device=dev).manual_seed(7 + offset)
    base = _normal(gen, (40 * 160 + offset,), dev, dtype)[offset:]
    x = base.view(40, 160)[:, :128].detach().requires_grad_(True)
    scale = (1.0 + 0.1 * _normal(gen, (128,), dev)).to(dtype)
    scale.requires_grad_(True)
    g = _normal(gen, (40, 128), dev, dtype)
    before = (_lib.LAUNCHES["rmsnorm"], _lib.LAUNCHES["rmsnorm_bwd"])
    got = torch.autograd.grad(krn.rmsnorm(x, scale), (x, scale), g)
    assert (_lib.LAUNCHES["rmsnorm"],
            _lib.LAUNCHES["rmsnorm_bwd"]) == (before[0] + 1, before[1] + 1)
    _assert_grads(got, krn.rmsnorm_bwd_plain(x, scale, g), dtype)
    flat = base[:40 * 128].view(40, 128)        # contiguous, maybe unaligned
    assert (flat.data_ptr() % 16 != 0) == bool(offset)
    _assert_grads(krn.rmsnorm_bwd(flat, scale.detach(), g),
                  krn.rmsnorm_bwd_plain(flat, scale.detach(), g), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_through_the_kernels(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _normal(gen, (2, 96, 8, 64), dev, dtype).requires_grad_(True)
    k = _normal(gen, (2, 96, 2, 64), dev, dtype).requires_grad_(True)
    v = _normal(gen, (2, 96, 2, 64), dev, dtype).requires_grad_(True)
    dout = _normal(gen, (2, 96, 8, 64), dev, dtype)
    before = (_lib.LAUNCHES["flash_attention"],
              _lib.LAUNCHES["flash_attention_bwd"])
    out = kfa.flash_attention(q, k, v, causal=True, window=40)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert (_lib.LAUNCHES["flash_attention"],
            _lib.LAUNCHES["flash_attention_bwd"]) == (before[0] + 1,
                                                      before[1] + 1)
    want = kfa.flash_attention_bwd_plain(q, k, v, out, dout, causal=True,
                                         window=40)
    _assert_grads(got, want, dtype)


def test_serving_calls_launch_the_forward_directly(dev):
    """Without a differentiated input (serving), the wrappers launch the
    forward as before: no autograd node, no backward launch."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _normal(gen, (8, 256), dev)
    scale = torch.ones(256, device=dev, requires_grad=True)
    q = _normal(gen, (1, 64, 4, 64), dev)
    before = dict(_lib.LAUNCHES)
    assert krn.rmsnorm(x, scale.detach()).grad_fn is None
    with torch.no_grad():
        assert krn.rmsnorm(x, scale).grad_fn is None
    assert kfa.flash_attention(q, q, q).grad_fn is None
    xs, dt, A, B, C = _ssd_inputs(gen, dev, 1, 128, 2, 64, 16, torch.float32)
    A.requires_grad_(True)
    with torch.no_grad():
        assert kss.ssd_scan(xs, dt, A, B, C, 64).grad_fn is None
    assert kss.ssd_scan(xs, dt, A.detach(), B, C, 64).grad_fn is None
    after = dict(_lib.LAUNCHES)
    assert after["rmsnorm"] == before["rmsnorm"] + 2
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["ssd_scan"] == before["ssd_scan"] + 2
    for name in ("rmsnorm_bwd", "flash_attention_bwd", "ssd_scan_bwd"):
        assert after[name] == before[name]


@pytest.mark.parametrize("arch,required", chip_smoke.TRAIN_ARCHS,
                         ids=[a for a, _ in chip_smoke.TRAIN_ARCHS])
def test_lm_config_train_step_on_card_matches_cpu(dev, arch, required):
    """One reduced float32 training step a config on the card against the
    CPU: loss, gradients and the SGD step within 1e-4, through the
    forward and backward kernels (chip_smoke.py's check (b))."""
    chip_smoke.check_train_small(arch, dev, required)


# kernel 9's backward: (label, (B, S, H, P, N), G, chunk, large_dt); the
# inputs at the model's scale (chip_smoke.ssd_bwd_inputs) unless large_dt
_SSD_BWD_CASES = [
    ("zamba2", (4, 512, 64, 64, 64), 1, 128, False),   # Zamba2's layer
    ("zamba2_large_dt", (4, 512, 64, 64, 64), 1, 128, True),
    ("mamba2", (2, 512, 80, 64, 128), 1, 128, False),  # mamba2-2.7b's
    ("chunk16", (2, 128, 4, 64, 32), 1, 16, False),
    ("chunk48", (2, 192, 4, 64, 64), 1, 48, False),    # not a multiple of 32
    ("groups2", (2, 256, 8, 32, 16), 2, 64, False),
    ("one_chunk", (3, 128, 4, 96, 128), 1, 128, False),  # S = Q, 3 P slices
    ("reduced", (2, 128, 16, 32, 16), 1, 32, False),   # the reduced configs'
    # the edges of ssd_bwd_plan's tensor-core pass: N 8 and 120 (padded to
    # 16), P 32 and 128 (its widest), and past it (N 128, P 128: SIMT)
    ("state8", (2, 256, 4, 32, 8), 1, 64, False),
    ("state120", (1, 256, 4, 96, 120), 1, 128, False),
    ("p128", (1, 384, 4, 128, 64), 1, 128, False),
    ("p128_state128", (1, 256, 2, 128, 128), 1, 128, False),
    ("groups3", (2, 128, 6, 32, 16), 3, 32, False),    # 3 groups of 2 heads
]


def _ssd_plain_autograd(x, dt, A, B, C, dy, chunk):
    """(dx, ddt, dA, dB, dC): autograd of the plain forward, with B and C
    repeated to the heads and their gradients summed back per group."""
    return chip_smoke._ssd_plain_grads(x, dt, A, B, C, dy, chunk)


def _assert_each_grad(got, want, dtype):
    """Each gradient within the tolerance of its own largest magnitude."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        chip_smoke._grad_err(f"grad {i}", g, w, _BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,shape,g,chunk,large_dt", _SSD_BWD_CASES,
                         ids=[c[0] for c in _SSD_BWD_CASES])
def test_ssd_scan_bwd(dev, dtype, label, shape, g, chunk, large_dt):
    """The four kernels against the plain backward and the plain forward's
    autograd, in the inputs' dtypes; a second call equal bit for bit.  At
    three chunks or more at the model's scale, the data move the
    gradients by SSD_CARRY_MARGIN times the tolerance once the state
    carries one chunk only, so a carry fault cannot pass."""
    b, s, h, p, n = shape
    gen = torch.Generator(device=dev).manual_seed(b * s + h + n + chunk)
    x, dt, A, B, C, dy = chip_smoke.ssd_bwd_inputs(
        gen, dev, b, s, h, p, n, dtype, g=g, large_dt=large_dt)
    if s >= 3 * chunk and not large_dt:
        assert (chip_smoke.ssd_carry_share(x, dt, A, B, C, dy, chunk)
                >= chip_smoke.SSD_CARRY_MARGIN * _BWD_TOL[dtype])
    before = _lib.LAUNCHES["ssd_scan_bwd"]
    got = kss.ssd_scan_bwd(x, dt, A, B, C, dy, chunk)
    assert _lib.LAUNCHES["ssd_scan_bwd"] == before + 1
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype]
    _assert_each_grad(got, kss.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk),
                      dtype)
    _assert_each_grad(got, _ssd_plain_autograd(x, dt, A, B, C, dy, chunk),
                      dtype)
    again = kss.ssd_scan_bwd(x, dt, A, B, C, dy, chunk)
    assert all(torch.equal(a, t) for a, t in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_autograd_through_the_kernels(dev, dtype):
    """Autograd through the wrapper, with dy non-contiguous and y sliced as
    ssm_forward slices off its padding: the forward and backward kernels
    launched once each, the gradients the plain forward's."""
    gen = torch.Generator(device=dev).manual_seed(9)
    x, dt, A, B, C = _ssd_inputs(gen, dev, 2, 256, 8, 64, 32, dtype)
    leaves = [t.requires_grad_(True) for t in (x, dt, A, B, C)]
    dy = _normal(gen, (2, 8, 200, 64), dev).transpose(1, 2)
    assert not dy.is_contiguous()
    before = (_lib.LAUNCHES["ssd_scan"], _lib.LAUNCHES["ssd_scan_bwd"])
    y = kss.ssd_scan(*leaves, 64)
    got = torch.autograd.grad(y[:, :200], leaves, dy)
    assert (_lib.LAUNCHES["ssd_scan"],
            _lib.LAUNCHES["ssd_scan_bwd"]) == (before[0] + 1, before[1] + 1)
    full = torch.zeros((2, 256, 8, 64), device=dev)
    full[:, :200] = dy
    _assert_each_grad(got, _ssd_plain_autograd(x, dt, A, B, C, full, 64),
                      dtype)


def test_ssd_scan_bwd_validates(dev):
    gen = torch.Generator(device=dev).manual_seed(10)
    x, dt, A, B, C = _ssd_inputs(gen, dev, 1, 128, 2, 64, 16, torch.float32)
    dy = _normal(gen, (1, 128, 2, 64), dev)
    with pytest.raises(ValueError, match="contiguous"):
        kss.ssd_scan_bwd(x, dt, A, B, C, dy.transpose(1, 2).contiguous()
                         .transpose(1, 2), 64)
    with pytest.raises(TypeError):
        kss.ssd_scan_bwd(x, dt, A, B, C, dy.to(torch.bfloat16), 64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        kss.ssd_scan_bwd(x, dt, A, B, C, dy, 48)

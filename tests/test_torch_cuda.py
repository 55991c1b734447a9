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
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dagsa_jit  # noqa: E402
from repro_torch.core.types import SchedulingProblem  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.fl.server import segment_weights  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
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
    """Exact ties inside one lane's columns (c and c + lanes) and across
    lanes (c and c + 1), a row of one value and one of -inf, odd N, and an
    snr 4 bytes off 16-byte alignment; each eager call adds one launch."""
    n = 2049
    rs = _rs(m)
    snr = torch.tensor(10.0 ** rs.uniform(-1, 5, (n, m)), dtype=torch.float32,
                       device=dev)
    lanes = ks.best_bs_plan(m)[0]
    top = snr.max(dim=1).values * 2
    for r in range(0, n - 1, 7):
        c = r % m
        c2 = c + (lanes if r % 2 == 0 else 1)
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
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                   n_test=40, local_epochs=1, batch_size=10, seed=7,
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


def test_flash_attention_cross_shape(dev):
    """Non-causal with T != S (keys past a ragged T masked)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _normal(gen, (1, 100, 4, 64), dev)
    k = _normal(gen, (1, 333, 4, 64), dev)
    v = _normal(gen, (1, 333, 4, 64), dev)
    _assert_close(kfa.flash_attention(q, k, v, causal=False),
                  kfa.flash_attention_plain(q, k, v, causal=False), "flash",
                  torch.float32)


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

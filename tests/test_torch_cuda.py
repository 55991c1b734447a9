"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Indices must match exactly; floats within rtol=1e-5 (sums in another
order; for a reduction, relative to the sum of its terms' magnitudes).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dagsa_jit  # noqa: E402
from repro_torch.core.types import SchedulingProblem  # noqa: E402
from repro_torch.core.types import WirelessConfig  # noqa: E402
from repro_torch.fl.rounds import FLConfig, FLSimulation  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import bandwidth_solve as kb  # noqa: E402
from repro_torch.kernels import compress_topk as ct  # noqa: E402
from repro_torch.kernels import fedavg_reduce as kf  # noqa: E402
from repro_torch.kernels import select_topk as ks  # noqa: E402

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


@pytest.mark.parametrize("k,u", [(8, 50), (1, 1), (33, 1000), (100, 4097)])
@pytest.mark.parametrize("method", ["newton", "bisect"])
def test_bandwidth_solve(dev, k, u, method):
    rs = _rs(k * u)
    snr = 10.0 ** rs.uniform(-1, 4, (k, u))
    coeff = torch.tensor(0.5 / np.log2(1 + snr), dtype=torch.float32,
                         device=dev)
    tcomp = torch.tensor(rs.uniform(0.1, 0.11, u), dtype=torch.float32,
                         device=dev)
    mask = torch.tensor(rs.random((k, u)) < 0.4, device=dev)
    mask[k // 2] = False
    bw = torch.tensor(rs.uniform(0.5, 1.5, k), dtype=torch.float32,
                      device=dev)
    lo = torch.tensor(rs.uniform(0.0, 0.3, k), dtype=torch.float32,
                      device=dev)
    for tc in (tcomp, tcomp.expand(k, u).contiguous()):
        got = kb.bandwidth_solve(coeff, tc, mask, bw, lo=lo, method=method)
        want = kb.bandwidth_solve_plain(coeff, tc, mask, bw, lo=lo,
                                        method=method)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        assert got[k // 2].item() == 0.0


@pytest.mark.parametrize("n,m", [(50, 8), (1, 1), (37, 5), (70000, 100),
                                 (3000, 300)])
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


def test_small_run_on_card_matches_cpu(dev):
    cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4), n_train=120,
                   n_test=40, local_epochs=1, batch_size=10, seed=7)
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

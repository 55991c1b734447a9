#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a and prints the build seconds;
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (N=50 users, M=8 BSs, every leaf of the paper-scale
   CNN) and at a fleet shape (N=1e6 users x M=100 BSs; the Eq. (11) solve
   on [100, 1e6] rows; FedAvg, per-BS FedAvg (M=8 and M=100) and the
   uplink compressor over 1,000 clients of the fc1 leaf), in float32 and
   over int8 codes, and times the kernel, the plain version and one
   PyTorch call as a yardstick;
4. checks small runs on the card against the same runs on the CPU (the
   plain versions): the synchronous round, hierarchical aggregation, and
   hierarchical aggregation over the top-k + int8 compressed uplink;
5. drives the port's full-width paths on the card, each with the kernels'
   launch counts zeroed just before it and read just after: the
   synchronous single-tier round (3 rounds), hierarchical aggregation with
   the top-k + int8 uplink (5 rounds, one global sync), hierarchical
   aggregation uncompressed (2 rounds) and the single-tier top-k + int8
   uplink (2 rounds);
6. profiles one more synchronous round and one more hierarchical +
   compressed round (torch.profiler: host and device time per round
   phase, the busiest device ops, the device's busy share);
7. prints one JSON line with every kernel's numbers, then, as the last
   line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line.  TF32 is turned off for
matmuls and convolutions, so float32 on the card means float32.  Exits
non-zero when no CUDA device is present or when run outside the checkout.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_OPS_S = 67e12      # H100 SXM float32 outside the tensor cores
RTOL = 1e-5

# Every kernel: (source, the TPU kernel it replaces, the full-width path
# whose launches the JSON line reports).
_FEDAVG = "src/repro_torch/csrc/fedavg_reduce.cu"
KERNELS = {
    "bandwidth_solve": ("src/repro_torch/csrc/bandwidth_solve.cu",
                        "src/repro/kernels/bandwidth_solve.py:115", "sync"),
    "masked_bs_argmax": ("src/repro_torch/csrc/select_topk.cu",
                         "src/repro/kernels/select_topk.py:112", "sync"),
    "best_bs_argmax": ("src/repro_torch/csrc/select_topk.cu",
                       "src/repro/kernels/select_topk.py:155", "sync"),
    "fedavg_reduce": (_FEDAVG, "src/repro/kernels/fedavg_reduce.py:75",
                      "sync"),
    "fedavg_reduce_int8": (_FEDAVG, "src/repro/kernels/fedavg_reduce.py:75",
                           "single_int8"),
    "fedavg_segment_reduce": (_FEDAVG,
                              "src/repro/kernels/fedavg_reduce.py:197",
                              "hier"),
    "fedavg_segment_reduce_int8": (
        _FEDAVG, "src/repro/kernels/fedavg_reduce.py:197", "hier_int8"),
    "sparsify_quantize": ("src/repro_torch/csrc/sparsify_quantize.cu",
                          "src/repro/kernels/compress_topk.py:172",
                          "hier_int8"),
}


def _time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _close(name, got, want, exact=False, scale=None):
    """Max abs error of got vs want; raises past the stated tolerance:
    exact, or |got - want| <= RTOL * scale + 1e-6 with scale = |want| (or,
    for a sum, the sum of its terms' magnitudes, since a sum that cancels
    keeps the rounding of its terms)."""
    got, want = got.detach().double(), want.detach().double()
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (exact check)")
        return 0.0
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin], want[~fin]):
        raise AssertionError(f"{name}: non-finite entries disagree")
    err = (got[fin] - want[fin]).abs()
    base = want.abs() if scale is None else scale.detach().double()
    lim = RTOL * base[fin] + 1e-6
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"exceeds rtol {RTOL}")
    return float(err.max()) if err.numel() else 0.0


def check_kernels(dev, fleet_users=1_000_000, fleet_bs=100,
                  fleet_clients=1000) -> dict:
    """Kernel vs plain version on the card; returns per-kernel numbers at
    the main-path shape ("main") and the fleet shape ("fleet")."""
    from repro_torch.kernels import bandwidth_solve as kb
    from repro_torch.kernels import compress_topk as ct
    from repro_torch.kernels import fedavg_reduce as kf
    from repro_torch.kernels import select_topk as ks
    from repro_torch.models import cnn

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {k: {} for k in KERNELS}

    def record(kernel, label, shape, err, fn, plain, lib, n_bytes, n_ops,
               reps):
        ms = _time_ms(fn, reps)
        plain_ms = _time_ms(plain, max(1, reps // 4))
        lib_ms = None if lib is None else _time_ms(lib, reps)
        bound, by = _bound_ms(n_bytes, n_ops)
        row = {"name": kernel, "shape": shape, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms}
        results[kernel][label] = row
        print(json.dumps({"check": label, **row}), flush=True)

    # -- selection argmaxes (Algorithm 1 steps 1 and 3) --------------------
    for label, n, m, reps in (("main", 50, 8, 200),
                              ("fleet", fleet_users, fleet_bs, 20)):
        # SNR in dB spread like the channel's, with forced exact ties
        snr = torch.pow(10.0, torch.rand((n, m), generator=gen, device=dev)
                        * 6.0 - 1.0)
        snr[n // 3] = snr[n // 5]                   # duplicate user rows
        snr[:, m - 1] = snr[:, 0]                   # duplicate BS columns
        rem = torch.rand((n,), generator=gen, device=dev) < 0.5
        rem[0] = False                              # tie: lowest remaining
        cand, best = ks.masked_bs_argmax(snr, rem)
        c_ref, b_ref = ks.masked_bs_argmax_plain(snr, rem)
        _close("masked_bs_argmax cand", cand, c_ref, exact=True)
        err = _close("masked_bs_argmax best", best, b_ref, exact=True)
        none = torch.zeros_like(rem)                # all-masked columns
        c0, b0 = ks.masked_bs_argmax(snr, none)
        if not (bool((c0 == 0).all()) and bool(torch.isneginf(b0).all())):
            raise AssertionError("masked_bs_argmax: all-masked column must "
                                 "give (0, -inf)")
        record("masked_bs_argmax", label, [n, m], err,
               lambda: ks.masked_bs_argmax(snr, rem),
               lambda: ks.masked_bs_argmax_plain(snr, rem),
               lambda: torch.argmax(
                   torch.where(rem[:, None], snr, -torch.inf), dim=0),
               n * m * 4 + n + 2 * m * 4, n * m, reps)

        bb = ks.best_bs_argmax(snr)
        _close("best_bs_argmax", bb, ks.best_bs_argmax_plain(snr), exact=True)
        record("best_bs_argmax", label, [n, m], 0.0,
               lambda: ks.best_bs_argmax(snr),
               lambda: ks.best_bs_argmax_plain(snr),
               lambda: torch.argmax(snr, dim=1),
               n * m * 4 + n * 4, n * m, reps)

    # -- Eq. (11) solve: K trial rows over U users, tcomp shared ------------
    for label, k, u, reps in (("main", 8, 50, 200),
                              ("fleet", fleet_bs, fleet_users, 5)):
        snr = torch.pow(10.0, torch.rand((k, u), generator=gen, device=dev)
                        * 6.0 - 1.0)
        coeff = (0.5 / torch.log2(1.0 + snr)).contiguous()
        tcomp = 0.10 + 0.01 * torch.rand((u,), generator=gen, device=dev)
        mask = torch.rand((k, u), generator=gen, device=dev) < 0.3
        mask[1] = False                             # an empty row -> 0
        bw = torch.full((k,), 1.0, device=dev)
        lo = torch.zeros((k,), device=dev)
        lo[0] = 0.2                                 # a warm start
        for method in ("newton", "bisect"):
            got = kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo,
                                     method=method)
            want = kb.bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo,
                                            method=method)
            err = _close(f"bandwidth_solve {method}", got, want)
            if got[1].item() != 0.0:
                raise AssertionError("bandwidth_solve: empty row must be 0")
        err = _close("bandwidth_solve", kb.bandwidth_solve(
            coeff, tcomp, mask, bw, lo=lo), kb.bandwidth_solve_plain(
            coeff, tcomp, mask, bw, lo=lo))
        nnz = float(mask.sum())
        record("bandwidth_solve", label, [k, u], err,
               lambda: kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo),
               lambda: kb.bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo),
               None, k * u * 4 + u * 4 + k * u + 3 * k * 4,
               (16 * 7 + 3) * nnz, reps)

    # -- Eq. (2) per-leaf reduction: every paper-scale CNN leaf ------------
    shapes = {name: tuple(p.shape) for name, p in (
        (f"{a}.{b}", leaf) for a, sub in cnn.init(
            torch.zeros(2, dtype=torch.int64, device=dev),
            cnn.CNNConfig.paper_scale()).items() for b, leaf in sub.items())}
    for leaf, shp in shapes.items():
        d = math.prod(shp)
        x = torch.randn((50, d), generator=gen, device=dev)
        x[3, d // 2] = float("nan")                 # poisoned entries
        x[7, 0] = float("inf")
        w = torch.rand((50,), generator=gen, device=dev)
        w[3] = 0.0
        err = _close(f"fedavg_reduce {leaf}", kf.reduce_leaf(w, x),
                     kf.reduce_leaf_plain(w, x),
                     scale=kf.reduce_leaf_plain(w.abs(), x.abs()))
        if leaf == "fc1.w":
            record("fedavg_reduce", "main", [50, d], err,
                   lambda: kf.reduce_leaf(w, x),
                   lambda: kf.reduce_leaf_plain(w, x), lambda: w @ x,
                   50 * d * 4 + 50 * 4 + d * 4, 2 * 50 * d, 200)
    n_fleet, d = fleet_clients, shapes["fc1.w"][0] * shapes["fc1.w"][1]
    x = torch.randn((n_fleet, d), generator=gen, device=dev)
    w = torch.rand((n_fleet,), generator=gen, device=dev)
    err = _close("fedavg_reduce fleet", kf.reduce_leaf(w, x),
                 kf.reduce_leaf_plain(w, x),
                 scale=kf.reduce_leaf_plain(w, x.abs()))
    record("fedavg_reduce", "fleet", [n_fleet, d], err,
           lambda: kf.reduce_leaf(w, x), lambda: kf.reduce_leaf_plain(w, x),
           lambda: w @ x, n_fleet * d * 4 + n_fleet * 4 + d * 4,
           2 * n_fleet * d, 20)

    # -- the same reduction over int8 codes (compressed uplink) ------------
    def int8_codes(n, d):
        return torch.randint(-127, 128, (n, d), generator=gen, device=dev,
                             dtype=torch.int8)

    for label, n, reps in (("main", 50, 200), ("fleet", fleet_clients, 20)):
        q = int8_codes(n, d)
        w = torch.rand((n,), generator=gen, device=dev)
        w[1] = 0.0
        err = _close(f"fedavg_reduce_int8 {label}", kf.reduce_leaf(w, q),
                     kf.reduce_leaf_plain(w, q),
                     scale=kf.reduce_leaf_plain(w, q.float().abs()))
        record("fedavg_reduce_int8", label, [n, d], err,
               lambda: kf.reduce_leaf(w, q), lambda: kf.reduce_leaf_plain(w, q),
               lambda: w @ q.float(), n * d + n * 4 + d * 4, 2 * n * d, reps)

    # -- hierarchical Eq. (2): per-BS sums, float32 and int8 ---------------
    def segment_case(n, m, int8):
        x = int8_codes(n, d) if int8 else torch.randn(
            (n, d), generator=gen, device=dev)
        if not int8:
            x[3 % n, d // 2] = float("nan")         # poisoned entries
            x[(7 % n), 0] = float("-inf")
        w = torch.rand((n, m), generator=gen, device=dev)
        w = w * (torch.rand((n, m), generator=gen, device=dev) < 0.5)
        w[:, m // 2] = 0.0                          # an empty BS column
        return w.contiguous(), x

    for kernel, int8 in (("fedavg_segment_reduce", False),
                         ("fedavg_segment_reduce_int8", True)):
        for leaf, shp in shapes.items():            # every leaf, M = 8
            w, x = segment_case(50, 8, int8)
            x = x[:, : math.prod(shp)].contiguous()
            _close(f"{kernel} {leaf}", kf.segment_reduce_leaf(w, x),
                   kf.segment_reduce_leaf_plain(w, x),
                   scale=kf.segment_reduce_leaf_plain(w, x.float().abs()))
        for label, n, m, reps in (("main", 50, 8, 200),
                                  ("fleet", fleet_clients, 8, 20),
                                  ("fleet_m100", fleet_clients, 100, 10)):
            w, x = segment_case(n, m, int8)
            got = kf.segment_reduce_leaf(w, x)
            err = _close(f"{kernel} {label}", got,
                         kf.segment_reduce_leaf_plain(w, x),
                         scale=kf.segment_reduce_leaf_plain(
                             w, x.float().abs()))
            if bool((got[m // 2] != 0).any()):
                raise AssertionError(f"{kernel}: an empty BS column must "
                                     f"sum to 0")
            x_bytes = n * d * (1 if int8 else 4)
            record(kernel, label, [n, m, d], err,
                   lambda: kf.segment_reduce_leaf(w, x),
                   lambda: kf.segment_reduce_leaf_plain(w, x),
                   lambda: w.t() @ x.float(),
                   x_bytes + n * m * 4 + m * d * 4, 2 * n * m * d, reps)
            del w, x, got

    # -- the uplink compressor: top-k mask (+ int8 stochastic round) -------
    for label, n, reps in (("main", 50, 200), ("fleet", fleet_clients, 20)):
        k = ct.nominal_k(d, 0.1)
        x = torch.randn((n, d), generator=gen, device=dev) * 0.01
        x[0] = 0.25                                 # a row of magnitude ties
        x[0, -1] = -0.25
        x[1] = 0.0                                  # an all-zero row: scale 1
        x[2, 5], x[2, 6] = float("nan"), float("inf")
        xs = torch.where(torch.isfinite(x), x, 0.0)
        thresh, rowmax = ct.topk_threshold(xs, k)
        u = torch.rand((n, d), generator=gen, device=dev)
        for quantize in (False, True):
            scale = ct.quant_scale(rowmax) if quantize else torch.ones_like(
                rowmax)
            got = ct.sparsify_quantize(x, thresh, scale, u, quantize=quantize)
            _close(f"sparsify_quantize {label} quantize={quantize}", got,
                   ct.sparsify_quantize_plain(x, thresh, scale, u,
                                              quantize=quantize), exact=True)
            if not (bool((got[0] != 0).all()) and bool((got[1] == 0).all())
                    and float(scale[1]) == 1.0):
                raise AssertionError("sparsify_quantize: threshold ties must "
                                     "all survive and a zero row stay 0")
            if quantize:                            # the main path's mode
                record("sparsify_quantize", label, [n, d], 0.0,
                       lambda: ct.sparsify_quantize(x, thresh, scale, u,
                                                    quantize=True),
                       lambda: ct.sparsify_quantize_plain(
                           x, thresh, scale, u, quantize=True), None,
                       2 * n * d * 4 + n * d + 2 * n * 4, 4 * n * d, reps)
        del x, xs, u, got
    torch.cuda.synchronize()
    return results


def check_small_runs(dev) -> None:
    """The same small runs (12 users, 4 BSs, seed 7, 3 rounds) on the card
    and on the CPU (plain versions): decisions and handover rates exact,
    t_round within rtol 1e-5, test_acc within one of the 40 samples."""
    from repro_torch.core.types import WirelessConfig
    from repro_torch.fl.rounds import FLConfig, FLSimulation

    for label, extra in (("sync", {}),
                         ("hier", dict(aggregation="hierarchical",
                                       tau_global=2)),
                         ("hier_int8", dict(aggregation="hierarchical",
                                            tau_global=2,
                                            compress="topk-int8",
                                            topk_frac=0.1))):
        cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                       n_train=120, n_test=40, local_epochs=1, batch_size=10,
                       seed=7, **extra)
        gpu = FLSimulation(cfg, device=dev).run(3)
        cpu = FLSimulation(cfg, device="cpu").run(3)
        for g, c in zip(gpu, cpu):
            print(f"small run {label}  card {g}\n{' ' * len(label)}"
                  f"            cpu  {c}", flush=True)
            if (g.n_selected, g.min_part_rate) != (c.n_selected,
                                                   c.min_part_rate):
                raise AssertionError(f"small run {label}: decisions differ "
                                     f"card vs CPU")
            if not (g.handover_rate == c.handover_rate or (
                    math.isnan(g.handover_rate)
                    and math.isnan(c.handover_rate))):
                raise AssertionError(f"small run {label}: handover_rate "
                                     f"differs card vs CPU")
            if not math.isclose(g.t_round, c.t_round, rel_tol=1e-5):
                raise AssertionError(f"small run {label}: t_round differs "
                                     f"card vs CPU")
            if abs(g.test_acc - c.test_acc) > 1.0 / 40 + 1e-9:
                raise AssertionError(f"small run {label}: test_acc differs "
                                     f"by more than one of the 40 samples")


# The full-width paths: (label, FLConfig extras, rounds, the kernels the
# path must launch; DAGSA's three on every path).  "sync" is the port's
# first main path; "hier_int8" this slice's (one global sync at round 5).
_SCHED = ("bandwidth_solve", "masked_bs_argmax", "best_bs_argmax")
PATHS = (
    ("sync", {}, 3, _SCHED + ("fedavg_reduce",)),
    ("hier_int8", dict(aggregation="hierarchical", tau_global=5,
                       compress="topk-int8", topk_frac=0.1), 5,
     _SCHED + ("sparsify_quantize", "fedavg_segment_reduce_int8")),
    ("hier", dict(aggregation="hierarchical", tau_global=5), 2,
     _SCHED + ("fedavg_segment_reduce",)),
    ("single_int8", dict(compress="topk-int8", topk_frac=0.1), 2,
     _SCHED + ("sparsify_quantize", "fedavg_reduce_int8")),
)


def run_path(dev, label: str, extra: dict, rounds: int,
             required: tuple) -> tuple:
    """``rounds`` full-width rounds of one path (the paper configuration,
    50 users, 8 BSs, paper-scale CNN); returns the simulation and the
    launch counts of the run."""
    from repro_torch.fl.rounds import FLConfig, FLSimulation
    from repro_torch.kernels import _lib
    from repro_torch.models.cnn import CNNConfig, n_params

    cfg = FLConfig(dataset="mnist", scheduler="dagsa_jit",
                   cnn=CNNConfig.paper_scale(), local_epochs=10,
                   batch_size=16, seed=0, **extra)
    t0 = time.perf_counter()
    sim = FLSimulation(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"path {label}: set-up {time.perf_counter() - t0:.3f} s, "
          f"{cfg.wireless.n_users} users, {cfg.wireless.n_bs} BSs, "
          f"{n_params(sim.params)} params, n_train "
          f"{sim.data.x_train.shape[0]}, n_test {sim.data.x_test.shape[0]}, "
          f"{json.dumps(extra)}", flush=True)
    _lib.reset_launches()
    recs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        rec = sim.run(1)[0]
        torch.cuda.synchronize()
        print(f"path {label} round {rec} wall_s="
              f"{time.perf_counter() - t0:.4f}", flush=True)
        recs.append(rec)
    launches = dict(_lib.LAUNCHES)
    print(f"path {label} launches: {json.dumps(launches)}", flush=True)
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"path {label} never launched {name}")
    for rec in recs:
        if not math.isfinite(rec.t_round) or rec.t_round <= 0:
            raise AssertionError(f"round {rec.round_idx}: t_round "
                                 f"{rec.t_round} is not a finite latency")
        if rec.n_selected < sim.min_participants:
            raise AssertionError(f"round {rec.round_idx}: {rec.n_selected} "
                                 f"users < the Eq. (8h) floor")
        if not 0.0 <= rec.test_acc <= 1.0:
            raise AssertionError(f"round {rec.round_idx}: accuracy "
                                 f"{rec.test_acc} out of range")
        if "aggregation" in extra and not 0.0 <= rec.handover_rate <= 1.0:
            raise AssertionError(f"round {rec.round_idx}: handover rate "
                                 f"{rec.handover_rate} out of range")
    models = [sim.params] + ([sim.edge_params] if sim.edge_params else [])
    for tree in models:
        for leaf in tree.values():
            for p in leaf.values():
                if not bool(torch.isfinite(p).all()):
                    raise AssertionError(f"path {label}: a model went "
                                         f"non-finite")
    return sim, launches


def profile_round(sim, label: str) -> dict:
    """One more round under torch.profiler: the host time and the device
    span of each round phase (the engine's named ranges), the device ops
    that took the most time, and the device's busy share of the round's
    wall time (the sum of device op durations over the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    phases, ops = {}, {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        on_device = e.device_type == DeviceType.CUDA
        if e.name.startswith("round."):
            row = phases.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0})
            row["device_ms" if on_device else "host_ms"] += ms
        elif on_device:
            t, c = ops.get(e.name, (0.0, 0))
            ops[e.name] = (t + ms, c + 1)
    busy_ms = sum(t for t, _ in ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"path": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms, "phases": phases,
           "top_device_ops": [{"name": k[:80], "ms": t, "calls": c}
                              for k, (t, c) in top]}
    print(json.dumps({"profile": out}), flush=True)
    return out


def kernel_rows(results: dict, launches: dict) -> list:
    """One row per kernel for the ``{"kernels": [...]}`` line: the main
    shape's numbers, the launches of the path named in KERNELS (and of
    every path), and the fleet shapes' numbers."""
    rows = []
    for name, (source, replaces, path) in KERNELS.items():
        main_row = results[name]["main"]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "launches_path": path,
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "shape": main_row["shape"],
            **{label: {k: v for k, v in row.items() if k != "name"}
               for label, row in results[name].items() if label != "main"}})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              f"checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn (float32 means float32)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)

    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"from {_lib.CSRC}", flush=True)

    results = check_kernels(dev)
    check_small_runs(dev)
    sims, launches = {}, {}
    for label, extra, rounds, required in PATHS:
        sims[label], launches[label] = run_path(dev, label, extra, rounds,
                                                required)
    profile_round(sims["sync"], "sync")
    profile_round(sims["hier_int8"], "hier_int8")

    print(json.dumps({"kernels": kernel_rows(results, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

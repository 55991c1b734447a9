#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py              # everything below, one card
    python3 chip_smoke.py --kernels    # steps 1-3 and 7a only
    python3 chip_smoke.py --sweeps     # step 1, the build, the plans' sweeps

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a and prints the build seconds, then the host us of the
   pieces a kernel launch is made of;
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (N=50 users, M=8 BSs, every leaf of the paper-scale
   CNN) and at a fleet shape (N=1e6 users x M=100 and x M=33 BSs,
   masked_bs_argmax also over int8 dB codes and bfloat16 with a per-BS
   scale, best_bs_argmax also on an snr off 16-byte alignment; the
   Eq. (11) solve on one row per path of its plan: [8, 50] (warp),
   [33, 4097] (block) and [100, 1e6] (cluster) at 30% of the users a row
   and at ~1e4 ("fleet_sparse"), newton and bisect; FedAvg, per-BS
   FedAvg (M=8 and M=100, 50%-dense and the path's one-hot weights) and
   the uplink compressor over 1,000 clients of the fc1 leaf), in float32
   and over int8 codes, and times the kernel, the plain version and one
   PyTorch call as a yardstick: each row's ``ms`` (CUDA events around
   back-to-back calls), ``graph_ms`` (the same calls captured in one CUDA
   graph and replayed: device time alone) and ``host_us`` (host time of
   one call), the yardstick's likewise (``--sweeps`` instead runs the
   card sweeps behind the plans of masked_bs_argmax, rows a block:
   ``masked_variants``, and of bandwidth_solve, warp or block and slices
   a row: ``bandwidth_variants``);
4. checks small runs on the card against the same runs on the CPU (the
   plain versions, the default scheduler, host DAGSA): the synchronous
   round, hierarchical aggregation, and hierarchical aggregation over the
   top-k + int8 compressed uplink;
5. drives the port's full-width paths on the card, each with the kernels'
   launch counts zeroed just before it and read just after: the
   synchronous single-tier round (3 rounds, ``dagsa_jit``), hierarchical
   aggregation with the top-k + int8 uplink (5 rounds, one global sync),
   hierarchical aggregation uncompressed (2 rounds), the single-tier top-k
   + int8 uplink (2 rounds) and the synchronous round under the default
   scheduler, the host DAGSA (``sync_dagsa``, 2 rounds);
6. profiles one more synchronous round and one more hierarchical +
   compressed round (torch.profiler: host and device time per round
   phase, the busiest device ops, the device's busy share);
7. the LM serving slice (Zamba2-1.2B, 38 Mamba2 layers + one shared
   attention block every 6, at full width and full depth):
   a. holds kernels 7-9 (flash_attention, rmsnorm, ssd_scan) against their
      plain versions in float32 and bfloat16 at the prefill shapes B=4,
      S=512 ("main") and B=8, S=2048 ("long"), flash also at S=200 and
      rmsnorm at the decode shape [4, 2048], at the qk_norm width 128 and
      on rows off 16-byte alignment, ssd_scan at mamba2-2.7b's head shape
      (80 heads of 64, state 128: "state128"), with the tolerances of
      tests/test_kernels.py, and times kernel, plain version and yardstick;
   b. runs the two reduced float32 configs of the tests on the card and on
      the CPU (prefill + 8 decode steps), within 1e-4;
   c. at full width in float32 holds ``lm.forward`` over 200 tokens
      against 200 cached ``decode_step`` logits within 5e-3;
   d. serves in the published bfloat16 (``zamba2_serve``, launch counts
      zeroed just before and read just after): ``serve_decode.serve`` at
      B=4, prompt 512, 32 new tokens, and ``api.prefill_fn`` on the same
      prompts and at B=8, S=2048;
   e. profiles one bfloat16 prefill (B=4, S=512) and one decode step
      (kernel 9's device ms a prefill among them);
8. prints one JSON line with every kernel's numbers, then, as the last
   line, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line.  TF32 is turned off for
matmuls and convolutions, so float32 on the card means float32.  Exits
non-zero when no CUDA device is present or when run outside the checkout.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_OPS_S = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_BF16_OPS_S = 989e12    # H100 SXM bfloat16 tensor cores, dense
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
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82",
                        "zamba2_serve"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:40", "zamba2_serve"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:72", "zamba2_serve"),
}


def _time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean time of one call, from CUDA events around ``reps`` calls made
    back to back: the device time, or the host's enqueue time where that
    is longer (a launch-bound call)."""
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


def _graph_ms(fn, reps: int, what: str) -> float | None:
    """Device time of one call without the host: ``reps`` calls captured
    in one CUDA graph, replayed between CUDA events.  None, with the
    reason printed, where the call cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                   # warm-up off the
        fn()                                        # capture, as advised
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as err:
        print(f"graph_ms {what}: not captured ({err})", flush=True)
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _host_us(fn, reps: int) -> float:
    """Mean host time of one call, by perf_counter_ns over ``reps`` calls
    with no synchronise inside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def _timings(kernel, label, fn, plain, lib, reps) -> dict:
    """The timed fields of a kernel row: the wrapper's event time (``ms``),
    its graph-replayed device time and its host time per call, the plain
    version's event time, and the yardstick call's three times.  ``ms``
    and ``host_us`` (the yardstick's too) are medians of three rounds,
    the wrapper and the yardstick in turns."""
    what = f"{kernel} {label}"
    ms, host, lib_ms, lib_host = [], [], [], []
    for _ in range(3):
        ms.append(_time_ms(fn, reps))
        host.append(_host_us(fn, reps))
        if lib is not None:
            lib_ms.append(_time_ms(lib, reps))
            lib_host.append(_host_us(lib, reps))
    row = {"ms": statistics.median(ms), "graph_ms": _graph_ms(fn, reps, what),
           "host_us": statistics.median(host),
           "plain_ms": _time_ms(plain, max(1, reps // 4)),
           "library_ms": None, "library_graph_ms": None,
           "library_host_us": None}
    if lib is not None:
        row.update(library_ms=statistics.median(lib_ms),
                   library_graph_ms=_graph_ms(lib, reps, what + " yardstick"),
                   library_host_us=statistics.median(lib_host))
    return row


def _bound_ms(n_bytes: float, n_ops: float,
              peak_ops: float = PEAK_F32_OPS_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _close(name, got, want, exact=False, scale=None, atol=1e-6):
    """Max abs error of got vs want; raises past the stated tolerance:
    exact, or |got - want| <= RTOL * scale + atol with scale = |want| (or,
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
    lim = RTOL * base[fin] + atol
    if bool((err > lim).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"exceeds rtol {RTOL}")
    return float(err.max()) if err.numel() else 0.0


def host_costs(dev, reps: int = 2000) -> dict:
    """Host us per call of the pieces a wrapper's launch can be made of
    (allocating the output, a device guard, a torch.cuda.Stream object or
    the raw stream handle, a lock, ``Tensor.device``), and of three whole
    wrappers at their main-path shapes beside their yardstick calls."""
    import threading

    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import select_topk as ks

    x = torch.randn((4, 2048), device=dev).to(torch.bfloat16)
    scale = torch.ones(2048, device=dev, dtype=torch.bfloat16)
    snr = torch.rand((50, 8), device=dev)
    rem = torch.rand((50,), device=dev) < 0.5
    index, lock = torch.cuda.current_device(), threading.Lock()

    def guard():
        with torch.cuda.device(x.device):
            pass

    def locked():
        with lock:
            pass

    pieces = {
        "empty_like": lambda: torch.empty_like(x),
        "device_guard": guard,
        "current_stream_object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "current_device": torch.cuda.current_device,
        "lock": locked,
        "tensor_device": lambda: x.device,
        "data_ptr": x.data_ptr,
        "rmsnorm_wrapper_4x2048_bf16": lambda: krn.rmsnorm(x, scale),
        "F.rms_norm_4x2048_bf16": lambda: F.rms_norm(x, (2048,), weight=scale,
                                                     eps=1e-6),
        "best_bs_argmax_wrapper_50x8": lambda: ks.best_bs_argmax(snr),
        "torch.argmax_50x8": lambda: torch.argmax(snr, dim=1),
        "masked_bs_argmax_wrapper_50x8": lambda: ks.masked_bs_argmax(snr, rem),
        "torch.argmax_masked_50x8": lambda: torch.argmax(
            torch.where(rem[:, None], snr, -torch.inf), dim=0),
    }
    out = {name: _host_us(fn, reps) for name, fn in pieces.items()}
    print(json.dumps({"host_costs_us": out}), flush=True)
    return out


def _bw_case(gen, dev, k, u, density):
    """Eq. (11) rows: coeff from a dB-spread SNR, tcomp shared, ``density``
    of the users masked in; with 3 rows or more, row 1 empty (-> 0), row 0
    warm-started inside the bracket and row 2 above hi (clipped to hi)."""
    snr = torch.pow(10.0, torch.rand((k, u), generator=gen, device=dev)
                    * 6.0 - 1.0)
    coeff = (0.5 / torch.log2(1.0 + snr)).contiguous()
    tcomp = 0.10 + 0.01 * torch.rand((u,), generator=gen, device=dev)
    mask = torch.rand((k, u), generator=gen, device=dev) < density
    bw = torch.full((k,), 1.0, device=dev)
    lo = torch.zeros((k,), device=dev)
    if k >= 3:
        mask[1] = False
        lo[0] = 0.2
        lo[2] = 1e6
    return coeff, tcomp, mask, bw, lo


def sweep_bandwidth(dev, gen, fleet_bs, fleet_users, reps=3) -> list:
    """The card sweep behind bandwidth_plan: ``graph_ms`` of kernel 1's
    launch plans (the path, the slices a row), each first held to the
    plain version (newton).  Short rows: warp vs one block; medium and
    fleet rows (30% and ~1e4 users a row): 1-8 slices."""
    from repro_torch.kernels import bandwidth_solve as kb

    def plans_for(u, slices_list):
        return [(f"s{s}", kb.BwPlan("cluster", slices=s,
                                    slice=-(-u // (8 * s)) * 8))
                for s in slices_list]

    cases = []
    for u in (64, 128, 256):
        cases.append((f"short_u{u}", 8, u, 0.3,
                      [("warp", kb.bandwidth_plan(8, u))]
                      + plans_for(u, (1,))))
    for k, u in ((8, 4096), (33, 4097), (8, 16384), (8, 65536),
                 (33, 65536), (8, 262144), (1, fleet_users)):
        cases.append((f"medium_k{k}_u{u}", k, u, 0.3,
                      plans_for(u, (1, 2, 4, 8))))
    for label, density in (("fleet", 0.3),
                           ("fleet_sparse", 1e4 / fleet_users)):
        cases.append((label, fleet_bs, fleet_users, density,
                      plans_for(fleet_users, (1, 2, 4, 8))))
    rows = []
    for label, k, u, density, plans in cases:
        coeff, tcomp, mask, bw, lo = _bw_case(gen, dev, k, u, density)
        want = kb.bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo)
        for name, plan in plans:
            def fn(plan=plan):
                return kb.solve_cuda(0, coeff, tcomp, mask, bw, lo, None,
                                     "newton", plan)
            _close(f"bandwidth sweep {label} {name}", fn(), want, atol=1e-7)
            # small rows: enough calls that the replay's own cost fades
            n_calls = reps if k * u > 2_000_000 else 100
            row = {"case": label, "k": k, "u": u, "density": density,
                   "variant": name, "plan": plan._asdict(),
                   "graph_ms": _graph_ms(fn, n_calls, f"{label} {name}")}
            rows.append(row)
        del coeff, tcomp, mask
    print(json.dumps({"bandwidth_variants": rows}), flush=True)
    return rows


def sweep_masked(dev, n, m, reps=20) -> list:
    """The card sweep behind masked_bs_plan's block size: ``graph_ms`` of
    masked_bs_argmax at the fleet shapes (float32 at M and at 33 BSs,
    bfloat16 and int8 at M) with 1/8-4x the plan's rows a block, each
    first held to the plain version exactly."""
    from repro_torch.kernels import select_topk as ks

    gen = torch.Generator(device=dev).manual_seed(1)
    rem = torch.rand((n,), generator=gen, device=dev) < 0.5
    rows = []
    for label, cols, dtype in (("fleet", m, torch.float32),
                               ("m33", 33, torch.float32),
                               ("fleet_bf16", m, torch.bfloat16),
                               ("fleet_int8", m, torch.int8)):
        snr = torch.randn((n, cols), generator=gen, device=dev) * 40.0
        snr = snr.to(dtype)
        scale = torch.rand((cols,), generator=gen, device=dev) + 0.05
        want = ks.masked_bs_argmax_plain(snr, rem, scale)
        v, threads, rpt, per_block, _ = ks.masked_bs_plan(n, cols, dtype,
                                                          True)
        step = 8 * rpt                  # a block: whole 8-tile steps
        for f in (0.125, 0.25, 0.5, 1, 2, 4):
            rows_f = max(step, int(per_block * f) // step * step)
            plan = (v, threads, rpt, rows_f, -(-n // rows_f))

            def fn(plan=plan):
                return ks.masked_cuda(0, snr, rem, scale, plan)
            for got, w in zip(fn(), want):
                _close(f"masked sweep {label} x{f}", got, w, exact=True)
            rows.append({"case": label, "dtype": str(dtype), "m": cols,
                         "rows_per_block": rows_f, "blocks": plan[4],
                         "graph_ms": _graph_ms(fn, reps, f"{label} x{f}")})
        del snr
    print(json.dumps({"masked_variants": rows}), flush=True)
    return rows


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
               reps, extra=None):
        bound, by = _bound_ms(n_bytes, n_ops)
        row = {"name": kernel, "shape": shape, "max_abs_err": err,
               **_timings(kernel, label, fn, plain, lib, reps),
               "bound_ms": bound, "bound_by": by, **(extra or {})}
        results[kernel][label] = row
        print(json.dumps({"check": label, **row}), flush=True)

    # -- selection argmaxes (Algorithm 1 steps 1 and 3) --------------------
    # "m33": one BS past a warp's 32 lanes (kernel 3's lane groups).
    for label, n, m, reps in (("main", 50, 8, 200),
                              ("fleet", fleet_users, fleet_bs, 20),
                              ("m33", fleet_users, 33, 20)):
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
        off = torch.empty(n * m + 1, device=dev)[1:].view(n, m)  # 4 bytes
        off.copy_(snr)                                  # off 16-byte align
        _close("best_bs_argmax unaligned", ks.best_bs_argmax(off), bb,
               exact=True)
        del off
        record("best_bs_argmax", label, [n, m], 0.0,
               lambda: ks.best_bs_argmax(snr),
               lambda: ks.best_bs_argmax_plain(snr),
               lambda: torch.argmax(snr, dim=1),
               n * m * 4 + n * 4, n * m, reps)

    # -- masked_bs_argmax over bf16 / int8 storage with a per-BS scale ------
    # (int8: quantize_snr_int8's dB codes; bf16: the linear SNR over its
    # column maximum; one BS's scale negative), exact against plain
    n, m = fleet_users, fleet_bs
    snr = torch.pow(10.0, torch.rand((n, m), generator=gen, device=dev)
                    * 6.0 - 1.0)
    rem = torch.rand((n,), generator=gen, device=dev) < 0.5
    db = 10.0 * torch.log10(snr)
    q_scale = torch.clamp(db.abs().amax(dim=0), min=1e-6) / 127.0
    q_scale[m // 2] = -q_scale[m // 2]
    for label, codes, scale in (
            ("fleet_int8", torch.clamp(torch.round(db / q_scale), -127, 127)
             .to(torch.int8), q_scale),
            ("fleet_bf16", snr.to(torch.bfloat16), 1.0 / snr.amax(dim=0))):
        cand, best = ks.masked_bs_argmax(codes, rem, scale)
        c_ref, b_ref = ks.masked_bs_argmax_plain(codes, rem, scale)
        _close(f"masked_bs_argmax {label} cand", cand, c_ref, exact=True)
        err = _close(f"masked_bs_argmax {label} best", best, b_ref,
                     exact=True)
        record("masked_bs_argmax", label, [n, m], err,
               lambda: ks.masked_bs_argmax(codes, rem, scale),
               lambda: ks.masked_bs_argmax_plain(codes, rem, scale),
               lambda: torch.argmax(torch.where(
                   rem[:, None], codes.float() * scale, -torch.inf), dim=0),
               n * m * codes.element_size() + n + 3 * m * 4, 2 * n * m, 20)
    del snr, rem, db, codes

    # -- Eq. (11) solve: K trial rows over U users, tcomp shared, one row
    # per path of bandwidth_plan: warp (main), block (medium), cluster
    # (fleet: 30% of the users a row; fleet_sparse: ~1e4 users a row) ------
    for label, k, u, density, reps in (
            ("main", 8, 50, 0.3, 200), ("medium", 33, 4097, 0.3, 50),
            ("fleet", fleet_bs, fleet_users, 0.3, 5),
            ("fleet_sparse", fleet_bs, fleet_users, 1e4 / fleet_users, 10)):
        coeff, tcomp, mask, bw, lo = _bw_case(gen, dev, k, u, density)
        for method in ("newton", "bisect"):
            got = kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo,
                                     method=method)
            want = kb.bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo,
                                            method=method)
            err = _close(f"bandwidth_solve {label} {method}", got, want,
                         atol=1e-7)
            if got[1].item() != 0.0:
                raise AssertionError("bandwidth_solve: empty row must be 0")
        err = _close(f"bandwidth_solve {label}", kb.bandwidth_solve(
            coeff, tcomp, mask, bw, lo=lo), kb.bandwidth_solve_plain(
            coeff, tcomp, mask, bw, lo=lo), atol=1e-7)
        nnz = float(mask.sum())
        # the bound counts what this run's data needs: the mask, and c and
        # tc of the users masked in (tc once per user that any row takes);
        # every input read once is kept beside it
        data_bytes = k * u + nnz * 4 + float(mask.any(dim=0).sum()) * 4 \
            + 3 * k * 4
        record("bandwidth_solve", label, [k, u], err,
               lambda: kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo),
               lambda: kb.bandwidth_solve_plain(coeff, tcomp, mask, bw, lo=lo),
               None, data_bytes, (16 * 7 + 3) * nnz, reps,
               extra={"plan": kb.bandwidth_plan(k, u)._asdict(),
                      "users_per_row": nnz / k,
                      "bound_bytes_once_ms": _bound_ms(
                          k * u * 4 + u * 4 + k * u + 3 * k * 4,
                          (16 * 7 + 3) * nnz)[0]})
        del coeff, tcomp, mask

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
    from repro_torch.fl.server import segment_weights

    def segment_case(n, m, int8, onehot=False):
        """x, and a w that is 50% dense with an empty BS column or, with
        ``onehot``, what segment_weights gives the path for a random
        assignment (one BS a client, ~10% unassigned, BS m // 2 empty)."""
        x = int8_codes(n, d) if int8 else torch.randn(
            (n, d), generator=gen, device=dev)
        if not int8:
            x[3 % n, d // 2] = float("nan")         # poisoned entries
            x[(7 % n), 0] = float("-inf")
        if onehot:
            bs = torch.randint(0, m, (n,), generator=gen, device=dev)
            bs[bs == m // 2] = (m // 2 + 1) % m     # an empty BS
            assigned = torch.rand((n,), generator=gen, device=dev) >= 0.1
            sizes = torch.randint(50, 150, (n,), generator=gen, device=dev)
            w, _ = segment_weights(torch.nn.functional.one_hot(bs, m).bool()
                                   & assigned[:, None], sizes)
            return w.contiguous(), x
        w = torch.rand((n, m), generator=gen, device=dev)
        w = w * (torch.rand((n, m), generator=gen, device=dev) < 0.5)
        w[:, m // 2] = 0.0                          # an empty BS column
        return w.contiguous(), x

    for kernel, int8 in (("fedavg_segment_reduce", False),
                         ("fedavg_segment_reduce_int8", True)):
        for leaf, shp in shapes.items():            # every leaf, M = 8
            for onehot in (False, True):
                w, x = segment_case(50, 8, int8, onehot)
                x = x[:, : math.prod(shp)].contiguous()
                _close(f"{kernel} {leaf} onehot={onehot}",
                       kf.segment_reduce_leaf(w, x),
                       kf.segment_reduce_leaf_plain(w, x),
                       scale=kf.segment_reduce_leaf_plain(w,
                                                          x.float().abs()))
        for label, n, m, onehot, reps in (
                ("main", 50, 8, False, 200),
                ("fleet", fleet_clients, 8, False, 20),
                ("fleet_m100", fleet_clients, 100, False, 10),
                ("fleet_onehot", fleet_clients, 8, True, 20),
                ("fleet_m100_onehot", fleet_clients, 100, True, 20)):
            w, x = segment_case(n, m, int8, onehot)
            got = kf.segment_reduce_leaf(w, x)
            err = _close(f"{kernel} {label}", got,
                         kf.segment_reduce_leaf_plain(w, x),
                         scale=kf.segment_reduce_leaf_plain(
                             w, x.float().abs()))
            if bool((got[m // 2] != 0).any()):
                raise AssertionError(f"{kernel}: an empty BS column must "
                                     f"sum to 0")
            # The bound counts the products this w needs (2 nnz(w) D, a
            # sparse product), beside the dense 2 N M D of the last BS tile
            # walking every client; the bytes read x once.
            x_bytes = n * d * (1 if int8 else 4)
            n_bytes = x_bytes + n * m * 4 + m * d * 4
            nnz = int((w != 0).sum())
            record(kernel, label, [n, m, d], err,
                   lambda: kf.segment_reduce_leaf(w, x),
                   lambda: kf.segment_reduce_leaf_plain(w, x),
                   lambda: w.t() @ x.float(), n_bytes, 2 * nnz * d, reps,
                   extra={"nnz_w": nnz,
                          "bound_bytes_ms": _bound_ms(n_bytes, 0)[0],
                          "bound_dense_ops_ms": _bound_ms(
                              0, 2 * n * m * d)[0]})
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
# path must launch; dagsa_jit's three on every path that runs it).  "sync" is the port's
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
    # the default scheduler: host greedy, Eq. (12) on the card
    ("sync_dagsa", dict(scheduler="dagsa"), 2,
     ("bandwidth_solve", "fedavg_reduce")),
)


def run_path(dev, label: str, extra: dict, rounds: int,
             required: tuple) -> tuple:
    """``rounds`` full-width rounds of one path (the paper configuration,
    50 users, 8 BSs, paper-scale CNN); returns the simulation and the
    launch counts of the run."""
    from repro_torch.fl.rounds import FLConfig, FLSimulation
    from repro_torch.kernels import _lib
    from repro_torch.models.cnn import CNNConfig, n_params

    cfg = FLConfig(**{"dataset": "mnist", "scheduler": "dagsa_jit",
                      "cnn": CNNConfig.paper_scale(), "local_epochs": 10,
                      "batch_size": 16, "seed": 0, **extra})
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


# ------------------------------------------------------- the LM slice ------
# Tolerances of tests/test_kernels.py (float32, bfloat16), which the Pallas
# kernels are held to against their oracles.
LM_TOL = {"rmsnorm": (1e-6, 2e-2), "flash_attention": (2e-5, 2e-2),
          "ssd_scan": (2e-4, 5e-2)}


def _close_tol(name, got, want, tol) -> float:
    """Max abs err of got vs want; raises past |d| <= tol + tol * |want|."""
    got, want = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} of {err.numel()} "
                             f"entries past tol {tol}, max abs err "
                             f"{err.max().item():.3e}")
    return float(err.max())


def _ssd_ops(b, s, h, p, n, q) -> float:
    """Multiply-adds x 2 of the chunked SSD: per chunk and head the causal
    C B^T scores and their product with x (q(q+1)/2 pairs each), the
    carried-in term and the state update (q n p each)."""
    pairs = q * (q + 1) // 2
    return 2.0 * b * h * (s // q) * (pairs * (n + p) + 2 * q * n * p)


def check_lm_kernels(dev, main=(4, 512), long=(8, 2048), ragged=200,
                     decode_rows=4) -> dict:
    """Kernels 7-9 against their plain versions on the card at Zamba2's
    widths (d_model 2048; 32 heads of 64; 64 SSM heads of 64, state 64,
    chunk 128), float32 and bfloat16.  Labels: "main" (bfloat16, B x S =
    4 x 512, the serving path's type and prompt), "long" (8 x 2048), the
    "_f32" twins, flash "ragged" (S = 200) and rmsnorm "decode" ([4, 2048],
    one token per sequence)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import ssd_scan as kss

    gen = torch.Generator(device=dev).manual_seed(13)
    results = {"flash_attention": {}, "rmsnorm": {}, "ssd_scan": {}}
    d_model, heads, hd, ssm_p, chunk = 2048, 32, 64, 64, 128

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(kernel, label, shape, err, fn, plain, lib, n_bytes, n_ops,
               peak, reps, extra=None):
        bound, by = _bound_ms(n_bytes, n_ops, peak)
        row = {"name": kernel, "shape": shape, "max_abs_err": err,
               **_timings(kernel, label, fn, plain, lib, reps),
               "bound_ms": bound, "bound_by": by, **(extra or {})}
        results[kernel][label] = row
        print(json.dumps({"check": label, **row}), flush=True)

    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        esize = 2 if dtype == torch.bfloat16 else 4
        tol = 1 if dtype == torch.bfloat16 else 0
        peak = PEAK_BF16_OPS_S if dtype == torch.bfloat16 else PEAK_F32_OPS_S

        # -- 8 rmsnorm: rows = B*S in prefill, B in decode; "qk_norm" the
        # per-head norm of 16 heads of 128 (Qwen3, ROADMAP A.1a) at the main
        # prompt; "unaligned" the main rows one element off 16-byte
        # alignment (a slice of a larger buffer: the scalar path) ----------
        for label, rows, d, offset, reps in (
                ("main", main[0] * main[1], d_model, 0, 50),
                ("long", long[0] * long[1], d_model, 0, 20),
                ("decode", decode_rows, d_model, 0, 200),
                ("qk_norm", main[0] * main[1] * 16, 128, 0, 50),
                ("unaligned", main[0] * main[1], d_model, 1, 50)):
            x = normal((rows * d + offset,), dtype)[offset:].view(rows, d)
            scale = (1.0 + 0.1 * normal((d,), torch.float32)).to(dtype)
            err = _close_tol(f"rmsnorm {label}{suffix}", krn.rmsnorm(x, scale),
                             krn.rmsnorm_plain(x, scale),
                             LM_TOL["rmsnorm"][tol])
            record("rmsnorm", label + suffix, [rows, d], err,
                   lambda: krn.rmsnorm(x, scale),
                   lambda: krn.rmsnorm_plain(x, scale),
                   lambda: F.rms_norm(x, (d,), weight=scale, eps=1e-6),
                   2 * rows * d * esize + d * esize,
                   4.0 * rows * d, PEAK_F32_OPS_S, reps,
                   # a device copy of x: what one read and one write of
                   # these bytes take on this card in practice
                   extra={"copy_graph_ms": _graph_ms(
                       x.clone, reps, f"rmsnorm {label}{suffix} copy")})

        # -- 7 flash attention: the shared block's causal self-attention ---
        for label, (b, s), reps in (("main", main, 20), ("long", long, 5),
                                    ("ragged", (main[0], ragged), 20)):
            q, k, v = (normal((b, s, heads, hd), dtype) for _ in range(3))
            err = _close_tol(f"flash_attention {label}{suffix}",
                             kfa.flash_attention(q, k, v, causal=True),
                             kfa.flash_attention_plain(q, k, v, causal=True),
                             LM_TOL["flash_attention"][tol])
            pairs = s * (s + 1) // 2
            record("flash_attention", label + suffix, [b, s, heads, hd], err,
                   lambda: kfa.flash_attention(q, k, v, causal=True),
                   lambda: kfa.flash_attention_plain(q, k, v, causal=True),
                   lambda: F.scaled_dot_product_attention(
                       q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), is_causal=True),
                   4 * b * s * heads * hd * esize,
                   4.0 * b * heads * pairs * hd, peak, reps)
            del q, k, v

        # -- 9 ssd scan: one Mamba2 layer's chunked scan; "state128" the
        # head shape of mamba2-2.7b (80 heads of 64, state 128) -----------
        for label, (b, s), ssm_h, ssm_n, reps in (
                ("main", main, 64, 64, 10), ("long", long, 64, 64, 3),
                ("state128", main, 80, 128, 10)):
            x = normal((b, s, ssm_h, ssm_p), dtype)
            dt = F.softplus(normal((b, s, ssm_h), torch.float32))
            A = -torch.exp(normal((ssm_h,), torch.float32) * 0.5)
            Bm, Cm = (normal((b, s, 1, ssm_n), dtype) for _ in range(2))
            y = kss.ssd_scan(x, dt, A, Bm, Cm, chunk)
            if y.dtype != torch.float32:
                raise AssertionError("ssd_scan must return float32")
            err = _close_tol(f"ssd_scan {label}{suffix}", y,
                             kss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk),
                             LM_TOL["ssd_scan"][tol])
            record("ssd_scan", label + suffix, [b, s, ssm_h, ssm_p, ssm_n],
                   err,
                   lambda: kss.ssd_scan(x, dt, A, Bm, Cm, chunk),
                   lambda: kss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk), None,
                   b * s * ssm_h * ssm_p * (esize + 4) + b * s * ssm_h * 4
                   + ssm_h * 4 + 2 * b * s * ssm_n * esize,
                   _ssd_ops(b, s, ssm_h, ssm_p, ssm_n, chunk), peak, reps)
            del x, dt, Bm, Cm, y
    torch.cuda.synchronize()
    return results


def _zamba(**changes):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2_1_2b"), **changes)


def check_zamba_small(dev) -> None:
    """The two reduced float32 configs of tests/test_torch_zamba.py (one
    group; two groups + a tail layer), prefill + 8 decode steps, on the
    card against the CPU (plain versions) within 1e-4."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.models import api, lm
    from repro_torch.tree import tree_map

    base = _zamba().reduced()
    for cfg in (base, dataclasses.replace(base, n_layers=5)):
        params = api.init_params(rng.PRNGKey(0), cfg)
        toks = rng.randint(rng.PRNGKey(1), (2, 41), 0, cfg.vocab)
        out = {}
        for d in ("cpu", dev):
            p = tree_map(lambda w: w.to(d), params)
            t = toks.to(d)
            logits, _ = lm.forward(p, cfg, {"tokens": t})
            pre = api.prefill_fn(p, cfg, {"tokens": t[:, :40]})
            cache = api.init_cache(cfg, 2, 8, device=d)
            steps = torch.stack([api.decode_step(p, cfg, cache, t[:, i:i + 1],
                                                 i)[0] for i in range(8)])
            out[str(d)] = (logits, pre, steps)
        errs = [_close_tol(f"zamba small n_layers={cfg.n_layers} {what}",
                           g.cpu(), c, 1e-4)
                for what, g, c in zip(("forward", "prefill", "decode"),
                                      out[str(dev)], out["cpu"])]
        print(f"zamba small n_layers={cfg.n_layers}: card vs CPU max abs err "
              f"forward {errs[0]:.3e} prefill {errs[1]:.3e} decode "
              f"{errs[2]:.3e}", flush=True)


def check_zamba_full_f32(dev, b: int = 2, t: int = 200) -> None:
    """Full width and depth in float32: ``lm.forward`` logits over ``t``
    tokens against the ``t`` stacked cached ``decode_step`` logits, within
    rtol=atol=5e-3 (tests/test_models.py's forward-vs-decode tolerance).
    The prefill path runs kernels 7-9, the decode path the recurrences."""
    from repro_torch import rng
    from repro_torch.models import api, lm

    cfg = _zamba(dtype="float32")
    t0 = time.perf_counter()
    params = api.init_params(rng.PRNGKey(0, device=dev), cfg)
    torch.cuda.synchronize()
    print(f"zamba f32: init {time.perf_counter() - t0:.2f} s, "
          f"{lm.n_params(params)} params", flush=True)
    toks = rng.randint(rng.PRNGKey(1, device=dev), (b, t + 1), 0, cfg.vocab)
    fwd, _ = lm.forward(params, cfg, {"tokens": toks})
    cache = api.init_cache(cfg, b, t, device=dev)
    t0 = time.perf_counter()
    steps = torch.stack([api.decode_step(params, cfg, cache,
                                         toks[:, i:i + 1], i)[0]
                         for i in range(t)], dim=1)
    torch.cuda.synchronize()
    err = (steps - fwd).abs()
    lim = 5e-3 + 5e-3 * fwd.abs()
    print(f"zamba f32 forward vs {t} decode steps: max abs err "
          f"{err.max().item():.3e} (logit scale {fwd.abs().max().item():.3f})"
          f", decode {(time.perf_counter() - t0) / t * 1e3:.2f} ms/step",
          flush=True)
    if not bool(torch.isfinite(fwd).all()) or bool((err > lim).any()):
        raise AssertionError("zamba f32: forward and cached decode disagree "
                             "past rtol=atol=5e-3")


def run_zamba_serve(dev, batch=4, prompt_len=512, gen_len=32,
                    long=(8, 2048)) -> tuple:
    """The serving path in the published bfloat16: ``serve_decode.serve``
    then ``api.prefill_fn`` on the same prompts and at ``long``; returns
    (params, cfg, prompt, launch counts of the path)."""
    from repro_torch import rng
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve_decode
    from repro_torch.models import api, lm

    cfg = _zamba()
    t0 = time.perf_counter()
    params = api.init_params(rng.PRNGKey(0, device=dev), cfg)
    torch.cuda.synchronize()
    print(f"path zamba2_serve: set-up {time.perf_counter() - t0:.2f} s, "
          f"{lm.n_params(params)} params in {cfg.dtype}", flush=True)
    _lib.reset_launches()
    res = serve_decode.serve(cfg, "zamba2_serve", batch=batch,
                             prompt_len=prompt_len, gen_len=gen_len,
                             device=dev, params=params)

    def prefill(tokens):
        return api.prefill_fn(params, cfg, {"tokens": tokens})

    def timed(tokens, reps):
        prefill(tokens)                              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = prefill(tokens)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / reps * 1e3

    pre, pre_ms = timed(res.prompt, 3)
    long_toks = rng.randint(rng.PRNGKey(2, device=dev), long, 0, cfg.vocab)
    pre_long, long_ms = timed(long_toks, 2)
    launches = dict(_lib.LAUNCHES)
    print(f"path zamba2_serve launches: {json.dumps(launches)}", flush=True)
    for name in ("flash_attention", "rmsnorm", "ssd_scan"):
        if launches[name] <= 0:
            raise AssertionError(f"path zamba2_serve never launched {name}")
    for name, x in (("prefill", pre), ("prefill long", pre_long),
                    ("stepped prompt", res.prompt_logits)):
        if not bool(torch.isfinite(x.float()).all()):
            raise AssertionError(f"zamba2_serve: {name} logits not finite")
    toks = res.tokens
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError("zamba2_serve: a greedy token outside the vocab")
    delta = (pre.float() - res.prompt_logits.float()).abs().max().item()
    print(json.dumps({"zamba2_serve": {
        "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
        "prefill_ms": pre_ms, "prefill_tok_per_s": batch * prompt_len
        / pre_ms * 1e3, "fill_by_steps_s": res.fill_s,
        "decode_ms_per_token": res.decode_s / gen_len * 1e3,
        "decode_tok_per_s": batch * gen_len / res.decode_s,
        "serve_tok_per_s": res.tok_per_s,
        "prefill_long_shape": list(long), "prefill_long_ms": long_ms,
        "prefill_long_tok_per_s": long[0] * long[1] / long_ms * 1e3,
        "max_abs_prefill_vs_stepped": delta,
        "sample": toks[0, :8].tolist()}}), flush=True)
    return params, cfg, res.prompt, launches


def _device_ops(prof) -> dict:
    from torch.autograd import DeviceType
    ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = ops.get(e.name, (0.0, 0))
            ops[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return ops


_LM_KERNEL_NAMES = {"flash_attention": "flash_fwd_",
                    "rmsnorm": "rmsnorm_", "ssd_scan": "ssd_"}
_MATMUL_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "matmul", "splitk")


def _host_ms_inside(module, name: str, fn,
                    reps: int = 5) -> tuple[float, float]:
    """Runs ``fn`` ``reps`` times with ``module.name`` wrapped in a host
    timer: (host ms spent inside ``module.name``, wall ms), each per run."""
    inner = getattr(module, name)
    spent = [0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter_ns()
        out = inner(*args, **kwargs)
        spent[0] += time.perf_counter_ns() - t0
        return out

    setattr(module, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    finally:
        setattr(module, name, inner)
    return spent[0] / 1e6 / reps, wall_ms


def profile_zamba(params, cfg, prompt, dev) -> dict:
    """One bfloat16 prefill and one decode step under torch.profiler: the
    device time of kernels 7-9, of the matmuls and of the rest, the
    device's busy share of the wall time, the number of device ops, and
    the launches of kernels 7-9; and, from 5 unprofiled runs before that,
    the host time spent in kernel 8's wrapper a run and its share of the
    run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _lib
    from repro_torch.models import api, layers

    cache = api.init_cache(cfg, prompt.shape[0], prompt.shape[1] + 1,
                           device=dev)
    out = {}
    for label, fn in (
            ("prefill", lambda: api.prefill_fn(params, cfg,
                                               {"tokens": prompt})),
            ("decode_step", lambda: api.decode_step(
                params, cfg, cache, prompt[:, :1], 0))):
        fn()                                         # warm-up
        rms_host_ms, plain_wall_ms = _host_ms_inside(layers, "rmsnorm", fn)
        _lib.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: _lib.LAUNCHES[k] for k in _LM_KERNEL_NAMES}
        ops = _device_ops(prof)
        busy = sum(t for t, _ in ops.values())
        kern = {k: sum(t for name, (t, _) in ops.items() if mark in name)
                for k, mark in _LM_KERNEL_NAMES.items()}
        mm = sum(t for name, (t, _) in ops.items()
                 if any(m in name.lower() for m in _MATMUL_MARKS))
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
        out[label] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                      "rmsnorm_host_ms": rms_host_ms,
                      "rmsnorm_host_share": rms_host_ms / plain_wall_ms,
                      "unprofiled_wall_ms": plain_wall_ms,
                      "device_busy_share": busy / wall_ms,
                      "device_ops": sum(c for _, c in ops.values()),
                      "kernel_ms": kern, "matmul_ms": mm,
                      "other_ms": busy - mm - sum(kern.values()),
                      "launches": launches,
                      "top_device_ops": [{"name": k[:80], "ms": t, "calls": c}
                                         for k, (t, c) in top]}
    print(json.dumps({"profile_zamba": {"batch": prompt.shape[0],
                                        "prompt_len": prompt.shape[1],
                                        **out}}), flush=True)
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
            **{k: main_row[k] for k in (
                "max_abs_err", "ms", "graph_ms", "host_us", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_graph_ms",
                "library_host_us", "shape")},
            **{label: {k: v for k, v in row.items() if k != "name"}
               for label, row in results[name].items() if label != "main"}})
    return rows


def main(argv: list[str]) -> int:
    kernels_only = argv == ["--kernels"]
    sweeps_only = argv == ["--sweeps"]
    if argv and not (kernels_only or sweeps_only):
        print(f"chip_smoke: unknown arguments {argv}; takes none, "
              f"--kernels or --sweeps", file=sys.stderr)
        return 2
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

    if sweeps_only:
        sweep_masked(dev, 1_000_000, 100)
        sweep_bandwidth(dev, torch.Generator(device=dev).manual_seed(0),
                        100, 1_000_000)
        return 0
    host_costs(dev)
    results = check_kernels(dev)
    results.update(check_lm_kernels(dev))
    if kernels_only:
        return 0
    check_small_runs(dev)
    check_zamba_small(dev)
    sims, launches = {}, {}
    for label, extra, rounds, required in PATHS:
        sims[label], launches[label] = run_path(dev, label, extra, rounds,
                                                required)
    profile_round(sims["sync"], "sync")
    profile_round(sims["hier_int8"], "hier_int8")
    del sims

    check_zamba_full_f32(dev)
    torch.cuda.empty_cache()
    params, cfg, prompt, launches["zamba2_serve"] = run_zamba_serve(dev)
    profile_zamba(params, cfg, prompt, dev)

    print(json.dumps({"kernels": kernel_rows(results, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

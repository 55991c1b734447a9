#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py              # everything below, one card
    python3 chip_smoke.py --kernels    # steps 1-3, 7a and 7f only
    python3 chip_smoke.py --sweeps     # step 1, the build, the plans' sweeps
    python3 chip_smoke.py --lm         # step 1, the build, steps 7f-7g
    python3 chip_smoke.py --train      # step 1, the build, step 7h
    python3 chip_smoke.py --train-probe  # step 1, the build, run_train_probe
    python3 chip_smoke.py --fused      # step 1, the build, step 6a
    python3 chip_smoke.py --tp         # step 1, the build, step 7i
    python3 chip_smoke.py --sweep-profile  # step 1, the build, the
                                       # all-worlds host-loop profile

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc for sm_90a and prints the build seconds, then the host us of the
   pieces a kernel launch is made of;
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (N=50 users, M=8 BSs, every leaf of the paper-scale
   CNN) and at a fleet shape (N=1e6 users x M=100 and x M=33 BSs,
   masked_bs_argmax also over int8 dB codes and bfloat16 with a per-BS
   scale, best_bs_argmax also on an snr off 16-byte alignment and over
   the sweeps' bfloat16 plane (alone and with a per-BS scale) and int8 dB
   codes + scale at M = 100 and 33 ("fleet_bf16", "fleet_bf16_scaled",
   "fleet_int8", "m33_int8", each beside the two-op reference where no
   single PyTorch call takes the scale); the
   Eq. (11) solve on one row per path of its plan: [8, 50] (warp),
   [33, 4097] (block) and [100, 1e6] (cluster) at 30% of the users a row
   and at ~1e4 ("fleet_sparse"), newton and bisect; FedAvg, per-BS
   FedAvg (M=8 and M=100, 50%-dense and the path's one-hot weights) and
   the uplink compressor over 1,000 clients of the fc1 leaf; FedAvg also
   as the faulty async tick weights it, "main_weighted_clip": staleness
   weights, clip_norm, a NaN client and a masked-out one; FedAvg, per-BS
   FedAvg and the compressor also on the [cap] rows of
   ``compute="selected"``, "selected_cap25" and "selected_cap100"), in
   float32 and over int8 codes, and times the kernel, the plain version and one
   PyTorch call as a yardstick: each row's ``ms`` (CUDA events around
   back-to-back calls), ``graph_ms`` (the same calls captured in one CUDA
   graph and replayed: device time alone) and ``host_us`` (host time of
   one call), the yardstick's likewise (``--sweeps`` instead runs the
   card sweeps behind the plans of masked_bs_argmax, rows a block:
   ``masked_variants``, and of bandwidth_solve, warp or block and slices
   a row: ``bandwidth_variants``); kernels 1-3 also over a leading fleet
   axis in one launch (the batched greedy's calls): the largest bucket of
   ``wireless_all`` at [F, 50, 8] and kernel 1 at its [F x 8, 50] trial
   rows ("fleet_axis"), [8, 1e5, 100] in float32, bfloat16 and int8 +
   scale ("fleet_axis_f32" / "_bf16" / "_int8"), each against its plain
   version and F 2-D calls and timed beside them (``per_problem_*``);
4. checks small runs on the card against the same runs on the CPU (the
   plain versions, the default scheduler, host DAGSA): the synchronous
   round, hierarchical aggregation, hierarchical aggregation over the
   top-k + int8 compressed uplink, and the four golden configs of the
   baselines / fault / async slice (``fedcs_low``; ``dagsa-r`` under
   ``faulty-uplink``; ``dagsa_jit`` async; ``dagsa-r`` faulty async, ticks
   of 0.5 s, alpha 0.5; on the card the async ones run captured ticks),
   delivery and queue counts exact, and the four stateful policies
   (``ucb``, ``biased-adaptive``, ``rr``, ``pf``);
5. drives the port's full-width paths on the card, each with the kernels'
   launch counts zeroed just before it and read just after: the
   synchronous single-tier round (3 rounds, ``dagsa_jit``), hierarchical
   aggregation with the top-k + int8 uplink (5 rounds, one global sync),
   hierarchical aggregation uncompressed (2 rounds), the single-tier top-k
   + int8 uplink (2 rounds), the synchronous round under the default
   scheduler, the host DAGSA (``sync_dagsa``, 2 rounds), the FedCS
   baseline (``fedcs``, 2 rounds), ``dagsa-r`` under the ``faulty-uplink``
   fault model (``faulty``, 3 rounds), the same with buffered-async
   aggregation (``faulty_async``, 4 ticks of 0.5 s, alpha 0.5) and the
   ``ucb`` policy (3 rounds); on ``faulty`` and ``faulty_async`` a spy on
   the engine's FedAvg call shows the delivery mask (and the staleness
   weights) reaching kernel 4; then ``compute="selected"``:
   ``sync_selected`` (the default cap of 25, 3 rounds, each round's
   ``n_selected`` beside the cap), ``hier_int8_selected`` (5 rounds) and
   ``faulty_async_selected`` (cap 8, 4 ticks), a spy showing local SGD
   and kernels 4-6 getting [cap] rows (the async tick's kernel 4 the [N]
   scatter of what was delivered), and ``sync_selected_cover`` (cap 50,
   2 rounds) against its ``compute="full"`` twin: records exactly equal,
   the model within rtol 1e-5;
6. profiles one more round of ``sync``, ``sync_selected``, ``hier_int8``,
   ``faulty_async`` and ``ucb`` each (torch.profiler: host and device
   time per round phase, the busiest device ops, the device's busy
   share), then runs ``fleet_selected``: 2 rounds of the mega-fleet world
   at 20,000 users x 100 BSs with ``compute="selected"`` (cap 100), its
   peak allocated bytes beside the dense fleet's 2 N P float32
   parameters and gradients, which it must stay below;
6a. the fused phase: ``sync``, ``sync_selected``, ``hier_int8``,
   ``faulty``, ``ucb``, ``faulty_async`` and ``faulty_async_selected``
   again as captured rounds (``run(mode="fused")``; the async paths
   ``run(mode="async")``, captured ticks), each held to its step or tick
   loop run of step 5: decisions, assignments, delivery, in-flight and
   dropped counts exact, times within rtol 1e-6, parameters within 1e-5,
   derived launches equal; a ``{"fused_path": ...}`` line each, two of
   them profiled, and a capture that reads the device on the host must
   raise;
6b. the scenario sweeps (``repro_torch.launch.sweep``): the four golden
   sweep configurations small on the card against the CPU, then, each
   with the launch counts zeroed just before it and read just after, the
   learning sweeps at the paper's width (``sweep_sync``: paper-default
   and high-mobility, ``sweep_hier`` tau 2, ``sweep_faulty`` and
   ``sweep_faulty_async`` under faulty-uplink with dagsa-r, 2 seeds x 3
   rounds; ``sweep_worlds``: hetero-compute and non-iid-pathological, 1 x
   2), the wireless sweep over every registered scenario (2 seeds x 5
   rounds, f32), paper-default and high-mobility in bf16 and in int8, and
   mega-fleet at 200,000 users x 100 BSs (rho1 0, rho2 5e-5, 1 x 2) in
   bf16 and in int8, a ``ucb`` learning sweep (``sweep_ucb``, 2 x 3) and
   the wireless sweep in user chunks of 16 (``wireless_chunk``,
   paper-default and shadowed, 2 x 5; its records equal the unchunked
   run's), a ``compute="selected"`` learning sweep (``sweep_selected``,
   paper-default and high-mobility, cap 16, 2 x 3); each through the
   sweep's uncaptured route (a host loop of the bucket step, each kernel
   counted at its launch); wall seconds a round and the loop's a cell
   round, peak allocated bytes and launches for each (a wireless bucket
   runs its cells in lockstep, one batched greedy a round: the batched
   calls and greedy steps too), and the profiled busy share of one
   learning round, one wireless round and, replayed, a round of every
   scenario x 2 seeds (``profile_sweep_replays``: each bucket captured,
   its later replays profiled; the same round through the host loop,
   profiled, runs under ``--sweep-profile`` alone); ``sweep_sync``,
   ``sweep_hier``, ``sweep_faulty_async``, ``wireless_all`` (its largest
   bucket 28 cells), ``wireless_int8``, ``fleet_bf16`` and
   ``wireless_chunk`` again through the public ``run_learning_sweep`` /
   ``run_sweep``, each bucket one captured CUDA graph a pattern (a
   wireless bucket's one graph) replayed once a round, records
   JSON-equal to the uncaptured run's, derived launches equal and peak
   allocated bytes at most twice the uncaptured run's (a
   ``{"fused_sweep": ...}`` line each: replay and step-loop wall a cell
   round, capture seconds, graphs, replays, peak allocated bytes, the
   card's reserved bytes after ``empty_cache`` before and after the
   sweep, ``sweep_sync``'s also after a second captured run);
6c. the ``shard`` phase: the same four paths unsharded here and on two
   gloo ranks sharing the card (``torchrun``, this script with
   ``--shard-rank DIR``): (a) the wireless sweep over every scenario x 2
   seeds x 3 rounds, (b) the faulty-uplink ``dagsa-r`` learning sweep at
   the paper's width (2 x 3), (c) ``shard_schedule_batch`` over the
   ``wireless_all`` bucket's 28 problems, (d) ``FLSimulation(shard=True)``
   synchronous, 3 rounds, 50 users; (a) and (b) byte-identical records,
   (c) exact decisions, (d) exact round records; a ``{"shard": ...}``
   line with each path's wall at world 1 and 2, the card's busy share in
   each (a profiled wireless sweep), the all-gather's ms a round, the
   verdicts, (d)'s largest parameter difference and its entries past
   rtol 1e-4 / atol 1e-5 beside a one-process control (half the clients
   trained alone against the same clients in the whole fleet), and each
   rank's launches a path (``shard_<path>_rank<r>`` in the kernels line;
   (a)'s and (b)'s buckets are captured by each rank, so their derived
   counts print on ``shard_wireless_launches_derived`` and
   ``shard_learning_launches_derived`` lines instead);
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
   f. holds kernels 7 and 8 at the shapes of the nine other configs
      against their plain versions and times them (``check_lm_arch_
      kernels``): kernel 7 bf16 at D = 128 with GQA 16/8 ("qwen3"), a
      window of 256 ("qwen3_window256", and its float32 twin), 16 and 1,
      64/8, 32/4, 28/4 over 1,536 positions, MHA 16/16, 8 x 2048, and
      Whisper's D = 64 encoder (1,500 frames), decoder (375 tokens) and
      cross attention (375 x 1,500; a decode step's one query over 80
      and 1,500 positions); kernel 8 at widths 384 to 8,192;
   g. the nine other configs (``run_lm_archs``; depth cut where LM_ARCHS
      says, every width kept), each (a) reduced in float32 on the card
      against the CPU (forward, prefill, 8 decode steps; Whisper also with
      the encoder's memory in the cache) within 1e-4, (b) at full width
      in float32, ``forward`` against 64 cached decode steps within
      rtol=atol=5e-3, (c) serving in bfloat16: ``serve`` (B=4, prompt 64,
      16 new tokens) and a timed ``prefill_fn`` at 4 x 512 (Whisper 1,500
      frames + 375 tokens, Qwen2-VL 1,024 patches + 512 tokens), launch
      counts zeroed just before and read just after; qwen3-0.6b also
      prefills 8 x 2048 and serves with a 256-token window over a
      512-token prompt (a spy shows kernel 7 got the window); one
      ``{"lm_path": ...}`` line a path;
   h. the training slice (``run_train_phase``): (a) the backward kernels
      of 7, 8 and 9 against the plain versions' autograd, bfloat16 (2e-2
      of the largest magnitude) and float32 (1e-4), a second call
      bit-equal, timed beside the bound, the plain version and a
      yardstick (SDPA's backward with enable_gqa, the window as a mask;
      F.rms_norm's backward; none for kernel 9): kernel 7 at
      qwen3-0.6b's [4, 512, 16 / 8 heads, 128] causal and with windows
      of 256 and 16, an MHA [4, 512, 32, 64] and Whisper's cross
      attention [4, 375 x 1,500, 6, 64]; kernel 8 at qwen3-0.6b's
      [4096, 1024], q_norm's [65536, 128] and k_norm's [32768, 128],
      zamba2-1.2b's [4096, 2048] and mamba2-2.7b's [4096, 2560], each
      with its route (``rmsnorm_bwd_plan``); kernel 9 at one Mamba2
      layer of Zamba2 ("main", [4, 512, 64 heads of 64, state 64]) and
      of mamba2-2.7b ("state128", [4, 512, 80, 64, 128]), chunk 128, on
      data at the model's scale (``ssd_bwd_inputs``) whose gradients
      move by at least SSD_CARRY_MARGIN times the tolerance when the
      state carries one chunk only (``ssd_carry_share``), and on the
      forward tests' large dt; (b) one training step of each of the
      ten reduced configs on the card against the CPU (loss, gradients
      and the SGD step within 1e-4, the forward and backward kernels
      launched: mamba2 and zamba2 through kernel 9's, over four chunks
      of 32 tokens);
      (c) through ``launch.train``'s loop in bfloat16, B = 8, T = 512,
      at full width: qwen3-0.6b 30 steps, zamba2-1.2b (38 Mamba2 layers
      and the shared block) 20, mamba2-2.7b 10 at 32 of its 64 layers
      (at 64 AdamW's step passes the card's memory) (falling
      finite loss; exact launch counts (``train_launches``): each forward
      kernel twice a layer a step under remat, the shared block's once;
      step ms, tokens/s, peak allocated bytes, the model-FLOP share;
      qwen3-0.6b and zamba2-1.2b one more step under torch.profiler,
      ``profile_train_step``: device ms by port kernel), on
      qwen3-0.6b a checkpoint round trip bit for bit and one more step
      from each tree, then 5 ``sgd_train_step``s of whisper-tiny on 4 x
      1,500-frame batches; a ``{"train_path": ...}`` line a run
      (``--train-probe`` instead runs ``run_train_probe``: zamba2-1.2b
      at lr 3e-3 through the kernels and through the plain forward's
      autograd, and mamba2-2.7b at 64 layers);
   i. (run between g and h) the tensor-parallel slice (``run_tp_phase``):
      the unsharded references in this process, each freed, then gloo
      ranks of this script sharing the card (``torchrun``, ``--tp-rank
      DIR``, a ``(1, model)`` mesh of ``launch.mesh.smoke_mesh``, one job
      a mesh shape): (a) reduced qwen3-0.6b in float32 at mesh (1, 2) on
      the card against the same two ranks on the CPU, prefill logits
      within 1e-4 of the largest and 8 greedy tokens of ``serve(mesh=)``
      exact; (b) qwen3-32b (8 of 64 layers, mesh (1, 2)), (c)
      deepseek-67b (8 of 95, (1, 4)), (d) qwen3-moe-30b-a3b (8 of 48, (1,
      4)), (e) qwen2-vl-7b (8 of 28, (1, 2), 1,024 patches ahead of the
      prompt), (f) deepseek-v2-236b (3 of 60, (1, 4)), (g) mamba2-2.7b
      (16 of 64, (1, 4): every SSM leaf whole on each rank), (h)
      zamba2-1.2b (12 of 38, two groups, (1, 4): its shared block split)
      and (i)
      whisper-tiny (4 + 4, (1, 2): 1,500 audio frames, 448 decoder
      tokens, the fill and steps attending to the encoded memory) at full
      width in bfloat16, B = 4, each rank drawing its blocks alone: a
      one-shot prefill of 512 tokens (a free warm-up, then two timed), its
      first 64 ((b), (c)) or 16 tokens stepped through the cache (timed),
      16 decode steps fed the unsharded run's greedy tokens; a MoE config
      drives its prefill, fill and steps again, untimed, with the routing
      forced to the unsharded run's (``route_spy``: every flip of the
      ranks' own routing counted, with its router margin), its free
      prefill held to a looser bound and its set flips counted against
      the float32-row witness's (``f32_rows``); every judged logits set
      within 2e-2 of the unsharded port's largest |logit| on the same
      weights, the argmax agreements counted, the residual stream the
      final norm takes bit-equal on the model ranks, kernels 7, 8 and 9
      launched on every rank as
      ``tp_expected_launches`` says (counts zeroed on each rank just
      before the path); each rank's peak allocated bytes, init, prefill
      and decode times beside the unsharded run's (``{"tp_small": ...}``,
      ``{"tp_path": ...}`` lines, the card's name and power limit in
      each; ``tp_<config>_rank<r>`` in the kernels line);
8. prints one JSON line with every kernel's numbers (the backward rows
   ``flash_attention_bwd`` and ``rmsnorm_bwd`` with the launches of
   ``train_qwen3_0_6b``, ``ssd_scan_bwd`` with those of
   ``train_zamba2_1_2b``), then, as the last line, ``{"ok": true,
   "device": {...}}``.

Any failure exits non-zero before the last line.  TF32 is turned off for
matmuls and convolutions, so float32 on the card means float32.  Exits
non-zero when no CUDA device is present or when run outside the checkout.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    # The caching allocator's expandable segments, set before torch loads:
    # with fixed segments, what the earlier phases and paths freed stays
    # cut into segments that a long run cannot release, and mamba2-2.7b's
    # AdamW step (~49 GB) ran out of memory with ~45 GiB reserved but
    # unused (PERF.md).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

import torch  # noqa: E402

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
    # the gradients of kernels 7 and 8: port-only, the TPU kernels have no
    # backward (JAX differentiates its jnp attention and norm)
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:82 "
                            "(its gradient; no TPU backward)",
                            "train_qwen3_0_6b"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:40 (its gradient; no TPU "
                    "backward)", "train_qwen3_0_6b"),
    # kernel 9's gradient: port-only (JAX differentiates its jnp scan)
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan.py:72 (its gradient; no TPU "
                     "backward)", "train_zamba2_1_2b"),
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


def _timings(kernel, label, fn, plain, lib, reps, lib_graph=None) -> dict:
    """The timed fields of a kernel row: the wrapper's event time (``ms``),
    its graph-replayed device time and its host time per call, the plain
    version's event time, and the yardstick call's three times (its
    graph time from ``lib_graph(reps)`` where given).  ``ms`` and
    ``host_us`` (the yardstick's too) are medians of three rounds, the
    wrapper and the yardstick in turns."""
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
                   library_graph_ms=(
                       lib_graph(reps) if lib_graph is not None
                       else _graph_ms(lib, reps, what + " yardstick")),
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
        unaligned_ms = _graph_ms(lambda: ks.best_bs_argmax(off), reps,
                                 f"best_bs_argmax {label} unaligned")
        del off
        record("best_bs_argmax", label, [n, m], 0.0,
               lambda: ks.best_bs_argmax(snr),
               lambda: ks.best_bs_argmax_plain(snr),
               lambda: torch.argmax(snr, dim=1),
               n * m * 4 + n * 4, n * m, reps,
               extra={"plan": list(ks.best_bs_plan(m)),
                      "unaligned_graph_ms": unaligned_ms})

    # -- both argmaxes over the sweeps' compact planes, at the main path's
    # [50, 8] (wireless_bf16 / wireless_int8) and at the fleet shape, exact
    # against plain.  masked_bs_argmax: int8 (quantize_snr_int8's dB codes)
    # and bf16 (the linear SNR over its column maximum), each with a per-BS
    # scale, one BS's negative.  best_bs_argmax: bf16 alone (the bf16
    # plane's call) and with a scale, int8 dB codes + scale, and int8 at 33
    # BSs (lane groups); also on a plane off 16-byte alignment.  No single
    # PyTorch call takes the scale: those rows time the two-op
    # (snr.float() * scale).argmax(1) as their reference ------------------
    for shape, n, m, reps in (("main", 50, 8, 200),
                              ("fleet", fleet_users, fleet_bs, 20)):
        snr = torch.pow(10.0, torch.rand((n, m), generator=gen, device=dev)
                        * 6.0 - 1.0)
        snr[n // 3] = snr[n // 5]                   # duplicate user rows
        snr[:, m - 1] = snr[:, 0]                   # duplicate BS columns
        rem = torch.rand((n,), generator=gen, device=dev) < 0.5
        db = 10.0 * torch.log10(snr)
        q_scale = torch.clamp(db.abs().amax(dim=0), min=1e-6) / 127.0
        q = torch.clamp(torch.round(db / q_scale), -127, 127).to(torch.int8)
        bf = snr.to(torch.bfloat16)
        neg = q_scale.clone()
        neg[m // 2] = -neg[m // 2]
        for label, codes, scale in ((f"{shape}_int8", q, neg),
                                    (f"{shape}_bf16", bf,
                                     1.0 / snr.amax(dim=0))):
            cand, best = ks.masked_bs_argmax(codes, rem, scale)
            c_ref, b_ref = ks.masked_bs_argmax_plain(codes, rem, scale)
            _close(f"masked_bs_argmax {label} cand", cand, c_ref, exact=True)
            err = _close(f"masked_bs_argmax {label} best", best, b_ref,
                         exact=True)
            record("masked_bs_argmax", label, [n, m], err,
                   lambda codes=codes, scale=scale: ks.masked_bs_argmax(
                       codes, rem, scale),
                   lambda codes=codes, scale=scale: ks.masked_bs_argmax_plain(
                       codes, rem, scale),
                   lambda codes=codes, scale=scale: torch.argmax(torch.where(
                       rem[:, None], codes.float() * scale, -torch.inf),
                       dim=0),
                   n * m * codes.element_size() + n + 3 * m * 4, 2 * n * m,
                   reps)
        cases = [(f"{shape}_bf16", bf, None), (f"{shape}_int8", q, neg)]
        if shape == "fleet":
            cases[1:1] = [("fleet_bf16_scaled", bf, 1.0 / snr.amax(dim=0))]
            cases.append(("m33_int8", q[:, :33].contiguous(),
                          neg[:33].contiguous()))
        for label, codes, scale in cases:
            got = ks.best_bs_argmax(codes, scale)
            _close(f"best_bs_argmax {label}", got,
                   ks.best_bs_argmax_plain(codes, scale), exact=True)
            rows_n, cols = codes.shape
            size = codes.element_size()
            buf = torch.empty(rows_n * cols + 16 // size + 1,
                              dtype=codes.dtype, device=dev)
            off = buf[1:1 + rows_n * cols].view(rows_n, cols)
            off.copy_(codes)                        # off 16-byte alignment
            _close(f"best_bs_argmax {label} unaligned",
                   ks.best_bs_argmax(off, scale), got, exact=True)
            # the same plane read in place 1 code off 16-byte alignment
            extra = {"unaligned_graph_ms": _graph_ms(
                lambda off=off, scale=scale: ks.best_bs_argmax(off, scale),
                reps, f"best_bs_argmax {label} unaligned")}
            del buf, off
            if scale is None:
                lib = lambda codes=codes: torch.argmax(codes, dim=1)  # noqa
            else:
                def two_op(codes=codes, scale=scale):
                    return (codes.float() * scale).argmax(dim=1)
                lib = None
                extra |= {
                    "reference": "(snr.float() * scale).argmax(1), two ops",
                    "reference_ms": _time_ms(two_op, reps),
                    "reference_graph_ms": _graph_ms(
                        two_op, reps, f"best_bs_argmax {label} reference"),
                    "reference_host_us": _host_us(two_op, reps)}
            record("best_bs_argmax", label, [rows_n, cols], 0.0,
                   lambda codes=codes, scale=scale: ks.best_bs_argmax(
                       codes, scale),
                   lambda codes=codes, scale=scale: ks.best_bs_argmax_plain(
                       codes, scale), lib,
                   rows_n * cols * size + rows_n * 4
                   + (0 if scale is None else cols * 4),
                   rows_n * cols * (1 if scale is None else 2), reps,
                   extra={"dtype": str(codes.dtype).replace("torch.", ""),
                          "scaled": scale is not None,
                          "plan": list(ks.best_bs_plan(cols, codes.dtype)),
                          **extra})
        del snr, rem, db, q, bf, codes, cases

    check_fleet_axis(dev, gen, record, fleet_users // 10, fleet_bs)

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
    # the faulty async tick's call: Eq. (2) weights of the delivered
    # clients times their staleness discount and norm-clip factor (a NaN
    # client screened out, one client not delivered), as fedavg_reduce
    # builds them
    from repro_torch.fl import server as fl_server
    d = math.prod(shapes["fc1.w"])
    ref = torch.randn((d,), generator=gen, device=dev) * 0.05
    x = ref[None] + 0.05 * torch.randn((50, d), generator=gen, device=dev)
    x[5] *= 1e3                                     # clipped
    x[6, d // 3] = float("nan")                     # poisoned
    delivered = torch.rand((50,), generator=gen, device=dev) < 0.8
    delivered[[5, 6]] = True
    delivered[7] = False                            # masked out
    sizes = torch.randint(50, 150, (50,), generator=gen, device=dev)
    stale = torch.randint(0, 3, (50,), generator=gen, device=dev)
    xs = {"fc1": {"w": x}}
    w, _ = fl_server.fedavg_weights(
        delivered & fl_server.finite_update_mask(xs), sizes)
    w = (w * fl_server.staleness_weights(stale, 0.5)
         * fl_server.clip_scales({"fc1": {"w": ref}}, xs, 25.0)).contiguous()
    if not (float(w[6]) == 0.0 and float(w[7]) == 0.0
            and 0.0 < float(w[5]) < 1.0):
        raise AssertionError("main_weighted_clip: weights not as built")
    err = _close("fedavg_reduce main_weighted_clip", kf.reduce_leaf(w, x),
                 kf.reduce_leaf_plain(w, x),
                 scale=kf.reduce_leaf_plain(w, x.abs()))
    record("fedavg_reduce", "main_weighted_clip", [50, d], err,
           lambda: kf.reduce_leaf(w, x), lambda: kf.reduce_leaf_plain(w, x),
           lambda: w @ x, 50 * d * 4 + 50 * 4 + d * 4, 2 * 50 * d, 200,
           extra={"clip_norm": 25.0, "staleness_alpha": 0.5,
                  "weights_zero": int((w == 0).sum())})
    del x, xs, ref
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
    # compute="selected": the [cap] gathered rows, the scheduled clients
    # first and padding rows of weight 0 (sync_selected's default cap of
    # 25; fleet_selected's 100)
    for label, cap, pad in (("selected_cap25", 25, 3),
                            ("selected_cap100", 100, 0)):
        x = torch.randn((cap, d), generator=gen, device=dev)
        x[cap // 2, d // 3] = float("nan")          # poisoned
        w = torch.rand((cap,), generator=gen, device=dev)
        w[cap - pad:] = 0.0                         # padding rows
        err = _close(f"fedavg_reduce {label}", kf.reduce_leaf(w, x),
                     kf.reduce_leaf_plain(w, x),
                     scale=kf.reduce_leaf_plain(w, x.abs()))
        record("fedavg_reduce", label, [cap, d], err,
               lambda: kf.reduce_leaf(w, x),
               lambda: kf.reduce_leaf_plain(w, x), lambda: w @ x,
               cap * d * 4 + cap * 4 + d * 4, 2 * cap * d, 200,
               extra={"plan": list(kf.reduce_plan(
                   torch.float32, cap, d, x.data_ptr() % 16 == 0))})

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
                ("fleet_m100_onehot", fleet_clients, 100, True, 20),
                # hier_int8_selected's [cap] rows at the default cap
                ("selected_cap25", 25, 8, True, 200)):
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
    for label, n, reps in (("main", 50, 200), ("fleet", fleet_clients, 20),
                           ("selected_cap25", 25, 200)):
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


def wireless_all_bucket() -> int:
    """Cells of the largest shape bucket of the ``wireless_all`` path
    (every registered scenario, 2 seeds): the fleet its batched greedy
    schedules each round."""
    from repro_torch.core.scenario import SCENARIOS
    from repro_torch.core.types import WirelessConfig
    from repro_torch.launch import sweep

    specs = [SCENARIOS[name] for name in SCENARIOS]
    buckets = sweep._wireless_buckets(specs, WirelessConfig())
    return 2 * max(len(group) for group in buckets.values())


def _per_problem_times(fn, reps: int, what: str) -> dict:
    """The yardstick of a fleet row: the F 2-D kernel calls that the one
    fleet launch replaces, timed as the row is (events, graph, host)."""
    return {"per_problem_ms": _time_ms(fn, reps),
            "per_problem_graph_ms": _graph_ms(fn, reps, what + " per problem"),
            "per_problem_host_us": _host_us(fn, reps)}


def check_fleet_axis(dev, gen, record, n_fleet: int = 100_000,
                     m_fleet: int = 100) -> None:
    """Kernels 1-3 over a leading fleet axis (DAGSA's batched greedy), one
    launch for the fleet: the largest bucket of ``wireless_all`` at [F,
    50, 8] ("fleet_axis"), [8, n_fleet, m_fleet] (the run's [8, 1e5,
    100]) in float32, bfloat16 and int8 + scale ("fleet_axis_f32" /
    "_bf16" / "_int8"), and kernel 1 at the
    matching [F x 8, 50] trial rows with tcomp [F, 50] ("fleet_axis").
    Each against its plain version and against F calls on the problems'
    2-D planes (indices exact; kernel 1 rtol 1e-5, atol 1e-7), and timed
    beside that loop of F calls (``per_problem_*``) and, where one
    PyTorch call computes the function, that call."""
    from repro_torch.kernels import bandwidth_solve as kb
    from repro_torch.kernels import select_topk as ks

    f_bucket = wireless_all_bucket()
    for label, f, n, m, kind, reps in (
            ("fleet_axis", f_bucket, 50, 8, "f32", 200),
            ("fleet_axis_f32", 8, n_fleet, m_fleet, "f32", 20),
            ("fleet_axis_bf16", 8, n_fleet, m_fleet, "bf16", 20),
            ("fleet_axis_int8", 8, n_fleet, m_fleet, "int8", 20)):
        snr = torch.pow(10.0, torch.rand((f, n, m), generator=gen,
                                         device=dev) * 6.0 - 1.0)
        snr[:, n // 3] = snr[:, n // 5]             # duplicate user rows
        snr[:, :, m - 1] = snr[:, :, 0]             # duplicate BS columns
        rem = torch.rand((f, n), generator=gen, device=dev) < 0.5
        rem[f // 2] = False                         # a problem with no user
        scale = None
        if kind == "int8":
            db = 10.0 * torch.log10(snr)
            scale = torch.clamp(db.abs().amax(dim=1), min=1e-6) / 127.0
            codes = torch.clamp(torch.round(db / scale[:, None]), -127,
                                127).to(torch.int8)
            del db
        elif kind == "bf16":
            codes = snr.to(torch.bfloat16)
            scale = 1.0 / snr.amax(dim=1)
        else:
            codes = snr
        del snr
        size = codes.element_size()

        def per_problem_masked(codes=codes, scale=scale):
            return [ks.masked_bs_argmax(codes[i], rem[i],
                                        None if scale is None else scale[i])
                    for i in range(f)]

        def per_problem_best(codes=codes, scale=scale):
            return [ks.best_bs_argmax(codes[i],
                                      None if scale is None else scale[i])
                    for i in range(f)]

        cand, best = ks.masked_bs_argmax(codes, rem, scale)
        pc, pb = ks.masked_bs_argmax_plain(codes, rem, scale)
        _close(f"masked_bs_argmax {label} cand", cand, pc, exact=True)
        _close(f"masked_bs_argmax {label} best", best, pb, exact=True)
        for i, (c1, b1) in enumerate(per_problem_masked()):
            _close(f"masked_bs_argmax {label} problem {i}", cand[i], c1,
                   exact=True)
            _close(f"masked_bs_argmax {label} problem {i} best", best[i], b1,
                   exact=True)
        if not (bool((cand[f // 2] == 0).all())
                and bool(torch.isneginf(best[f // 2]).all())):
            raise AssertionError("masked_bs_argmax: a problem with no user "
                                 "left must give (0, -inf)")
        sc_bytes = 0 if scale is None else f * m * 4
        record("masked_bs_argmax", label, [f, n, m], 0.0,
               lambda codes=codes, scale=scale: ks.masked_bs_argmax(
                   codes, rem, scale),
               lambda codes=codes, scale=scale: ks.masked_bs_argmax_plain(
                   codes, rem, scale),
               lambda codes=codes, scale=scale: torch.argmax(torch.where(
                   rem[..., None], codes.float() if scale is None
                   else codes.float() * scale[:, None], -torch.inf), dim=1),
               f * (n * m * size + n + 2 * m * 4) + sc_bytes,
               f * n * m * (1 if scale is None else 2), reps,
               extra={"dtype": kind, "scaled": scale is not None,
                      **_per_problem_times(per_problem_masked, reps,
                                           f"masked_bs_argmax {label}")})

        # kernel 3: the bf16 plane is read unscaled (the sweeps' bf16
        # call), int8 codes with their scale
        b_scale = scale if kind == "int8" else None
        bb = ks.best_bs_argmax(codes, b_scale)
        _close(f"best_bs_argmax {label}", bb,
               ks.best_bs_argmax_plain(codes, b_scale), exact=True)
        for i, one in enumerate(per_problem_best(codes, b_scale)):
            _close(f"best_bs_argmax {label} problem {i}", bb[i], one,
                   exact=True)
        extra = {"dtype": kind, "scaled": b_scale is not None,
                 **_per_problem_times(
                     lambda codes=codes, s=b_scale: per_problem_best(codes, s),
                     reps, f"best_bs_argmax {label}")}
        if b_scale is None:
            lib = lambda codes=codes: torch.argmax(codes, dim=2)  # noqa
        else:
            def two_op(codes=codes, s=b_scale):
                return (codes.float() * s[:, None]).argmax(dim=2)
            lib = None
            extra |= {
                "reference": "(snr.float() * scale).argmax(2), two ops",
                "reference_ms": _time_ms(two_op, reps),
                "reference_graph_ms": _graph_ms(
                    two_op, reps, f"best_bs_argmax {label} reference"),
                "reference_host_us": _host_us(two_op, reps)}
        record("best_bs_argmax", label, [f, n, m], 0.0,
               lambda codes=codes, s=b_scale: ks.best_bs_argmax(codes, s),
               lambda codes=codes, s=b_scale: ks.best_bs_argmax_plain(
                   codes, s), lib,
               f * (n * m * size + n * 4) + (0 if b_scale is None
                                             else f * m * 4),
               f * n * m * (1 if b_scale is None else 2), reps, extra=extra)
        del codes, rem, cand, best, pc, pb

    # kernel 1: the bucket's F x 8 trial rows of 50 users, tcomp [F, 50]
    f, k, u = f_bucket, 8, 50
    c, _, mask, bw, lo = _bw_case(gen, dev, f * k, u, 0.3)
    coeff, mask = c.view(f, k, u), mask.view(f, k, u)
    bw, lo = bw.view(f, k), lo.view(f, k)
    tcomp = 0.10 + 0.01 * torch.rand((f, u), generator=gen, device=dev)

    def per_problem_solve():
        return [kb.bandwidth_solve(coeff[i], tcomp[i], mask[i], bw[i],
                                   lo=lo[i]) for i in range(f)]

    err = 0.0
    for method in ("newton", "bisect"):
        got = kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo, method=method)
        want = kb.bandwidth_solve_fleet_plain(coeff, tcomp, mask, bw, lo=lo,
                                              method=method)
        err = max(err, _close(f"bandwidth_solve fleet_axis {method}", got,
                              want, atol=1e-7))
        for i in range(f):
            _close(f"bandwidth_solve fleet_axis {method} problem {i}", got[i],
                   kb.bandwidth_solve(coeff[i], tcomp[i], mask[i], bw[i],
                                      lo=lo[i], method=method), atol=1e-7)
    nnz = float(mask.sum())
    data_bytes = f * k * u + nnz * 4 + float(mask.any(dim=1).sum()) * 4 \
        + 3 * f * k * 4
    record("bandwidth_solve", "fleet_axis", [f * k, u], err,
           lambda: kb.bandwidth_solve(coeff, tcomp, mask, bw, lo=lo),
           lambda: kb.bandwidth_solve_fleet_plain(coeff, tcomp, mask, bw,
                                                  lo=lo),
           None, data_bytes, (16 * 7 + 3) * nnz, 200,
           extra={"plan": kb.bandwidth_plan(f * k, u)._asdict(),
                  "tcomp_shape": [f, u],
                  "bound_bytes_once_ms": _bound_ms(
                      f * k * u * 5 + f * u * 4 + 3 * f * k * 4,
                      (16 * 7 + 3) * nnz)[0],
                  **_per_problem_times(per_problem_solve, 200,
                                       "bandwidth_solve fleet_axis")})


# hierarchical and compressed runs take a tensor-step scheduler: as in
# JAX, the host greedy's eager mode refuses them
SMALL_RUNS = (
    ("sync", {}),
    ("hier", dict(scheduler="dagsa_jit", aggregation="hierarchical",
                  tau_global=2)),
    ("hier_int8", dict(scheduler="dagsa_jit", aggregation="hierarchical",
                       tau_global=2, compress="topk-int8", topk_frac=0.1)),
    ("engine_fedcs", dict(scheduler="fedcs_low")),
    ("engine_faulty", dict(scheduler="dagsa-r", faults="faulty-uplink")),
    ("engine_async", dict(scheduler="dagsa_jit", aggregation_async=True,
                          tick_s=0.5, staleness_alpha=0.5)),
    ("engine_faulty_async", dict(scheduler="dagsa-r", faults="faulty-uplink",
                                 aggregation_async=True, tick_s=0.5,
                                 staleness_alpha=0.5)),
    # the stateful online policies, their estimates carried in the round
    ("engine_ucb", dict(scheduler="ucb")),
    ("engine_biased", dict(scheduler="biased-adaptive")),
    ("engine_rr", dict(scheduler="rr")),
    ("engine_pf", dict(scheduler="pf")),
)


def check_small_runs(dev) -> None:
    """The same small runs (12 users, 4 BSs, seed 7, 3 rounds) on the card
    and on the CPU (plain versions): decisions, handover rates and the
    delivery and queue counts exact, t_round, delivered_rate and goodput
    within rtol 1e-5, test_acc within one of the 40 samples."""
    from repro_torch.core.types import WirelessConfig
    from repro_torch.fl.rounds import FLConfig, FLSimulation

    def same(a, b):
        return a == b or (math.isnan(a) and math.isnan(b))

    for label, extra in SMALL_RUNS:
        cfg = FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                       n_train=120, n_test=40, local_epochs=1, batch_size=10,
                       seed=7, **extra)
        gpu = FLSimulation(cfg, device=dev).run(3)
        cpu = FLSimulation(cfg, device="cpu").run(3)
        for g, c in zip(gpu, cpu):
            print(f"small run {label}  card {g}\n{' ' * len(label)}"
                  f"            cpu  {c}", flush=True)
            for f in ("n_selected", "min_part_rate", "n_delivered",
                      "n_inflight", "n_dropped", "handover_rate"):
                if not same(getattr(g, f), getattr(c, f)):
                    raise AssertionError(f"small run {label}: {f} differs "
                                         f"card vs CPU")
            for f in ("t_round", "delivered_rate", "goodput_mbit_s"):
                a, b = getattr(g, f), getattr(c, f)
                if not (math.isclose(a, b, rel_tol=1e-5) or same(a, b)):
                    raise AssertionError(f"small run {label}: {f} differs "
                                         f"card vs CPU")
            if abs(g.test_acc - c.test_acc) > 1.0 / 40 + 1e-9:
                raise AssertionError(f"small run {label}: test_acc differs "
                                     f"by more than one of the 40 samples")


# The full-width paths: (label, FLConfig extras, rounds, the kernels the
# path must launch; dagsa_jit's three on every path that runs it).  "sync"
# is the port's first main path; "hier_int8" the hierarchical slice's (one
# global sync at round 5); "fedcs", "faulty" and "faulty_async" the
# baselines / fault / async slice's.
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
    # the baselines / fault / async slice
    ("fedcs", dict(scheduler="fedcs_low"), 2,
     ("best_bs_argmax", "fedavg_reduce")),
    ("faulty", dict(scheduler="dagsa-r", faults="faulty-uplink"), 3,
     _SCHED + ("fedavg_reduce",)),
    ("faulty_async", dict(scheduler="dagsa-r", faults="faulty-uplink",
                          aggregation_async=True, tick_s=0.5,
                          staleness_alpha=0.5), 4,
     _SCHED + ("fedavg_reduce",)),
    # a stateful online policy: top-k by its UCB index, kernel 3 for the
    # best BS, kernel 1 for the Eq. (11) split
    ("ucb", dict(scheduler="ucb"), 3,
     ("best_bs_argmax", "bandwidth_solve", "fedavg_reduce")),
    # compute="selected": local SGD and the reductions on [cap] rows (the
    # default cap is ceil(rho2 N) = 25); the async tick trains and admits
    # [8] rows and reduces the [N] scatter of what was delivered
    ("sync_selected", dict(compute="selected"), 3,
     _SCHED + ("fedavg_reduce",)),
    ("hier_int8_selected", dict(aggregation="hierarchical", tau_global=5,
                                compress="topk-int8", topk_frac=0.1,
                                compute="selected"), 5,
     _SCHED + ("sparsify_quantize", "fedavg_segment_reduce_int8")),
    ("faulty_async_selected", dict(scheduler="dagsa-r", faults="faulty-uplink",
                                   aggregation_async=True, tick_s=0.5,
                                   staleness_alpha=0.5, compute="selected",
                                   select_cap=8), 4,
     _SCHED + ("fedavg_reduce",)),
)
# sync_selected_cover: a cap covering the fleet (50), against its
# compute="full" twin in the same call
COVER = ("sync_selected_cover", dict(compute="selected", select_cap=50), 2,
         _SCHED + ("fedavg_reduce",))
# fleet_selected: the mega-fleet world at 20,000 users and 100 BSs, 10
# samples a user, the default cap ceil(5e-3 N) = 100; no dense twin (its
# 2 N P float32 parameters and gradients alone take 16.9 GB)
FLEET_SELECTED = ("fleet_selected", dict(
    scenario="mega-fleet", n_train=200_000, batch_size=10, local_epochs=2,
    compute="selected", wireless=dict(n_users=20_000, rho1=0.0, rho2=5e-3)),
    2, _SCHED + ("fedavg_reduce",))


def _fedavg_spy(rounds_mod) -> tuple:
    """Wrap the round engine's FedAvg entry point (kernel 4's wrapper) to
    record, for each call, how many clients its mask lets in and the
    smallest staleness weight among them; returns the list it fills and
    the wrapper it replaced."""
    calls = []
    real = rounds_mod.fedavg_reduce

    def spy(params, clients, selected, data_sizes, clip_norm=None,
            weights=None):
        mask_in = int(selected.sum())
        w = None
        if weights is not None:
            on = weights[selected]
            w = float(on.min()) if on.numel() else 1.0
        calls.append({"mask_in": mask_in, "clip_norm": clip_norm,
                      "min_weight_in": w})
        return real(params, clients, selected, data_sizes,
                    clip_norm=clip_norm, weights=weights)

    rounds_mod.fedavg_reduce = spy
    return calls, real


def _row_spy() -> tuple[dict, callable]:
    """Wrap the client-row entry points of a round: local SGD (both
    flavours) and the wrappers of kernels 4, 5 and 6, wherever the engine
    and the compressor look them up, to record the client rows each call
    gets.  Returns ``{entry: [rows, ...]}`` and the function that undoes
    the wrapping."""
    from repro_torch.fl import client as fl_client
    from repro_torch.kernels import compress_topk as ct
    from repro_torch.kernels import fedavg_reduce as kf

    rows: dict = {}
    undo = []

    def wrap(mod, name, key, arg):
        real = getattr(mod, name)

        def spy(*args, **kwargs):
            rows.setdefault(key, []).append(int(args[arg].shape[0]))
            return real(*args, **kwargs)

        setattr(mod, name, spy)
        undo.append((mod, name, real))

    wrap(fl_client, "fleet_local_sgd", "local_sgd", 1)
    wrap(fl_client, "fleet_local_sgd_per_client", "local_sgd", 1)
    for mod in (kf, ct):
        wrap(mod, "reduce_leaf", "fedavg_reduce", 1)
        wrap(mod, "segment_reduce_leaf", "fedavg_segment_reduce", 1)
    wrap(ct, "sparsify_quantize", "sparsify_quantize", 0)

    def restore():
        for mod, name, real in undo:
            setattr(mod, name, real)
    return rows, restore


def _check_selected_rows(label: str, rows: dict, cap: int, n: int,
                         is_async: bool) -> None:
    """compute="selected": local SGD ran on [cap] rows, and so did every
    kernel 4-6 call, except an async tick's kernel 4, which reduces the
    [N] scatter of what was delivered."""
    print(f"path {label} client rows a call (cap {cap}, N {n}): "
          f"{json.dumps({k: sorted(set(v)) for k, v in rows.items()})}",
          flush=True)
    if set(rows.get("local_sgd", [])) != {cap}:
        raise AssertionError(f"path {label}: local SGD did not run on "
                             f"[{cap}] rows")
    for key in ("fedavg_reduce", "fedavg_segment_reduce",
                "sparsify_quantize"):
        want = n if (is_async and key == "fedavg_reduce") else cap
        if key in rows and set(rows[key]) != {want}:
            raise AssertionError(f"path {label}: {key} got rows "
                                 f"{sorted(set(rows[key]))}, not {want}")
    if not ({"fedavg_reduce", "fedavg_segment_reduce"} & set(rows)):
        raise AssertionError(f"path {label}: no FedAvg kernel call seen")


def path_config(extra: dict):
    """The FLConfig of a full-width path: the paper configuration (50
    users, 8 BSs, paper-scale CNN, 10 epochs of batch 16, dagsa_jit)
    with ``extra``'s fields."""
    from repro_torch.core.types import WirelessConfig
    from repro_torch.fl.rounds import FLConfig
    from repro_torch.models.cnn import CNNConfig

    kw = dict(extra)
    if "wireless" in kw:
        kw["wireless"] = WirelessConfig(**kw["wireless"])
    return FLConfig(**{"dataset": "mnist", "scheduler": "dagsa_jit",
                       "cnn": CNNConfig.paper_scale(), "local_epochs": 10,
                       "batch_size": 16, "seed": 0, **kw})


# each path's wall seconds a round (host clock to a sync), by label
PATH_WALLS: dict = {}


def run_path(dev, label: str, extra: dict, rounds: int,
             required: tuple, on_ready=None, mode: str | None = None
             ) -> tuple:
    """``rounds`` full-width rounds of one path (the paper configuration,
    50 users, 8 BSs, paper-scale CNN, unless ``extra`` says otherwise);
    returns the simulation, the launch counts of the run and its records.
    On a faulty path a spy on the engine's FedAvg call checks that the
    delivery mask (and on an async path the staleness weights) reach
    kernel 4; on a ``compute="selected"`` path a spy on local SGD and the
    wrappers of kernels 4-6 checks the client rows they get, and each
    round's ``n_selected`` prints beside the cap.  ``on_ready()`` runs
    between the set-up and the first round.  ``mode``: ``run``'s mode,
    None for the host loop (``FLSimulation._run_host``: the step loop,
    or the async tick loop), whose launches the spies see call by
    call."""
    from repro_torch.fl import rounds as fl_rounds
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.kernels import _lib
    from repro_torch.models.cnn import n_params

    cfg = path_config(extra)
    t0 = time.perf_counter()
    sim = FLSimulation(cfg, device=dev)
    torch.cuda.synchronize()
    print(f"path {label}: set-up {time.perf_counter() - t0:.3f} s, "
          f"{sim.wireless.n_users} users, {sim.wireless.n_bs} BSs, "
          f"{n_params(sim.params)} params, n_train "
          f"{sim.data.x_train.shape[0]}, n_test {sim.data.x_test.shape[0]}, "
          f"{json.dumps(extra)}", flush=True)
    faulty, is_async = sim.faults.active, cfg.aggregation_async
    selected = sim.compute == "selected"
    if faulty:
        calls, real = _fedavg_spy(fl_rounds)
    if selected:
        rows, restore = _row_spy()
    if on_ready is not None:
        on_ready()
    _lib.reset_launches()
    recs, walls = [], PATH_WALLS.setdefault(label, [])
    try:
        for _ in range(rounds):
            t0 = time.perf_counter()
            rec = (sim._run_host(1) if mode is None
                   else sim.run(1, mode=mode))[0]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            print(f"path {label} round {rec} wall_s="
                  f"{walls[-1]:.4f}", flush=True)
            if selected:
                print(f"path {label} round {rec.round_idx}: n_selected "
                      f"{rec.n_selected} cap {sim.select_cap}"
                      f"{' (cut)' if rec.n_selected > sim.select_cap else ''}",
                      flush=True)
            recs.append(rec)
    finally:
        if faulty:
            fl_rounds.fedavg_reduce = real
        if selected:
            restore()
    launches = dict(_lib.LAUNCHES)
    print(f"path {label} launches: {json.dumps(launches)}", flush=True)
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"path {label} never launched {name}")
    # FedCS has no Eq. (8h) floor, and async eligibility leaves out the
    # users with an update in flight
    floor = not (cfg.scheduler.startswith("fedcs") or is_async)
    for rec in recs:
        if not math.isfinite(rec.t_round) or rec.t_round <= 0:
            raise AssertionError(f"round {rec.round_idx}: t_round "
                                 f"{rec.t_round} is not a finite latency")
        if floor and rec.n_selected < sim.min_participants:
            raise AssertionError(f"round {rec.round_idx}: {rec.n_selected} "
                                 f"users < the Eq. (8h) floor")
        if not 0.0 <= rec.test_acc <= 1.0:
            raise AssertionError(f"round {rec.round_idx}: accuracy "
                                 f"{rec.test_acc} out of range")
        if "aggregation" in extra and not 0.0 <= rec.handover_rate <= 1.0:
            raise AssertionError(f"round {rec.round_idx}: handover rate "
                                 f"{rec.handover_rate} out of range")
        # async deliveries include earlier ticks' dispatches
        top = sim.wireless.n_users if is_async else rec.n_selected
        if (faulty or is_async) and not (0 <= rec.n_delivered <= top and
                                         0.0 <= rec.delivered_rate <= 1.0):
            raise AssertionError(f"round {rec.round_idx}: delivery counts "
                                 f"out of range: {rec}")
        if is_async and not (rec.n_inflight >= 0 and rec.n_dropped >= 0
                             and rec.t_round == float(
                                 torch.tensor(cfg.tick_s))):
            raise AssertionError(f"round {rec.round_idx}: async record out "
                                 f"of range: {rec}")
    if faulty:
        print(f"path {label} fedavg calls: {json.dumps(calls)}", flush=True)
        if [c["mask_in"] for c in calls] != [r.n_delivered for r in recs]:
            raise AssertionError(f"path {label}: the FedAvg mask is not the "
                                 f"delivery mask")
        if not is_async and all(r.n_delivered == r.n_selected
                                for r in recs):
            raise AssertionError(f"path {label}: no update was lost, the "
                                 f"delivery mask was not exercised")
        if is_async and any(c["min_weight_in"] is None for c in calls):
            raise AssertionError(f"path {label}: FedAvg got no staleness "
                                 f"weights")
    models = [sim.params] + ([sim.edge_params] if sim.edge_params else [])
    for tree in models:
        for leaf in tree.values():
            for p in leaf.values():
                if not bool(torch.isfinite(p).all()):
                    raise AssertionError(f"path {label}: a model went "
                                         f"non-finite")
    if selected:
        _check_selected_rows(label, rows, sim.select_cap,
                             sim.wireless.n_users, is_async)
    return sim, launches, recs


def run_cover_pair(dev) -> dict:
    """``sync_selected_cover``: a cap covering the fleet trains every
    client, the scheduled ones first, so it must reproduce its
    ``compute="full"`` twin run in the same call: decisions, t_round and
    the clock exactly, test_acc within one of the 1,000 test samples, the
    global model within rtol 1e-5 (prints the largest difference).
    Returns the cover path's launch counts."""
    label, extra, rounds, required = COVER
    sim, launches, recs = run_path(dev, label, extra, rounds, required)
    twin, _, want = run_path(dev, "sync_full_twin", {}, rounds, required)
    for g, w in zip(recs, want):
        for f in ("n_selected", "min_part_rate", "t_round", "wall_clock"):
            if getattr(g, f) != getattr(w, f):
                raise AssertionError(f"{label}: {f} differs from the full "
                                     f"run's: {g} vs {w}")
        if abs(g.test_acc - w.test_acc) > 1.0 / 1000 + 1e-9:
            raise AssertionError(f"{label}: test_acc differs by more than "
                                 f"one sample")
    diff, rel = 0.0, 0.0
    for k, sub in sim.params.items():
        for leaf, p in sub.items():
            q = twin.params[k][leaf]
            diff = max(diff, float((p - q).abs().max()))
            rel = max(rel, float(((p - q).abs() - 1e-5 * q.abs()).max()))
    print(json.dumps({"cover": label, "rounds": rounds,
                      "max_abs_param_diff": diff,
                      "within_rtol_1e-5": rel <= 0.0}), flush=True)
    if rel > 0.0:
        raise AssertionError(f"{label}: parameters differ from the full "
                             f"run's beyond rtol 1e-5 (max abs {diff})")
    return launches


def run_fleet_selected(dev) -> tuple:
    """``fleet_selected``: 2 rounds at 20,000 users with
    ``compute="selected"``; prints the card's peak allocated bytes of the
    run (``max_memory_allocated``, set-up included), and of the set-up and
    the rounds each, beside the dense fleet's 2 N P float32 parameters and
    gradients, and fails unless the peak is below them."""
    from repro_torch.models.cnn import n_params

    label, extra, rounds, required = FLEET_SELECTED
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    phases = {}

    def ready():                    # the set-up's peak; the rounds' next
        torch.cuda.synchronize()
        phases["setup_peak"] = torch.cuda.max_memory_allocated()
        phases["setup_end"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        phases["t_rounds"] = time.perf_counter()

    sim, launches, recs = run_path(dev, label, extra, rounds, required,
                                   on_ready=ready)
    torch.cuda.synchronize()
    wall = time.perf_counter() - phases.pop("t_rounds")
    rounds_peak = torch.cuda.max_memory_allocated()
    peak = max(phases["setup_peak"], rounds_peak)
    n, p = sim.wireless.n_users, n_params(sim.params)
    dense = 2 * n * p * 4
    out = {"fleet_selected": {
        "n_users": n, "n_bs": sim.wireless.n_bs, "cap": sim.select_cap,
        "params": p, "rounds": rounds, "wall_s": wall,
        "wall_s_per_round": wall / rounds,
        "n_selected": [r.n_selected for r in recs],
        "max_memory_allocated": peak, "allocated_before": base,
        **phases, "rounds_peak": rounds_peak,
        "dense_2NP4_bytes": dense, "peak_over_dense": peak / dense,
        "rounds_peak_over_dense": rounds_peak / dense}}
    print(json.dumps(out), flush=True)
    if not peak < dense:
        raise AssertionError(f"{label}: peak {peak} B is not below the "
                             f"dense fleet's {dense} B")
    del sim
    return launches


def _profile_phases(prof) -> tuple[dict, dict]:
    """From a torch.profiler run: each ``round.*`` phase's host ms (its
    range on the host), the device ms of the kernels launched inside it
    (nested phases included in their parent) and its count; and every
    device op's (ms, calls), the phases' own annotation ranges left out."""
    from torch.autograd import DeviceType

    phases, ops = {}, {}
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        if e.name.startswith("round."):
            if on_device:
                continue                    # the range's annotation
            dev_us = getattr(e, "device_time_total", None)
            if dev_us is None:              # torch before 2.4
                dev_us = e.cuda_time_total
            row = phases.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0,
                                             "calls": 0})
            row["host_ms"] += e.time_range.elapsed_us() / 1e3
            row["device_ms"] += dev_us / 1e3
            row["calls"] += 1
        elif on_device:
            t, c = ops.get(e.name, (0.0, 0))
            ops[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return phases, ops


def profile_round(sim, label: str, mode: str | None = None) -> dict:
    """One more round under torch.profiler: the host time of each round
    phase (the engine's named ranges) and the device time of the kernels
    launched inside it, the device ops that took the most time, and the
    device's busy share of the round's wall time (the sum of device op
    durations over the wall time).  ``mode``: ``run``'s (None: the host
    loop, as :func:`run_path` runs it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if mode is None:
            sim._run_host(1)
        else:
            sim.run(1, mode=mode)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    phases, ops = _profile_phases(prof)
    busy_ms = sum(t for t, _ in ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"path": label, "mode": mode or "host loop", "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms, "phases": phases,
           "top_device_ops": [{"name": k[:80], "ms": t, "calls": c}
                              for k, (t, c) in top]}
    print(json.dumps({"profile": out}), flush=True)
    return out


# ------------------------------------------------- the fused FL engine ----
# FLSimulation.run(mode="fused") on the card: one synchronous round
# captured as a CUDA graph (the greedy's loop a WHILE node), replayed once
# a round.  Each twin runs its PATHS entry's config and rounds in fused
# mode and is held to that path's step run of this call: decisions and
# assignments exact, t_round / wall_clock / min_part_rate within rtol
# FUSED_RTOL, parameters within FUSED_PARAM_TOL (max abs), the launch
# counts equal.  FUSED_PROFILED twins get one more round under the
# profiler (the device's busy share of a replayed round).  A replay
# launches no wrapper, so a fused run's launch counts are derived (the
# capture's counts once a replay, a WHILE body's once a pass, from the
# node's device counter): they appear on the fused_path lines as
# "launches_derived" and stay out of the kernels line, whose counts are
# the step runs' launches.  The async twins run run(mode="async"), a tick
# captured as a fused round is, and are held to their path's host tick
# loop, delivery, in-flight and dropped counts exact.
FUSED_TWINS = ("sync", "sync_selected", "hier_int8", "faulty", "ucb",
               "faulty_async", "faulty_async_selected")
FUSED_PROFILED = ("sync", "sync_selected")
FUSED_RTOL = 1e-6
FUSED_PARAM_TOL = 1e-5
CARD = ""                     # nvidia-smi's name and power limit


def assign_spy() -> tuple:
    """Wrap the two functions that hand a round's assignment to the
    engine (the greedy's ``dagsa_jit._schedule``, and the best-BS
    assignment of the baselines and the stateful policies): with
    ``spy["log"]`` a list, each call appends a copy of its [N, M]
    assignment (a step run); with ``spy["buf"]`` a tensor, each call
    copies the assignment into it, so a captured round writes it at each
    replay.  Returns the spy dict and a function that restores both."""
    from repro_torch.core import baselines, dagsa_jit

    spy = {"log": None, "buf": None}
    real_sched, real_best = dagsa_jit._schedule, baselines._best_bs_assign

    def keep(assign):
        if spy["buf"] is not None:
            spy["buf"].copy_(assign)
        elif spy["log"] is not None:
            spy["log"].append(assign.clone())

    def sched(*args, **kw):
        out = real_sched(*args, **kw)
        keep(out[0])
        return out

    def best(snr, selected):
        out = real_best(snr, selected)
        keep(out)
        return out

    def restore():
        dagsa_jit._schedule, baselines._best_bs_assign = real_sched, real_best

    dagsa_jit._schedule, baselines._best_bs_assign = sched, best
    return spy, restore


def _params_clone(params) -> dict:
    return {k: {leaf: p.clone() for leaf, p in sub.items()}
            for k, sub in params.items()}


def run_fused_twin(dev, label: str, extra: dict, rounds: int, step: dict,
                   spy: dict) -> dict:
    """``rounds`` fused rounds of path ``label`` (one ``run(1)`` a round,
    timed to a sync; ``mode="async"`` for an async path: captured ticks),
    held to ``step`` (the path's step or tick loop: ``recs``, ``params``,
    ``launches``, ``assigns``, ``walls``).  Prints and returns a
    ``fused_path`` line."""
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.kernels import _lib

    sim = FLSimulation(path_config(extra), device=dev)
    mode = "async" if sim.aggregation_async else "fused"
    w = sim.wireless
    spy["buf"] = torch.zeros((w.n_users, w.n_bs), dtype=torch.bool,
                             device=dev)
    _lib.reset_launches()
    recs, walls, assigns, steps = [], [], [], []
    try:
        for _ in range(rounds):
            t0 = time.perf_counter()
            rec = sim.run(1, mode=mode)[0]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            recs.append(rec)
            assigns.append(spy["buf"].clone())
            steps.extend(int(s) for s in sim.greedy_steps)
    finally:
        spy["buf"] = None
    launches = dict(_lib.LAUNCHES)
    for i, (g, want) in enumerate(zip(recs, step["recs"])):
        for f in ("round_idx", "n_selected", "n_delivered", "n_inflight",
                  "n_dropped"):
            if getattr(g, f) != getattr(want, f):
                raise AssertionError(f"fused {label} round {i + 1}: {f} "
                                     f"{getattr(g, f)} != step's "
                                     f"{getattr(want, f)}")
        for f in ("t_round", "wall_clock", "min_part_rate"):
            if not math.isclose(getattr(g, f), getattr(want, f),
                                rel_tol=FUSED_RTOL):
                raise AssertionError(f"fused {label} round {i + 1}: {f} "
                                     f"{getattr(g, f)} vs step's "
                                     f"{getattr(want, f)}")
    if len(assigns) != len(step["assigns"]) or not all(
            torch.equal(a, b) for a, b in zip(assigns, step["assigns"])):
        raise AssertionError(f"fused {label}: assignments differ from the "
                             f"step run's")
    if launches != step["launches"]:
        raise AssertionError(f"fused {label}: launches {launches} != the "
                             f"step run's {step['launches']}")
    diff = max(float((p - step["params"][k][leaf]).abs().max())
               for k, sub in sim.params.items() for leaf, p in sub.items())
    if not diff <= FUSED_PARAM_TOL:
        raise AssertionError(f"fused {label}: parameters {diff} from the "
                             f"step run's")

    def median_after_first(v):
        return statistics.median(v[1:]) if len(v) > 1 else v[0]

    out = {"fused_path": label, "mode": mode, "card": CARD,
           "rounds": rounds,
           "wall_s_fused": walls, "wall_s_step": step["walls"],
           "replay_wall_s_median": median_after_first(walls),
           "step_wall_s_median": median_after_first(step["walls"]),
           "capture_s": sim.fused.capture_s, "graphs": sim.fused.n_graphs,
           "replays": sim.fused.replays, "greedy_steps": steps,
           "launches_derived": {k: v for k, v in launches.items() if v},
           "launches_derived_per_replay": {
               k: v / rounds for k, v in launches.items() if v},
           "graph_launches_outside_loops": sim.fused.launches_outside_loops(),
           "max_abs_param_diff": diff}
    print(json.dumps(out), flush=True)
    if label in FUSED_PROFILED:
        out["profile"] = profile_round(sim, f"{label}_fused", mode="fused")
    return out


def check_fused_capture_failure(dev) -> None:
    """A round that reads the device on the host cannot be captured: the
    fused run raises and the engine does not fall back to the host loop
    (12 users, the small runs' config)."""
    from repro_torch.core.types import WirelessConfig
    from repro_torch.fl import rounds as fl_rounds
    from repro_torch.fl.rounds import FLConfig, FLSimulation

    real, calls = fl_rounds.cnn.accuracy, []

    def syncing(params, x, y):
        acc = real(params, x, y)
        calls.append(torch.cuda.is_current_stream_capturing())
        float(acc)                          # a host read a capture refuses
        return acc

    sim = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=12, n_bs=4),
                                n_train=120, n_test=40, local_epochs=1,
                                batch_size=10, seed=7, scheduler="dagsa_jit"),
                       device=dev)
    fl_rounds.cnn.accuracy = syncing
    try:
        sim.run(2, mode="fused")
    except RuntimeError as e:
        err = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    else:
        raise AssertionError("a capture that reads the device on the host "
                             "did not raise")
    finally:
        fl_rounds.cnn.accuracy = real
    torch.cuda.synchronize()
    if calls != [False, True] or sim.round_idx != 0:
        raise AssertionError(f"a failed capture ran on: accuracy calls "
                             f"{calls}, round {sim.round_idx}")
    print(json.dumps({"fused_capture_failure": err, "step_calls": calls}),
          flush=True)


def run_paths(dev, labels, spy: dict) -> tuple:
    """The PATHS entries named in ``labels``, in the step loop: their
    simulations and launch counts by label, and for each of FUSED_TWINS
    what its fused twin is held to (records, assignments through ``spy``,
    launches, walls, parameters)."""
    sims, launches, steps = {}, {}, {}
    for label, extra, rounds, required in PATHS:
        if label not in labels:
            continue
        spy["log"] = [] if label in FUSED_TWINS else None
        sims[label], launches[label], recs = run_path(dev, label, extra,
                                                      rounds, required)
        if label in FUSED_TWINS:
            steps[label] = {"recs": recs, "assigns": spy["log"],
                            "launches": launches[label],
                            "walls": PATH_WALLS[label],
                            "params": _params_clone(sims[label].params)}
        spy["log"] = None
    return sims, launches, steps


def run_fused_only(dev) -> None:
    """``--fused``: the step runs of FUSED_TWINS' paths, their profiled
    rounds (FUSED_PROFILED) and the fused phase, then FUSED_SWEEPS' paths
    uncaptured and captured."""
    spy, restore = assign_spy()
    try:
        sims, _, steps = run_paths(dev, FUSED_TWINS, spy)
        for label in FUSED_PROFILED:
            profile_round(sims[label], label)
        del sims
        run_fused_phase(dev, steps, spy)
    finally:
        restore()
    for label, learning, names, extra, required in SWEEP_PATHS:
        if label in FUSED_SWEEPS:
            out, launches, recs = run_sweep_path(dev, label, learning, names,
                                                 extra, required)
            run_fused_sweep(dev, label, learning, names, extra, out,
                            launches, recs)


def run_fused_phase(dev, steps: dict, spy: dict) -> None:
    """The fused twins of FUSED_TWINS (see above) and the failed-capture
    check."""
    by_label = {p[0]: p for p in PATHS}
    for label in FUSED_TWINS:
        _, extra, rounds, _ = by_label[label]
        run_fused_twin(dev, label, extra, rounds, steps[label], spy)
        torch.cuda.empty_cache()
    check_fused_capture_failure(dev)


# ------------------------------------------------------- the sweeps -------
# The four sweep cases of tests/test_golden_trajectories.py: (label,
# scenarios, run_learning_sweep extras).
SMALL_SWEEPS = (
    ("sweep_sync", ["paper-default", "high-mobility"], {}),
    ("sweep_hier", ["paper-default"], dict(aggregation="hierarchical",
                                           tau_global=2)),
    ("sweep_faulty", ["faulty-uplink"], dict(scheduler="dagsa-r")),
    ("sweep_faulty_async", ["faulty-uplink"],
     dict(scheduler="dagsa-r", aggregation_async=True, tick_s=0.5,
          staleness_alpha=0.5)),
)


def check_small_sweeps(dev) -> None:
    """The wireless sweep at the paper's width in f32, bf16 and int8, then
    the four golden sweep configurations (12 users, 4 BSs, seed 7, 2
    seeds, 3 rounds, 120 / 40 samples, 1 epoch of batch 10), on the card
    and on the CPU: n_selected, delivery and queue curves exact, the
    clock and t_round within rtol 1e-5 (wireless bf16: 1e-2), test_acc
    within one of the 40 samples."""
    from repro_torch.core.types import WirelessConfig
    from repro_torch.launch import sweep

    # the wireless sweep at the main path's width (wireless_* below: 50
    # users, 8 BSs) in each channel dtype, so the kernel instances those
    # paths launch are held against the CPU's plain versions: n_selected
    # exact, t_round within rtol 1e-5 (bf16: 1e-2, as
    # tests/test_torch_cuda.py::test_small_sweep_on_card_matches_cpu: one
    # bfloat16 ulp of a coefficient, 0.4%, can round the other way when the
    # two devices' float32 SNR differ by an ulp)
    for dtype in ("f32", "bf16", "int8"):
        wk = dict(n_seeds=2, n_rounds=5, seed=7, channel_dtype=dtype)
        names = ["paper-default", "high-mobility"]
        gpu = sweep.run_sweep(names, device=dev, **wk)
        cpu = sweep.run_sweep(names, device="cpu", **wk)
        rtol = 1e-2 if dtype == "bf16" else 1e-5
        for g, c in zip(gpu, cpu):
            print(f"small wireless sweep {dtype} {g['scenario']}: card "
                  f"{json.dumps(g['curves'])}\n  cpu "
                  f"{json.dumps(c['curves'])}", flush=True)
            if g["curves"]["n_selected"] != c["curves"]["n_selected"]:
                raise AssertionError(f"small wireless sweep {dtype}: "
                                     f"n_selected differs card vs CPU")
            a = torch.tensor(g["curves"]["t_round_s"], dtype=torch.float64)
            b = torch.tensor(c["curves"]["t_round_s"], dtype=torch.float64)
            if not torch.allclose(a, b, rtol=rtol, atol=0.0):
                raise AssertionError(f"small wireless sweep {dtype}: "
                                     f"t_round differs card vs CPU")

    kw = dict(cfg=WirelessConfig(n_users=12, n_bs=4), n_seeds=2, n_rounds=3,
              n_train=120, n_test=40, local_epochs=1, batch_size=10, seed=7)
    for label, names, extra in SMALL_SWEEPS:
        gpu = sweep.run_learning_sweep(names, device=dev, **kw, **extra)
        cpu = sweep.run_learning_sweep(names, device="cpu", **kw, **extra)
        for g, c in zip(gpu, cpu):
            print(f"small sweep {label} {g['scenario']}: card "
                  f"{json.dumps(g['curves'])}\n  cpu "
                  f"{json.dumps(c['curves'])}",
                  flush=True)
            for k in ("n_selected", "n_delivered", "n_inflight",
                      "n_dropped", "handover_rate"):
                if g["curves"].get(k) != c["curves"].get(k):
                    raise AssertionError(f"small sweep {label}: {k} differs "
                                         f"card vs CPU")
            for k in ("wall_clock_s", "t_round_s"):
                a = torch.tensor(g["curves"][k], dtype=torch.float64)
                b = torch.tensor(c["curves"][k], dtype=torch.float64)
                if not torch.allclose(a, b, rtol=1e-5, atol=0.0):
                    raise AssertionError(f"small sweep {label}: {k} differs "
                                         f"card vs CPU")
            for ga, ca in zip(g["seed_curves"]["test_acc"],
                              c["seed_curves"]["test_acc"]):
                for x, y in zip(ga, ca):
                    if abs(x - y) > 1.0 / 40 + 1e-9:
                        raise AssertionError(f"small sweep {label}: "
                                             f"test_acc differs by more "
                                             f"than one of the 40 samples")


# The sweeps' full-width paths: (label, learning?, scenarios, extras,
# kernels the path must launch).  Learning sweeps run the paper's
# configuration (50 users, synthetic mnist 4,000 / 1,000, the paper-scale
# CNN, 10 local epochs of batch 16); the fleet runs are the docs'
# million-user recipe at 200,000 users (mega-fleet, 100 BSs, rho1 0, rho2
# 5e-5) without --user-chunk.
_ALL = "all"
SWEEP_PATHS = (
    ("sweep_sync", True, ["paper-default", "high-mobility"],
     dict(n_seeds=2, n_rounds=3), _SCHED + ("fedavg_reduce",)),
    ("sweep_hier", True, ["paper-default"],
     dict(n_seeds=2, n_rounds=3, aggregation="hierarchical", tau_global=2),
     _SCHED + ("fedavg_segment_reduce",)),
    ("sweep_faulty", True, ["faulty-uplink"],
     dict(n_seeds=2, n_rounds=3, scheduler="dagsa-r"),
     _SCHED + ("fedavg_reduce",)),
    ("sweep_faulty_async", True, ["faulty-uplink"],
     dict(n_seeds=2, n_rounds=3, scheduler="dagsa-r", aggregation_async=True,
          tick_s=0.5, staleness_alpha=0.5), _SCHED + ("fedavg_reduce",)),
    ("sweep_worlds", True, ["hetero-compute", "non-iid-pathological"],
     dict(n_seeds=1, n_rounds=2), _SCHED + ("fedavg_reduce",)),
    ("wireless_all", False, _ALL, dict(n_seeds=2, n_rounds=5), _SCHED),
    ("wireless_bf16", False, ["paper-default", "high-mobility"],
     dict(n_seeds=2, n_rounds=5, channel_dtype="bf16"), _SCHED),
    ("wireless_int8", False, ["paper-default", "high-mobility"],
     dict(n_seeds=2, n_rounds=5, channel_dtype="int8"), _SCHED),
    ("fleet_bf16", False, ["mega-fleet"],
     dict(n_seeds=1, n_rounds=2, channel_dtype="bf16", fleet=True), _SCHED),
    ("fleet_int8", False, ["mega-fleet"],
     dict(n_seeds=1, n_rounds=2, channel_dtype="int8", fleet=True), _SCHED),
    # a stateful policy's learning sweep, and the wireless sweep in user
    # chunks (shadowed: the [N, M, 64] field in blocks of 16 users), whose
    # records must equal the unchunked run's
    ("sweep_ucb", True, ["paper-default"],
     dict(n_seeds=2, n_rounds=3, scheduler="ucb"),
     ("best_bs_argmax", "bandwidth_solve", "fedavg_reduce")),
    ("wireless_chunk", False, ["paper-default", "shadowed"],
     dict(n_seeds=2, n_rounds=5, user_chunk=16), _SCHED),
    # compute="selected" in the learning sweep: [16] rows a round
    ("sweep_selected", True, ["paper-default", "high-mobility"],
     dict(n_seeds=2, n_rounds=3, compute="selected", select_cap=16),
     _SCHED + ("fedavg_reduce",)),
)
LEARNING = dict(dataset="mnist", n_train=4000, n_test=1000, local_epochs=10,
                batch_size=16, eval_every=1, seed=0)


@contextlib.contextmanager
def uncaptured_sweep():
    """Route the sweeps' buckets (learning and wireless) through their
    uncaptured route (``sweep._run_bucket_host``: the host loop of the
    bucket step, each kernel launched by its wrapper) inside, timing the
    round loops: yields a list that fills with each bucket's loop seconds
    (to a sync)."""
    from repro_torch.launch import sweep

    loops, real = [], sweep._run_bucket

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep._run_bucket_host(*args)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t0)
        return out

    sweep._run_bucket = timed
    try:
        yield loops
    finally:
        sweep._run_bucket = real


@contextlib.contextmanager
def captured_sweep_engines():
    """Record each captured bucket's engine as it is released: yields a
    list that fills with ``{"capture_s", "run_s", "graphs", "replays"}``
    a bucket."""
    from repro_torch.fl import fused

    engines, real = [], fused.FusedRounds.release

    def release(self):
        engines.append({"capture_s": self.capture_s, "run_s": self.run_s,
                        "graphs": self.n_graphs, "replays": self.replays})
        real(self)

    fused.FusedRounds.release = release
    try:
        yield engines
    finally:
        fused.FusedRounds.release = real


def _sweep_args(names, extra: dict) -> tuple:
    """A sweep path's ``(scenario names, WirelessConfig, run_*sweep
    keywords)``: ``_ALL`` is every registered scenario, ``fleet=True`` the
    mega-fleet config (200,000 users, rho1 0, rho2 5e-5)."""
    from repro_torch.core.scenario import SCENARIOS
    from repro_torch.core.types import WirelessConfig

    kw = dict(extra)
    cfg = (WirelessConfig(n_users=200_000, rho1=0.0, rho2=5e-5)
           if kw.pop("fleet", False) else WirelessConfig())
    return (list(SCENARIOS) if names == _ALL else list(names)), cfg, kw


def _run_sweep(dev, learning: bool, names: list, cfg, kw: dict) -> list:
    """The public entry point: ``run_learning_sweep`` at the paper's width
    (LEARNING, the paper-scale CNN) or ``run_sweep``."""
    from repro_torch.launch import sweep
    from repro_torch.models.cnn import CNNConfig

    if learning:
        return sweep.run_learning_sweep(names, cfg=cfg, device=dev,
                                        cnn_cfg=CNNConfig.paper_scale(),
                                        **LEARNING, **kw)
    return sweep.run_sweep(names, cfg=cfg, device=dev, **kw)


def run_sweep_path(dev, label: str, learning: bool, names, extra: dict,
                   required: tuple) -> tuple:
    """One sweep through the port's entry point
    (``repro_torch.launch.sweep.run_sweep`` / ``run_learning_sweep``)
    and its uncaptured route (:func:`uncaptured_sweep`, whose launches
    are made call by call; the captured twins are
    :func:`run_fused_sweep`'s), the kernels' launch counts zeroed just
    before it and read just after; prints its wall seconds a round
    (set-up included) and the loops' a cell round, and checks its
    records: finite positive latencies, the Eq. (8h) floor met (wireless,
    single-tier synchronous), accuracies in [0, 1].  A wireless sweep
    runs a bucket's cells in lockstep, one batched greedy a round: it
    prints the batched calls (kernel 3's launches), the greedy steps
    (kernel 2's launches less one a call) and kernel 1's launches.  A
    sweep with ``user_chunk`` is run again without it, and the two
    records must be equal.  Returns the ``sweep_path`` line, the launches
    and the records."""
    from repro_torch.kernels import _lib

    names, cfg, kw = _sweep_args(names, extra)
    n_seeds, n_rounds = kw["n_seeds"], kw["n_rounds"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with uncaptured_sweep() as loops:
        recs = _run_sweep(dev, learning, names, cfg, kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_lib.LAUNCHES)
    cells = len(names) * n_seeds
    calls = launches["best_bs_argmax"]
    steps = launches["masked_bs_argmax"] - calls
    greedy = ({"greedy_calls": calls, "greedy_steps": steps,
               "steps_per_call": steps / calls,
               "bandwidth_solve_per_call": launches["bandwidth_solve"] / calls,
               "masked_bs_argmax_per_call":
                   launches["masked_bs_argmax"] / calls}
              if calls and launches["masked_bs_argmax"] else {})
    out = {"sweep_path": label, "scenarios": len(names), "seeds": n_seeds,
           "rounds": n_rounds, "n_users": cfg.n_users, "wall_s": wall,
           "wall_s_per_round": wall / (cells * n_rounds),
           "peak_allocated_bytes": peak,
           "loop_wall_s_per_cell_round": sum(loops) / (cells * n_rounds),
           "launches": {k: v for k, v in launches.items() if v}, **greedy,
           **({"final_acc_mean": {r["scenario"]: r["final_acc_mean"]
                                  for r in recs}} if learning else
              {"t_round_mean_s": {r["scenario"]: r["t_round_mean_s"]
                                  for r in recs},
               "participants_mean": {r["scenario"]: r["participants_mean"]
                                     for r in recs}})}
    print(json.dumps(out), flush=True)
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"sweep {label} never launched {name}")
    if "user_chunk" in kw:
        whole_kw = {k: v for k, v in kw.items() if k != "user_chunk"}
        with uncaptured_sweep():
            whole = _run_sweep(dev, learning, names, cfg, whole_kw)
        if whole != recs:
            raise AssertionError(f"sweep {label}: the records in user chunks "
                                 f"differ from the unchunked run's")
        print(f"sweep {label}: records equal to the unchunked run's",
              flush=True)
    minp = math.ceil(cfg.rho2 * cfg.n_users)
    for r in recs:
        ts = r["curves"]["t_round_s"]
        if not all(math.isfinite(t) and t > 0 for t in ts):
            raise AssertionError(f"sweep {label} {r['scenario']}: t_round "
                                 f"{ts} is not a finite latency")
        if learning:
            if not all(a is None or 0.0 <= a <= 1.0
                       for a in r["curves"]["test_acc"]):
                raise AssertionError(f"sweep {label} {r['scenario']}: "
                                     f"accuracy out of range")
            if r["final_acc_mean"] is None:
                raise AssertionError(f"sweep {label} {r['scenario']}: no "
                                     f"evaluation landed")
        elif min(r["curves"]["n_selected"]) < minp:
            raise AssertionError(f"sweep {label} {r['scenario']}: fewer "
                                 f"users than the Eq. (8h) floor")
    return out, launches, recs


# Sweep paths run again through the public run_learning_sweep / run_sweep,
# on the card each bucket captured (one CUDA graph a pattern, a wireless
# bucket's one graph, replayed once a round), and held to the path's
# uncaptured run of this call: records JSON-equal and derived launches
# equal to its counted ones (kept off the kernels line, as the fused twins'
# are).  wireless_all holds the 28-cell bucket, fleet_bf16 the mega-fleet.
FUSED_SWEEPS = ("sweep_sync", "sweep_hier", "sweep_faulty_async",
                "wireless_all", "wireless_int8", "fleet_bf16",
                "wireless_chunk")
FUSED_PEAK_RATIO = 2.0      # captured peak allocated bytes at most 2x


def _reserved() -> int:
    """The card's reserved bytes once every freed block went back to it
    (``torch.cuda.memory_reserved`` after ``empty_cache``)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def run_fused_sweep(dev, label: str, learning: bool, names, extra: dict,
                    step: dict, step_launches: dict,
                    step_recs: list) -> dict:
    """The captured twin of sweep path ``label`` (see FUSED_SWEEPS), held
    to its uncaptured run (``step``: the ``sweep_path`` line,
    ``step_launches``, ``step_recs``): records JSON-equal, derived
    launches equal, one replay a round in every bucket (a wireless bucket:
    one graph), peak allocated bytes at most FUSED_PEAK_RATIO times the
    uncaptured run's.  Prints and returns a ``fused_sweep`` line: the
    whole call's wall, the replay and the step loop's wall seconds a cell
    round, capture seconds, graphs, replays, derived launches and peak
    allocated bytes beside the step run's, and the bytes the card keeps
    reserved before and after the sweep (each bucket's graphs and pools
    released at its end), the first path's also after the same sweep
    captured once more."""
    from repro_torch.kernels import _lib

    names, cfg, kw = _sweep_args(names, extra)
    cells = len(names) * kw["n_seeds"]
    cell_rounds = cells * kw["n_rounds"]
    reserved_before = _reserved()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with captured_sweep_engines() as engines:
        recs = _run_sweep(dev, learning, names, cfg, kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_lib.LAUNCHES)
    reserved_after = _reserved()
    if not _same_json(recs, step_recs):
        raise AssertionError(f"fused sweep {label}: records differ from "
                             f"the uncaptured run's")
    if launches != step_launches:
        raise AssertionError(f"fused sweep {label}: derived launches "
                             f"{launches} != the uncaptured run's "
                             f"{step_launches}")
    if not engines or any(e["replays"] != kw["n_rounds"]
                          or (not learning and e["graphs"] != 1)
                          for e in engines):
        raise AssertionError(f"fused sweep {label}: buckets {engines}, not "
                             f"one replay a round")
    peak_ratio = peak / step["peak_allocated_bytes"]
    capture = sum(e["capture_s"] for e in engines)
    out = {"fused_sweep": label, "card": CARD, "cells": cells,
           "rounds": kw["n_rounds"], "buckets": len(engines),
           "wall_s": wall, "wall_s_step": step["wall_s"],
           "replay_wall_s_per_cell_round": sum(
               e["run_s"] - e["capture_s"] for e in engines) / cell_rounds,
           "step_wall_s_per_cell_round": step["loop_wall_s_per_cell_round"],
           "capture_s": capture,
           "graphs": sum(e["graphs"] for e in engines),
           "replays": sum(e["replays"] for e in engines),
           "launches_derived": {k: v for k, v in launches.items() if v},
           "peak_allocated_bytes": peak,
           "peak_allocated_bytes_step": step["peak_allocated_bytes"],
           "peak_ratio": peak_ratio,
           "reserved_bytes_before": reserved_before,
           "reserved_bytes_after": reserved_after,
           "records_equal": True}
    if label == FUSED_SWEEPS[0]:
        # the same sweep captured again: a first capture leaves torch's
        # per-stream library workspaces once; a later bucket's graphs,
        # pools and kept buffers must leave nothing
        again = _run_sweep(dev, learning, names, cfg, kw)
        if not _same_json(again, step_recs):
            raise AssertionError(f"fused sweep {label}: a second captured "
                                 f"run's records differ")
        out["reserved_bytes_after_repeat"] = _reserved()
    print(json.dumps(out), flush=True)
    if peak_ratio > FUSED_PEAK_RATIO:
        raise AssertionError(f"fused sweep {label}: peak allocated bytes "
                             f"{peak_ratio:.2f}x the uncaptured run's")
    return out


def profile_sweep_round(dev, learning: bool, rounds: int = 3,
                        names=("paper-default",), n_seeds: int = 1) -> dict:
    """A sweep of ``names`` (default paper-default), ``n_seeds`` seeds and
    ``rounds`` rounds through its entry point (``run_learning_sweep`` at
    the paper's width or ``run_sweep``) and its uncaptured route, whose
    round phases the profiler sees (the first round schedules every user,
    as Eq. (8g) makes them all necessary, the later ones run the greedy),
    under torch.profiler after a warm-up call: its wall ms
    (set-up included) and that a round, the device's busy share, each
    round phase's host ms and the device ms of the kernels launched
    inside it (``round.schedule``: the greedy), the greedy steps a round
    (from kernel 2's launches), and the device ops that took the most
    time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scenario import SCENARIOS
    from repro_torch.kernels import _lib
    from repro_torch.launch import sweep
    from repro_torch.models.cnn import CNNConfig

    names = list(SCENARIOS) if names == _ALL else list(names)
    kw = dict(n_seeds=n_seeds, n_rounds=rounds, device=dev)

    def call():
        with uncaptured_sweep():
            if learning:
                return sweep.run_learning_sweep(
                    names, cnn_cfg=CNNConfig.paper_scale(), **LEARNING,
                    **kw)
            return sweep.run_sweep(names, **kw)

    call()
    torch.cuda.synchronize()
    _lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_lib.LAUNCHES)
    phases, ops = _profile_phases(prof)
    busy = sum(t for t, _ in ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]
    sched = phases.get("round.schedule", {})
    out = {"kind": "learning" if learning else "wireless",
           "scenarios": len(names), "seeds": n_seeds,
           "rounds": rounds, "wall_ms": wall_ms,
           "wall_ms_per_round": wall_ms / rounds,
           "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
           "greedy_host_ms_per_round": sched.get("host_ms", 0.0) / rounds,
           "greedy_steps_per_round": (launches["masked_bs_argmax"]
                                      - launches["best_bs_argmax"]) / rounds,
           "launches": {k: v for k, v in launches.items() if v},
           "phases": phases,
           "top_device_ops": [{"name": k[:80], "ms": t, "calls": c}
                              for k, (t, c) in top]}
    print(json.dumps({"profile_sweep": out}), flush=True)
    return out


def profile_sweep_replays(dev, names=_ALL, n_seeds: int = 2,
                          rounds: int = 3) -> dict:
    """A wireless sweep of ``names`` (default every scenario) x
    ``n_seeds`` x ``rounds`` through ``run_sweep``, each bucket captured
    and replayed once, then its other rounds' replays under torch.profiler
    (device activity): the replays' wall ms (host clock to a sync) and
    device busy ms summed over the buckets, and the busy share.  Prints a
    ``profile_sweep_replays`` line."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scenario import SCENARIOS
    from repro_torch.fl import fused
    from repro_torch.launch import sweep

    names = list(SCENARIOS) if names == _ALL else list(names)
    acc = {"wall_ms": 0.0, "device_busy_ms": 0.0, "buckets": 0}

    def profiled(states, step_fn, pattern, n_rounds, dev):
        engine = fused.FusedRounds(step_fn, pattern, dev)
        try:
            states, first = engine.run(states, 0, 1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, rest = engine.run(states, 1, n_rounds - 1)
                torch.cuda.synchronize()
                acc["wall_ms"] += (time.perf_counter() - t0) * 1e3
        finally:
            engine.release()
        _, ops = _profile_phases(prof)
        acc["device_busy_ms"] += sum(t for t, _ in ops.values())
        acc["buckets"] += 1
        return {k: torch.cat([torch.from_numpy(first[k]),
                              torch.from_numpy(rest[k])]).T.contiguous()
                for k in first if k != "greedy_steps"}

    real = sweep._run_bucket
    sweep._run_bucket = profiled
    try:
        sweep.run_sweep(names, n_seeds=n_seeds, n_rounds=rounds, device=dev)
    finally:
        sweep._run_bucket = real
    replayed = rounds - 1
    out = {"card": CARD, "scenarios": len(names), "seeds": n_seeds,
           "rounds": rounds, "replays_profiled": replayed, **acc,
           "wall_ms_per_round": acc["wall_ms"] / replayed,
           "device_busy_ms_per_round": acc["device_busy_ms"] / replayed,
           "device_busy_share": acc["device_busy_ms"] / acc["wall_ms"]}
    print(json.dumps({"profile_sweep_replays": out}), flush=True)
    return out


# ------------------------------------------------------- sharded paths ----
# The sharded sweeps and FLConfig.shard on a gloo world of SHARD_WORLD
# ranks, all on cuda:0, against the same paths unsharded in this process.
SHARD_WORLD = 2
SHARD_WIRELESS = dict(n_seeds=2, n_rounds=3)          # every scenario
SHARD_LEARNING = dict(n_seeds=2, n_rounds=3, scheduler="dagsa-r")
SHARD_FL = dict(dataset="mnist", scheduler="dagsa_jit", local_epochs=10,
                batch_size=16, seed=0)                  # and the paper CNN
SHARD_FL_ROUNDS = 3
SHARD_GATHER_REPS = 5
SHARD_PROFILED = 4          # scenarios of the profiled wireless sweep


def _shard_fleet(dev) -> tuple:
    """The ``wireless_all`` bucket's fleet: F paper-width problems (F =
    :func:`wireless_all_bucket`), one prior participation each, and their
    keys."""
    from repro_torch import rng
    from repro_torch.core import channel, mobility
    from repro_torch.core.types import WirelessConfig

    cfg = WirelessConfig()
    key = rng.PRNGKey(0, device=dev)
    probs = []
    for s in range(wireless_all_bucket()):
        k0, k1 = rng.split(rng.fold_in(key, s)).unbind(0)
        st = mobility.init_positions_grid_bs(k0, cfg)
        probs.append(channel.make_problem(
            k1, st, cfg, torch.ones((cfg.n_users,), device=dev), 0))
    return probs, rng.split(rng.PRNGKey(1, device=dev), len(probs))


def shard_paths(dev, mesh=None) -> dict:
    """(a) the wireless sweep over every scenario, (b) the faulty-uplink
    ``dagsa-r`` learning sweep at the paper's width, (c) the fleet
    scheduler over the ``wireless_all`` bucket and (d) the synchronous
    FLSimulation (50 users, paper CNN), each through its entry point:
    unsharded with ``mesh`` None, else sharded over ``mesh`` (this rank's
    part).  Each phase's wall seconds (between barriers) and the kernel
    launches of this process, the outputs, the card's utilization
    sampled by nvidia-smi through the timed wireless sweep (on rank 0:
    the card's, both ranks together), the device busy ms of a profiled
    wireless sweep of the first SHARD_PROFILED scenarios of the largest
    bucket (device activity alone: a trace of every scenario takes a
    minute to read back), and the seconds since the start at each step's
    end.  Unsharded, also the batch-split control of
    :func:`_split_control`."""
    from functools import partial

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dagsa_jit import dagsa_schedule_batch
    from repro_torch.core.scenario import SCENARIOS
    from repro_torch.core.types import WirelessConfig
    from repro_torch.fl.rounds import FLConfig, FLSimulation
    from repro_torch.interop import params_to_numpy
    from repro_torch.kernels import _lib
    from repro_torch.launch import shard_sweep, sweep
    from repro_torch.models.cnn import CNNConfig, n_params

    names = list(SCENARIOS)
    if mesh is None:
        wireless, learning = sweep.run_sweep, sweep.run_learning_sweep
        schedule = dagsa_schedule_batch
    else:
        wireless = partial(shard_sweep.run_shard_sweep, mesh=mesh)
        learning = partial(shard_sweep.run_shard_learning_sweep, mesh=mesh)
        schedule = partial(shard_sweep.shard_schedule_batch, mesh=mesh)

    def barrier():
        torch.cuda.synchronize()
        if mesh is not None:
            dist.barrier()

    out = {"steps_s": {}}
    t_start = time.perf_counter()

    def step(label):
        out["steps_s"][label] = time.perf_counter() - t_start

    def timed(label, fn):
        barrier()
        _lib.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        barrier()
        out[label] = {"wall_s": time.perf_counter() - t0,
                      "launches": dict(_lib.LAUNCHES)}
        step(label)
        return res

    wireless(names, n_seeds=1, n_rounds=1, device=dev)          # warm-up
    step("warm_up")
    smi = (None if mesh is not None and mesh.rank else subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True))
    out["wireless_records"] = timed("wireless", lambda: wireless(
        names, device=dev, **SHARD_WIRELESS))
    if smi is not None:
        smi.terminate()
        util = [float(v) for v in smi.communicate(timeout=30)[0].split()]
        out["smi_util_mean"] = sum(util) / max(len(util), 1) / 100.0
        out["smi_samples"] = len(util)
    buckets = sweep._wireless_buckets([SCENARIOS[n] for n in names],
                                      WirelessConfig())
    biggest = max(buckets.values(), key=len)
    profiled = [spec.name for _, spec in biggest[:SHARD_PROFILED]]
    barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wireless(profiled, device=dev, **SHARD_WIRELESS)
        barrier()
        wall_ms = (time.perf_counter() - t0) * 1e3
    step("profiled_run")
    _, ops = _profile_phases(prof)
    out["profile"] = {"scenarios": profiled, "wall_ms": wall_ms,
                      "device_busy_ms": sum(t for t, _ in ops.values())}
    step("profile_read")
    out["learning_records"] = timed("learning", lambda: learning(
        ["faulty-uplink"], device=dev, cnn_cfg=CNNConfig.paper_scale(),
        **LEARNING, **SHARD_LEARNING))
    probs, keys = _shard_fleet(dev)
    res = timed("schedule", lambda: schedule(probs, keys))
    out["schedule_result"] = {k: v.cpu() for k, v in vars(res).items()
                              if v is not None}
    sim = FLSimulation(FLConfig(**SHARD_FL, cnn=CNNConfig.paper_scale(),
                                shard=mesh is not None), device=dev)
    step("fl_setup")
    recs = timed("fl", lambda: sim.run(SHARD_FL_ROUNDS, mode="step"))
    out["fl_records"] = [vars(r) for r in recs]
    out["fl_params"] = params_to_numpy(sim.params)
    if mesh is not None:
        rows = torch.zeros((sim.wireless.n_users // mesh.size,
                            n_params(sim.params)), device=dev)
        mesh.gather_rows(rows)                                  # warm-up
        barrier()
        t0 = time.perf_counter()
        for _ in range(SHARD_GATHER_REPS):
            mesh.gather_rows(rows)
        barrier()
        out["gather_ms"] = (time.perf_counter() - t0) * 1e3 \
            / SHARD_GATHER_REPS
        out["gather_bytes"] = rows.numel() * 4 * mesh.size
    else:
        out["split_params"], out["split_records"] = _split_control(dev)
    step("end")
    return out


def _split_control(dev) -> tuple:
    """(d) in one process with each round's local SGD run as the ranks
    run it, the clients in SHARD_WORLD blocks one after another, and no
    process group: (parameters, round records).  The sharded run must
    equal it bit for bit; its distance from the whole-fleet run is the
    batched SGD's rounding, which moves with the clients trained at
    once."""
    from repro_torch.fl import client as fl_client
    from repro_torch.fl.rounds import FLConfig, FLSimulation
    from repro_torch.interop import params_to_numpy
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.tree import tree_map

    real = fl_client.fleet_local_sgd_per_client

    def in_blocks(init, x, y, keys, *args, **kw):
        b = x.shape[0] // SHARD_WORLD
        parts = [real(tree_map(lambda t: t[r * b:(r + 1) * b], init),
                      x[r * b:(r + 1) * b], y[r * b:(r + 1) * b],
                      keys[r * b:(r + 1) * b], *args, **kw)
                 for r in range(SHARD_WORLD)]
        return tree_map(lambda *ts: torch.cat(ts), *parts)

    fl_client.fleet_local_sgd_per_client = in_blocks
    try:
        sim = FLSimulation(FLConfig(**SHARD_FL, cnn=CNNConfig.paper_scale()),
                           device=dev)
        recs = sim.run(SHARD_FL_ROUNDS, mode="step")
    finally:
        fl_client.fleet_local_sgd_per_client = real
    return params_to_numpy(sim.params), [vars(r) for r in recs]


def shard_rank(out_dir: Path) -> int:
    """One rank of the ``shard`` phase (``--shard-rank DIR`` under
    torchrun): :func:`shard_paths` over the gloo mesh of every rank, its
    outputs pickled to ``DIR/rank{r}.pkl``."""
    import pickle

    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh()
    torch.cuda.set_device(mesh.device)
    try:
        res = shard_paths(mesh.device, mesh)
    finally:
        mesh.close()
    with open(out_dir / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    return 0


def _same_json(a, b) -> bool:
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _same_value(a, b) -> bool:
    return a == b or (a != a and b != b)                    # NaN == NaN


def run_shard_phase(dev) -> dict:
    """The ``shard`` phase: :func:`shard_paths` unsharded here, then on
    SHARD_WORLD ranks sharing this card (torchrun, gloo) in child
    processes; checks (a) and (b) byte-identical records, (c) exact
    decisions and (d) exact round records; prints the ``{"shard": ...}``
    line (wall seconds a cell round at world 1 and 2, the busy shares,
    the all-gather's ms a round, the verdicts, (d)'s parameter
    differences beside the batch control's, each step's end) and returns
    each rank's launch counts a path."""
    import os
    import pickle
    import tempfile

    t_phase = time.perf_counter()
    one = shard_paths(dev)
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]))
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(SHARD_WORLD), str(ROOT / "chip_smoke.py"),
             "--shard-rank", tmp], env=env, cwd=ROOT, timeout=600,
            capture_output=True, text=True)
        print(proc.stdout[-2000:], end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr, flush=True)
            raise AssertionError(f"shard: the {SHARD_WORLD}-rank job exited "
                                 f"with {proc.returncode}")
        ranks = []
        for r in range(SHARD_WORLD):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))

    verdicts = {
        "wireless_bytes_equal": all(_same_json(
            r["wireless_records"], one["wireless_records"]) for r in ranks),
        "learning_bytes_equal": all(_same_json(
            r["learning_records"], one["learning_records"]) for r in ranks),
        "schedule_decisions_exact": all(
            torch.equal(r["schedule_result"][k], one["schedule_result"][k])
            for r in ranks for k in ("assign", "selected")),
        "fl_records_exact": all(
            _same_value(g[k], w[k]) for r in ranks
            for g, w in zip(r["fl_records"], one["fl_records"]) for k in w),
    }
    sched_err = max(float((r["schedule_result"][k].double()
                           - one["schedule_result"][k].double()).abs().max())
                    for r in ranks for k in ("bw", "bs_time", "t_round"))
    param_err, past_tol, n_entries, split_err = 0.0, 0, 0, 0.0
    for r in ranks:
        for k, leaves in one["fl_params"].items():
            for leaf, want in leaves.items():
                got = r["fl_params"][k][leaf].astype("float64")
                err = abs(got - want)
                param_err = max(param_err, float(err.max()))
                past_tol += int((err > 1e-5 + 1e-4 * abs(want)).sum())
                n_entries += err.size
                split_err = max(split_err, float(abs(
                    got - one["split_params"][k][leaf]).max()))
    verdicts["fl_equals_split_control"] = split_err == 0.0 and all(
        _same_value(g[k], w[k]) for r in ranks
        for g, w in zip(r["fl_records"], one["split_records"]) for k in w)
    cells = len(one["wireless_records"]) * SHARD_WIRELESS["n_seeds"]
    cell_rounds = cells * SHARD_WIRELESS["n_rounds"]
    learn_rounds = SHARD_LEARNING["n_seeds"] * SHARD_LEARNING["n_rounds"]
    wall2 = {p: max(r[p]["wall_s"] for r in ranks)
             for p in ("wireless", "learning", "schedule", "fl")}
    prof_wall2 = max(r["profile"]["wall_ms"] for r in ranks)
    out = {
        "world": SHARD_WORLD, "device": torch.cuda.get_device_name(0),
        "wireless_cells": cells,
        "wireless_s_per_cell_round": {
            "world1": one["wireless"]["wall_s"] / cell_rounds,
            "world2": wall2["wireless"] / cell_rounds},
        "wireless_ratio_world2_world1": wall2["wireless"]
        / one["wireless"]["wall_s"],
        "learning_s_per_cell_round": {
            "world1": one["learning"]["wall_s"] / learn_rounds,
            "world2": wall2["learning"] / learn_rounds},
        "schedule_s": {"world1": one["schedule"]["wall_s"],
                       "world2": wall2["schedule"]},
        "fl_s_per_round": {"world1": one["fl"]["wall_s"] / SHARD_FL_ROUNDS,
                           "world2": wall2["fl"] / SHARD_FL_ROUNDS},
        "device_busy_share": {
            "world1": one["profile"]["device_busy_ms"]
            / one["profile"]["wall_ms"],
            "world2": sum(r["profile"]["device_busy_ms"] for r in ranks)
            / prof_wall2},
        "device_busy_share_profiled": one["profile"]["scenarios"],
        "smi_util_mean": {"world1": one["smi_util_mean"],
                          "world2": ranks[0]["smi_util_mean"]},
        "smi_samples": {"world1": one["smi_samples"],
                        "world2": ranks[0]["smi_samples"]},
        "gather_ms_per_round": max(r["gather_ms"] for r in ranks),
        "gather_bytes": ranks[0]["gather_bytes"],
        "schedule_max_abs_err": sched_err,
        "fl_params_max_abs_err": param_err,
        "fl_params_past_rtol1e-4_atol1e-5": [past_tol, n_entries],
        "fl_split_control_max_abs_err": split_err,
        "steps_s": {"world1": one["steps_s"],
                    **{f"rank{i}": r["steps_s"]
                       for i, r in enumerate(ranks)}},
        "verdicts": verdicts,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(json.dumps({"shard": out}), flush=True)
    failed = [k for k, ok in verdicts.items() if not ok]
    if failed:
        raise AssertionError(f"shard: {failed} failed")
    # the sweeps' buckets are captured on the card: their counts are
    # derived, so they print here and stay off the kernels line
    launches = {}
    for r, res in enumerate(ranks):
        for path, required in (("wireless", _SCHED),
                               ("learning", _SCHED + ("fedavg_reduce",)),
                               ("schedule", _SCHED),
                               ("fl", _SCHED + ("fedavg_reduce",))):
            counts = res[path]["launches"]
            for name in required:
                if counts[name] <= 0:
                    raise AssertionError(f"shard {path} rank {r} never "
                                         f"launched {name}")
            if path in ("wireless", "learning"):
                print(json.dumps({f"shard_{path}_launches_derived": {
                    "rank": r, "card": CARD,
                    "launches": {k: v for k, v in counts.items() if v}}}),
                    flush=True)
            else:
                launches[f"shard_{path}_rank{r}"] = counts
    return launches


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


def _lm_record(results, kernel, label, shape, err, fn, plain, lib, n_bytes,
               n_ops, peak, reps, extra=None, after=None,
               lib_graph=None) -> None:
    """Time a checked LM kernel row into ``results[kernel][label]`` (and
    print it): the wrapper, its plain version and the yardstick, beside
    the bound; then the fields ``after()`` measures (a profile, kept
    apart from the timings)."""
    bound, by = _bound_ms(n_bytes, n_ops, peak)
    row = {"name": kernel, "shape": shape, "max_abs_err": err,
           **_timings(kernel, label, fn, plain, lib, reps, lib_graph),
           "bound_ms": bound, "bound_by": by, **(extra or {})}
    if after is not None:
        row.update(after())
    results[kernel][label] = row
    print(json.dumps({"check": label, **row}), flush=True)


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

    def record(*args, **kwargs):
        _lm_record(results, *args, **kwargs)

    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        esize = 2 if dtype == torch.bfloat16 else 4
        tol = 1 if dtype == torch.bfloat16 else 0
        peak = PEAK_BF16_OPS_S if dtype == torch.bfloat16 else PEAK_F32_OPS_S

        # -- 8 rmsnorm: rows = B*S in prefill, B in decode; "qk_norm" the
        # per-head norm of 16 heads of 128 (qwen3-0.6b's qk_norm) at the main
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


def _attn_pairs(s: int, t: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs attention computes: all S x T, the causal
    triangle, or the causal band of ``window`` keys a query."""
    if not causal:
        return s * t
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def check_lm_arch_kernels(dev, results: dict, main=(4, 512)) -> None:
    """Kernels 7 and 8 at the shapes the nine configs beside Zamba2 give
    them, against their plain versions, timed beside the bound and the
    yardstick (rows added to ``results``): kernel 7 bf16 at D = 128 with
    GQA 16/8 (qwen3-0.6b; "qwen3"), the same with a window of 256
    ("qwen3_window256", and its float32 twin) and with windows of 16 and
    1 (where a key wrongly kept or dropped at the window's edge moves an
    output by about its own size), 64/8 (qwen3-32b,
    deepseek-67b), 32/4 (qwen3-moe), 28/4 over qwen2-vl's 1,024 patches +
    512 tokens, MHA 16/16 (olmo), qwen3's 8 x 2048 prefill, and Whisper's
    D = 64 MHA 6/6: the encoder over 1,500 frames (non-causal), the
    decoder over 375 tokens (causal), its cross attention (375 x 1,500,
    non-causal) and a decode step's cross attention, one query a sequence
    over the serve path's memory of prompt + generated positions
    ("whisper_cross_decode") and over 1,500 encoder frames, and one tp
    rank's heads (qwen3-32b at model 2, 32/4; deepseek-67b at model 4,
    16/2; qwen3-moe at model 4, 8/1; qwen2-vl at model 2, 14/2 over its
    1,536 positions; zamba2's shared block at model 4, 8/8 of 64;
    whisper at model 2, 3/3 of 64: the encoder over 1,500 frames, the
    decoder over 448 tokens, its cross attention 448 x 1,500 and a decode
    step's 1 x 1,500); kernel 8 bf16 at each new row width over the 4 x
    512 prefill rows ("d384" ... "d8192", deepseek-v2's q / kv latents
    among them; the per-head qk_norm width 128 is check_lm_kernels'
    "qk_norm"), at the q / k norm rows of one tp rank: qwen3-32b's
    ("tp_q_norm_m2", "tp_k_norm_m2") and qwen3-moe's
    ("tp_moe_q_norm_m4", "tp_moe_k_norm_m4"), and at whisper's tp
    prefill rows (4 x 1,500 encoder and 4 x 448 decoder rows of 384).
    Kernel 9 at the tp paths' shapes (zamba2's and mamba2-2.7b's layers,
    every head on every rank) is check_lm_kernels' "main" / "state128"."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krn

    gen = torch.Generator(device=dev).manual_seed(23)
    b0, s0 = main

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(*args):
        _lm_record(results, *args)

    for label, (b, s, t), h, kv, d, causal, window, dtype, reps in (
            ("qwen3", (b0, s0, s0), 16, 8, 128, True, 0, torch.bfloat16, 20),
            ("qwen3_window256", (b0, s0, s0), 16, 8, 128, True, 256,
             torch.bfloat16, 20),
            ("qwen3_window256_f32", (b0, s0, s0), 16, 8, 128, True, 256,
             torch.float32, 5),
            ("qwen3_window16", (b0, s0, s0), 16, 8, 128, True, 16,
             torch.bfloat16, 10),
            ("qwen3_window1", (b0, s0, s0), 16, 8, 128, True, 1,
             torch.bfloat16, 10),
            ("qwen3_long", (8, 2048, 2048), 16, 8, 128, True, 0,
             torch.bfloat16, 5),
            ("gqa64_8", (b0, s0, s0), 64, 8, 128, True, 0, torch.bfloat16,
             10),
            ("gqa32_4", (b0, s0, s0), 32, 4, 128, True, 0, torch.bfloat16,
             10),
            ("vlm_gqa28_4", (b0, 1536, 1536), 28, 4, 128, True, 0,
             torch.bfloat16, 5),
            ("olmo_mha16", (b0, s0, s0), 16, 16, 128, True, 0,
             torch.bfloat16, 10),
            # one rank's heads in the tp phase: qwen3-32b at model 2,
            # deepseek-67b and qwen3-moe at model 4, qwen2-vl at model 2
            # over its 1,024 patches and 512 tokens
            ("tp_qwen3_32b_m2", (b0, s0, s0), 32, 4, 128, True, 0,
             torch.bfloat16, 10),
            ("tp_deepseek_67b_m4", (b0, s0, s0), 16, 2, 128, True, 0,
             torch.bfloat16, 10),
            ("tp_qwen3_moe_m4", (b0, s0, s0), 8, 1, 128, True, 0,
             torch.bfloat16, 10),
            ("tp_qwen2_vl_m2", (b0, 1536, 1536), 14, 2, 128, True, 0,
             torch.bfloat16, 5),
            # ... zamba2's shared block at model 4, whisper at model 2
            ("tp_zamba2_m4", (b0, s0, s0), 8, 8, 64, True, 0,
             torch.bfloat16, 10),
            ("tp_whisper_enc_m2", (b0, 1500, 1500), 3, 3, 64, False, 0,
             torch.bfloat16, 10),
            ("tp_whisper_dec_m2", (b0, 448, 448), 3, 3, 64, True, 0,
             torch.bfloat16, 20),
            ("tp_whisper_cross_m2", (b0, 448, 1500), 3, 3, 64, False, 0,
             torch.bfloat16, 20),
            ("tp_whisper_cross_decode_m2", (b0, 1, 1500), 3, 3, 64, False,
             0, torch.bfloat16, 50),
            ("whisper_enc", (b0, 1500, 1500), 6, 6, 64, False, 0,
             torch.bfloat16, 10),
            ("whisper_dec", (b0, 375, 375), 6, 6, 64, True, 0,
             torch.bfloat16, 20),
            ("whisper_cross", (b0, 375, 1500), 6, 6, 64, False, 0,
             torch.bfloat16, 20),
            ("whisper_cross_decode",
             (b0, 1, LM_SERVE["prompt_len"] + LM_SERVE["gen_len"]), 6, 6,
             64, False, 0, torch.bfloat16, 50),
            ("whisper_cross_decode_1500", (b0, 1, 1500), 6, 6, 64, False, 0,
             torch.bfloat16, 50)):
        q = normal((b, s, h, d), dtype)
        k, v = (normal((b, t, kv, d), dtype) for _ in range(2))
        tol = LM_TOL["flash_attention"][dtype == torch.bfloat16]
        err = _close_tol(f"flash_attention {label}",
                         kfa.flash_attention(q, k, v, causal, window),
                         kfa.flash_attention_plain(q, k, v, causal,
                                                   window=window), tol)
        if window:
            i = torch.arange(s, device=dev)[:, None]
            j = torch.arange(t, device=dev)[None, :]
            mask = (j <= i) & (i - j < window)
            sdpa_kw = {"attn_mask": mask}
        else:
            sdpa_kw = {"is_causal": causal}
        esize = q.element_size()
        record("flash_attention", label, [b, s, t, h, kv, d], err,
               lambda: kfa.flash_attention(q, k, v, causal, window),
               lambda: kfa.flash_attention_plain(q, k, v, causal,
                                                 window=window),
               lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   enable_gqa=h != kv, **sdpa_kw),
               (2 * b * s * h + 2 * b * t * kv) * d * esize,
               4.0 * b * h * _attn_pairs(s, t, causal, window) * d,
               PEAK_BF16_OPS_S if dtype == torch.bfloat16
               else PEAK_F32_OPS_S, reps)
        del q, k, v

    rows = b0 * s0
    # the d-wide norms of the configs (deepseek-v2's q / kv latents: d1536,
    # d512), then the q / k norms over one rank's heads of 128 in the tp
    # phase: qwen3-32b's 32 / 4 at model 2, qwen3-moe's 8 / 1 at model 4;
    # whisper's tp prefill rows (its encoder's 1,500 frames, 448 tokens)
    for label, n, d in [(f"d{d}", rows, d) for d in (
            384, 512, 1024, 1536, 2048, 2560, 3584, 5120, 8192)] + [
            ("tp_q_norm_m2", rows * 32, 128), ("tp_k_norm_m2", rows * 4, 128),
            ("tp_moe_q_norm_m4", rows * 8, 128),
            ("tp_moe_k_norm_m4", rows, 128),
            ("tp_whisper_enc_d384", b0 * 1500, 384),
            ("tp_whisper_dec_d384", b0 * 448, 384)]:
        x = normal((n, d), torch.bfloat16)
        scale = (1.0 + 0.1 * normal((d,), torch.float32)).to(torch.bfloat16)
        err = _close_tol(f"rmsnorm {label}", krn.rmsnorm(x, scale),
                         krn.rmsnorm_plain(x, scale), LM_TOL["rmsnorm"][1])
        record("rmsnorm", label, [n, d], err,
               lambda: krn.rmsnorm(x, scale),
               lambda: krn.rmsnorm_plain(x, scale),
               lambda: F.rms_norm(x, (d,), weight=scale, eps=1e-6),
               4 * n * d + 2 * d, 4.0 * n * d, PEAK_F32_OPS_S, 20)
        del x
    torch.cuda.synchronize()


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


# ------------------------------------------------------ the nine configs ---
# The LM configs beside Zamba2: (id, the depth the card runs (None: full
# depth; a cut keeps every width), the kernels its path must launch).
# deepseek-67b is ~134 GB in bfloat16 and does not fit one 80 GB card;
# the others are cut to keep the phase short.  MLA's attention, the MoE
# experts and OLMo's LayerNorm are plain, as in JAX.
LM_ARCHS = (
    ("qwen3_0_6b", None, ("flash_attention", "rmsnorm")),
    ("qwen3_32b", 4, ("flash_attention", "rmsnorm")),
    ("deepseek_67b", 2, ("flash_attention", "rmsnorm")),
    ("olmo_1b", None, ("flash_attention",)),
    ("mamba2_2_7b", None, ("rmsnorm", "ssd_scan")),
    ("qwen3_moe_30b_a3b", 4, ("flash_attention", "rmsnorm")),
    ("deepseek_v2_236b", 2, ("rmsnorm",)),   # first_dense + 1 MoE layer
    ("whisper_tiny", None, ("flash_attention", "rmsnorm")),
    ("qwen2_vl_7b", 4, ("flash_attention", "rmsnorm")),
)
LM_STEPS = 8                 # (a): cached decode steps, reduced
LM_FULL_STEPS = 64           # (b): forward vs cached decode, full width
LM_SERVE = dict(batch=4, prompt_len=64, gen_len=16)      # (c)
LM_PREFILL = (4, 512)        # (c): the timed prefill
WHISPER_PREFILL = (1500, 375)      # encoder frames, decoder tokens
VLM_TEXT = 512               # text tokens after qwen2-vl's 1,024 patches
QWEN3_LONG = (8, 2048)
# a prompt just past the window still crosses it (512 spent 35 s filling
# the prompt by decode steps)
QWEN3_WINDOW = dict(sliding_window=256, prompt_len=272, gen_len=16)
def _lm_cfg(arch: str, depth, **changes):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if depth is not None:
        changes["n_layers"] = depth
    return dataclasses.replace(cfg, **changes)


def _lm_forward(params, cfg, batch):
    from repro_torch.models import encdec, lm
    fwd = encdec.forward if cfg.encoder_decoder else lm.forward
    return fwd(params, cfg, batch)[0]


def check_lm_small(arch, dev, required) -> dict:
    """(a) the reduced float32 config on the card against the CPU: forward,
    prefill and LM_STEPS cached decode steps (Whisper also with the
    encoder's memory in the cache) within 1e-4, the card's run launching
    each kernel of ``required``; ``api.cast_params`` of the weights to
    bfloat16 equals a bfloat16 init bit for bit.  tests/test_torch_cuda.py
    runs it too."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.kernels import _lib
    from repro_torch.models import api, encdec
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _lm_cfg(arch, None).reduced()
    params = api.init_params(rng.PRNGKey(0), cfg)
    bf16_cfg = dataclasses.replace(cfg, dtype="bfloat16")
    bf16 = api.init_params(rng.PRNGKey(0), bf16_cfg)
    for g, w in zip(tree_leaves(api.cast_params(params, bf16_cfg)),
                    tree_leaves(bf16)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{arch}: the bfloat16 cast of the float32 "
                                 f"init is not the bfloat16 init")
    batch = api.make_train_batch(rng.PRNGKey(1), cfg, 2, 32)
    out = {}
    for d in ("cpu", dev):
        p = tree_map(lambda w: w.to(d), params)
        bt = {k: v.to(d) for k, v in batch.items()}
        _lib.reset_launches()
        runs = [_lm_forward(p, cfg, bt),
                api.prefill_fn(p, cfg, dict(bt, tokens=bt["tokens"][:, :-1]))]
        memories = [None]
        if cfg.encoder_decoder:
            memories.append(encdec.encode(p, cfg, bt["audio_embeds"][:, :8]))
        for memory in memories:
            cache = api.init_cache(cfg, 2, LM_STEPS, device=d)
            if memory is not None:
                cache["memory"] = memory
            runs.append(torch.stack([
                api.decode_step(p, cfg, cache, bt["tokens"][:, i:i + 1], i)[0]
                for i in range(LM_STEPS)]))
        out[str(d)] = runs
    for name in required:
        if _lib.LAUNCHES[name] <= 0:
            raise AssertionError(f"{arch} small: the card's run never "
                                 f"launched {name}")
    return {what: _close_tol(f"{arch} small {what}", g.cpu(), c, 1e-4)
            for what, g, c in zip(("forward", "prefill", "decode",
                                   "decode_memory"),
                                  out[str(dev)], out["cpu"])}


def _lm_full_f32(arch, depth, dev, params, cfg) -> dict:
    """(b) full width in float32: the forward's logits over LM_FULL_STEPS
    tokens against as many cached decode steps, within rtol=atol=5e-3
    (tests/test_models.py's tolerance).  MoE configs route with capacity
    factor 16, as that test does: capacity drops legitimately differ
    between a whole sequence's routing groups and one token's; qwen2-vl
    runs a text-only request (no patches), whose M-RoPE positions a
    decode step reproduces; Whisper decodes with ``encode``'s memory of
    4 x LM_FULL_STEPS frames in the cache."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.models import api, encdec

    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    if cfg.frontend == "vision":
        cfg = dataclasses.replace(cfg, n_patches=0)
    b, t = 2, LM_FULL_STEPS
    batch = api.make_train_batch(rng.PRNGKey(1, device=dev), cfg, b,
                                 4 * t if cfg.encoder_decoder else t)
    toks = batch["tokens"]
    fwd = _lm_forward(params, cfg, batch)
    if cfg.encoder_decoder:
        cache = encdec.init_cache(cfg, b, t, s_enc=4 * t, device=dev)
        cache["memory"] = encdec.encode(params, cfg, batch["audio_embeds"])
    else:
        cache = api.init_cache(cfg, b, t, device=dev)
    t0 = time.perf_counter()
    steps = torch.stack([api.decode_step(params, cfg, cache,
                                         toks[:, i:i + 1], i)[0]
                         for i in range(t)], dim=1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / t * 1e3
    err = (steps - fwd).abs()
    if not bool(torch.isfinite(fwd).all()) or bool(
            (err > 5e-3 + 5e-3 * fwd.abs()).any()):
        raise AssertionError(f"{arch} f32: forward and {t} cached decode "
                             f"steps disagree past rtol=atol=5e-3 (max abs "
                             f"err {err.max().item():.3e})")
    return {"max_abs_err": err.max().item(),
            "logit_scale": fwd[..., :cfg.vocab].abs().max().item(),
            "decode_ms": step_ms}


def _lm_prefill_batch(cfg, dev):
    """The timed prefill's inputs: LM_PREFILL tokens; Whisper 1,500 audio
    frames and 375 decoder tokens; qwen2-vl 1,024 patches and VLM_TEXT
    tokens."""
    from repro_torch import rng
    b, s = LM_PREFILL
    ks = rng.split(rng.PRNGKey(2, device=dev), 2)
    if cfg.encoder_decoder:
        frames, s = WHISPER_PREFILL
        return {"tokens": rng.randint(ks[0], (b, s), 0, cfg.vocab),
                "audio_embeds": rng.normal(ks[1], (b, frames,
                                                   cfg.frontend_dim)
                                           ).to(cfg.param_dtype)}
    if cfg.frontend == "vision":
        return {"tokens": rng.randint(ks[0], (b, VLM_TEXT), 0, cfg.vocab),
                "patch_embeds": rng.normal(ks[1], (b, cfg.n_patches,
                                                   cfg.frontend_dim)
                                           ).to(cfg.param_dtype)}
    return {"tokens": rng.randint(ks[0], (b, s), 0, cfg.vocab)}


def _timed_prefill(params, cfg, batch, reps: int = 3) -> tuple:
    from repro_torch.models import api
    api.prefill_fn(params, cfg, batch)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = api.prefill_fn(params, cfg, batch)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def _lm_serve(label, arch, params, cfg, dev, required, serve_kw,
              prefills) -> dict:
    """(c) the bfloat16 serving path, launch counts zeroed just before and
    read just after: ``serve_decode.serve`` and the timed prefills; finite
    logits, greedy tokens inside the vocab, and every required kernel
    launched.  A spy on kernel 7's wrapper records the windows it got."""
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve_decode
    from repro_torch.models import attention

    windows = set()
    inner = attention.flash_attention

    def spy(q, k, v, causal=True, window=0):
        windows.add(window)
        return inner(q, k, v, causal=causal, window=window)

    attention.flash_attention = spy
    try:
        _lib.reset_launches()
        res = serve_decode.serve(cfg, label, device=dev, params=params,
                                 **serve_kw)
        timed = {}
        for name, batch in prefills.items():
            logits, ms = _timed_prefill(params, cfg, batch)
            # positions prefilled: tokens, patches and audio frames
            n_tok = sum(batch[k].shape[:2].numel() for k in (
                "tokens", "patch_embeds", "audio_embeds") if k in batch)
            if not bool(torch.isfinite(logits.float()).all()):
                raise AssertionError(f"{label}: {name} logits not finite")
            timed[name] = {"shape": [batch["tokens"].shape[0],
                                     n_tok // batch["tokens"].shape[0]],
                           "ms": ms, "tok_per_s": n_tok / ms * 1e3}
        launches = dict(_lib.LAUNCHES)
    finally:
        attention.flash_attention = inner
    lm_launches = {k: launches[k] for k in _LM_KERNEL_NAMES}
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"path {label} never launched {name}")
    if not bool(torch.isfinite(res.prompt_logits.float()).all()):
        raise AssertionError(f"{label}: stepped prompt logits not finite")
    if not bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise AssertionError(f"{label}: a greedy token outside the vocab")
    gen = res.tokens.shape[1]
    return {"serve": {**serve_kw, "fill_by_steps_s": res.fill_s,
                      "decode_ms_per_token": res.decode_s / gen * 1e3,
                      "decode_tok_per_s": res.tokens.numel() / res.decode_s,
                      "serve_tok_per_s": res.tok_per_s,
                      "sample": res.tokens[0, :8].tolist()},
            "prefill": timed, "launches": launches,
            "lm_launches": lm_launches, "flash_windows": sorted(windows)}


def run_lm_archs(dev) -> dict:
    """The nine configs beside Zamba2, each (a) reduced on the card vs the
    CPU, (b) at full width in float32 at its depth, forward vs cached
    decode, (c) serving in bfloat16 at its depth, with launch counts;
    qwen3-0.6b also prefills QWEN3_LONG and serves with a 256-token window
    over a 512-token prompt.  One ``{"lm_path": ...}`` line a path; returns
    the launches by path."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.models import api, lm

    t_phase = time.perf_counter()
    launches = {}
    for arch, depth, required in LM_ARCHS:
        t0 = time.perf_counter()
        small = check_lm_small(arch, dev, required)
        cfg = _lm_cfg(arch, depth, dtype="float32")
        t1 = time.perf_counter()
        params = api.init_params(rng.PRNGKey(0, device=dev), cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        n_params = lm.n_params(params)
        full = _lm_full_f32(arch, depth, dev, params, cfg)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        params = api.cast_params(params, cfg)
        torch.cuda.empty_cache()
        label = f"lm_{arch}"
        prefills = {"prefill": _lm_prefill_batch(cfg, dev)}
        if arch == "qwen3_0_6b":
            prefills["prefill_long"] = {"tokens": rng.randint(
                rng.PRNGKey(3, device=dev), QWEN3_LONG, 0, cfg.vocab)}
        served = _lm_serve(label, arch, params, cfg, dev, required,
                           LM_SERVE, prefills)
        launches[label] = served.pop("launches")
        print(json.dumps({"lm_path": label, "depth": cfg.n_layers,
                          "n_params": n_params, "init_f32_s": init_s,
                          "small_max_abs_err": small, "full_f32": full,
                          **served, "seconds": time.perf_counter() - t0}),
              flush=True)
        if arch == "qwen3_0_6b":
            t0 = time.perf_counter()
            w = QWEN3_WINDOW["sliding_window"]
            wcfg = dataclasses.replace(cfg, sliding_window=w)
            label = f"lm_{arch}_window{w}"
            served = _lm_serve(
                label, arch, params, wcfg, dev, required,
                dict(batch=LM_SERVE["batch"],
                     prompt_len=QWEN3_WINDOW["prompt_len"],
                     gen_len=QWEN3_WINDOW["gen_len"]),
                {"prefill": _lm_prefill_batch(wcfg, dev)})
            if served["flash_windows"] != [w]:
                raise AssertionError(f"{label}: kernel 7 got windows "
                                     f"{served['flash_windows']}, not [{w}]")
            launches[label] = served.pop("launches")
            print(json.dumps({"lm_path": label, "depth": cfg.n_layers,
                              **served,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        del params
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(json.dumps({"lm_phase_seconds": seconds}), flush=True)
    return launches


# ------------------------------------------------- the tensor-parallel slice --
# (a) reduced qwen3-0.6b in float32, tensor-parallel on the card against the
# same ranks on the CPU; (b)-(i) configs at full width in bfloat16, most
# depth cut, against the unsharded port on the same weights:
# (config, layers, (data, model), prompt tokens stepped through the cache).
# deepseek-67b (~134 GB in bfloat16) needs the mesh; its full depth waits
# for a machine with four cards (ROADMAP).  qwen3-32b and deepseek-67b keep
# the depth and fill they were first verified at (8 layers, 64 tokens);
# qwen3-moe (a rank its 32 experts) and qwen2-vl run 8 layers and step 16
# tokens, deepseek-v2 its dense first layer and 2 MoE layers (each 7.5 GB
# of experts; the reference's init draws an expert leaf whole in float32,
# 5 GB) and 16 tokens: the run's time is taken from the new paths' fill.
# mamba2-2.7b (16 of 64 layers; every SSM leaf whole on each rank, so a
# rank's draw is nearly a whole init), zamba2-1.2b (12 of 38 Mamba2 layers:
# two groups, so the shared block, split over 4 ranks, and its cache are
# reused) and whisper-tiny at full depth (1,500 audio frames, 448 decoder
# tokens; its 6 heads divide over 2, not 4) step 16 tokens too.  zamba2 at
# all 38 layers sits 2.0e-2 to 2.9e-2 from one process, past TP_TOL, and
# so does one process whose row sums round as a rank's do (the witness,
# 2.5e-2): any rounding change at its six shared blocks moves the logits
# that far through the Mamba2 stack (ROADMAP C.19), so the path is cut.
TP_SMALL = ("qwen3_0_6b", (1, 2))
TP_SMALL_SERVE = dict(batch=4, prompt_len=16, gen_len=8)
TP_SMALL_TOL = 1e-4          # card vs CPU, of the largest |logit|
TP_FULL = (("qwen3_32b", 8, (1, 2), 64), ("deepseek_67b", 8, (1, 4), 64),
           ("qwen3_moe_30b_a3b", 8, (1, 4), 16),
           ("qwen2_vl_7b", 8, (1, 2), 16),
           ("deepseek_v2_236b", 3, (1, 4), 16),
           ("mamba2_2_7b", 16, (1, 4), 16), ("zamba2_1_2b", 12, (1, 4), 16),
           ("whisper_tiny", 4, (1, 2), 16))
TP_BATCH, TP_PROMPT, TP_STEPS = 4, 512, 16
TP_WHISPER = (1500, 448)     # audio frames (its 30 s window), decoder tokens
TP_TOL = 2e-2                # of the largest |logit|: PERF.md §2's bf16 bound
TP_PREFILL_REPS = 2          # timed one-shot prefills after a warm-up
TP_FLIPS_SHOWN = 20          # routing flips listed a path (all counted)
# The ranks' own MoE routing (the free prefill, not forced): its logits
# against the reference's and its share of token-layers routed to another
# set of experts, each bound about twice the first full-width readings
# (7.46e-2 and 8.5%: PERF.md §6).  A flip there changes the experts a token
# meets, so its error is not the bf16 bound's: random routers leave the
# k-th and next probabilities ~1e-3 apart, and one process with its row
# products in float32 (the witness) flips as many.
TP_FREE_TOL = 0.15
TP_FREE_SET_SHARE = 0.15


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    """Zero ``dev``'s peak allocated bytes (a first allocation starts the
    caching allocator, which refuses the reset before it)."""
    torch.empty(1, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)


def tp_expected_launches(cfg, fill: int) -> dict:
    """Kernel 7, 8 and 9 launches of :func:`tp_drive` on each rank (and in
    one process), from the code:

    * a decoder-only config's prefill: kernel 7 once an attention block
      (each GQA layer, zamba2's shared block once a group; MLA's attention
      is plain, as in JAX), kernel 9 once a Mamba2 layer; kernel 8 in the
      two norms of an attention block (the one of a Mamba2 block: its
      gated norm is plain), qwen3's q / k norms over the rank's heads,
      MLA's ``q_norm`` / ``kv_norm`` and the final norm.  A decode step
      launches kernel 8 as a prefill does and neither 7 (decode attends
      with the plain ``_sdpa``) nor 9 (the recurrence is plain);
    * the encoder-decoder's prefill: the encoder (kernel 7 a layer,
      bidirectional; kernel 8 its two norms a layer and ``enc_norm``),
      then the decoder (kernel 7 twice a layer, causal self and cross
      attention; kernel 8 its three norms a layer and the final norm); a
      decode step attends to the memory through kernel 7 once a layer
      (the cached self-attention is plain) and runs the decoder's norms;
      :func:`tp_drive` encodes the memory once more for the fill.

    A MoE config drives one prefill and one fill more (the forced
    routing's run)."""
    n_prefills = 1 + TP_PREFILL_REPS + cfg.is_moe
    n_steps = fill + TP_STEPS + fill * cfg.is_moe
    rms = cfg.norm == "rmsnorm"
    if cfg.encoder_decoder:         # (kernel 7, kernel 8) a call
        enc = (cfg.n_enc_layers, (2 * cfg.n_enc_layers + 1) * rms)
        dec = (2 * cfg.n_layers, (3 * cfg.n_layers + 1) * rms)
        step = (cfg.n_layers, (3 * cfg.n_layers + 1) * rms)
        return {k: e * (n_prefills + 1) + d * n_prefills + t * n_steps
                for k, e, d, t in zip(("flash_attention", "rmsnorm"),
                                      enc, dec, step)} | {"ssd_scan": 0}
    n_ssm = cfg.n_layers * (cfg.arch_type in ("ssm", "hybrid"))
    n_attn = (cfg.n_layers // cfg.shared_attn_every
              if cfg.arch_type == "hybrid" else cfg.n_layers - n_ssm)
    per_call = ((2 * n_attn + n_ssm + 1) * rms
                + 2 * n_attn * (bool(cfg.qk_norm) or cfg.attention == "mla"))
    return {"flash_attention": n_attn * n_prefills * (cfg.attention == "gqa"),
            "rmsnorm": per_call * (n_prefills + n_steps),
            "ssd_scan": n_ssm * n_prefills}


@contextlib.contextmanager
def route_spy(cfg, forced=None):
    """Records each ``moe.router`` call of ``cfg``'s model, in call order,
    on the device: the top-k experts (``top_i``), ``keep`` (``moe.assign``
    of that choice: the capacity's cut) and each token's router margin
    (the k-th largest probability less the next).  With ``forced`` (a
    reference run's ``top_i`` a call, on the device), each call returns
    the reference's choice in place of its own, which ``moe.route`` then
    assigns as it assigns its own (the same weights, slots and keep as the
    reference's): the routing's counterpart of the teacher-forced tokens,
    so a near-tie that routes a token elsewhere is counted
    (:func:`_routing_flips`) and not carried into the logits."""
    from repro_torch.models import moe

    inner = moe.router
    log = []
    k = cfg.moe_top_k

    def spy(params, xg):
        probs, ranked = inner(params, xg)
        top_i = ranked[..., :k]
        keep = moe.assign(cfg, probs, top_i)[3]
        p = probs.gather(-1, ranked[..., k - 1:k + 1])
        margin = p[..., 0] - p[..., 1] if p.shape[-1] > 1 else p[..., 0]
        log.append((top_i.to(torch.int16), keep, margin))
        if forced is None:
            return probs, ranked
        return probs, forced[len(log) - 1]

    moe.router = spy
    try:
        yield log
    finally:
        moe.router = inner


@contextlib.contextmanager
def final_streams(params):
    """Records the residual stream each call hands the model's final norm
    (``params["final_norm"]``), in call order: every Mamba2 layer's and
    row-parallel sum's output runs into it, so the model ranks must hold
    it bit for bit (:func:`_model_ranks_alike`)."""
    from repro_torch.models import layers

    inner = layers.norm_apply
    log = []

    def spy(cfg, p, x):
        if p is params["final_norm"]:
            log.append(x)
        return inner(cfg, p, x)

    layers.norm_apply = spy
    try:
        yield log
    finally:
        layers.norm_apply = inner


def _model_ranks_alike(cfg, streams: list):
    """Whether every model rank of ``cfg``'s mesh holds each tensor of
    ``streams`` bit for bit, and the largest |difference| from model rank
    0's (a collective: every model rank calls it); None without a model
    mesh."""
    mesh = getattr(cfg, "mesh", None)
    if mesh is None or mesh.model == 1:
        return None
    equal, worst = True, 0.0
    for x in streams:
        every = mesh.model_gather(x)
        equal &= all(torch.equal(y, every[0]) for y in every[1:])
        worst = max(worst, float((every.float() - every[0].float())
                                 .abs().max()))
    return {"equal": equal, "max_abs_diff": worst, "compared": len(streams)}


@contextlib.contextmanager
def f32_rows():
    """The unsharded port with its row-parallel products
    (``parallel.row_matmul``, the MoE combine's ``row_einsum``) in float32,
    rounded once to the activation dtype, as the ranks sum their partials:
    the witness of the ranks' own routing (ROADMAP C.18)."""
    from repro_torch.models import parallel

    saved = parallel.row_matmul, parallel.row_einsum
    parallel.row_matmul = \
        lambda cfg, x, w: (x.float() @ w.float()).to(x.dtype)
    parallel.row_einsum = lambda cfg, eq, a, b: torch.einsum(
        eq, a.float(), b.float()).to(a.dtype)
    try:
        yield
    finally:
        parallel.row_matmul, parallel.row_einsum = saved


def _route_record(log: list) -> list:
    """A :func:`route_spy` log on the host: (top_i, keep, margin) a
    call."""
    return [tuple(t.cpu() for t in call) for call in log]


def _whole(cfg, logits) -> torch.Tensor:
    """The real vocab's logits (pad ids hold -1e9), every rank's shard
    gathered, on the host in their own dtype."""
    from repro_torch.models import parallel
    return parallel.gather_columns(cfg, logits)[..., :cfg.vocab].cpu()


def tp_drive(params, cfg, batch, dev, fill: int, teacher=None,
             routes=None) -> dict:
    """The tp path on one rank of ``cfg``'s mesh (or in one process):
    a warm-up one-shot ``prefill_fn`` of ``batch`` (tokens [B, S],
    qwen2-vl's patch embeddings or whisper's audio frames too), free (a
    MoE config's routing its own, recorded: :func:`route_spy`);
    TP_PREFILL_REPS timed prefills; the prompt's first ``fill`` tokens
    stepped through the cache (the serving path's fill, text only, timed:
    decode ms a step; an encoder-decoder's cache holds the memory encoded
    once, untimed, before the free prefill).  A dense
    config then takes TP_STEPS decode steps fed ``teacher``'s tokens
    [B, TP_STEPS] (without one, its own greedy picks).  A MoE config
    drives the prefill, the fill and the steps again, untimed, with its
    routing recorded and, given ``routes`` (the reference's ``top_i`` a
    call), forced to the reference's after the free prefill's calls.  The
    timed calls run without the spy.  Returns the free prefill's, the
    judged prefill's and the fill's last and every step's whole-vocab
    logits (host), the greedy picks, the routing record, whether the
    model ranks' residual streams (the free prefill's and each step's, as
    the final norm takes them) are bit-equal, the times, and the kernels'
    launches over the path."""
    from repro_torch.kernels import _lib
    from repro_torch.models import api, encdec, parallel

    prompt = batch["tokens"]
    b = prompt.shape[0]
    mesh = getattr(cfg, "mesh", None)
    n_moe = (cfg.n_layers - cfg.first_k_dense) * cfg.is_moe
    if routes is not None:           # on the card before any timing
        routes = [t.to(dev, torch.int64) for t in routes[n_moe:]]

    def barrier():
        if mesh is not None:
            mesh.barrier()

    memory = None

    def filled():
        cache = api.init_cache(cfg, b, fill + TP_STEPS, device=dev)
        if memory is not None:       # the audio the decode attends to
            cache["memory"] = memory
        for t in range(fill):
            logits, cache = api.decode_step(params, cfg, cache,
                                            prompt[:, t:t + 1], t)
        return logits, cache

    _lib.reset_launches()
    if cfg.encoder_decoder:          # the caller's route to the audio (C.15)
        memory = encdec.encode(params, cfg, batch["audio_embeds"])
    with route_spy(cfg) as free_log, final_streams(params) as streams:
        free = api.prefill_fn(params, cfg, batch)
    _sync(dev)
    barrier()
    t0 = time.perf_counter()
    for _ in range(TP_PREFILL_REPS):
        pre = api.prefill_fn(params, cfg, batch)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) / TP_PREFILL_REPS * 1e3
    barrier()
    t0 = time.perf_counter()
    logits, cache = filled()
    _sync(dev)
    fill_s = time.perf_counter() - t0
    with contextlib.ExitStack() as stack:
        log = []
        if cfg.is_moe:
            log = stack.enter_context(route_spy(cfg, routes))
            pre = api.prefill_fn(params, cfg, batch)
            logits, cache = filled()
        steps, picks = [_whole(cfg, logits)], []
        step_streams = stack.enter_context(final_streams(params))
        for i in range(TP_STEPS):
            nxt = parallel.greedy(cfg, logits)
            picks.append(nxt)
            feed = nxt if teacher is None else teacher[:, i:i + 1].to(dev)
            logits, cache = api.decode_step(params, cfg, cache,
                                            feed.to(torch.int32), fill + i)
            steps.append(_whole(cfg, logits))
        _sync(dev)
    launches = dict(_lib.LAUNCHES)
    alike = _model_ranks_alike(cfg, streams + step_streams)
    return {"free_prefill_logits": _whole(cfg, free),
            "prefill_logits": _whole(cfg, pre),
            "step_logits": torch.stack(steps),
            "picks": torch.cat(picks, dim=1).cpu(),
            "routing": _route_record(free_log + log),
            "streams_alike": alike,
            "prefill_ms": prefill_ms, "fill_s": fill_s,
            "decode_ms_per_step": fill_s / fill * 1e3, "launches": launches}


def _tp_prompt(cfg, dev, b: int = TP_BATCH, s: int = TP_PROMPT):
    from repro_torch import rng
    return rng.randint(rng.PRNGKey(2, device=dev), (b, s), 0, cfg.vocab)


def _tp_batch(cfg, dev) -> dict:
    """The tp path's prefill batch: TP_BATCH x TP_PROMPT tokens, and
    qwen2-vl's 1,024 patch embeddings ahead of them; whisper's TP_WHISPER
    audio frames and decoder tokens."""
    from repro_torch import rng
    if cfg.encoder_decoder:
        frames, tokens = TP_WHISPER
        return {"tokens": _tp_prompt(cfg, dev, s=tokens),
                "audio_embeds": rng.normal(
                    rng.PRNGKey(3, device=dev),
                    (TP_BATCH, frames, cfg.frontend_dim)).to(cfg.param_dtype)}
    batch = {"tokens": _tp_prompt(cfg, dev)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(
            rng.PRNGKey(3, device=dev),
            (TP_BATCH, cfg.n_patches, cfg.frontend_dim)).to(cfg.param_dtype)
    return batch


def _tp_small_run(mesh, dev) -> dict:
    """(a) on one rank: reduced qwen3-0.6b in float32 on ``dev``, its
    weights this rank's blocks; the prefill's whole-vocab logits and the
    greedy tokens of ``serve(mesh=)``, with the kernels' launches."""
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve_decode
    from repro_torch.models import api, parallel

    cfg = get_config(TP_SMALL[0]).reduced()
    lcfg = parallel.local_config(cfg, mesh)
    _lib.reset_launches()
    params = api.init_params(rng.PRNGKey(0, device=dev), lcfg)
    prompt = _tp_prompt(cfg, dev, 4, 16)
    pre = api.prefill_fn(params, lcfg, {"tokens": prompt})
    res = serve_decode.serve(cfg, "tp_small", device=dev, params=params,
                             mesh=mesh, **TP_SMALL_SERVE)
    return {"prefill_logits": parallel.gather_columns(
                lcfg, pre)[..., :cfg.vocab].cpu(),
            "tokens": res.tokens.cpu(),
            "launches": dict(_lib.LAUNCHES)}


def tp_rank(out_dir: Path) -> int:
    """One rank of the ``tp`` phase (``--tp-rank DIR`` under torchrun):
    the runs ``DIR/job.json`` names on the (1, world) mesh of every rank,
    the results pickled to ``DIR/rank{r}.pkl`` (the logits by model rank
    0 alone: every rank gathers the same)."""
    import pickle

    from repro_torch import rng
    from repro_torch.launch.mesh import smoke_mesh
    from repro_torch.models import api, parallel

    job = json.loads((out_dir / "job.json").read_text())
    world = int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = smoke_mesh(1, world)
    torch.cuda.set_device(mesh.device)
    dev = mesh.device
    res = {"rank": mesh.rank, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank}
    try:
        if job["small"]:
            res["small_cuda"] = _tp_small_run(mesh, dev)
            res["small_cpu"] = _tp_small_run(mesh, torch.device("cpu"))
        for arch, depth, fill in job["full"]:
            cfg = _lm_cfg(arch, depth)
            lcfg = parallel.local_config(cfg, mesh)
            torch.cuda.empty_cache()
            _reset_peak(dev)
            # one rank draws at a time, so each draw's time and peak are
            # its own (the hash is bound by the card's memory rate)
            t_turns = time.perf_counter()
            for r in range(world):
                if r == mesh.rank:
                    t0 = time.perf_counter()
                    params = api.init_params(rng.PRNGKey(0, device=dev),
                                             lcfg)
                    _sync(dev)
                    init_s = time.perf_counter() - t0
                    init_peak = torch.cuda.max_memory_allocated(dev)
                    # the draw's freed temporaries back to the card for
                    # the next rank's draw
                    torch.cuda.empty_cache()
                mesh.barrier()
            turns_s = time.perf_counter() - t_turns
            teacher = torch.load(out_dir / f"teacher_{arch}.pt")
            routes = torch.load(out_dir / f"routes_{arch}.pt")
            t0 = time.perf_counter()
            out = tp_drive(params, lcfg, _tp_batch(cfg, dev), dev, fill,
                           teacher, routes)
            out.update(init_s=init_s, init_turns_s=turns_s,
                       drive_s=time.perf_counter() - t0,
                       init_peak_bytes=init_peak,
                       peak_bytes=torch.cuda.max_memory_allocated(dev),
                       param_bytes=_param_bytes(params))
            if mesh.model_rank != 0:
                for k in ("free_prefill_logits", "prefill_logits",
                          "step_logits"):
                    out.pop(k)
            res[arch] = out
            del params
    finally:
        mesh.close()
    with open(out_dir / f"rank{res['rank']}.pkl", "wb") as f:
        pickle.dump(res, f)
    return 0


def _param_bytes(params) -> int:
    from repro_torch.tree import tree_leaves
    return sum(w.numel() * w.element_size() for w in tree_leaves(params))


def _tp_job(world: int, out_dir: Path, small: bool, full: list) -> list:
    """``world`` gloo ranks of this script (``--tp-rank``) sharing the
    card through torchrun; their pickled results in rank order."""
    import pickle

    (out_dir / "job.json").write_text(json.dumps({"small": small,
                                                  "full": full}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), str(ROOT / "chip_smoke.py"),
         "--tp-rank", str(out_dir)], env=env, cwd=ROOT, timeout=900,
        capture_output=True, text=True)
    print(proc.stdout[-2000:], end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        raise AssertionError(f"tp: the {world}-rank job exited with "
                             f"{proc.returncode}")
    ranks = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _tp_reference(arch: str, depth: int, fill: int, dev) -> dict:
    """(b)-(i)'s reference: the unsharded port on the same weights, in
    this process, then freed (the ranks share the card after it).  Its
    witness too: one free prefill with the row products in float32
    (:func:`f32_rows`), its logits and a MoE config's routing: how far
    one process moves under the ranks' rounding of the row sums."""
    from repro_torch import rng
    from repro_torch.models import api

    cfg = _lm_cfg(arch, depth)
    torch.cuda.empty_cache()
    _reset_peak(dev)
    t0 = time.perf_counter()
    params = api.init_params(rng.PRNGKey(0, device=dev), cfg)
    _sync(dev)
    init_s = time.perf_counter() - t0
    batch = _tp_batch(cfg, dev)
    out = tp_drive(params, cfg, batch, dev, fill)
    out.update(init_s=init_s,
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               param_bytes=_param_bytes(params))
    with f32_rows(), route_spy(cfg) as log:
        out["witness_logits"] = _whole(cfg, api.prefill_fn(params, cfg,
                                                           batch))
    out["witness_routing"] = _route_record(log)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _flips(cfg, ref: list, got: list, phase, shown: list) -> dict:
    """Routing ``got`` against ``ref`` (:func:`route_spy` records, call by
    call): by ``phase(call)``, the token-layers whose top-k experts or
    ``keep`` differ (``order``: the ranked choices; ``set``: the experts
    that take the token) and the largest and median reference margin of
    each kind of flip beside all tokens' median; the first flips appended
    to ``shown`` (up to TP_FLIPS_SHOWN) with their margins."""
    e = cfg.n_experts

    def experts(top_i, keep):      # [T, E]: the experts that take a token
        idx = torch.where(keep, top_i, e)
        return torch.zeros(idx.shape[0], e + 1, dtype=torch.bool).scatter_(
            1, idx, True)[:, :e]

    counts, margins = {}, {}
    for c, (r, g) in enumerate(zip(ref, got)):
        ri, gi = (t[0].long().flatten(0, 1) for t in (r, g))     # [T, k]
        rk, gk = (t[1].flatten(0, 1) for t in (r, g))
        rm = r[2].flatten()
        order = (ri != gi).any(-1) | (rk != gk).any(-1)
        sets = (experts(ri, rk) != experts(gi, gk)).any(-1)
        ph = phase(c)
        n = counts.setdefault(ph, {"tokens": 0, "order": 0, "set": 0})
        n["tokens"] += ri.shape[0]
        n["order"] += int(order.sum())
        n["set"] += int(sets.sum())
        m = margins.setdefault(ph, {"all": [], "order": [], "set": []})
        m["all"].append(rm)
        m["order"].append(rm[order])
        m["set"].append(rm[sets])
        seq = TP_PROMPT if ph.startswith("prefill") else 1
        for t in order.nonzero()[:, 0].tolist()[:TP_FLIPS_SHOWN - len(shown)]:
            shown.append({
                "call": c, "phase": ph,
                "layer": cfg.first_k_dense + c % (cfg.n_layers
                                                  - cfg.first_k_dense),
                "row": t // seq, "position": t % seq,
                "ref_top_i": ri[t].tolist(), "top_i": gi[t].tolist(),
                "ref_keep": rk[t].tolist(), "keep": gk[t].tolist(),
                "ref_margin": float(rm[t]), "margin": float(g[2].flatten()[t]),
                "set_changed": bool(sets[t])})
    for ph, m in margins.items():
        stats = {}
        for kind, parts in m.items():
            v = torch.cat(parts).float()
            if v.numel():
                stats[kind] = {"max": float(v.max()),
                               "median": float(v.median())}
        counts[ph]["ref_margin"] = stats
    return counts


def _routing_flips(cfg, fill: int, ref: dict, ranks: list) -> dict:
    """The routing decisions of every rank against the reference's, call
    by call: flips by phase (:func:`_flips`: the free prefill's, then the
    forced run's prefill, fill and steps, each rank's own choice there
    given the reference's earlier ones), the first TP_FLIPS_SHOWN listed;
    the free prefill's against the witness's (:func:`f32_rows`) and the
    reference's against the witness's; whether every rank routed alike."""
    if not cfg.is_moe:
        return {}
    n_moe = cfg.n_layers - cfg.first_k_dense

    def phase(call):
        i = call // n_moe
        if i <= 1:
            return "prefill_free" if i == 0 else "prefill"
        return "fill" if i - 2 < fill else "step"

    got = ranks[0]
    calls = n_moe * (2 + fill + TP_STEPS)
    shown = []
    flips = _flips(cfg, ref["routing"], got, phase, shown)
    witness = ref["witness_routing"]

    def free(call):
        return "prefill_free"

    same = all(len(res) == len(got) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(res, got)) for res in ranks)
    return {"calls": [len(got), calls], "flips": flips,
            "witness_flips": {
                "ranks": _flips(cfg, witness, got[:n_moe], free, [])[
                    "prefill_free"],
                "reference": _flips(cfg, witness, ref["routing"][:n_moe],
                                    free, [])["prefill_free"]},
            "first_flips": shown, "same_on_every_rank": same,
            "recorded": len(got) == calls == len(ref["routing"])
            and len(witness) == n_moe}


def _rel(got, want) -> float:
    """max |got - want| over the largest |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _tp_compare(label, cfg, fill: int, ref: dict, ranks: list) -> dict:
    """(b)-(i)'s verdicts: every judged logits set (the prefill, the
    fill's last, each teacher-forced step; a MoE config's under the
    forced routing) within TP_TOL of the reference's largest |logit|, the
    free prefill within TP_TOL (TP_FREE_TOL under a MoE config's own
    routing), a MoE config's set flips there at most TP_FREE_SET_SHARE of
    its token-layers and, against the float32-row witness, no more than
    the reference's (the ranks' own routing inside the spread of two
    one-process roundings), its routing recorded in full and alike on
    every rank, exact launch counts on every rank, the residual streams
    bit-equal on the model ranks (:func:`_model_ranks_alike`); the argmax
    agreements, the routing flips, the witness's errors and each rank's
    numbers."""
    want_launch = tp_expected_launches(cfg, fill)
    got = ranks[0][label]
    sets = [("prefill", got["prefill_logits"], ref["prefill_logits"])] + [
        (f"step{i}", g, w) for i, (g, w) in enumerate(
            zip(got["step_logits"], ref["step_logits"]))]
    rel = {}
    for name, g, w in sets:
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: {name} logits not finite")
        rel[name] = _rel(g, w)
    free_rel = _rel(got["free_prefill_logits"], ref["free_prefill_logits"])
    agree = int((got["step_logits"][:-1].argmax(-1)
                 == ref["step_logits"][:-1].argmax(-1)).sum())
    rows = []
    for res in ranks:
        rows.append({"rank": res["rank"], "model_rank": res["model_rank"],
                     **{k: res[label][k] for k in (
                         "init_s", "init_turns_s", "drive_s",
                         "init_peak_bytes", "peak_bytes", "param_bytes",
                         "prefill_ms", "fill_s", "decode_ms_per_step")},
                     "launches": {k: res[label]["launches"][k]
                                  for k in want_launch},
                     "streams_alike": res[label]["streams_alike"]})
    routing = _routing_flips(cfg, fill, ref,
                             [res[label]["routing"] for res in ranks])
    verdicts = {
        "logits_within_tol": max(rel.values()) <= TP_TOL,
        "free_prefill_within_bound":
            free_rel <= (TP_FREE_TOL if cfg.is_moe else TP_TOL),
        "launches_exact": all(r["launches"] == want_launch for r in rows),
        "streams_same_on_model_ranks": all(
            r["streams_alike"]["equal"] for r in rows),
        "picks_same_on_every_rank": all(
            torch.equal(r[label]["picks"], ranks[0][label]["picks"])
            for r in ranks)}
    if routing:
        free = routing["flips"]["prefill_free"]
        verdicts["free_set_flips_within_bound"] = \
            free["set"] <= TP_FREE_SET_SHARE * free["tokens"]
        spread = routing["witness_flips"]
        verdicts["free_set_flips_within_witness_spread"] = \
            spread["ranks"]["set"] <= spread["reference"]["set"]
        verdicts["routing_recorded"] = routing["recorded"]
        verdicts["routing_same_on_every_rank"] = \
            routing["same_on_every_rank"]
    witness = {"free_prefill_rel_err": _rel(got["free_prefill_logits"],
                                            ref["witness_logits"]),
               "reference_rel_err": _rel(ref["free_prefill_logits"],
                                         ref["witness_logits"])}
    return {"rel_err": rel, "max_rel_err": max(rel.values()),
            "free_prefill_rel_err": free_rel,
            "argmax_agree": [agree, TP_STEPS * TP_BATCH],
            "routing": routing, "witness": witness,
            "expected_launches": want_launch, "ranks": rows,
            "verdicts": verdicts}


def run_tp_phase(dev) -> dict:
    """The ``tp`` phase: (a) reduced qwen3-0.6b float32 at mesh (1, 2) on
    the card against the same two ranks on the CPU (prefill logits within
    TP_SMALL_TOL of the largest, greedy tokens exact); (b) qwen3-32b, (c)
    deepseek-67b, (d) qwen3-moe-30b-a3b, (e) qwen2-vl-7b and (f)
    deepseek-v2-236b, (g) mamba2-2.7b, (h) zamba2-1.2b and (i)
    whisper-tiny at full width in bfloat16 (TP_FULL: depth cut but
    whisper's, mesh (1, 2) or (1, 4)): a one-shot prefill of
    TP_BATCH x TP_PROMPT tokens (qwen2-vl's behind its 1,024 patches;
    whisper's TP_WHISPER frames and decoder tokens, its fill and steps
    attending to the memory encoded from them), the prompt's first tokens
    stepped through the cache and TP_STEPS teacher-forced decode steps,
    every judged logits set (the real vocab's) within TP_TOL of the
    unsharded port's largest |logit| on the same weights, a MoE config's
    routing forced to the reference's in the judged run and its own free
    run held to TP_FREE_TOL and TP_FREE_SET_SHARE, every flip counted
    (:func:`route_spy`) and set beside the float32-row witness's
    (:func:`f32_rows`; every path's witness logits reported beside the
    ranks' and the reference's), the residual streams bit-equal on the
    model ranks, kernels 7, 8 and 9 launched as
    :func:`tp_expected_launches` says on every rank.  The references of a
    mesh shape run first, one after another (each freed), then one
    torchrun job serves its configs.  Prints a ``{"tp_small": ...}`` and a
    ``{"tp_path": ...}`` line a config (the card's name and power limit
    beside every number) and returns each rank's launches by path
    (``tp_<config>_rank<r>``)."""
    import tempfile

    launches = {}
    failed = []
    by_mesh: dict = {}            # one torchrun job a mesh shape
    for arch, depth, shape, fill in TP_FULL:
        by_mesh.setdefault(shape, []).append((arch, depth, fill))
    for i, ((data, model), runs) in enumerate(by_mesh.items()):
        refs, ref_s = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for arch, depth, fill in runs:
                t0 = time.perf_counter()
                refs[arch] = _tp_reference(arch, depth, fill, dev)
                ref_s[arch] = time.perf_counter() - t0
                torch.save(refs[arch]["picks"],
                           Path(tmp) / f"teacher_{arch}.pt")
                torch.save([call[0] for call in refs[arch]["routing"]],
                           Path(tmp) / f"routes_{arch}.pt")
            t1 = time.perf_counter()
            ranks = _tp_job(data * model, Path(tmp), small=i == 0,
                            full=[list(run) for run in runs])
            job_s = time.perf_counter() - t1
        if i == 0:
            small = {}
            cuda, cpu = ranks[0]["small_cuda"], ranks[0]["small_cpu"]
            scale = float(cpu["prefill_logits"].abs().max())
            small["prefill_rel_err"] = float(
                (cuda["prefill_logits"] - cpu["prefill_logits"]).abs().max()
            ) / scale
            small["verdicts"] = {
                "prefill_within_tol": small["prefill_rel_err"]
                <= TP_SMALL_TOL,
                "tokens_exact": all(
                    torch.equal(r["small_cuda"]["tokens"],
                                r["small_cpu"]["tokens"])
                    and torch.equal(r["small_cuda"]["tokens"],
                                    cuda["tokens"]) for r in ranks),
                "kernels_launched": all(
                    r["small_cuda"]["launches"][k] > 0 for r in ranks
                    for k in ("flash_attention", "rmsnorm"))}
            small["launches"] = [{k: r["small_cuda"]["launches"][k]
                                  for k in ("flash_attention", "rmsnorm")}
                                 for r in ranks]
            small["tokens"] = cuda["tokens"][0].tolist()
            print(json.dumps({"tp_small": {
                "config": TP_SMALL[0] + "-reduced", "mesh": TP_SMALL[1],
                "card": CARD, **small}}), flush=True)
            failed += [f"tp_small {k}" for k, ok in small["verdicts"].items()
                       if not ok]
        for arch, depth, fill in runs:
            ref = refs.pop(arch)
            cfg = _lm_cfg(arch, depth)
            out = _tp_compare(arch, cfg, fill, ref, ranks)
            ref_launch = {k: ref["launches"][k]
                          for k in out["expected_launches"]}
            out["verdicts"]["reference_launches_exact"] = \
                ref_launch == out["expected_launches"]
            print(json.dumps({"tp_path": {
                "config": arch, "layers": depth, "mesh": [data, model],
                "moe_dispatch": cfg.moe_dispatch if cfg.is_moe else None,
                "patches": cfg.n_patches if cfg.frontend == "vision" else 0,
                "audio_frames":
                    TP_WHISPER[0] if cfg.encoder_decoder else 0,
                "batch": TP_BATCH,
                "prompt": TP_WHISPER[1] if cfg.encoder_decoder
                else TP_PROMPT, "fill": fill,
                "steps": TP_STEPS,
                "card": CARD,
                "unsharded": {k: ref[k] for k in (
                    "init_s", "peak_bytes", "param_bytes", "prefill_ms",
                    "fill_s", "decode_ms_per_step")},
                **out, "reference_s": ref_s[arch],
                "job_s": job_s, "job_configs": [a for a, _, _ in runs]}}),
                flush=True)
            failed += [f"{arch} {k}" for k, ok in out["verdicts"].items()
                       if not ok]
            for r in ranks:
                launches[f"tp_{arch}_rank{r['rank']}"] = r[arch]["launches"]
    if failed:
        raise AssertionError(f"tp: {failed} failed")
    return launches


# ------------------------------------------------------ the training slice --
# The kernels a reduced config's training step must launch on the card,
# forward and backward.
_ATTN_NORM = ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd")
_SSM_NORM = ("ssd_scan", "ssd_scan_bwd", "rmsnorm", "rmsnorm_bwd")
TRAIN_KERNELS = _ATTN_NORM + ("ssd_scan", "ssd_scan_bwd")
TRAIN_ARCHS = (
    ("qwen3_0_6b", _ATTN_NORM), ("qwen3_32b", _ATTN_NORM),
    ("deepseek_67b", _ATTN_NORM),
    ("olmo_1b", ("flash_attention", "flash_attention_bwd")),
    ("qwen3_moe_30b_a3b", _ATTN_NORM),
    ("deepseek_v2_236b", ("rmsnorm", "rmsnorm_bwd")),
    ("whisper_tiny", _ATTN_NORM), ("qwen2_vl_7b", _ATTN_NORM),
    ("mamba2_2_7b", _SSM_NORM), ("zamba2_1_2b", TRAIN_KERNELS),
)
TRAIN_TOL = 1e-4             # (b): card vs CPU, relative to a leaf's max
TRAIN_SMALL_CHUNKS = 4       # (b): a Mamba2 config's sequence, in chunks
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}    # (a)
# (c): the full-width bfloat16 runs through launch.train's loop (depth
# None: full depth; resume: a checkpoint round trip after the run).
# mamba2-2.7b runs 32 of its 64 layers: at 64 its first step asks for
# more than the card's 79 GiB (the functional AdamW step holds the old
# and new float32 moments and the float32 clipped gradients at once).
# zamba2 trains at lr 1e-3: at launch.train's 3e-3 its loss spikes near
# step 14 through the kernels and through the plain forward's autograd
# alike.  ``--train-probe`` shows both (PERF.md).
# profile: one more step under torch.profiler after the run, its device
# time by kernel (`profile_train_step`).
TRAIN_FULL = (
    dict(arch="qwen3_0_6b", depth=None, steps=30, lr=3e-3, resume=True,
         profile=True),
    dict(arch="zamba2_1_2b", depth=None, steps=20, lr=1e-3, resume=False,
         profile=True),
    dict(arch="mamba2_2_7b", depth=32, steps=10, lr=3e-3, resume=False,
         profile=False),
)
TRAIN_BATCH, TRAIN_SEQ = 8, 512
WHISPER_TRAIN = dict(batch=4, frames=1500, steps=5)
# (a): kernel 9's backward, (label, (B, S, H, P, N)) at chunk 128: one
# Mamba2 layer of Zamba2-1.2B and of mamba2-2.7b (state 128)
SSD_BWD_CASES = (("main", (4, 512, 64, 64, 64)),
                 ("state128", (4, 512, 80, 64, 128)))
# A multi-chunk kernel 9 backward row's gradients must move by at least
# this many times its tolerance when the state stops carrying past one
# chunk (ssd_carry_share): else its data could not show a carry fault.
SSD_CARRY_MARGIN = 10.0
# (a): kernel 7's backward, (label, (B, S, T, H, KV, D), causal, window)
FLASH_BWD_CASES = (
    ("main", (4, 512, 512, 16, 8, 128), True, 0),            # qwen3-0.6b
    ("qwen3_window256", (4, 512, 512, 16, 8, 128), True, 256),
    ("qwen3_window16", (4, 512, 512, 16, 8, 128), True, 16),
    ("mha", (4, 512, 512, 32, 32, 64), True, 0),
    ("whisper_cross", (4, 375, 1500, 6, 6, 64), False, 0),
)
# (a): kernel 8's backward at every shape the training paths give it, 8 x
# 512 tokens: qwen3-0.6b's norms ("main"), q_norm (16 heads) and k_norm (8
# heads) of 128; zamba2-1.2b's and mamba2-2.7b's model widths.
RMSNORM_BWD_CASES = (("main", (4096, 1024)), ("qk_norm", (65536, 128)),
                     ("k_norm", (32768, 128)), ("zamba2", (4096, 2048)),
                     ("mamba2", (4096, 2560)))


def _grad_err(name, got, want, tol, scale=None) -> float:
    """max |got - want| / scale of one gradient, scale = max |want| unless
    given; raises past tol."""
    got, want = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    if scale is None:
        scale = want.abs().max().item()
    scale = max(scale, 1e-30)
    rel = (got - want).abs().max().item() / scale
    if rel > tol:
        raise AssertionError(f"{name}: max abs err {rel:.3e} of the largest "
                             f"magnitude, past {tol}")
    return rel


def _grads_err(name, got, want, tol) -> float:
    """The worst :func:`_grad_err` of a kernel's gradients (dq, dk, dv or
    dx, dscale) against their plain versions, each relative to the largest
    magnitude among them: a gradient that is exactly zero (dq and dk
    under a window of 1, where each softmax row holds one key) is held to
    the scale of the others."""
    scale = max(w.detach().float().abs().max().item() for w in want)
    return max(_grad_err(f"{name} {i}", g, w, tol, scale)
               for i, (g, w) in enumerate(zip(got, want)))


def _band_mask(s, t, window, dev):
    """The causal band of ``window`` keys a query as SDPA's boolean mask
    (True: attended)."""
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(t, device=dev)[None, :]
    return (j <= i) & (i - j < window)


def ssd_bwd_inputs(gen, dev, b, s, h, p, n, dtype, g=1, large_dt=False):
    """(x, dt, A, B, C, dy) for kernel 9's backward.  At the model's scale
    (the default) A = -1 .. -H and dt = softplus(0.5 z + bias_h), the
    biases putting head h's dt at ssm_init's range [0.001, 0.1] spread
    geometrically in head order: every decay from a state that carries
    across the whole sequence (head 1) to one that forgets within a few
    positions.  ``large_dt``: the forward tests' dt = softplus(z) and
    A = -exp(z / 2), where a 128-chunk's decay underflows."""
    import torch.nn.functional as F

    def normal(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    x = normal((b, s, h, p), dtype)
    if large_dt:
        dt = F.softplus(normal((b, s, h)))
        A = -torch.exp(normal((h,)) * 0.5)
    else:
        d0 = torch.logspace(-3, -1, h, device=dev)
        dt = F.softplus(0.5 * normal((b, s, h)) + d0
                        + torch.log(-torch.expm1(-d0)))
        A = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    B, C = (normal((b, s, g, n), dtype) for _ in range(2))
    dy = normal((b, s, h, p))
    return x, dt, A, B, C, dy


def _ssd_plain_grads(x, dt, A, B, C, dy, chunk, forward=None):
    """(dx, ddt, dA, dB, dC): autograd of kernel 9's plain forward (or of
    ``forward``), B and C repeated to the heads and their gradients summed
    back over each group."""
    from repro_torch.kernels import ssd_scan as kss

    forward = forward or kss.ssd_scan_plain
    hg = x.shape[2] // B.shape[2]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        y = forward(*leaves[:3], leaves[3].repeat_interleave(hg, dim=2),
                    leaves[4].repeat_interleave(hg, dim=2), chunk)
        return torch.autograd.grad(y, leaves, dy)


def _ssd_one_chunk_memory(x, dt, A, B, C, chunk):
    """Kernel 9's plain forward with the state carried across one chunk
    boundary and no further: chunk c's entering state is chunk c-1's own
    contribution (each chunk scanned behind its predecessor, or behind
    zeros)."""
    from repro_torch.kernels import ssd_scan as kss

    b, s = x.shape[:2]
    nc = s // chunk

    def pairs(t):
        t = t.reshape(b, nc, chunk, *t.shape[2:])
        t = torch.cat([torch.zeros_like(t[:, :1]), t], 1)
        return torch.stack([t[:, :-1], t[:, 1:]], 2).reshape(
            b * nc, 2 * chunk, *t.shape[3:])

    y = kss.ssd_scan_plain(pairs(x), pairs(dt), A, pairs(B), pairs(C), chunk)
    return y.reshape(b, nc, 2, chunk, *y.shape[2:])[:, :, 1].reshape(
        b, s, *y.shape[2:])


def ssd_carry_share(x, dt, A, B, C, dy, chunk) -> float:
    """How far the data let the carry between chunks show: the largest,
    over the five gradients, of max |plain - plain with the state carried
    one chunk only| over the gradient's largest magnitude.  0 for a
    single chunk."""
    full = _ssd_plain_grads(x, dt, A, B, C, dy, chunk)
    short = _ssd_plain_grads(x, dt, A, B, C, dy, chunk,
                             _ssd_one_chunk_memory)
    return max(((f - c).abs().max() / f.abs().max().clamp_min(1e-30)).item()
               for f, c in zip(full, short))


def _kernel_split_ms(fn, reps: int = 3) -> dict:
    """Device ms a call of each kernel ``fn`` launches, by name
    (torch.profiler over ``reps`` calls)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, (t, _) in _device_ops(prof).items():
        short = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
        key = short.group(1) if short else name
        out[key] = out.get(key, 0.0) + t / reps
    if not out:
        print("kernels_ms: the profiler recorded no device activity",
              flush=True)
    return out or None


def _bwd_graph_ms(call, leaves, grad_out, reps: int, what: str):
    """Graph-replayed device ms of ``call``'s backward alone: ``call`` on
    fresh leaves (the tensors of ``leaves``, detached, requiring grad) and
    torch.autograd.grad of it captured in one graph, less ``call``
    captured alone (a backward from a graph retained outside the capture
    does not capture).  A process's first capture of a backward has
    failed on the card, whichever the call, so a failed one is tried once
    more on fresh leaves.  None where neither captures."""
    for attempt in (1, 2):
        fresh = [t.detach().requires_grad_(True) for t in leaves]
        label = f"{what}, attempt {attempt},"
        both = _graph_ms(
            lambda: torch.autograd.grad(call(*fresh), fresh, grad_out),
            reps, f"{label} forward + backward")
        alone = _graph_ms(lambda: call(*fresh), reps, f"{label} forward")
        if both is not None and alone is not None:
            return both - alone
    return None


def _host_split_us(name: str, fn, reps: int = 50) -> dict:
    """Where a wrapper's host time goes: us a call of ``fn`` whole, with
    the library call (``_lib.launch``: ctypes and the C side's launches)
    made a no-op, and their difference."""
    from repro_torch.kernels import _lib

    whole = _host_us(fn, reps)
    launch = _lib.launch
    _lib.launch = lambda *args: None
    try:
        python = _host_us(fn, reps)
    finally:
        _lib.launch = launch
    return {f"{name}_wrapper": whole, "without_launch": python,
            "launch": whole - python}


def check_train_kernels(dev) -> dict:
    """(a) the backward kernels of 7, 8 and 9 against the plain versions'
    autograd on the card, in bfloat16 and float32 (suffix "_f32"): the
    gradients within BWD_TOL of their largest magnitude (kernel 9: each
    gradient of its own), a second call equal bit for bit; timed beside
    the bound (backward ops ~2.5x the forward's pair FLOPs for kernel 7,
    2x the forward's multiply-adds for kernel 9), the plain version and a
    yardstick: SDPA's backward with enable_gqa (the window as a mask) and
    F.rms_norm's backward, each from a retained graph (their graph time:
    forward and backward captured together, less the forward,
    ``_bwd_graph_ms``); no single PyTorch call computes kernel 9's.
    Kernel 9's rows also give the device ms of each of its kernels and
    where the wrapper's host time goes."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rmsnorm as krn
    from repro_torch.kernels import ssd_scan as kss

    gen = torch.Generator(device=dev).manual_seed(23)
    results = {"flash_attention_bwd": {}, "rmsnorm_bwd": {},
               "ssd_scan_bwd": {}}

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def same(name, a, b):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: two calls differ")

    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        esize = 2 if dtype == torch.bfloat16 else 4
        peak = PEAK_BF16_OPS_S if dtype == torch.bfloat16 else PEAK_F32_OPS_S
        tol = BWD_TOL[dtype]
        for label, (b, s, t, h, kv, d), causal, window in FLASH_BWD_CASES:
            name = f"flash_attention_bwd {label}{suffix}"
            q = normal((b, s, h, d), dtype)
            k, v = (normal((b, t, kv, d), dtype) for _ in range(2))
            dout = normal((b, s, h, d), dtype)
            out, lse = kfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                    window=window)

            def kernel():
                return kfa.flash_attention_bwd(q, k, v, out, dout, lse,
                                               causal=causal, window=window)

            def plain():
                return kfa.flash_attention_bwd_plain(
                    q, k, v, out, dout, causal=causal, window=window)

            got, want = kernel(), plain()
            same(name, got, kernel())
            err = _grads_err(name, got, want, tol)
            lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            mask = _band_mask(s, t, window, dev) if window else None
            lo = F.scaled_dot_product_attention(
                lq, lk, lv, enable_gqa=True,
                is_causal=causal and not window, attn_mask=mask)
            ldout = dout.transpose(1, 2)

            def lib():
                return torch.autograd.grad(lo, (lq, lk, lv), ldout,
                                           retain_graph=True)

            def lib_graph(reps):
                return _bwd_graph_ms(
                    lambda a, b_, c: F.scaled_dot_product_attention(
                        a, b_, c, enable_gqa=True,
                        is_causal=causal and not window, attn_mask=mask),
                    (lq, lk, lv), ldout, reps, f"{name} yardstick")

            pairs = _attn_pairs(s, t, causal, window)
            _lm_record(results, "flash_attention_bwd", label + suffix,
                       [b, s, t, h, kv, d], err, kernel, plain, lib,
                       (4 * b * s * h + 4 * b * t * kv) * d * esize,
                       2.5 * 4.0 * b * h * pairs * d, peak, 5,
                       extra={"causal": causal, "window": window},
                       lib_graph=lib_graph)
            del q, k, v, dout, out, lse, got, want, lq, lk, lv, lo
        for label, (rows, d) in RMSNORM_BWD_CASES:
            name = f"rmsnorm_bwd {label}{suffix}"
            x = normal((rows, d), dtype)
            scale = (1.0 + 0.1 * normal((d,), torch.float32)).to(dtype)
            g = normal((rows, d), dtype)

            def kernel():
                return krn.rmsnorm_bwd(x, scale, g)

            def plain():
                return krn.rmsnorm_bwd_plain(x, scale, g)

            got, want = kernel(), plain()
            same(name, got, kernel())
            if got[1].dtype != dtype or got[0].dtype != dtype:
                raise AssertionError(f"{name}: gradients not in {dtype}")
            err = _grads_err(name, got, want, tol)
            lx = x.detach().requires_grad_(True)
            ls = scale.detach().requires_grad_(True)
            lo = F.rms_norm(lx, (d,), weight=ls, eps=1e-6)

            def lib():
                return torch.autograd.grad(lo, (lx, ls), g,
                                           retain_graph=True)

            def lib_graph(reps):
                return _bwd_graph_ms(
                    lambda a, w: F.rms_norm(a, (d,), weight=w, eps=1e-6),
                    (lx, ls), g, reps, f"{name} yardstick")

            route, lanes, vecs = krn.rmsnorm_bwd_plan(dtype, d, True)
            _lm_record(results, "rmsnorm_bwd", label + suffix, [rows, d],
                       err, kernel, plain, lib,
                       (3 * rows * d + 2 * d) * esize, 10.0 * rows * d,
                       PEAK_F32_OPS_S, 20, lib_graph=lib_graph,
                       extra={"route": route, "threads_a_row": lanes,
                              "vectors_a_lane": vecs,
                              "partial_rows": krn.rmsnorm_bwd_parts(
                                  route, lanes, rows)})
            del x, g, got, want, lx, ls, lo
        chunk = 128
        for label, (b, s, h, p, n) in SSD_BWD_CASES:
            name = f"ssd_scan_bwd {label}{suffix}"

            def check(x, dt, A, B, C, dy, what):
                got = kss.ssd_scan_bwd(x, dt, A, B, C, dy, chunk)
                same(what, got, kss.ssd_scan_bwd(x, dt, A, B, C, dy, chunk))
                if [t.dtype for t in got] != [dtype, torch.float32,
                                              torch.float32, dtype, dtype]:
                    raise AssertionError(f"{what}: gradients in the wrong "
                                         f"dtypes")
                want = _ssd_plain_grads(x, dt, A, B, C, dy, chunk)
                return max(_grad_err(f"{what} {i}", g, w, tol)
                           for i, (g, w) in enumerate(zip(got, want)))

            # the row's data at the model's scale, where the carry between
            # chunks must show; and the forward tests' large dt, where a
            # chunk's decay underflows
            extra = {"max_abs_err_large_dt": check(
                *ssd_bwd_inputs(gen, dev, b, s, h, p, n, dtype,
                                large_dt=True), name + " large dt")}
            x, dt, A, B, C, dy = ssd_bwd_inputs(gen, dev, b, s, h, p, n, dtype)
            err = check(x, dt, A, B, C, dy, name)
            extra["carry_share"] = ssd_carry_share(x, dt, A, B, C, dy, chunk)
            if extra["carry_share"] < SSD_CARRY_MARGIN * tol:
                raise AssertionError(f"{name}: the carry between chunks "
                                     f"moves the gradients by "
                                     f"{extra['carry_share']:.3e} only")

            def kernel():
                return kss.ssd_scan_bwd(x, dt, A, B, C, dy, chunk)

            def plain():
                return kss.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk)

            bsh = b * s * h
            _lm_record(results, "ssd_scan_bwd", label + suffix,
                       [b, s, h, p, n], err, kernel, plain, None,
                       bsh * p * (2 * esize + 4) + 2 * bsh * 4
                       + 4 * b * s * n * esize + 2 * h * 4,
                       2.0 * _ssd_ops(b, s, h, p, n, chunk), peak, 5,
                       extra=extra,
                       after=lambda: {"kernels_ms": _kernel_split_ms(kernel),
                                      "host_split_us": _host_split_us(
                                          "ssd_scan_bwd", kernel)})
            del x, dt, A, B, C, dy
    torch.cuda.synchronize()
    return results


def check_train_small(arch, dev, required) -> dict:
    """(b) one training step of the reduced float32 config on the card
    against the CPU: the loss, nll and aux, every gradient (within
    TRAIN_TOL of its largest magnitude) and the parameters after one
    ``api.sgd_train_step``, the card's run launching each kernel of
    ``required``.  The batch is 2 x 32 tokens; a config with Mamba2 layers
    takes TRAIN_SMALL_CHUNKS of its chunks, so the state crosses chunk
    boundaries.  tests/test_torch_cuda.py runs it too."""
    from repro_torch import rng
    from repro_torch.kernels import _lib
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map

    cfg = _lm_cfg(arch, None).reduced()
    params = api.init_params(rng.PRNGKey(0), cfg)
    seq = (TRAIN_SMALL_CHUNKS * cfg.ssm_chunk
           if cfg.arch_type in ("ssm", "hybrid") else 32)
    batch = api.make_train_batch(rng.PRNGKey(1), cfg, 2, seq)
    runs = {}
    for d in ("cpu", dev):
        p = tree_map(lambda w: w.to(d), params)
        bt = {k: v.to(d) for k, v in batch.items()}
        _lib.reset_launches()
        (loss, (nll, aux)), grads = api.value_and_grad(p, cfg, bt)
        new, _ = api.sgd_train_step(p, cfg, bt)
        runs[str(d)] = ([loss, nll, aux], tree_leaves(grads),
                        tree_leaves(new), dict(_lib.LAUNCHES))
    card, cpu = runs[str(dev)], runs["cpu"]
    for name in required:
        if card[3][name] <= 0:
            raise AssertionError(f"{arch} train: the card's step never "
                                 f"launched {name}")
    out = {"loss": max(_close_tol(f"{arch} train {w}", g.cpu(), c, TRAIN_TOL)
                       for w, g, c in zip(("loss", "nll", "aux"), card[0],
                                          cpu[0])),
           "grads": max(_grad_err(f"{arch} train grad {i}", g.cpu(), c,
                                  TRAIN_TOL)
                        for i, (g, c) in enumerate(zip(card[1], cpu[1]))),
           "params": max(_close_tol(f"{arch} train params", g.cpu(), c,
                                    TRAIN_TOL)
                         for g, c in zip(card[2], cpu[2])),
           "launches": {k: card[3][k] for k in TRAIN_KERNELS}}
    return out


def train_launches(cfg, steps: int) -> dict:
    """The exact launches of each training kernel in ``steps`` steps of
    ``cfg`` (models/lm.py's ``_run_layers``): a layer of the stack
    launches its forward kernels twice a step under remat (the forward,
    then the backward's recompute) and its backward kernels once; a
    hybrid's shared block (after each whole group of
    ``shared_attn_every`` Mamba2 layers, not checkpointed) and the final
    norm once each way.  An attention block: kernel 7 once, kernel 8 for
    norm1 and norm2 (and q_norm, k_norm); a Mamba2 block: kernel 9 once,
    kernel 8 for its input norm (its gated norm is plain)."""
    fwd = 2 if cfg.remat else 1
    attn = {"flash_attention": 1, "rmsnorm": 4 if cfg.qk_norm else 2}
    if cfg.arch_type in ("ssm", "hybrid"):
        layer = {"ssd_scan": 1, "rmsnorm": 1}
    else:
        layer = attn
    shared = (cfg.n_layers // cfg.shared_attn_every
              if cfg.arch_type == "hybrid" else 0)
    want = dict.fromkeys(TRAIN_KERNELS, 0)
    for name, k in layer.items():
        want[name] += fwd * cfg.n_layers * k
        want[name + "_bwd"] += cfg.n_layers * k
    for name, k in attn.items():
        want[name] += shared * k
        want[name + "_bwd"] += shared * k
    want["rmsnorm"] += 1                       # the final norm
    want["rmsnorm_bwd"] += 1
    return {name: k * steps for name, k in want.items()}


def run_train_full(dev, spec: dict) -> dict:
    """(c) one TRAIN_FULL run: the config at full width (depth as the spec
    says) in bfloat16 through ``launch.train``'s loop, launch counts
    zeroed just before and read just after and held to
    :func:`train_launches`; every loss finite and the last below the
    first; step ms, tokens/s, peak allocated bytes and the model-FLOP
    share (6ND over the median step at 989 TFLOP/s).  With ``resume`` it
    then saves a checkpoint and loads it into a fresh tree bit for bit,
    and takes one more step from each: equal losses,
    parameters within one bfloat16 ulp (the embedding's gradient may add
    in another order).  Returns the launches."""
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.data import token_batches
    from repro_torch.kernels import _lib
    from repro_torch.launch import train as train_mod
    from repro_torch.roofline import report
    from repro_torch.tree import tree_leaves, tree_map

    arch, steps = spec["arch"], spec["steps"]
    b, s = TRAIN_BATCH, TRAIN_SEQ
    cfg = _lm_cfg(arch, spec["depth"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = [torch.cuda.memory_allocated(), torch.cuda.memory_reserved()]
    t0 = time.perf_counter()
    _lib.reset_launches()
    try:
        res = train_mod.train(cfg, steps, b, s, spec["lr"], dev,
                              log=lambda line: print(f"train {line}",
                                                     flush=True))
    except torch.OutOfMemoryError as err:
        print(json.dumps({
            "train_path": f"train_{arch}", "depth": cfg.n_layers,
            "out_of_memory": True,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "card_bytes": torch.cuda.get_device_properties(dev).total_memory,
            "allocated_reserved_bytes_before": held,
            "error": str(err).splitlines()[0]}), flush=True)
        raise
    launches = dict(_lib.LAUNCHES)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.n_layers
    want = train_launches(cfg, steps)
    got = {k: launches[k] for k in want}
    losses = res.losses
    step_s = statistics.median(res.step_s[1:])
    # 6ND, N scaled to the layers run where the depth is cut (N counts no
    # embedding; a cut config has no shared block)
    flops = report.model_flops(arch, {"global_batch": b, "seq_len": s},
                               "train") * layers / _lm_cfg(arch,
                                                           None).n_layers
    row = {"train_path": f"train_{arch}", "depth": layers, "dtype":
           str(cfg.param_dtype).split(".")[-1], "batch": b, "seq": s,
           "steps": steps, "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "step_ms_median": step_s * 1e3,
           "step_ms": [x * 1e3 for x in res.step_s],
           "tokens_per_s": b * s / step_s, "peak_allocated_bytes": peak,
           "model_flops_per_step": flops,
           "model_flop_share": flops / step_s / PEAK_BF16_OPS_S,
           "launches": got, "launches_expected": want, "seconds": seconds,
           "allocated_reserved_bytes_before": held}
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        print(json.dumps(row), flush=True)
        raise AssertionError(f"train_{arch}: losses {losses}")
    if got != want:
        print(json.dumps(row), flush=True)
        raise AssertionError(f"train_{arch}: launches {got}, expected "
                             f"{want}")
    if spec["profile"]:
        batch = next(token_batches(3, cfg.vocab, b, s, 1, top=8, device=dev))
        row["profile_step"] = profile_train_step(
            train_mod.make_step(cfg, res.opt), res.params, res.opt_state,
            batch)
    if not spec["resume"]:
        print(json.dumps(row), flush=True)
        del res
        torch.cuda.empty_cache()
        return launches
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "params.npz")
        t0 = time.perf_counter()
        save_pytree(path, res.params, step=steps)
        fresh = load_pytree(path, tree_map(torch.empty_like, res.params))
        ckpt_s = time.perf_counter() - t0
    for a, c in zip(tree_leaves(fresh), tree_leaves(res.params)):
        if a.dtype != c.dtype or not torch.equal(a, c):
            raise AssertionError(f"train_{arch}: checkpoint not bit for bit")
    step = train_mod.make_step(cfg, res.opt)
    batch = next(token_batches(2, cfg.vocab, b, s, 1, top=8, device=dev))
    p1, _, l1 = step(res.params, res.opt_state, batch)
    p2, _, l2 = step(fresh, res.opt_state, batch)
    if not torch.equal(l1, l2):
        raise AssertionError(f"train_{arch}: the step from the loaded "
                             f"checkpoint gives loss {float(l2)}, not "
                             f"{float(l1)}")
    ulps, bit_equal = 0.0, True
    for a, c in zip(tree_leaves(p1), tree_leaves(p2)):
        if not torch.equal(a, c):
            bit_equal = False
            d = (a.float() - c.float()).abs()
            ulp = torch.clamp(c.float().abs(), min=1e-30) * 2.0 ** -7
            ulps = max(ulps, (d / ulp).max().item())
    if ulps > 1.0:
        raise AssertionError(f"train_{arch}: the steps from the loaded and "
                             f"the trained weights differ by {ulps} ulps")
    row.update(checkpoint_s=ckpt_s, resumed_bit_equal=bit_equal,
               resumed_max_ulps=ulps)
    print(json.dumps(row), flush=True)
    del res, fresh, p1, p2
    torch.cuda.empty_cache()
    return launches


# The port's kernels of a training step by the names the profiler gives
# their CUDA functions (kernel 9's backward: its five kernels of either
# route).
_TRAIN_KERNEL_OF = (
    ("flash_bwd_", "flash_attention_bwd"), ("flash_fwd_", "flash_attention"),
    ("rmsnorm_bwd_", "rmsnorm_bwd"), ("rmsnorm_", "rmsnorm"),
    ("ssd_mma_kernel", "ssd_scan"), ("ssd_simt_kernel", "ssd_scan"),
    *((k, "ssd_scan_bwd") for k in (
        "chunk_state_mma", "state_scan", "local_mma", "local_kernel",
        "state_kernel", "reduce_kernel", "da_kernel")))


def profile_train_step(step, params, opt_state, batch) -> dict:
    """One training step under torch.profiler: its wall ms (to a sync),
    the device's busy ms and share, the device ms and calls of each port
    kernel of the step (``_TRAIN_KERNEL_OF``; PyTorch's own kernels, in
    ``at::``, are not the port's), the matmuls' ms and the top device
    ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    ops = _device_ops(prof)
    if not ops:
        print("profile_step: the profiler recorded no device activity",
              flush=True)
        return {"wall_ms": wall_ms, "device_ops": 0}
    busy = sum(t for t, _ in ops.values())
    kernel_ms, kernel_calls = {}, {}
    for name, (t, c) in ops.items():
        short = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
        ident = short.group(1) if short and "at::" not in name else ""
        kernel = next((k for prefix, k in _TRAIN_KERNEL_OF
                       if ident.startswith(prefix)), None)
        if kernel is not None:
            kernel_ms[kernel] = kernel_ms.get(kernel, 0.0) + t
            kernel_calls[kernel] = kernel_calls.get(kernel, 0) + c
    mm = sum(t for name, (t, _) in ops.items()
             if any(m in name.lower() for m in _MATMUL_MARKS))
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "device_ops": sum(c for _, c in ops.values()),
            "kernel_ms": kernel_ms, "kernel_calls": kernel_calls,
            "matmul_ms": mm,
            "top_device_ops": [{"name": k[:80], "ms": t, "calls": c}
                               for k, (t, c) in top]}


def run_whisper_train(dev) -> dict:
    """(c) whisper-tiny at full width: WHISPER_TRAIN's
    ``api.sgd_train_step``s on ``make_train_batch`` batches (audio frames
    and 1/4 as many decoder tokens), launch counts zeroed just before and
    read just after; finite losses, kernels 7 and 8 launched forward and
    backward."""
    from repro_torch import rng
    from repro_torch.kernels import _lib
    from repro_torch.models import api

    cfg = _lm_cfg("whisper_tiny", None)
    params = api.init_params(rng.PRNGKey(0, device=dev), cfg)
    _lib.reset_launches()
    w_losses, w_ms = [], []
    for i in range(WHISPER_TRAIN["steps"]):
        batch = api.make_train_batch(rng.PRNGKey(10 + i, device=dev), cfg,
                                     WHISPER_TRAIN["batch"],
                                     WHISPER_TRAIN["frames"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, metrics = api.sgd_train_step(params, cfg, batch)
        w_losses.append(float(metrics["loss"]))
        w_ms.append((time.perf_counter() - t0) * 1e3)
    w_launches = dict(_lib.LAUNCHES)
    if not all(math.isfinite(x) for x in w_losses):
        raise AssertionError(f"train_whisper_tiny: losses {w_losses}")
    for name in _ATTN_NORM:
        if w_launches[name] <= 0:
            raise AssertionError(f"train_whisper_tiny never launched {name}")
    print(json.dumps({"train_path": "train_whisper_tiny",
                      "batch": WHISPER_TRAIN["batch"],
                      "frames": WHISPER_TRAIN["frames"],
                      "tokens": batch["tokens"].shape[1] - 1,
                      "losses": w_losses, "step_ms": w_ms,
                      "launches": {k: w_launches[k] for k in _ATTN_NORM}}),
          flush=True)
    del params
    torch.cuda.empty_cache()
    return w_launches


def run_train_probe(dev) -> None:
    """``--train-probe``: the two full-width questions TRAIN_FULL's
    settings rest on, asked apart from the smoke run.  (1) zamba2-1.2b at
    ``launch.train``'s default lr 3e-3, 20 steps, through the kernels and
    again through autograd of kernel 9's plain forward (same weights and
    batches): the two loss curves, then both backwards' gradients on the
    first batch at the kernel run's trained weights, at the initial ones
    and at the initial ones in float32 (the largest, over the leaves, of
    max |kernel - plain| over the leaf's largest magnitude, and that
    leaf's path).  (2)
    mamba2-2.7b at all 64 layers, 3 steps: the run's row, or its memory
    when the card runs out."""
    from repro_torch import rng
    from repro_torch.data import token_batches
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.launch import train as train_mod
    from repro_torch.models import api, ssm
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    cfg = _lm_cfg("zamba2_1_2b", None)
    out = {}
    for label in ("kernels", "plain"):
        if label == "plain":
            ssm.ssd_scan = kss.ssd_scan_plain
        try:
            res = train_mod.train(cfg, 20, TRAIN_BATCH, TRAIN_SEQ, 3e-3, dev,
                                  log=lambda line: None)
        finally:
            ssm.ssd_scan = kss.ssd_scan
        out[f"losses_{label}"] = res.losses
        if label == "kernels":
            params = res.params
        del res
        torch.cuda.empty_cache()
    batch = next(token_batches(1, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, 1,
                               top=8, device=dev))

    def grad_gap(weights, cfg) -> tuple[float, str]:
        _, g_kernel = api.value_and_grad(weights, cfg, batch)
        ssm.ssd_scan = kss.ssd_scan_plain
        try:
            _, g_plain = api.value_and_grad(weights, cfg, batch)
        finally:
            ssm.ssd_scan = kss.ssd_scan
        return max((((a.float() - c.float()).abs().max()
                     / c.float().abs().max().clamp_min(1e-30)).item(),
                    "/".join(map(str, path)))
                   for (path, a), c in zip(tree_leaves_with_path(g_kernel),
                                           tree_leaves(g_plain)))

    out["grad_gap_trained"] = grad_gap(params, cfg)
    del params
    for label, c in (("init", cfg),
                     ("init_f32", _lm_cfg("zamba2_1_2b", None,
                                          dtype="float32"))):
        out[f"grad_gap_{label}"] = grad_gap(
            api.init_params(rng.PRNGKey(0, device=dev), c), c)
        torch.cuda.empty_cache()
    print(json.dumps({"train_probe_zamba2_lr3e-3": out}), flush=True)
    torch.cuda.empty_cache()
    try:
        run_train_full(dev, dict(arch="mamba2_2_7b", depth=64, steps=3,
                                 lr=3e-3, resume=False, profile=False))
    except (torch.OutOfMemoryError, AssertionError) as err:
        print(f"train_probe mamba2_2_7b depth 64: {type(err).__name__}",
              flush=True)


def run_train_phase(dev) -> tuple[dict, dict]:
    """The training slice: (a) the backward kernel rows, (b) the reduced
    configs card vs CPU, (c) the full-width runs.  Returns (kernel rows by
    kernel, launches by path)."""
    t_phase = time.perf_counter()
    results = check_train_kernels(dev)
    small = {arch: check_train_small(arch, dev, required)
             for arch, required in TRAIN_ARCHS}
    print(json.dumps({"train_small": small,
                      "seconds": time.perf_counter() - t_phase}), flush=True)
    launches = {f"train_{spec['arch']}": run_train_full(dev, spec)
                for spec in TRAIN_FULL}
    launches["train_whisper_tiny"] = run_whisper_train(dev)
    print(json.dumps({"train_phase_seconds": time.perf_counter() - t_phase}),
          flush=True)
    return results, launches


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


PHASE_S: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Time a phase of the run: prints ``{"phase": name, "s": ...}`` when
    it ends and keeps the seconds in PHASE_S."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = time.perf_counter() - t0
        print(json.dumps({"phase": name, "s": PHASE_S[name]}), flush=True)


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
    lm_only = argv == ["--lm"]
    train_only = argv == ["--train"]
    probe_only = argv == ["--train-probe"]
    fused_only = argv == ["--fused"]
    tp_only = argv == ["--tp"]
    profile_only = argv == ["--sweep-profile"]
    shard_rank_dir = (Path(argv[1]) if len(argv) == 2
                      and argv[0] == "--shard-rank" else None)
    tp_rank_dir = (Path(argv[1]) if len(argv) == 2
                   and argv[0] == "--tp-rank" else None)
    if argv and not (kernels_only or sweeps_only or lm_only or train_only
                     or probe_only or fused_only or tp_only or profile_only
                     or shard_rank_dir or tp_rank_dir):
        print(f"chip_smoke: unknown arguments {argv}; takes none, "
              f"--kernels, --sweeps, --lm, --train, --train-probe, "
              f"--fused, --tp or --sweep-profile", file=sys.stderr)
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
    if shard_rank_dir is not None:
        return shard_rank(shard_rank_dir)
    if tp_rank_dir is not None:
        return tp_rank(tp_rank_dir)
    print("tf32: off for matmul and cudnn (float32 means float32)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
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
    if lm_only:
        check_lm_arch_kernels(dev, {"flash_attention": {}, "rmsnorm": {}})
        run_lm_archs(dev)
        return 0
    if train_only:
        run_train_phase(dev)
        return 0
    if probe_only:
        run_train_probe(dev)
        return 0
    if fused_only:
        run_fused_only(dev)
        return 0
    if tp_only:
        run_tp_phase(dev)
        return 0
    if profile_only:
        # every scenario x 2 seeds through the host loop, profiled: the
        # largest buckets' batched greedy (PERF.md §5)
        profile_sweep_round(dev, learning=False, names=_ALL, n_seeds=2)
        return 0
    t_run = time.perf_counter()
    with phase("host_costs"):
        host_costs(dev)
    with phase("kernels"):
        results = check_kernels(dev)
    with phase("lm_kernels"):
        results.update(check_lm_kernels(dev))
        check_lm_arch_kernels(dev, results)
    if kernels_only:
        return 0
    with phase("small_runs"):
        check_small_runs(dev)
        check_zamba_small(dev)
    spy, restore_spy = assign_spy()
    try:
        with phase("fl_paths"):
            sims, launches, steps = run_paths(dev, [p[0] for p in PATHS],
                                              spy)
            launches[COVER[0]] = run_cover_pair(dev)
        with phase("fl_profiles"):
            profile_round(sims["sync"], "sync")
            profile_round(sims["sync_selected"], "sync_selected")
            profile_round(sims["hier_int8"], "hier_int8")
            profile_round(sims["faulty_async"], "faulty_async")
            profile_round(sims["ucb"], "ucb")
        del sims
        with phase("fl_fused"):
            run_fused_phase(dev, steps, spy)
    finally:
        restore_spy()
    del steps
    with phase("fleet_selected"):
        launches[FLEET_SELECTED[0]] = run_fleet_selected(dev)

    with phase("sweeps"):
        check_small_sweeps(dev)
        for label, learning, names, extra, required in SWEEP_PATHS:
            out, launches[label], recs = run_sweep_path(
                dev, label, learning, names, extra, required)
            if label in FUSED_SWEEPS:
                run_fused_sweep(dev, label, learning, names, extra, out,
                                launches[label], recs)
            del recs
            torch.cuda.empty_cache()
        profile_sweep_round(dev, learning=True)
        profile_sweep_round(dev, learning=False)
        # the largest buckets' batched greedy, every scenario x 2 seeds,
        # replayed (its host loop profiled: --sweep-profile)
        profile_sweep_replays(dev)
    with phase("shard"):
        launches.update(run_shard_phase(dev))

    with phase("zamba2"):
        check_zamba_full_f32(dev)
        torch.cuda.empty_cache()
        params, cfg, prompt, launches["zamba2_serve"] = run_zamba_serve(dev)
        profile_zamba(params, cfg, prompt, dev)
        del params
        torch.cuda.empty_cache()
    with phase("lm_archs"):
        launches.update(run_lm_archs(dev))
    with phase("tp"):
        launches.update(run_tp_phase(dev))
    with phase("train"):
        train_results, train_launches = run_train_phase(dev)
    results.update(train_results)
    launches.update(train_launches)
    print(json.dumps({"phases_s": PHASE_S,
                      "total_s": time.perf_counter() - t_run}), flush=True)

    print(json.dumps({"kernels": kernel_rows(results, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Graph-replayed device ms of kernels 7 and 9 forward (flash attention and
the SSD scan) on one CUDA card, for the tree whose ``src`` directory is
given: an A/B of two commits runs this once per tree, alternating, in one
session on one card.

    python3 tools/time_lm_forward.py SRC [--reps R]

Times the bfloat16 forwards at ``chip_smoke.py``'s kernel-check shapes
("main" and "long" of kernel 7 at Zamba2's attention, [4 | 8, 512 | 2048,
32, 64], and at qwen3's, [4 | 8, 512 | 2048, 16 / 8, 128], all causal;
kernel 9's "main", "long" and "state128", chunk 128), each as ``R`` calls
captured in one CUDA graph and replayed between CUDA events, and prints
one JSON line: ms a call by row, and the card's ``nvidia-smi`` name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def graph_ms(torch, fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="the tree's src directory (holds "
                                "repro_torch)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"{src} holds no repro_torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kss

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = {}
    for label, (b, s, h, kv, d) in (("flash main", (4, 512, 32, 32, 64)),
                                    ("flash long", (8, 2048, 32, 32, 64)),
                                    ("flash qwen3", (4, 512, 16, 8, 128)),
                                    ("flash qwen3_long",
                                     (8, 2048, 16, 8, 128))):
        q, k, v = normal((b, s, h, d)), normal((b, s, kv, d)), \
            normal((b, s, kv, d))
        rows[label] = graph_ms(
            torch, lambda: kfa.flash_attention(q, k, v, causal=True),
            args.reps)
    for label, (b, s, h, p, n) in (("ssd main", (4, 512, 64, 64, 64)),
                                   ("ssd long", (8, 2048, 64, 64, 64)),
                                   ("ssd state128", (4, 512, 80, 64, 128))):
        x = normal((b, s, h, p))
        dt = torch.nn.functional.softplus(normal((b, s, h), torch.float32))
        A = -torch.exp(normal((h,), torch.float32) * 0.5)
        B, C = normal((b, s, 1, n)), normal((b, s, 1, n))
        rows[label] = graph_ms(
            torch, lambda: kss.ssd_scan(x, dt, A, B, C, 128), args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"src": str(src), "card": smi, "graph_ms": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

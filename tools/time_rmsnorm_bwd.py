#!/usr/bin/env python3
"""Graph-replayed device ms of kernel 8's backward (``rmsnorm_bwd``) on one
CUDA card, for the tree whose ``src`` directory is given: an A/B of two
commits runs this once per tree, alternating, in one session on one card.

    python3 tools/time_rmsnorm_bwd.py SRC [--reps R] [--grid B:R[:V] ...]
                                         [--split] [--cold N]

Times the wrapper at ``chip_smoke.RMSNORM_BWD_CASES`` in bfloat16 and
float32, each as ``R`` calls captured in one CUDA graph and replayed
between CUDA events, after holding its gradients to the plain version
within ``chip_smoke.BWD_TOL``, and prints one JSON line: ms a call by row,
the host us a call (``chip_smoke._host_us``), and the card's
``nvidia-smi`` name and power limit.  ``--grid B:R[:V]`` (a
tree whose wrapper has them) sets ``BWD_MAX_BLOCKS`` to B,
``BWD_BLOCK_ROWS`` to R and ``BWD_MAX_VECS_PER_LANE`` to V first, one
line each: the sweep behind their values.  ``--split`` adds each row's
device ms by kernel (torch.profiler, ``chip_smoke._kernel_split_ms``).
``--cold N`` makes the calls walk N copies of each row's inputs in turn,
so that what they read (N x 2 arrays) passes the 50 MB L2, as a training
step's backward finds its inputs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="the tree's src directory (holds "
                                "repro_torch)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--grid", nargs="*", default=[None],
                    help="B:R[:V]: BWD_MAX_BLOCKS, BWD_BLOCK_ROWS and "
                         "BWD_MAX_VECS_PER_LANE")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--cold", type=int, default=1)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"{src} holds no repro_torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import rmsnorm as krn

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(23)
    cases = []
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        for label, (rows, d) in chip_smoke.RMSNORM_BWD_CASES:
            x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
            scale = (1.0 + 0.1 * torch.randn((d,), generator=gen,
                                             device=dev)).to(dtype)
            g = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
            cases.append((label + suffix, x, scale, g,
                          krn.rmsnorm_bwd_plain(x, scale, g),
                          [(x.clone(), g.clone())
                           for _ in range(args.cold - 1)] + [(x, g)]))
    for grid in args.grid:
        if grid is not None:
            values = list(map(int, grid.split(":")))
            krn.BWD_MAX_BLOCKS, krn.BWD_BLOCK_ROWS = values[:2]
            if len(values) > 2:
                krn.BWD_MAX_VECS_PER_LANE = values[2]
                krn.rmsnorm_bwd_plan.cache_clear()
        ms, host, err, split = {}, {}, {}, {}
        for label, x, scale, g, want, copies in cases:
            turn = iter(range(10 ** 9))

            def call():
                cx, cg = copies[next(turn) % len(copies)]
                return krn.rmsnorm_bwd(cx, scale, cg)

            got = krn.rmsnorm_bwd(x, scale, g)
            err[label] = chip_smoke._grads_err(
                f"rmsnorm_bwd {label}", got, want,
                chip_smoke.BWD_TOL[x.dtype])
            ms[label] = chip_smoke._graph_ms(call, args.reps,
                                             f"rmsnorm_bwd {label}")
            host[label] = chip_smoke._host_us(call, args.reps)
            if args.split:
                split[label] = chip_smoke._kernel_split_ms(call)
        print(json.dumps({"src": str(src), "card": smi, "grid": grid,
                          "cold": args.cold,
                          "graph_ms": ms, "host_us": host,
                          "max_abs_err": err,
                          **({"kernel_ms": split} if args.split else {})}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

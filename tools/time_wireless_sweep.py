#!/usr/bin/env python3
"""Wall seconds a round of the port's wireless sweep on one CUDA card,
for the tree whose ``src`` directory is given: an A/B of two commits runs
this once per tree, alternating, in one session on one card.

    python3 tools/time_wireless_sweep.py SRC [--rounds R] [--seeds S]

Runs ``repro_torch.launch.sweep.run_sweep`` over every registered
scenario (the ``wireless_all`` path of ``chip_smoke.py``: 50 users,
float32 plane, seed 0) once to warm up and build the kernels, then times
a second call of ``R`` rounds and ``S`` seeds, set-up included, and
prints one JSON line: the wall seconds, the seconds a (scenario, seed,
round) cell round, the kernels' launches, and the card's ``nvidia-smi``
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="the tree's src directory (holds "
                                "repro_torch)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seeds", type=int, default=2)
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
    from repro_torch.core.scenario import SCENARIOS
    from repro_torch.kernels import _lib
    from repro_torch.launch import sweep

    names = list(SCENARIOS)
    sweep.run_sweep(names, n_seeds=args.seeds, n_rounds=1, device="cuda")
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    sweep.run_sweep(names, n_seeds=args.seeds, n_rounds=args.rounds,
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cells = len(names) * args.seeds
    print(json.dumps({"src": str(src), "card": smi, "scenarios": len(names),
                      "seeds": args.seeds, "rounds": args.rounds,
                      "wall_s": wall,
                      "wall_s_per_cell_round": wall / (cells * args.rounds),
                      "launches": {k: v for k, v in _lib.LAUNCHES.items()
                                   if v}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

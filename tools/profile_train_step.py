#!/usr/bin/env python3
"""One full-width bfloat16 training step under torch.profiler on one CUDA
card, for the tree whose ``src`` directory is given: the device ms of the
port's kernels in a step, before and after a change to them, in one
session on one card.

    python3 tools/profile_train_step.py SRC [--arch A ...] [--warm N]

For each config (default qwen3_0_6b and zamba2_1_2b, full depth, B = 8,
T = 512, AdamW at lr 1e-3 through ``launch.train``) it runs ``N`` steps
(default 3), then profiles one more with ``chip_smoke.profile_train_step``
and prints one JSON line: the step's wall ms, the device's busy ms and
share, each port kernel's device ms and calls, the matmuls' ms and the
top device ops, with the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="the tree's src directory (holds "
                                "repro_torch)")
    ap.add_argument("--arch", nargs="+",
                    default=["qwen3_0_6b", "zamba2_1_2b"])
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"{src} holds no repro_torch", file=sys.stderr)
        return 1
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.data import token_batches
    from repro_torch.launch import train as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    b, s = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ
    for arch in args.arch:
        cfg = chip_smoke._lm_cfg(arch, None)
        res = train_mod.train(cfg, args.warm, b, s, 1e-3, dev,
                              log=lambda line: None)
        batch = next(token_batches(3, cfg.vocab, b, s, 1, top=8, device=dev))
        prof = chip_smoke.profile_train_step(
            train_mod.make_step(cfg, res.opt), res.params, res.opt_state,
            batch)
        print(json.dumps({"src": str(src), "card": smi, "arch": arch,
                          "warm_step_ms": [x * 1e3 for x in res.step_s],
                          "profile_step": prof}), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

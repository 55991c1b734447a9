#!/usr/bin/env python3
"""The card memory a sweep leaves reserved, captured and not.

    python3 tools/sweep_memory.py [--order host,host,captured,captured]
                                  [--sweep learning|fleet] [--expandable]
                                  [--history]

Runs the ``sweep_sync`` learning sweep of ``chip_smoke.py`` (paper-default
and high-mobility, 2 seeds, 3 rounds, the CNN at the paper's width, 50
users) through ``run_learning_sweep``, or with ``--sweep fleet`` its
``fleet_bf16`` wireless sweep (mega-fleet at 200,000 users x 100 BSs,
rho1 0, rho2 5e-5, bf16 plane, 1 seed, 2 rounds) through ``run_sweep``,
once for each entry of ``--order``: ``captured`` is the public route (on
the card each bucket one captured graph a pattern, released at the
bucket's end), ``host`` the sweep's uncaptured route.  ``--expandable``
sets the caching allocator's expandable segments, as ``chip_smoke.py``
does.  After each run it prints one JSON line: the bytes the
card keeps reserved once every free block went back
(``torch.cuda.memory_reserved`` after ``empty_cache``), and the reserved
segments grouped by memory pool and stream with the bytes of live blocks
in them.  ``--history`` records torch's allocation history and adds the
call sites (in this repo) of the largest live blocks.  The first line
gives the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _site(frames) -> str:
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name or "chip_smoke" in name:
            return f"{Path(name).name}:{f.get('line')} {f.get('name')}"
    return "outside the repo"


def reading(torch, history: bool) -> dict:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pools = collections.defaultdict(lambda: [0, 0, 0])
    sites = collections.Counter()
    for seg in torch.cuda.memory._snapshot()["segments"]:
        key = f"pool{tuple(seg.get('segment_pool_id', ()))} " \
              f"stream{seg['stream']:#x} {seg['segment_type']}"
        pools[key][0] += 1
        pools[key][1] += seg["total_size"]
        pools[key][2] += seg["allocated_size"]
        if history:
            for b in seg["blocks"]:
                if b["state"] == "active_allocated":
                    sites[_site(b.get("frames", []))] += b["size"]
    out = {"reserved_bytes": torch.cuda.memory_reserved(),
           "allocated_bytes": torch.cuda.memory_allocated(),
           "segments": {k: {"n": v[0], "bytes": v[1], "live_bytes": v[2]}
                        for k, v in sorted(pools.items())}}
    if history:
        out["live_bytes_by_site"] = dict(sites.most_common(12))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", default="host,host,captured,captured")
    ap.add_argument("--sweep", default="learning",
                    choices=("learning", "fleet"))
    ap.add_argument("--expandable", action="store_true")
    ap.add_argument("--history", action="store_true")
    args = ap.parse_args(argv)
    if args.expandable:
        # before torch loads, as chip_smoke.py sets it
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("sweep_memory: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core.types import WirelessConfig
    from repro_torch.launch import sweep
    from repro_torch.models.cnn import CNNConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    if args.history:
        torch.cuda.memory._record_memory_history(max_entries=200000)
    dev = torch.device("cuda")
    if args.sweep == "fleet":
        cfg = WirelessConfig(n_users=200_000, rho1=0.0, rho2=5e-5)

        def run():
            sweep.run_sweep(["mega-fleet"], n_seeds=1, n_rounds=2, cfg=cfg,
                            channel_dtype="bf16", device=dev)
    else:
        kw = dict(n_seeds=2, n_rounds=3, device=dev, dataset="mnist",
                  n_train=4000, n_test=1000, local_epochs=10, batch_size=16,
                  eval_every=1, seed=0, cnn_cfg=CNNConfig.paper_scale())

        def run():
            sweep.run_learning_sweep(["paper-default", "high-mobility"],
                                     **kw)
    real = sweep._run_bucket
    print(json.dumps({"run": "start", **reading(torch, args.history)}),
          flush=True)
    for i, route in enumerate(args.order.split(",")):
        sweep._run_bucket = (real if route == "captured"
                             else sweep._run_bucket_host)
        try:
            run()
        finally:
            sweep._run_bucket = real
        print(json.dumps({"run": i, "route": route,
                          **reading(torch, args.history)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

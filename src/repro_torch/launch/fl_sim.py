"""FL simulation driver for the PyTorch port — the paper's end-to-end run.

    PYTHONPATH=src python -m repro_torch.launch.fl_sim \
        --scheduler dagsa --dataset mnist --rounds 20
    PYTHONPATH=src python -m repro_torch.launch.fl_sim --aggregation \
        hierarchical --tau-global 2 --compress topk-int8 --topk-frac 0.1
    PYTHONPATH=src python -m repro_torch.launch.fl_sim --scheduler \
        dagsa-r --faults faulty-uplink --async --tick 0.5 \
        --staleness-alpha 0.5
    PYTHONPATH=src python -m repro_torch.launch.fl_sim --scheduler \
        dagsa_jit --scenario non-iid-pathological --speed 50
    PYTHONPATH=src python -m repro_torch.launch.fl_sim --scheduler ucb
    PYTHONPATH=src python -m repro_torch.launch.fl_sim --scheduler \
        dagsa_jit --compute selected --select-cap 10
    torchrun --nproc-per-node 2 -m repro_torch.launch.fl_sim --shard \
        --device cpu --scheduler dagsa_jit

Runs on CUDA by default (``--device cpu`` to run on the CPU) and prints one
line per round once the run ends.  ``--mode`` picks the engine as in the
JAX package: ``fused`` (the default for a tensor-step scheduler; on the
card each round replays a captured CUDA graph), ``step`` or ``eager``
(the host loop; the host greedies' only mode).  ``--compute selected`` trains only a
static-size gather of the scheduled clients; like the JAX package, the
host schedulers (``dagsa``, ``dagsa-r-host``) train the whole fleet.
``--shard [--mesh D]`` splits each round's local SGD over the
``torch.distributed`` ranks (``FLConfig.shard``); rank 0 alone prints.
"""
from __future__ import annotations

import argparse

from repro_torch.core.scenario import PARTITIONS, SCENARIOS
from repro_torch.core.scheduler import SCHEDULERS
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.faults import FAULT_PRESETS
from repro_torch.fl.rounds import (AGGREGATIONS, BS_LAYOUTS, COMPRESS_MODES,
                                   COMPUTE_MODES, FLConfig, FLSimulation,
                                   accuracy_at_budget)
from repro_torch.models.cnn import CNNConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="dagsa",
                    choices=list(SCHEDULERS))
    ap.add_argument("--dataset", default="mnist", choices=sorted(DATASETS))
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--speed", type=float, default=None,
                    help="user speed in m/s (overrides the scenario's)")
    ap.add_argument("--hetero-bw", action="store_true",
                    help="Fig. 3: per-BS bandwidth B_k ~ U[0.5, 1.5] MHz")
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="named scenario: mobility model, BS layout, "
                         "bandwidth and shadowing in one word")
    ap.add_argument("--n-train", type=int, default=1000)
    ap.add_argument("--n-test", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=20)
    ap.add_argument("--local-epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--shards-per-user", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--bs-layout", default="grid", choices=BS_LAYOUTS)
    ap.add_argument("--paper-cnn", action="store_true",
                    help="the 16/32/64 CNN (CNNConfig.paper_scale) instead "
                         "of the small default")
    ap.add_argument("--mode", default=None,
                    choices=("fused", "step", "eager"),
                    help="fused (default for the tensor-step schedulers: "
                         "on the card a round captured as a CUDA graph and "
                         "replayed), the per-round step, or the host path "
                         "(the host greedies' only mode)")
    ap.add_argument("--compute", default="full", choices=COMPUTE_MODES,
                    help="selected: train only a static-size padded top-K "
                         "subset of scheduled clients")
    ap.add_argument("--select-cap", type=int, default=None,
                    help="K for --compute selected (default ceil(rho2*N))")
    ap.add_argument("--aggregation", default=None, choices=AGGREGATIONS,
                    help="hierarchical: per-BS edge aggregation with a "
                         "global sync every --tau-global rounds (default: "
                         "single-tier)")
    ap.add_argument("--tau-global", type=int, default=None,
                    help="global sync period in rounds (hierarchical only)")
    ap.add_argument("--faults", default=None, choices=sorted(FAULT_PRESETS),
                    help="fault-injection preset: outages, stragglers, "
                         "crashes, poisoned updates (default: none)")
    ap.add_argument("--deadline", type=float, default=None, metavar="T",
                    help="round deadline in simulated seconds: the server "
                         "stops waiting at T and drops late updates")
    ap.add_argument("--async", dest="async_agg", action="store_true",
                    help="buffered-async aggregation: the server ticks "
                         "every --tick simulated seconds and folds in "
                         "whatever updates landed, staleness-discounted")
    ap.add_argument("--tick", type=float, default=None, metavar="S",
                    help="async aggregation period in simulated seconds "
                         "(required with --async)")
    ap.add_argument("--staleness-alpha", type=float, default=0.0,
                    metavar="A",
                    help="staleness discount exponent in (1+s)^(-A) "
                         "(--async only; 0 disables)")
    ap.add_argument("--buffer-size", type=int, default=None, metavar="B",
                    help="async event-queue capacity (default n_users, "
                         "which never overflows)")
    ap.add_argument("--compress", default=None, choices=COMPRESS_MODES,
                    help="uplink update compression: top-k sparsification "
                         "(topk) or top-k + int8 stochastic rounding "
                         "(topk-int8); the per-user payload s_k feeds the "
                         "Eq. (1)/(3)/(11) latency model (default: off)")
    ap.add_argument("--topk-frac", type=float, default=None, metavar="F",
                    help="fraction of model coordinates kept per client "
                         "update (requires --compress)")
    ap.add_argument("--partition", default=None, choices=sorted(PARTITIONS),
                    help="client data partition: label shards (shard) or "
                         "Dirichlet non-IID label mixing (dirichlet; "
                         "default: inherit the scenario)")
    ap.add_argument("--dirichlet-alpha", type=float, default=None,
                    metavar="A",
                    help="Dirichlet concentration for --partition dirichlet "
                         "(small = pathological non-IID)")
    ap.add_argument("--shard", action="store_true",
                    help="split each round's local SGD over the "
                         "torch.distributed ranks (launch with torchrun "
                         "--nproc-per-node D); numerically equal to the "
                         "unsharded run, not bit-equal")
    ap.add_argument("--mesh", type=int, default=None, metavar="D",
                    help="ranks that train for --shard (default: every "
                         "rank; must divide n_users)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    if args.async_agg and args.tick is None:
        ap.error("--async needs --tick (the aggregation period in "
                 "simulated seconds)")
    if not args.async_agg and (args.tick is not None
                               or args.staleness_alpha != 0.0
                               or args.buffer_size is not None):
        ap.error("--tick/--staleness-alpha/--buffer-size only apply with "
                 "--async; they would silently do nothing")

    cnn_cfg = None
    if args.paper_cnn:
        h, w, c = DATASETS[args.dataset][:3]
        cnn_cfg = CNNConfig.paper_scale(height=h, width=w, channels=c)
    cfg = FLConfig(dataset=args.dataset, scheduler=args.scheduler,
                   local_epochs=args.local_epochs, batch_size=args.batch_size,
                   lr=args.lr, shards_per_user=args.shards_per_user,
                   eval_every=args.eval_every, seed=args.seed,
                   n_train=args.n_train, n_test=args.n_test, cnn=cnn_cfg,
                   bs_layout=args.bs_layout, compute=args.compute,
                   select_cap=args.select_cap, aggregation=args.aggregation,
                   tau_global=args.tau_global, faults=args.faults,
                   deadline_s=args.deadline, aggregation_async=args.async_agg,
                   tick_s=args.tick, staleness_alpha=args.staleness_alpha,
                   buffer_size=args.buffer_size, compress=args.compress,
                   topk_frac=args.topk_frac, speed_mps=args.speed,
                   hetero_bw=args.hetero_bw, scenario=args.scenario,
                   partition=args.partition,
                   dirichlet_alpha=args.dirichlet_alpha, shard=args.shard,
                   mesh_devices=args.mesh)
    sim = FLSimulation(cfg, device=args.device)
    try:
        recs = sim.run(args.rounds, mode=args.mode)
    finally:
        if sim.mesh is not None:
            sim.mesh.close()
    if sim.mesh is not None and sim.mesh.rank != 0:
        return
    hier = sim.aggregation == "hierarchical"
    faulty = sim.faults.active
    is_async = cfg.aggregation_async
    print(f"{'round':>5} {'t_round':>8} {'clock':>8} {'users':>5} "
          f"{'acc':>6} {'min_fair':>8}"
          + (f" {'handover':>8}" if hier else "")
          + (f" {'deliv':>5} {'del_rate':>8} {'goodput':>8}"
             if faulty or is_async else "")
          + (f" {'inflight':>8} {'dropped':>7}" if is_async else ""))
    for r in recs:
        line = (f"{r.round_idx:5d} {r.t_round:8.3f} {r.wall_clock:8.2f} "
                f"{r.n_selected:5d} {r.test_acc:6.3f} {r.min_part_rate:8.2f}")
        if hier:
            line += f" {r.handover_rate:8.3f}"
        if faulty or is_async:
            line += (f" {r.n_delivered:5d} {r.delivered_rate:8.2f} "
                     f"{r.goodput_mbit_s:8.2f}")
        if is_async:
            line += f" {r.n_inflight:8d} {r.n_dropped:7d}"
        print(line)
    budget = recs[-1].wall_clock / 2
    print(f"\nacc@{budget:.1f}s = {accuracy_at_budget(recs, budget):.3f}  "
          f"final = {recs[-1].test_acc:.3f}")
    if faulty or is_async:
        n = len(recs)
        print(f"delivered_rate mean = "
              f"{sum(r.delivered_rate for r in recs) / n:.3f}  "
              f"goodput mean = "
              f"{sum(r.goodput_mbit_s for r in recs) / n:.2f} Mbit/s")


if __name__ == "__main__":
    main()

"""FL simulation driver for the PyTorch port — the paper's end-to-end run.

    PYTHONPATH=src python -m repro_torch.launch.fl_sim \
        --scheduler dagsa_jit --dataset mnist --rounds 20

Runs on CUDA by default (``--device cpu`` to run on the CPU) and prints one
line per round once the run ends.
"""
from __future__ import annotations

import argparse

from repro_torch.core.scheduler import SCHEDULERS
from repro_torch.data.synthetic import DATASETS
from repro_torch.fl.rounds import BS_LAYOUTS, FLConfig, FLSimulation
from repro_torch.models.cnn import CNNConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler", default="dagsa_jit",
                    choices=list(SCHEDULERS))
    ap.add_argument("--dataset", default="mnist", choices=sorted(DATASETS))
    ap.add_argument("--rounds", type=int, default=20)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    cnn_cfg = None
    if args.paper_cnn:
        h, w, c = DATASETS[args.dataset][:3]
        cnn_cfg = CNNConfig.paper_scale(height=h, width=w, channels=c)
    cfg = FLConfig(dataset=args.dataset, scheduler=args.scheduler,
                   local_epochs=args.local_epochs, batch_size=args.batch_size,
                   lr=args.lr, shards_per_user=args.shards_per_user,
                   eval_every=args.eval_every, seed=args.seed,
                   n_train=args.n_train, n_test=args.n_test, cnn=cnn_cfg,
                   bs_layout=args.bs_layout)
    recs = FLSimulation(cfg, device=args.device).run(args.rounds)
    print(f"{'round':>5} {'t_round':>8} {'clock':>8} {'users':>5} "
          f"{'acc':>6} {'min_fair':>8}")
    for r in recs:
        print(f"{r.round_idx:5d} {r.t_round:8.3f} {r.wall_clock:8.2f} "
              f"{r.n_selected:5d} {r.test_acc:6.3f} {r.min_part_rate:8.2f}")


if __name__ == "__main__":
    main()

"""The two-rank half of tests/test_torch_shard.py: every sharded path of
repro_torch on the CPU, over a gloo world of two ranks.

    torchrun --standalone --nproc-per-node 2 tests/_torch_shard_job.py OUT

Each rank writes what it computed to ``OUT/rank{r}.pkl``; rank 0 also
writes the sharded sweep CLI's JSON to ``OUT/cli.json``.  Imports no jax:
the test process, which does, compares these with its own unsharded runs.
"""
import dataclasses
import pickle
import sys
from pathlib import Path

import torch

from repro_torch import rng
from repro_torch.core import channel, mobility
from repro_torch.core.types import WirelessConfig
from repro_torch.fl.rounds import FLConfig, FLSimulation
from repro_torch.interop import params_to_numpy
from repro_torch.launch import sweep
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.launch.shard_sweep import (run_shard_learning_sweep,
                                            run_shard_sweep,
                                            shard_schedule_batch)

# one shape bucket, three mobility behaviours: 3 cells pad to 4 on 2 ranks
THREE = dict(scenarios=["paper-default", "high-mobility", "static"],
             n_seeds=1, n_rounds=2)
# the JAX package's tests/test_shard_sweep.py LEARN_KW
LEARN_KW = dict(n_rounds=2, n_train=400, n_test=32, local_epochs=1,
                batch_size=4)
LEARNING = dict(scenarios=["faulty-uplink"], scheduler="dagsa-r",
                n_seeds=2, **LEARN_KW)
FL = dict(scheduler="dagsa_jit", n_train=400, n_test=32, batch_size=4,
          local_epochs=1)
FL_ROUNDS = 2
CLI = ["--scenarios", "paper-default,high-mobility", "--seeds", "3",
       "--rounds", "2", "--n-users", "12"]


def fleet_problems(n: int):
    """``n`` paper-width problems, one prior participation each (the JAX
    test's ``_fleet_problems``), and their ``[n, 2]`` keys."""
    cfg = WirelessConfig()
    key = rng.PRNGKey(0)
    probs = []
    for s in range(n):
        k0, k1 = rng.split(rng.fold_in(key, s)).unbind(0)
        st = mobility.init_positions_grid_bs(k0, cfg)
        probs.append(channel.make_problem(k1, st, cfg,
                                          torch.ones((cfg.n_users,)), 0))
    return probs, rng.split(rng.PRNGKey(1), n)


def fl_run(shard: bool, n_users: int = 50):
    """(round records as dicts, final parameters as numpy)."""
    sim = FLSimulation(FLConfig(wireless=WirelessConfig(n_users=n_users),
                                shard=shard, **FL), device="cpu")
    recs = sim.run(FL_ROUNDS)
    return [dataclasses.asdict(r) for r in recs], params_to_numpy(sim.params)


def main(out: Path) -> None:
    torch.set_num_threads(1)
    mesh = make_data_mesh(device="cpu")
    res = {"rank": mesh.rank, "world_size": mesh.world_size,
           "block": list(mesh.block(3))}
    scen = THREE["scenarios"]
    res["wireless"] = run_shard_sweep(scen, n_seeds=THREE["n_seeds"],
                                      n_rounds=THREE["n_rounds"], mesh=mesh)
    learn = dict(LEARNING)
    res["learning"] = run_shard_learning_sweep(learn.pop("scenarios"),
                                               mesh=mesh, **learn)
    probs, keys = fleet_problems(5)
    sched = shard_schedule_batch(probs, keys, mesh=mesh)
    res["schedule"] = {f.name: getattr(sched, f.name).numpy()
                       for f in dataclasses.fields(sched)
                       if getattr(sched, f.name) is not None}
    res["fl"] = fl_run(shard=True)
    try:
        fl_run(shard=True, n_users=49)
    except ValueError as err:
        res["indivisible"] = str(err)
    sweep.main(CLI + ["--shard", "--device", "cpu", "--out",
                      str(out / "cli.json")])
    mesh.close()
    with open(out / f"rank{res['rank']}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(Path(sys.argv[1]))

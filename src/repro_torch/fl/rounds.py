"""The mobility-aware FL round engine (PyTorch port of ``repro.fl.rounds``:
the synchronous, single-tier ``"engine"`` world).

Per communication round:
  1. users move (``rd`` or ``static`` mobility),
  2. the BSs observe one round's channels -> SchedulingProblem,
  3. DAGSA picks users, BSs and bandwidth (kernels ``best_bs_argmax``,
     ``masked_bs_argmax``, ``bandwidth_solve`` on the card),
  4. every client runs E epochs of local SGD (the mask enters only the
     aggregation, ``compute="full"``),
  5. masked FedAvg, Eq. (2) (kernel ``fedavg_reduce`` on the card),
  6. participation counts and the simulated clock (Eq. 3) advance, and the
     global model is evaluated every ``eval_every`` rounds.

The PRNG follows the JAX engine exactly, so both packages simulate the
same world from the same seed: ``split(PRNGKey(seed), 6)`` at set-up,
``fold_in(k_pos, 1)`` for the mobility aux state, ``split(key, 5)`` each
round and ``split(k_fleet, N)`` for the clients.

:class:`FLSimulation` runs on ``device="cuda"`` unless told otherwise and
raises when CUDA is absent and no device was given; it never falls back
to the CPU on its own.  Records stay on the device until ``run`` ends.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import channel, mobility
from repro_torch.core import scheduler as sched
from repro_torch.core.types import (ClientState, MobilityState, RoundState,
                                    ServerState, WirelessConfig, WorldState)
from repro_torch.data.synthetic import make_dataset
from repro_torch.fl import client as fl_client
from repro_torch.fl.partition import shard_partition
from repro_torch.kernels.fedavg_reduce import fedavg_reduce
from repro_torch.models import cnn

BS_LAYOUTS = ("grid", "uniform")

# A named range per round phase, read by torch.profiler (chip_smoke.py's
# breakdown); with no profiler running each costs a few microseconds.
span = torch.profiler.record_function


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """End-to-end FL simulation config (the fields this port implements)."""

    dataset: str = "mnist"
    scheduler: str = "dagsa_jit"
    wireless: WirelessConfig = dataclasses.field(default_factory=WirelessConfig)
    local_epochs: int = 10          # paper §IV
    batch_size: int = 16
    lr: float = 0.01                # paper §IV
    shards_per_user: int = 2        # paper §IV Non-IID split
    eval_every: int = 1
    seed: int = 0
    n_train: Optional[int] = None   # defaults per dataset
    n_test: Optional[int] = None
    cnn: Optional[cnn.CNNConfig] = None
    bs_layout: str = "grid"         # grid | uniform

    def __post_init__(self):
        sched.check_scheduler(self.scheduler)
        if self.bs_layout not in BS_LAYOUTS:
            raise ValueError(f"unknown bs_layout {self.bs_layout!r}; "
                             f"choose from {BS_LAYOUTS}")


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    t_round: float        # simulated round latency (s), Eq. (3)
    wall_clock: float     # cumulative simulated time (s)
    n_selected: int
    test_acc: float       # nan when not evaluated this round
    min_part_rate: float  # min_i counts_i / n — fairness monitor (Eq. 8g)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is absent and no
    device was given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


def make_round_step(cfg: FLConfig, w: WirelessConfig, *, mob_model: str,
                    x_clients, y_clients, data_sizes, x_test, y_test, bs_pos,
                    bs_bw, params0, pos0, aux0, counts0, key0):
    """Build the synchronous single-tier round step: ``(init_state,
    step_fn)`` with ``step_fn(state, r) -> (state', out)`` and ``out`` a
    dict of 0-dim device tensors."""
    n = w.n_users
    init_state = RoundState(world=WorldState(pos=pos0, mob_aux=aux0),
                            clients=ClientState(counts=counts0),
                            server=ServerState(params=params0), key=key0)

    def step_fn(state: RoundState, r: int):
        params = state.server.params
        counts = state.clients.counts
        key, k_mob, k_prob, k_sched, k_fleet = rng.split(state.key, 5).unbind(0)
        with span("round.world"):
            pos, aux = mobility.step_named(mob_model, k_mob, state.world.pos,
                                           state.world.mob_aux, w)
            prob = channel.make_problem(
                k_prob, MobilityState(user_pos=pos, bs_pos=bs_pos), w, counts,
                r, bs_bw=bs_bw)
        with span("round.schedule"):
            res = sched.schedule(cfg.scheduler, prob, w, k_sched)
        with span("round.local_sgd"):
            client_params = fl_client.fleet_local_sgd(
                params, x_clients, y_clients, rng.split(k_fleet, n),
                epochs=cfg.local_epochs, batch_size=cfg.batch_size, lr=cfg.lr)
        with span("round.fedavg"):
            params = fedavg_reduce(params, client_params, res.selected,
                                   data_sizes)

        counts = counts + res.selected.to(counts.dtype)
        with span("round.eval"):
            if cfg.eval_every and (r + 1) % cfg.eval_every == 0:
                acc = cnn.accuracy(params, x_test, y_test)
            else:
                acc = torch.tensor(float("nan"), device=counts.device)
        out = {"t_round": res.t_round, "test_acc": acc,
               "min_part_rate": counts.min() / (r + 1.0),
               "n_selected": res.selected.sum().to(torch.int32)}
        new_state = RoundState(world=WorldState(pos=pos, mob_aux=aux),
                               clients=ClientState(counts=counts),
                               server=ServerState(params=params), key=key)
        return new_state, out

    return init_state, step_fn


class FLSimulation:
    """Owns all state of one FL run; ``run(n_rounds)`` yields RoundRecords."""

    def __init__(self, cfg: FLConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        w = self.wireless = cfg.wireless

        key = rng.PRNGKey(cfg.seed, device=dev)
        k_data, k_part, k_pos, k_model, k_bw, k_run = rng.split(key, 6).unbind(0)
        self.data = make_dataset(cfg.dataset, seed=cfg.seed,
                                 n_train=cfg.n_train, n_test=cfg.n_test,
                                 device=dev)
        idx = shard_partition(k_part, self.data.y_train, w.n_users,
                              cfg.shards_per_user)
        self.x_clients = self.data.x_train[idx]      # [N, n_i, H, W, C]
        self.y_clients = self.data.y_train[idx]      # [N, n_i]
        self.data_sizes = torch.full((w.n_users,), idx.shape[1],
                                     dtype=torch.int32, device=dev)

        h, wd, c = self.data.x_train.shape[1:]
        self.cnn_cfg = cfg.cnn or cnn.CNNConfig(height=h, width=wd, channels=c)
        params0 = cnn.init(k_model, self.cnn_cfg)

        if cfg.bs_layout == "uniform":
            mob = mobility.init_positions(k_pos, w)
        else:
            mob = mobility.init_positions_grid_bs(k_pos, w)
        self.bs_pos = mob.bs_pos
        aux0 = mobility.init_aux(rng.fold_in(k_pos, 1), w.n_users, w)
        bs_bw = torch.full((w.n_bs,), w.bs_bandwidth_mhz, device=dev)
        counts0 = torch.zeros((w.n_users,), device=dev)

        self.wall_clock = 0.0
        self.round_idx = 0
        self._state, self._step_fn = make_round_step(
            cfg, w, mob_model="rd", x_clients=self.x_clients,
            y_clients=self.y_clients, data_sizes=self.data_sizes,
            x_test=self.data.x_test, y_test=self.data.y_test,
            bs_pos=self.bs_pos, bs_bw=bs_bw, params0=params0,
            pos0=mob.user_pos, aux0=aux0, counts0=counts0, key0=k_run)

    @property
    def params(self):
        return self._state.server.params

    @property
    def min_participants(self) -> int:
        return int(math.ceil(self.wireless.rho2 * self.wireless.n_users))

    def run(self, n_rounds: int) -> list[RoundRecord]:
        """Run ``n_rounds``; the records cross to the host once, at the end."""
        if n_rounds <= 0:
            return []
        outs = []
        for r in range(self.round_idx, self.round_idx + n_rounds):
            self._state, out = self._step_fn(self._state, r)
            outs.append(out)
        stacked = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                   for k in outs[0]}                     # the one host copy
        first = self.round_idx + 1
        self.round_idx += n_rounds
        wall = self.wall_clock + np.cumsum(stacked["t_round"],
                                           dtype=np.float64)
        recs = [RoundRecord(round_idx=first + i,
                            t_round=float(stacked["t_round"][i]),
                            wall_clock=float(wall[i]),
                            n_selected=int(stacked["n_selected"][i]),
                            test_acc=float(stacked["test_acc"][i]),
                            min_part_rate=float(stacked["min_part_rate"][i]))
                for i in range(n_rounds)]
        self.wall_clock = float(wall[-1])
        return recs

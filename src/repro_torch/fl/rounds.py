"""The mobility-aware FL round engine (PyTorch port of ``repro.fl.rounds``:
the synchronous ``"engine"`` world).

Per communication round:
  1. users move (``rd`` or ``static`` mobility),
  2. the BSs observe one round's channels -> SchedulingProblem (with a
     compressed uplink, each user's payload s_k scales the Eq. (1)/(11)
     coefficients),
  3. DAGSA picks users, BSs and bandwidth: the host greedy ``dagsa`` (the
     default, numpy draws seeded ``seed * 100003 + r`` as in the JAX
     engine's eager path; kernel ``bandwidth_solve`` for Eq. (12)) or
     ``dagsa_jit`` (kernels ``best_bs_argmax``, ``masked_bs_argmax``,
     ``bandwidth_solve`` on the card),
  4. every client runs E epochs of local SGD (the mask enters only the
     aggregation, ``compute="full"``),
  5. aggregation, Eq. (2):
     * ``aggregation="single"``: masked FedAvg into the global model
       (kernel ``fedavg_reduce``);
     * ``aggregation="hierarchical"``: each client trains from its camped
       cell's edge model, every BS edge-aggregates the users assigned to
       it (kernel ``fedavg_segment_reduce``), and every ``tau_global``
       rounds the edge models sync into the global model;
     with ``compress="topk"|"topk-int8"`` the clients upload top-k (+ int8)
     codes of their deltas (kernel ``sparsify_quantize``) and the server
     aggregates the codes as they are (the int8 variants of the two
     reductions),
  6. participation counts and the simulated clock (Eq. 3) advance, and the
     global model (on hierarchical runs the edge mixture) is evaluated
     every ``eval_every`` rounds.

The PRNG follows the JAX engine exactly, so both packages simulate the
same world from the same seed: ``split(PRNGKey(seed), 6)`` at set-up,
``fold_in(k_pos, 1)`` for the mobility aux state, ``split(key, 5)`` each
round, ``split(k_fleet, N)`` for the clients and, for ``topk-int8``, the
rounding-noise key ``fold_in(k_fleet, N + 1)``.

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

from repro_torch import resolve_device, rng
from repro_torch.core import channel, mobility
from repro_torch.core import scheduler as sched
from repro_torch.core.types import (ClientState, MobilityState, RoundState,
                                    ServerState, WirelessConfig, WorldState)
from repro_torch.data.synthetic import make_dataset
from repro_torch.fl import client as fl_client
from repro_torch.fl import server as fl_server
from repro_torch.fl.partition import shard_partition
from repro_torch.kernels import compress_topk as ct
from repro_torch.kernels.fedavg_reduce import (fedavg_reduce,
                                               fedavg_segment_reduce)
from repro_torch.models import cnn
from repro_torch.tree import tree_map

BS_LAYOUTS = ("grid", "uniform")
AGGREGATIONS = ("single", "hierarchical")
COMPRESS_MODES = ("topk", "topk-int8")

# Global sync period when hierarchical aggregation names no tau.
DEFAULT_TAU_GLOBAL = 5

# A named range per round phase, read by torch.profiler (chip_smoke.py's
# breakdown); with no profiler running each costs a few microseconds.
span = torch.profiler.record_function


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """End-to-end FL simulation config (the fields this port implements)."""

    dataset: str = "mnist"
    scheduler: str = "dagsa"
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
    aggregation: Optional[str] = None  # single | hierarchical (None: single)
    tau_global: Optional[int] = None   # global sync period (rounds), only
                                       # with hierarchical (None: 5)
    compress: Optional[str] = None     # uplink compression: topk |
                                       # topk-int8 (None: off)
    topk_frac: Optional[float] = None  # fraction of each leaf's entries a
                                       # client uploads (None: 1.0, dense)

    def __post_init__(self):
        sched.check_scheduler(self.scheduler)
        if self.bs_layout not in BS_LAYOUTS:
            raise ValueError(f"unknown bs_layout {self.bs_layout!r}; "
                             f"choose from {BS_LAYOUTS}")
        if (self.aggregation is not None
                and self.aggregation not in AGGREGATIONS):
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             f"choose from {AGGREGATIONS}")
        if self.tau_global is not None:
            if self.tau_global < 1:
                raise ValueError("tau_global must be >= 1")
            if self.aggregation != "hierarchical":
                raise ValueError(
                    f"tau_global={self.tau_global} only applies to "
                    f"aggregation='hierarchical' (resolved aggregation is "
                    f"{self.aggregation or 'single'!r}); it would silently "
                    f"do nothing")
        if self.compress is not None and self.compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compress mode {self.compress!r}; "
                             f"choose from {COMPRESS_MODES}")
        if self.topk_frac is not None:
            if not 0.0 < self.topk_frac <= 1.0:
                raise ValueError("topk_frac must be in (0, 1]")
            if self.compress is None:
                raise ValueError(
                    f"topk_frac={self.topk_frac} only applies with a "
                    f"compress mode (the resolved mode is off); it would "
                    f"silently do nothing")


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    t_round: float        # simulated round latency (s), Eq. (3)
    wall_clock: float     # cumulative simulated time (s)
    n_selected: int
    test_acc: float       # nan when not evaluated this round
    min_part_rate: float  # min_i counts_i / n — fairness monitor (Eq. 8g)
    handover_rate: float = float("nan")  # fraction of users whose serving
                                         # BS changed this round
                                         # (hierarchical runs only)


def camped_bs(dist: torch.Tensor) -> torch.Tensor:
    """[N] int32 serving cell: the geometrically nearest BS (lowest index
    on a tie)."""
    return torch.argmin(dist, dim=1).to(torch.int32)


def _compress_updates(ref_params, client_params, compress: str,
                      topk_frac: float, key):
    """Client side of the compressed uplink: deltas from ``ref_params``
    (the shared global model, or per-client [N, ...] references) -> top-k
    (+ int8) codes.  Returns ``(codes, scales, finite)``; ``finite`` [N]
    marks clients whose raw delta was all-finite, since the compressor
    screens non-finite entries to 0 and the caller drops the others'
    weight."""
    delta = tree_map(
        lambda c, g: c - (g if g.dim() == c.dim() else g[None]).to(c.dtype),
        client_params, ref_params)
    finite = fl_server.finite_update_mask(delta)
    codes, scales = ct.compress_delta_tree(
        delta, topk_frac, quantize=(compress == "topk-int8"), key=key)
    return codes, scales, finite


def train_and_aggregate(params, x_clients, y_clients, keys, selected,
                        data_sizes, *, epochs: int, batch_size: int,
                        lr: float, compress: str | None = None,
                        topk_frac: float = 1.0, compress_key=None):
    """The single-tier data plane: local SGD on every client, then masked
    FedAvg (Eq. 2), over compressed deltas when ``compress`` is set."""
    with span("round.local_sgd"):
        client_params = fl_client.fleet_local_sgd(
            params, x_clients, y_clients, keys, epochs=epochs,
            batch_size=batch_size, lr=lr)
    if compress is None:
        with span("round.fedavg"):
            return fedavg_reduce(params, client_params, selected, data_sizes)
    with span("round.compress"):
        codes, scales, finite = _compress_updates(
            params, client_params, compress, topk_frac, compress_key)
    with span("round.fedavg"):
        return ct.fedavg_decompress_reduce(params, codes, scales,
                                           selected & finite, data_sizes)


def hierarchical_round(global_params, edge_params, edge_weight, prev_bs,
                       x_clients, y_clients, keys, assign, serving,
                       data_sizes, r: int, *, tau_global: int, epochs: int,
                       batch_size: int, lr: float,
                       compress: str | None = None, topk_frac: float = 1.0,
                       compress_key=None):
    """One hierarchical data-plane round (arXiv 2108.09103's architecture).

    Each client trains from the edge model of its serving (camped) cell and
    its update edge-aggregates into the BS the scheduler assigned it
    (per-BS Eq. (2)); every ``tau_global`` rounds the edge models sync into
    the global model, weighted by the data each aggregated since the last
    sync, and every edge restarts from the new global model.

    Returns ``(global_params, edge_params, edge_weight, serving,
    handover_rate)``.
    """
    moved = (serving != prev_bs) & (prev_bs >= 0)
    handover_rate = moved.float().mean()
    with span("round.local_sgd"):
        init = fl_client.gather_client_tree(edge_params, serving)
        client_params = fl_client.fleet_local_sgd_per_client(
            init, x_clients, y_clients, keys, epochs=epochs,
            batch_size=batch_size, lr=lr)
    if compress is None:
        with span("round.fedavg"):
            edge_params = fedavg_segment_reduce(edge_params, client_params,
                                                assign, data_sizes)
    else:
        # deltas from the serving edge model (what the client trained
        # from), decoded into the assigned BS's aggregation
        with span("round.compress"):
            codes, scales, finite = _compress_updates(
                init, client_params, compress, topk_frac, compress_key)
        assign = assign & finite[:, None]
        with span("round.fedavg"):
            edge_params = ct.fedavg_decompress_segment_reduce(
                edge_params, codes, scales, assign, serving, data_sizes)
    # as in the JAX engine, without the finite-update screen that the
    # uncompressed segmented reduction applies inside
    _, bs_totals = fl_server.segment_weights(assign, data_sizes)
    edge_weight = edge_weight + bs_totals
    if (r + 1) % tau_global == 0:
        with span("round.sync"):
            global_params = fl_server.edge_global_sync(
                global_params, edge_params, edge_weight)
            edge_params = tree_map(
                lambda g, e: g[None].repeat((e.shape[0],) + (1,) * g.dim()),
                global_params, edge_params)
            edge_weight = torch.zeros_like(edge_weight)
    return global_params, edge_params, edge_weight, serving, handover_rate


def make_round_step(cfg: FLConfig, w: WirelessConfig, *, mob_model: str,
                    x_clients, y_clients, data_sizes, x_test, y_test, bs_pos,
                    bs_bw, params0, pos0, aux0, counts0, key0,
                    aggregation: str = "single", tau_global: int = 1,
                    compress: str | None = None, topk_frac: float = 1.0):
    """Build the synchronous round step: ``(init_state, step_fn)`` with
    ``step_fn(state, r) -> (state', out)`` and ``out`` a dict of 0-dim
    device tensors.  ``aggregation``, ``tau_global``, ``compress`` and
    ``topk_frac`` are the resolved knobs of ``cfg``."""
    n = w.n_users
    dev = counts0.device
    hier = aggregation == "hierarchical"
    # compressed uplink: the per-user payload s_k = ratio * S scales the
    # Eq. (1)/(11) coefficients; None keeps the uniform S exactly
    if compress is not None:
        up_mbit = w.model_mbit * ct.compression_ratio(
            params0, topk_frac, compress == "topk-int8")
        payload0 = torch.full((n,), up_mbit, dtype=torch.float32, device=dev)
    else:
        payload0 = None
    init_state = RoundState(
        world=WorldState(pos=pos0, mob_aux=aux0),
        clients=ClientState(
            counts=counts0,
            prev_bs=(torch.full((n,), -1, dtype=torch.int32, device=dev)
                     if hier else None)),
        server=ServerState(
            params=params0,
            edge_params=(tree_map(lambda p: p[None].repeat(
                (w.n_bs,) + (1,) * p.dim()), params0) if hier else None),
            edge_weight=(torch.zeros((w.n_bs,), device=dev)
                         if hier else None)),
        key=key0)

    def step_fn(state: RoundState, r: int):
        params = state.server.params
        edge, edge_w = state.server.edge_params, state.server.edge_weight
        counts, prev_bs = state.clients.counts, state.clients.prev_bs
        key, k_mob, k_prob, k_sched, k_fleet = rng.split(state.key, 5).unbind(0)
        with span("round.world"):
            pos, aux = mobility.step_named(mob_model, k_mob, state.world.pos,
                                           state.world.mob_aux, w)
            mstate = MobilityState(user_pos=pos, bs_pos=bs_pos)
            prob = channel.make_problem(k_prob, mstate, w, counts, r,
                                        bs_bw=bs_bw, payload_mbit=payload0)
            if hier:
                serving = camped_bs(mstate.distances())
        with span("round.schedule"):
            res = sched.schedule(cfg.scheduler, prob, w, k_sched,
                                 seed=cfg.seed * 100003 + r)
        keys = rng.split(k_fleet, n)
        ck = (rng.fold_in(k_fleet, n + 1) if compress == "topk-int8"
              else None)
        data_kw = dict(epochs=cfg.local_epochs, batch_size=cfg.batch_size,
                       lr=cfg.lr, compress=compress, topk_frac=topk_frac,
                       compress_key=ck)
        if hier:
            params, edge, edge_w, prev_bs, handover_rate = \
                hierarchical_round(params, edge, edge_w, prev_bs, x_clients,
                                   y_clients, keys, res.assign, serving,
                                   data_sizes, r, tau_global=tau_global,
                                   **data_kw)
        else:
            params = train_and_aggregate(params, x_clients, y_clients, keys,
                                         res.selected, data_sizes, **data_kw)

        counts = counts + res.selected.to(counts.dtype)
        with span("round.eval"):
            if cfg.eval_every and (r + 1) % cfg.eval_every == 0:
                # hierarchical: the virtual global model, the edges mixed
                # by their accumulated weight (the global right after a sync)
                model = (fl_server.edge_global_sync(params, edge, edge_w)
                         if hier else params)
                acc = cnn.accuracy(model, x_test, y_test)
            else:
                acc = torch.tensor(float("nan"), device=counts.device)
        out = {"t_round": res.t_round, "test_acc": acc,
               "min_part_rate": counts.min() / (r + 1.0),
               "n_selected": res.selected.sum().to(torch.int32)}
        if hier:
            out["handover_rate"] = handover_rate
        new_state = RoundState(
            world=WorldState(pos=pos, mob_aux=aux),
            clients=ClientState(counts=counts, prev_bs=prev_bs),
            server=ServerState(params=params, edge_params=edge,
                               edge_weight=edge_w),
            key=key)
        return new_state, out

    return init_state, step_fn


class FLSimulation:
    """Owns all state of one FL run; ``run(n_rounds)`` yields RoundRecords."""

    def __init__(self, cfg: FLConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        w = self.wireless = cfg.wireless
        self.aggregation = cfg.aggregation or "single"
        self.tau_global = (
            (cfg.tau_global or DEFAULT_TAU_GLOBAL)
            if self.aggregation == "hierarchical" else 1)
        self.compress = cfg.compress
        self.topk_frac = (float(cfg.topk_frac) if cfg.topk_frac is not None
                          else 1.0)

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
            pos0=mob.user_pos, aux0=aux0, counts0=counts0, key0=k_run,
            aggregation=self.aggregation, tau_global=self.tau_global,
            compress=self.compress, topk_frac=self.topk_frac)

    @property
    def params(self):
        return self._state.server.params

    @property
    def edge_params(self):
        """[M, ...] per-BS edge models (hierarchical runs; else None)."""
        return self._state.server.edge_params

    @property
    def edge_weight(self):
        return self._state.server.edge_weight

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
        hand = stacked.get("handover_rate")
        recs = [RoundRecord(round_idx=first + i,
                            t_round=float(stacked["t_round"][i]),
                            wall_clock=float(wall[i]),
                            n_selected=int(stacked["n_selected"][i]),
                            test_acc=float(stacked["test_acc"][i]),
                            min_part_rate=float(stacked["min_part_rate"][i]),
                            handover_rate=(float(hand[i]) if hand is not None
                                           else float("nan")))
                for i in range(n_rounds)]
        self.wall_clock = float(wall[-1])
        return recs

"""The mobility-aware FL round engine (PyTorch port of ``repro.fl.rounds``:
the ``"engine"`` and ``"sweep"`` worlds, ``compute="full"`` and
``"selected"``).

Per communication round:
  1. users move (the scenario's mobility model; ``rd`` by default),
  2. the BSs observe one round's channels -> SchedulingProblem (with a
     compressed uplink, each user's payload s_k scales the Eq. (1)/(11)
     coefficients; with faults, each user's camped BS, its distance to
     the cell edge and a handover flag give the delivery estimate
     ``p_deliver``),
  3. a scheduler picks users, BSs and bandwidth: the host greedy ``dagsa``
     (the default, numpy draws seeded ``seed * 100003 + r`` as in the JAX
     engine's eager path; kernel ``bandwidth_solve`` for Eq. (12)),
     ``dagsa_jit`` (kernels ``best_bs_argmax``, ``masked_bs_argmax``,
     ``bandwidth_solve`` on the card), their delivery-discounted twins
     ``dagsa-r-host`` / ``dagsa-r``, or a paper baseline (``rs``, ``ub``,
     ``fedcs_low``, ``fedcs_high``, ``sa``: kernel ``best_bs_argmax``,
     and ``bandwidth_solve`` for the optimal splits),
  4. with faults, the round's stragglers, outages, crashes and poisoned
     updates are drawn (:mod:`repro_torch.fl.faults`) and a deadline
     drops late clients; clients run E epochs of local SGD: every client
     with ``compute="full"`` (the mask enters only the aggregation), or
     with ``compute="selected"`` a static-size gather of ``cap`` clients,
     the scheduled ones first (:func:`repro_torch.fl.client.
     topk_selected_indices`), each with its own key, mask entry, data
     size and fault draw, so the reductions below take ``[cap]`` rows,
  5. aggregation, Eq. (2), over the DELIVERED clients (the scheduled
     ones in the perfect world):
     * ``aggregation="single"``: masked FedAvg into the global model
       (kernel ``fedavg_reduce``, with the norm clip of the fault model);
     * ``aggregation="hierarchical"``: each client trains from its camped
       cell's edge model, every BS edge-aggregates the users assigned to
       it (kernel ``fedavg_segment_reduce``), and every ``tau_global``
       rounds the edge models sync into the global model;
     * ``aggregation_async``: the buffered-async engine.  Each round is a
       tick of ``tick_s`` simulated seconds; the scheduled clients with no
       update in flight are dispatched with their Eq. (1) completion
       times into an event queue, and the server folds in whatever lands
       by the tick's end, each update weighted by ``(1 + s)^-alpha`` for
       its staleness of s ticks (kernel ``fedavg_reduce``'s ``weights``);
     with ``compress="topk"|"topk-int8"`` the clients upload top-k (+ int8)
     codes of their deltas (kernel ``sparsify_quantize``) and the server
     aggregates the codes as they are (the int8 variants of the two
     reductions; the async engine decodes them at dispatch),
  6. participation counts advance by delivery and the simulated clock by
     Eq. (3) (deadline-truncated with faults; one tick when async), and
     the global model (on hierarchical runs the edge mixture) is
     evaluated every ``eval_every`` rounds.

The PRNG follows the JAX engine exactly, so both packages simulate the
same world from the same seed: ``split(PRNGKey(seed), 6)`` at set-up,
``fold_in(k_pos, 1)`` for the mobility aux state, ``split(key, 5)`` each
round (``split(key, 6)`` with an active fault model, the sixth key for
the fault draws), ``split(k_fleet, N)`` for the clients and, for
``topk-int8``, the rounding-noise key ``fold_in(k_fleet, N + 1)``.  A
scenario adds ``fold_in(k_bw, 7)`` for the shadowing field and
``fold_in(that, 1)`` for the device spreads; the sweep world's PRNG is
:func:`make_round_step`'s.

:class:`FLSimulation` runs on ``device="cuda"`` unless told otherwise and
raises when CUDA is absent and no device was given; it never falls back
to the CPU on its own.  Records stay on the device until ``run`` ends.

Execution modes, as the JAX package's (``run(n, mode=...)``; all take the
same round step, so they take the same decisions):

* ``fused``: the default for the schedulers of :data:`FUSED_SCHEDULERS`.
  On the card each round replays a CUDA graph that holds the whole
  synchronous round, the greedy's loop included (:mod:`repro_torch.fl.
  fused`): no per-round dispatch of its ops and no host sync inside a
  round.  On the CPU the same step runs without a graph.
* ``step`` and ``eager``: the host loop, one call of the round step a
  round (``eager`` is the host greedies' only mode; JAX's refusals hold
  for both).
* ``async``: the buffered-async tick loop, the only mode of an
  ``aggregation_async`` run.  On the card each tick replays a CUDA graph
  as a fused round does (the tick index read from the device); a
  ``shard=True`` run over several ranks keeps the host loop there, its
  gloo all-gather being a host call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import const, resolve_device, rng
from repro_torch.core import channel, dagsa_jit, latency, mobility
from repro_torch.core import scheduler as sched
from repro_torch.core.scenario import (AGGREGATIONS, BS_LAYOUTS,
                                       COMPRESS_MODES, PARTITIONS,
                                       get_scenario,
                                       resolve_aggregation, resolve_compress,
                                       resolve_partition)
from repro_torch.core.types import (ClientState, MobilityState, RoundState,
                                    ScheduleResult, SchedulingProblem,
                                    ServerState, WirelessConfig, WorldState)
from repro_torch.data.synthetic import make_dataset
from repro_torch.fl import client as fl_client
from repro_torch.fl import faults as fl_faults
from repro_torch.fl import fused as fused_engine
from repro_torch.fl import server as fl_server
from repro_torch.fl.partition import dirichlet_partition, shard_partition
from repro_torch.kernels import compress_topk as ct
from repro_torch.kernels.fedavg_reduce import (fedavg_reduce,
                                               fedavg_segment_reduce)
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models import cnn
from repro_torch.tree import tree_leaves, tree_map

WORLDS = ("engine", "sweep")
COMPUTE_MODES = ("full", "selected")

# The schedulers the buffered-async engine takes: JAX runs it only in its
# traced round step, which the host schedulers cannot enter (the stateful
# policies enter it: their estimates ride RoundState.sched).
ASYNC_SCHEDULERS = tuple(s for s in sched.SCHEDULERS
                         if s not in sched.HOST_SCHEDULERS)

# The schedulers whose round runs fused (JAX's: the ones its round step
# traces, every one but the host greedies; the stateful policies' estimates
# ride RoundState.sched).
FUSED_SCHEDULERS = ("dagsa_jit", "dagsa-r", "rs", "ub", "fedcs_low",
                    "fedcs_high", "sa") + sched.STATEFUL_SCHEDULERS

# run()'s execution modes, as JAX's: "fused" (on the card a captured round
# replayed once a round, :mod:`repro_torch.fl.fused`), "step" and "eager"
# (the host loop, one call of the step a round), "async" (the buffered-
# async tick loop, on the card a captured tick replayed once a tick).
MODES = ("fused", "step", "eager", "async")

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
    faults: Any = None              # fault model: a FaultSpec, a
                                    # FAULT_PRESETS name, or None (the
                                    # perfect world)
    deadline_s: Optional[float] = None  # round deadline T_dl override (s):
                                        # late clients are dropped
    aggregation_async: bool = False  # buffered-async engine: aggregate
                                     # every tick_s simulated seconds from
                                     # the in-flight event queue
    tick_s: Optional[float] = None   # async aggregation period (s);
                                     # REQUIRED when aggregation_async
    staleness_alpha: float = 0.0     # alpha of w(s) = (1+s)^(-alpha);
                                     # 0 disables the discount
    buffer_size: Optional[int] = None   # event-queue capacity (None:
                                        # n_users, which never overflows)
    compress: Optional[str] = None     # uplink compression: topk |
                                       # topk-int8 (None: the scenario's,
                                       # else off)
    topk_frac: Optional[float] = None  # fraction of each leaf's entries a
                                       # client uploads (None: the
                                       # scenario's, else 1.0, dense)
    hetero_bw: bool = False            # Fig. 3: B_k ~ U[0.5, 1.5] MHz
    speed_mps: Optional[float] = None  # override the resolved speed (Fig. 4)
    scenario: Optional[str] = None     # registry name (core.scenario)
    compute: str = "full"              # full: every client trains, the
                                       # mask enters at aggregation;
                                       # selected: a static-size padded
                                       # gather of the scheduled clients
                                       # (client.topk_selected_indices)
    select_cap: Optional[int] = None   # the gather's size for selected;
                                       # None: ceil(rho2 * N), the Eq. (8h)
                                       # floor
    partition: Optional[str] = None    # shard | dirichlet (None: the
                                       # scenario's, else shard)
    dirichlet_alpha: Optional[float] = None   # Dir(alpha) concentration;
                                              # REQUIRED iff dirichlet
    shard: bool = False                # split each round's local SGD over
                                       # the torch.distributed ranks (one
                                       # all-gather a round; every rank
                                       # runs the rest of the round).
                                       # Numerically equal, not bit-equal
    mesh_devices: Optional[int] = None  # ranks that train for shard
                                        # (None: every rank of the world)

    def __post_init__(self):
        sched.check_scheduler(self.scheduler)
        check_compute(self.compute)
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
            # with a scenario, FLSimulation checks the resolved aggregation
            if self.aggregation != "hierarchical" and self.scenario is None:
                raise ValueError(
                    f"tau_global={self.tau_global} only applies to "
                    f"aggregation='hierarchical' (resolved aggregation is "
                    f"{self.aggregation or 'single'!r}); it would silently "
                    f"do nothing")
        if self.mesh_devices is not None and not self.shard:
            raise ValueError("mesh_devices only applies with shard=True; "
                             "it would silently do nothing")
        if self.deadline_s is not None and not self.deadline_s > 0.0:
            raise ValueError("deadline_s must be > 0")
        if (self.faults is not None and not isinstance(self.faults, str)
                and not hasattr(self.faults, "active")):
            raise ValueError(
                "faults must be a repro_torch.fl.faults.FaultSpec, a preset "
                f"name, or None; got {type(self.faults).__name__}")
        if self.aggregation_async:
            if self.tick_s is None:
                raise ValueError(
                    "aggregation_async=True needs tick_s (the simulated "
                    "aggregation period in seconds)")
            if self.aggregation == "hierarchical":
                raise ValueError(
                    "aggregation_async composes with the single-tier "
                    "Eq. (2) only; hierarchical edge aggregation is "
                    "synchronous by construction")
        else:
            for name, val, default in (("tick_s", self.tick_s, None),
                                       ("staleness_alpha",
                                        self.staleness_alpha, 0.0),
                                       ("buffer_size", self.buffer_size,
                                        None)):
                if val != default:
                    raise ValueError(
                        f"{name}={val!r} only applies with "
                        f"aggregation_async=True; it would silently do "
                        f"nothing")
        if self.tick_s is not None and not self.tick_s > 0.0:
            raise ValueError("tick_s must be > 0")
        if self.staleness_alpha < 0.0:
            raise ValueError("staleness_alpha must be >= 0")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        if self.compress is not None and self.compress not in COMPRESS_MODES:
            raise ValueError(f"unknown compress mode {self.compress!r}; "
                             f"choose from {COMPRESS_MODES}")
        if self.topk_frac is not None:
            if not 0.0 < self.topk_frac <= 1.0:
                raise ValueError("topk_frac must be in (0, 1]")
            if self.compress is None and self.scenario is None:
                raise ValueError(
                    f"topk_frac={self.topk_frac} only applies with a "
                    f"compress mode (or a scenario that sets one); it "
                    f"would silently do nothing")
        if self.partition is not None and self.partition not in PARTITIONS:
            raise ValueError(f"unknown partition {self.partition!r}; "
                             f"choose from {PARTITIONS}")
        if self.dirichlet_alpha is not None:
            if not self.dirichlet_alpha > 0.0:
                raise ValueError("dirichlet_alpha must be > 0")
            if self.partition == "shard":
                raise ValueError(
                    f"dirichlet_alpha={self.dirichlet_alpha} only applies "
                    f"with partition='dirichlet'; it would silently do "
                    f"nothing")
        if self.scenario is not None:
            get_scenario(self.scenario)         # raises on an unknown name


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    t_round: float        # simulated round latency (s), Eq. (3)
    wall_clock: float     # cumulative simulated time (s)
    n_selected: int       # async: scheduled users with nothing in flight
    test_acc: float       # nan when not evaluated this round
    min_part_rate: float  # min_i counts_i / n — fairness monitor (Eq. 8g)
    handover_rate: float = float("nan")  # fraction of users whose serving
                                         # BS changed this round
                                         # (hierarchical runs only)
    n_delivered: int = -1     # scheduled clients whose update arrived
                              # (-1 with neither faults nor async)
    delivered_rate: float = float("nan")   # n_delivered / n_selected
                                           # (async: n_delivered / n_users)
    goodput_mbit_s: float = float("nan")   # delivered uplink Mbit per
                                           # simulated second this round
    n_inflight: int = -1      # async: updates still queued at tick end
                              # (-1 on synchronous runs)
    n_dropped: int = -1       # async: updates evicted by a full buffer
                              # this tick (-1 on synchronous runs)


def check_compute(compute: str) -> None:
    """Raise on a compute mode outside :data:`COMPUTE_MODES`."""
    if compute not in COMPUTE_MODES:
        raise ValueError(f"unknown compute mode {compute!r}; "
                         f"choose from {COMPUTE_MODES}")


def _selected_rows(mask: torch.Tensor, compute: str,
                   select_cap: int | None) -> torch.Tensor | None:
    """The ``[cap]`` client rows a ``compute="selected"`` round trains
    (``mask``'s clients first), or None for the whole fleet."""
    check_compute(compute)
    if compute == "full":
        return None
    return fl_client.topk_selected_indices(
        mask, fl_client.resolve_cap(mask.shape[0], select_cap))


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


def _poison(client_params, corrupt, corrupt_mode_id, corrupt_scale):
    if corrupt is None:
        return client_params
    return fl_faults.corrupt_updates(client_params, corrupt, corrupt_mode_id,
                                     corrupt_scale)


def train_and_aggregate(params, x_clients, y_clients, keys, selected,
                        data_sizes, *, epochs: int, batch_size: int,
                        lr: float, compute: str = "full",
                        select_cap: int | None = None, delivered=None,
                        corrupt=None, corrupt_mode_id: int = 0,
                        corrupt_scale: float = 1.0, clip_norm=None,
                        compress: str | None = None, topk_frac: float = 1.0,
                        compress_key=None, mesh=None):
    """The single-tier data plane: local SGD, then masked FedAvg (Eq. 2),
    over compressed deltas when ``compress`` is set.

    ``compute="full"`` trains every client; ``compute="selected"`` trains
    the ``select_cap`` rows of :func:`fl_client.topk_selected_indices`
    (the whole fleet when None), each row with its client's data, key,
    mask entry, data size and fault draw, and aggregates those rows.
    Fault layer: ``delivered`` [N] replaces ``selected`` as the
    aggregation mask, ``corrupt`` [N] poisons those clients' updates after
    SGD and ``clip_norm`` turns on the server's norm clip.  ``mesh``
    splits the local SGD over its ranks (``FLConfig.shard``)."""
    sel = selected if delivered is None else delivered
    with span("round.local_sgd"):
        idx = _selected_rows(selected, compute, select_cap)
        if idx is not None:
            x_clients, y_clients, keys = x_clients[idx], y_clients[idx], \
                keys[idx]
            sel, data_sizes = sel[idx], data_sizes[idx]
            corrupt = None if corrupt is None else corrupt[idx]
        client_params = fl_client.fleet_local_sgd(
            params, x_clients, y_clients, keys, epochs=epochs,
            batch_size=batch_size, lr=lr, mesh=mesh)
    client_params = _poison(client_params, corrupt, corrupt_mode_id,
                            corrupt_scale)
    if compress is None:
        with span("round.fedavg"):
            return fedavg_reduce(params, client_params, sel, data_sizes,
                                 clip_norm=clip_norm)
    with span("round.compress"):
        codes, scales, finite = _compress_updates(
            params, client_params, compress, topk_frac, compress_key)
    with span("round.fedavg"):
        return ct.fedavg_decompress_reduce(params, codes, scales,
                                           sel & finite, data_sizes,
                                           clip_norm=clip_norm)


# ---------------------------------------------------- buffered-async engine --
# The in-flight event queue is a tuple of fixed-shape tensors:
#
#     comp  [B] f32   absolute Eq. (1) completion time; inf = empty slot
#     tick  [B] i32   the tick the update was dispatched on (staleness base)
#     idx   [B] i32   owning client; N is the empty-slot sentinel
#     size  [B] f32   the client's Eq. (2) data weight |D_i|
#     upd   tree      the updates themselves, leaves [B, ...]
#
# ``comp`` stays sorted ascending, so live entries form a prefix and the
# capacity cut is a slice.  A client with an update in flight is busy and
# not dispatched again, so delivery scatters by client index into [N]
# masks and weights and feeds the same masked Eq. (2) reduction as the
# synchronous round, in client order.


def async_queue_init(params, n_users: int, buffer_size: int) -> tuple:
    """An empty event queue shaped for ``params`` updates."""
    dev = tree_leaves(params)[0].device
    upd = tree_map(lambda p: torch.zeros((buffer_size,) + tuple(p.shape),
                                         dtype=p.dtype, device=dev), params)
    return (torch.full((buffer_size,), torch.inf, device=dev),
            torch.zeros((buffer_size,), dtype=torch.int32, device=dev),
            torch.full((buffer_size,), n_users, dtype=torch.int32,
                       device=dev),
            torch.zeros((buffer_size,), device=dev),
            upd)


def async_busy(queue: tuple, n_users: int) -> torch.Tensor:
    """[N] bool: the client has an update in flight (empty slots hold the
    sentinel index and mark nobody)."""
    idx = queue[2]
    return fl_client.scatter_client_tree(
        n_users, idx, torch.ones(idx.shape, dtype=torch.bool,
                                 device=idx.device))


def _tick_index(r, dev) -> torch.Tensor:
    """The tick index as a 0-dim int32 device tensor.  ``r`` is an int or
    the round's device index (a 0-dim float32 tensor, exact for every tick
    below 2^24), which a captured tick reads in place of a host scalar."""
    if isinstance(r, torch.Tensor):
        return r.to(torch.int32)
    return const(int(r), torch.int32, dev)


def async_queue_step(queue: tuple, client_params, dispatch: torch.Tensor,
                     comp_time: torch.Tensor, data_sizes: torch.Tensor, r,
                     tick_end, staleness_alpha, admit_idx=None) -> tuple:
    """Advance the event queue by one tick: admit, deliver, evict.

    The queue's rows come first, then this tick's dispatch rows in client
    order (``dispatch`` [N] bool, ``comp_time`` [N] absolute completion
    times), stamped with tick ``r`` (an int, or the round's 0-dim float32
    device index).  Every live entry completing by ``tick_end`` is
    delivered; the rest are sorted by completion time (stable, so equal
    times keep row order) and cut to capacity (the latest completions are
    evicted).

    ``admit_idx`` [cap] admits ``compute="selected"`` rows:
    ``client_params`` leaves are [cap, ...], row j owned by client
    ``admit_idx[j]``.  Those indices list the dispatched clients in client
    order, so a cap that covers the dispatch set admits the live entries
    in the dense admit's order; undispatched padding rows enter as empty
    slots.

    Returns ``(queue', delivered, wstale, delivered_updates, diag)``:
    ``delivered`` [N] bool, ``wstale`` [N] f32 and ``delivered_updates``
    (leaves [N, ...], zeros off delivery) feed the weighted Eq. (2);
    ``diag`` holds n_delivered / n_inflight / n_dropped / w_delivered.
    """
    comp_q, tick_q, idx_q, size_q, upd_q = queue
    n = dispatch.shape[0]
    b = comp_q.shape[0]
    dev = dispatch.device
    if admit_idx is None:
        rows = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        rows = admit_idx.to(torch.int32)
        dispatch, comp_time = dispatch[admit_idx], comp_time[admit_idx]
        data_sizes = data_sizes[admit_idx]
    r_i32 = _tick_index(r, dev)
    comp = torch.cat([comp_q, torch.where(dispatch, comp_time, torch.inf)])
    tick = torch.cat([tick_q, r_i32.expand(rows.shape[0])])
    idx = torch.cat([idx_q, torch.where(dispatch, rows, n)])
    size = torch.cat([size_q, torch.where(dispatch, data_sizes.float(),
                                          0.0)])
    upd = tree_map(lambda q, c: torch.cat([q, c.to(q.dtype)]), upd_q,
                   client_params)

    deliver = torch.isfinite(comp) & (comp <= tick_end)       # [B+rows]
    wst = fl_server.staleness_weights(r_i32 - tick, staleness_alpha)
    # delivered entries land in their client's row (busy-masking makes
    # those indices unique); the others go to the sentinel and drop
    scat = torch.where(deliver, idx, n)
    delivered = fl_client.scatter_client_tree(n, scat, deliver)
    wstale = fl_client.scatter_client_tree(n, scat, wst)
    delivered_upd = fl_client.scatter_client_tree(n, scat, upd)

    # delivered slots turn empty (inf) and sink past the live prefix
    comp_left = torch.where(deliver, torch.inf, comp)
    order = torch.argsort(comp_left, stable=True)
    keep = order[:b]
    kept_live = torch.isfinite(comp_left[keep])
    new_queue = (comp_left[keep],
                 torch.where(kept_live, tick[keep], 0),
                 torch.where(kept_live, idx[keep], n),
                 torch.where(kept_live, size[keep], 0.0),
                 tree_map(lambda u: u[keep], upd))
    dropped = torch.isfinite(comp_left[order[b:]])
    diag = {
        "n_delivered": deliver.sum().to(torch.int32),
        "n_inflight": kept_live.sum().to(torch.int32),
        "n_dropped": dropped.sum().to(torch.int32),
        "w_delivered": torch.where(deliver, size * wst, 0.0).sum(),
    }
    return new_queue, delivered, wstale, delivered_upd, diag


def aggregate_weighted(params, delivered_updates, delivered: torch.Tensor,
                       data_sizes: torch.Tensor, weights: torch.Tensor, *,
                       clip_norm=None):
    """Staleness-weighted masked Eq. (2) (kernel ``fedavg_reduce`` with
    per-client ``weights``)."""
    return fedavg_reduce(params, delivered_updates, delivered, data_sizes,
                         clip_norm=clip_norm, weights=weights)


def async_round_tick(params, queue: tuple, x_clients, y_clients, keys,
                     dispatch, t_user, data_sizes, r, *, tick_s: float,
                     staleness_alpha, epochs: int, batch_size: int,
                     lr: float, compute: str = "full",
                     select_cap: int | None = None, corrupt=None,
                     corrupt_mode_id: int = 0, corrupt_scale: float = 1.0,
                     clip_norm=None, compress: str | None = None,
                     topk_frac: float = 1.0, compress_key=None,
                     mesh=None) -> tuple:
    """One buffered-async tick of the data plane: local SGD on the fleet
    (``compute="full"``) or on the ``select_cap`` rows of the dispatch
    set (``compute="selected"``: training and the queue admit are [cap]
    rows), each dispatched client's completion time ``now + t_user`` with
    ``now = r * tick_s`` (``r`` the round's 0-dim float32 device index,
    which a captured tick reads in place), one step of the event queue,
    and the staleness-weighted Eq. (2) over what landed by
    ``now + tick_s`` (the deliveries scattered to [N] client rows).

    A compressed uplink's lossy round trip happens at dispatch (the queue
    parks what the server will decode), and a client whose raw update
    went non-finite is not dispatched.  Returns ``(params, queue,
    delivered, diag)``.
    """
    with span("round.local_sgd"):
        admit_idx = _selected_rows(dispatch, compute, select_cap)
        if admit_idx is not None:
            x_clients, y_clients, keys = x_clients[admit_idx], \
                y_clients[admit_idx], keys[admit_idx]
            corrupt = None if corrupt is None else corrupt[admit_idx]
        client_params = fl_client.fleet_local_sgd(
            params, x_clients, y_clients, keys, epochs=epochs,
            batch_size=batch_size, lr=lr, mesh=mesh)
    client_params = _poison(client_params, corrupt, corrupt_mode_id,
                            corrupt_scale)
    if compress is not None:
        with span("round.compress"):
            codes, scales, finite = _compress_updates(
                params, client_params, compress, topk_frac, compress_key)
            client_params = tree_map(lambda g, d: g[None] + d.to(g.dtype),
                                     params, ct.decompress_tree(codes, scales))
        if admit_idx is not None:
            # the [cap] rows' screen back onto the [N] dispatch mask
            finite = fl_client.scatter_client_tree(
                dispatch.shape[0], admit_idx, finite,
                base=torch.ones_like(dispatch))
        dispatch = dispatch & finite
    dev = dispatch.device
    tick = const(tick_s, torch.float32, dev)
    now = r * tick
    with span("round.queue"):
        queue, delivered, wstale, delivered_upd, diag = async_queue_step(
            queue, client_params, dispatch, now + t_user, data_sizes, r,
            now + tick, staleness_alpha, admit_idx=admit_idx)
    with span("round.fedavg"):
        params = aggregate_weighted(params, delivered_upd, delivered,
                                    data_sizes, wstale, clip_norm=clip_norm)
    return params, queue, delivered, diag


def hierarchical_round(global_params, edge_params, edge_weight, prev_bs,
                       x_clients, y_clients, keys, assign, selected, serving,
                       data_sizes, sync: bool, *, epochs: int,
                       batch_size: int, lr: float, compute: str = "full",
                       select_cap: int | None = None, delivered=None,
                       corrupt=None, corrupt_mode_id: int = 0,
                       corrupt_scale: float = 1.0, clip_norm=None,
                       compress: str | None = None, topk_frac: float = 1.0,
                       compress_key=None, mesh=None):
    """One hierarchical data-plane round (arXiv 2108.09103's architecture).

    Each client trains from the edge model of its serving (camped) cell and
    its update edge-aggregates into the BS the scheduler assigned it
    (per-BS Eq. (2)); on a ``sync`` round (every ``tau_global``-th) the edge
    models sync into
    the global model, weighted by the data each aggregated since the last
    sync, and every edge restarts from the new global model.  With faults,
    an undelivered client's upload reaches no BS (``delivered`` masks
    ``assign``), ``corrupt`` poisons updates after SGD and ``clip_norm``
    clips each update against its assigned edge model.
    ``compute="selected"`` trains only the ``select_cap`` rows of
    ``selected`` (:func:`fl_client.topk_selected_indices`): their serving
    cells are gathered first, so only those rows' edge models are pulled
    and the segment reductions take [cap] rows.

    Returns ``(global_params, edge_params, edge_weight, serving,
    handover_rate)``.
    """
    moved = (serving != prev_bs) & (prev_bs >= 0)
    handover_rate = moved.float().mean()
    if delivered is not None:
        assign = assign & delivered[:, None]
    serving_r = serving
    with span("round.local_sgd"):
        idx = _selected_rows(selected, compute, select_cap)
        if idx is not None:
            serving_r = serving[idx]
            x_clients, y_clients, keys = x_clients[idx], y_clients[idx], \
                keys[idx]
            assign, data_sizes = assign[idx], data_sizes[idx]
            corrupt = None if corrupt is None else corrupt[idx]
        init = fl_client.gather_client_tree(edge_params, serving_r)
        client_params = fl_client.fleet_local_sgd_per_client(
            init, x_clients, y_clients, keys, epochs=epochs,
            batch_size=batch_size, lr=lr, mesh=mesh)
    client_params = _poison(client_params, corrupt, corrupt_mode_id,
                            corrupt_scale)
    if compress is None:
        with span("round.fedavg"):
            edge_params = fedavg_segment_reduce(edge_params, client_params,
                                                assign, data_sizes,
                                                clip_norm=clip_norm)
    else:
        # deltas from the serving edge model (what the client trained
        # from), decoded into the assigned BS's aggregation
        with span("round.compress"):
            codes, scales, finite = _compress_updates(
                init, client_params, compress, topk_frac, compress_key)
        assign = assign & finite[:, None]
        with span("round.fedavg"):
            edge_params = ct.fedavg_decompress_segment_reduce(
                edge_params, codes, scales, assign, serving_r, data_sizes,
                clip_norm=clip_norm)
    # as in the JAX engine, without the finite-update screen that the
    # uncompressed segmented reduction applies inside
    _, bs_totals = fl_server.segment_weights(assign, data_sizes)
    edge_weight = edge_weight + bs_totals
    if sync:
        with span("round.sync"):
            global_params = fl_server.edge_global_sync(
                global_params, edge_params, edge_weight)
            edge_params = tree_map(
                lambda g, e: g[None].repeat((e.shape[0],) + (1,) * g.dim()),
                global_params, edge_params)
            edge_weight = torch.zeros_like(edge_weight)
    return global_params, edge_params, edge_weight, serving, handover_rate


def _heterogeneity(k_shadow: torch.Tensor, n: int, compute_spread: float,
                   power_spread_db: float, folded: bool):
    """Per-user device spreads from one fixed draw u ~ U[0, 1) a user
    (``fold_in(k_shadow, 1)``): compute time stretched by
    ``compute_spread**u``, linear SNR scaled by ``10^(-power_spread_db u /
    10)``.  ``(None, None)`` for the homogeneous defaults, which the JAX
    package's sweep applies as exact no-ops.

    The powers are taken in float64 and rounded once, within an ulp of
    XLA's float32 ``pow``.  ``folded``: the spread is a constant, which XLA
    folds into ``u * (-spread / 10)`` (the engine world); a traced spread
    (the sweep) is ``(-spread * u) * 0.1``."""
    if compute_spread == 1.0 and power_spread_db == 0.0:
        return None, None
    u = rng.uniform(rng.fold_in(k_shadow, 1), (n,))
    het_tcomp = torch.pow(float(np.float32(compute_spread)),
                          u.double()).float()
    tenth, spread = np.float32(0.1), np.float32(-power_spread_db)
    db = (u * float(spread * tenth) if folded
          else (u * float(spread)) * float(tenth))
    het_power = torch.pow(10.0, db.double()).float()
    return het_tcomp, het_power


def make_round_step(cfg: FLConfig, w: WirelessConfig, *, scenario: dict,
                    x_clients, y_clients, data_sizes, x_test, y_test, bs_pos,
                    bs_bw, k_shadow, params0, pos0, aux0, counts0, key0,
                    world: str = "engine", min_participants: int | None = None,
                    channel_dtype: str = "f32", aggregation: str = "single",
                    tau_global: int = 1, compress: str | None = None,
                    topk_frac: float = 1.0,
                    faults: fl_faults.FaultSpec = fl_faults.NO_FAULTS,
                    async_on: bool = False, tick_s: float = 1.0,
                    staleness_alpha: float = 0.0, buffer_size: int = 1,
                    user_chunk: int | None = None, compute: str = "full",
                    select_cap: int | None = None, mesh=None):
    """Build the round step: ``(init_state, step_fn, pattern)`` with
    ``step_fn(state, r, r_dev=None) -> (state', out)`` and ``out`` a dict
    of 0-dim device tensors.  ``pattern(r)`` holds every branch the step
    takes on the host from the round index ``r`` (an evaluation round, a
    hierarchical global sync); the step reads its branches there, so a
    captured round (:mod:`repro_torch.fl.fused`) keys its graphs by it.
    The other use of ``r``, a host scheduler's seed, belongs to runs that
    never run captured.  ``r_dev``, the same index as a 0-dim float32
    device tensor, is what the device reads (None: filled from ``r``), the
    async tick's clock and staleness among it: a captured round fills it
    before each replay.

    ``world`` picks how a round draws its world, as in the JAX package:

    * ``"engine"`` (:class:`FLSimulation`): ``split(key, 5)`` a round (6
      with faults), mobility by the model's name, the problem from
      :func:`channel.make_problem`, the scheduler through the registry.
      ``scenario`` holds ``mob_model``, ``pause_s``, ``gm_memory``,
      ``shadow_sigma``, ``compute_spread`` and ``power_spread_db``.
    * ``"sweep"`` (:mod:`repro_torch.launch.sweep`): ``split(key, 6)`` a
      round (7 with faults; separate SNR and tcomp keys), mobility by the
      model's registry id, tcomp from the scenario's range, the channel
      plane stored as ``channel_dtype`` (the int8 plane's Eq. (11)
      coefficients from its dequantised SNR), and the DAGSA greedy called
      on the stored plane.  ``scenario`` is one row of
      ``launch.sweep._scenario_params``; ``user_chunk`` evaluates the
      channel (and, on the CPU, the greedy's selection) in user blocks.

    The shadowing field is drawn from ``k_shadow`` the same every round.
    ``aggregation``, ``tau_global``, ``compress``, ``topk_frac``,
    ``faults``, the async knobs, ``compute`` and ``select_cap`` (None:
    the whole fleet) are the resolved knobs of ``cfg``; an inert
    ``faults`` runs the exact fault-free round.  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.DataMesh`) splits every round's local
    SGD over its ranks; each rank runs the rest of the round itself."""
    if world not in WORLDS:
        raise ValueError(f"unknown world {world!r}; choose from {WORLDS}")
    check_compute(compute)
    n = w.n_users
    dev = counts0.device
    hier = aggregation == "hierarchical"
    faults_on = faults.active
    need_prev = hier or faults_on
    fp = fl_faults.fault_params(faults)
    sweep = world == "sweep"
    minp = (int(math.ceil(w.rho2 * n)) if min_participants is None
            else int(min_participants))
    p = scenario
    # compressed uplink: the per-user payload s_k = ratio * S scales the
    # Eq. (1)/(11) coefficients; None keeps the uniform S exactly
    if compress is not None:
        up_mbit = w.model_mbit * ct.compression_ratio(
            params0, topk_frac, compress == "topk-int8")
        payload0 = torch.full((n,), up_mbit, dtype=torch.float32, device=dev)
    else:
        up_mbit, payload0 = w.model_mbit, None
    het_tcomp, het_power = _heterogeneity(
        k_shadow, n, float(p["compute_spread"]), float(p["power_spread_db"]),
        folded=not sweep)
    # read on the host once, outside any round (the float32 value, exact)
    shadow_sigma = float(p["shadow_sigma"])
    if sweep:
        tc_lo = p["tcomp_min"]
        tc_span = p["tcomp_max"] - p["tcomp_min"]
    init_state = RoundState(
        world=WorldState(pos=pos0, mob_aux=aux0),
        clients=ClientState(
            counts=counts0,
            prev_bs=(torch.full((n,), -1, dtype=torch.int32, device=dev)
                     if need_prev else None)),
        server=ServerState(
            params=params0,
            edge_params=(tree_map(lambda q: q[None].repeat(
                (w.n_bs,) + (1,) * q.dim()), params0) if hier else None),
            edge_weight=(torch.zeros((w.n_bs,), device=dev)
                         if hier else None),
            queue=(async_queue_init(params0, n, buffer_size)
                   if async_on else None)),
        sched=sched.scheduler_state_init(cfg.scheduler, n, device=dev),
        key=key0)

    def engine_world(k_mob, k_prob, pos, aux, counts, r_dev):
        pos, aux = mobility.step_named(p["mob_model"], k_mob, pos, aux, w,
                                       pause_s=p["pause_s"],
                                       gm_memory=p["gm_memory"])
        mstate = MobilityState(user_pos=pos, bs_pos=bs_pos)
        shadow_db = None
        if shadow_sigma > 0.0:
            shadow_db = shadow_sigma * channel.sample_shadowing(
                k_shadow, pos, bs_pos, w, sigma_db=1.0)
        prob = channel.make_problem(k_prob, mstate, w, counts, r_dev,
                                    bs_bw=bs_bw, shadow_db=shadow_db,
                                    tcomp_scale=het_tcomp,
                                    power_scale=het_power,
                                    payload_mbit=payload0)
        dist = mstate.distances() if need_prev else None
        return pos, aux, prob, (prob.snr, None, prob.coeff), dist

    def sweep_world(k_mob, k_snr, k_tc, pos, aux, counts, r_dev):
        pos, aux = mobility.step_switch(
            p["model_id"], k_mob, pos, aux, w.area_m, w.round_duration_s,
            p["speed"], p["pause_s"], p["gm_memory"])
        dist, shadow_db = channel.dist_and_shadow(pos, bs_pos, shadow_sigma,
                                                  k_shadow, w, user_chunk)
        snr_raw = channel.sample_snr(k_snr, dist, w, shadow_db=shadow_db)
        if het_power is not None:
            # the power spread scales the SNR BEFORE encoding, so the
            # compact channel codes carry the heterogeneous link
            snr_raw = snr_raw * het_power[:, None]
        snr_store, snr_scale, snr_lin = channel.encode_channel(
            snr_raw, channel_dtype)
        coeff, loop_coeff = channel.plane_coefficients(
            snr_store, snr_lin, channel_dtype, w, payload_mbit=payload0)
        tcomp = rng.fma(rng.uniform(k_tc, (n,)), tc_span, tc_lo)
        if het_tcomp is not None:
            tcomp = tcomp * het_tcomp
        floor = const(w.rho1, torch.float32, dev) * (r_dev + 1.0)
        prob = SchedulingProblem(snr=snr_lin, tcomp=tcomp, bs_bw=bs_bw,
                                 coeff=coeff if loop_coeff is None
                                 else loop_coeff,
                                 necessary=counts < floor,
                                 min_participants=minp,
                                 payload_mbit=payload0)
        return pos, aux, prob, (snr_store, snr_scale, coeff), dist

    def schedule(prob, plane, p_est, k_sched, r, sched_state):
        """(the round's ScheduleResult, the scheduler state after it)."""
        if not sweep or cfg.scheduler not in ("dagsa_jit", "dagsa-r"):
            if sweep:
                # XLA's jitted sweep feeds these schedulers' Eq. (11)
                # solves the float32 quotient of a bf16 plane, not its
                # bf16 rounding (ROADMAP C.10, C.12)
                prob = dataclasses.replace(prob, coeff=plane[2])
            if cfg.scheduler in sched.STATEFUL_SCHEDULERS:
                return sched.schedule_stateful(cfg.scheduler, prob, w,
                                               k_sched, sched_state)
            return sched.schedule(cfg.scheduler, prob, w, k_sched,
                                  seed=cfg.seed * 100003 + r), sched_state
        # the sweep calls the greedy on the stored plane, so bf16 / int8
        # codes and their scale stream through the selection kernels
        score, scale, solve_coeff = plane
        if faults_on and cfg.scheduler == "dagsa-r":
            # the delivery-discounted score (a per-user factor keeps each
            # user's best BS)
            score = prob.snr * torch.clamp(p_est, 0.0, 1.0)[:, None]
            scale = None
        assign, selected, user_bw, t_k, t_star = dagsa_jit._schedule(
            score, solve_coeff, prob.tcomp, bs_bw, prob.necessary, minp,
            k_sched, selection_block=user_chunk, snr_scale=scale,
            loop_coeff=prob.coeff)
        return ScheduleResult(assign=assign, selected=selected, bw=user_bw,
                              bs_time=t_k, t_round=t_star), sched_state

    def pattern(r: int) -> tuple:
        """(an evaluation round, a hierarchical global sync) for round
        ``r``: the step's host branches."""
        return (bool(cfg.eval_every and (r + 1) % cfg.eval_every == 0),
                hier and (r + 1) % tau_global == 0)

    def step_fn(state: RoundState, r: int, r_dev=None):
        # the host branches on r come from pattern(r); the device reads
        # r_dev, which a captured round fills before each replay
        evaluate, sync = pattern(r)
        if r_dev is None:
            r_dev = const(float(r), torch.float32, dev)
        params, queue = state.server.params, state.server.queue
        edge, edge_w = state.server.edge_params, state.server.edge_weight
        counts, prev_bs = state.clients.counts, state.clients.prev_bs
        # one more key for the fault draws when faults are on
        n_keys = (6 if sweep else 5) + (1 if faults_on else 0)
        keys_r = rng.split(state.key, n_keys).unbind(0)
        key, k_mob = keys_r[0], keys_r[1]
        k_fault = keys_r[-1] if faults_on else None
        with span("round.world"):
            if sweep:
                k_snr, k_tc, k_sched, k_fleet = keys_r[2:6]
                pos, aux, prob, plane, dist = sweep_world(
                    k_mob, k_snr, k_tc, state.world.pos,
                    state.world.mob_aux, counts, r_dev)
            else:
                k_prob, k_sched, k_fleet = keys_r[2:5]
                pos, aux, prob, plane, dist = engine_world(
                    k_mob, k_prob, state.world.pos, state.world.mob_aux,
                    counts, r_dev)
            if need_prev:
                serving = camped_bs(dist)
            p_est = None
            if faults_on:
                edge_frac = fl_faults.edge_proximity(dist, serving, w)
                handover = (serving != prev_bs) & (prev_bs >= 0)
                # the pre-scheduling delivery estimate dagsa-r discounts by
                p_est = fl_faults.delivery_probability(fp, edge_frac,
                                                       handover)
                if not sweep:
                    prob = dataclasses.replace(prob, p_deliver=p_est)
        with span("round.schedule"):
            res, sched_state = schedule(prob, plane, p_est, k_sched, r,
                                        state.sched)
        # faults: stragglers stretch tcomp, outages and crashes kill
        # uplinks, the deadline drops late survivors
        corrupt = None
        if faults_on:
            tcomp_eff, alive, corrupt = fl_faults.sample_round_faults(
                k_fault, fp, edge_frac, handover, prob.tcomp)
            t_user = latency.per_user_latency(prob, res, tcomp=tcomp_eff)
            gate = alive & latency.on_time(t_user, fp["deadline_s"])
        elif async_on:
            t_user = latency.per_user_latency(prob, res)
            gate = torch.ones_like(res.selected)
        keys = rng.split(k_fleet, n)
        ck = (rng.fold_in(k_fleet, n + 1) if compress == "topk-int8"
              else None)
        data_kw = dict(epochs=cfg.local_epochs, batch_size=cfg.batch_size,
                       lr=cfg.lr, compute=compute, select_cap=select_cap,
                       corrupt=corrupt,
                       corrupt_mode_id=fp["corrupt_mode_id"],
                       corrupt_scale=fp["corrupt_scale"],
                       clip_norm=faults.clip_norm, compress=compress,
                       topk_frac=topk_frac, compress_key=ck, mesh=mesh)
        if async_on:
            # a dead or late uplink never enters the queue
            eligible = res.selected & ~async_busy(queue, n)
            params, queue, delivered, diag = async_round_tick(
                params, queue, x_clients, y_clients, keys, eligible & gate,
                t_user, data_sizes, r_dev, tick_s=tick_s,
                staleness_alpha=staleness_alpha, **data_kw)
            t_round = torch.full((), tick_s, dtype=torch.float32, device=dev)
        else:
            if faults_on:
                delivered = res.selected & gate
                t_round = latency.deadline_round_latency(
                    t_user, res.selected, fp["deadline_s"])
            else:
                delivered, t_round = res.selected, res.t_round
            deliv_kw = dict(delivered=delivered if faults_on else None)
            if hier:
                params, edge, edge_w, prev_bs, handover_rate = \
                    hierarchical_round(params, edge, edge_w, prev_bs,
                                       x_clients, y_clients, keys,
                                       res.assign, res.selected, serving,
                                       data_sizes, sync, **deliv_kw,
                                       **data_kw)
            else:
                params = train_and_aggregate(params, x_clients, y_clients,
                                             keys, res.selected, data_sizes,
                                             **deliv_kw, **data_kw)

        # participation follows delivery: a lost update stays "necessary"
        counts = counts + delivered.to(counts.dtype)
        with span("round.eval"):
            if evaluate:
                # hierarchical: the virtual global model, the edges mixed
                # by their accumulated weight (the global right after a sync)
                model = (fl_server.edge_global_sync(params, edge, edge_w)
                         if hier else params)
                acc = cnn.accuracy(model, x_test, y_test)
            else:
                acc = torch.full((), float("nan"), device=counts.device)
        n_sel = eligible.sum() if async_on else res.selected.sum()
        out = {"t_round": t_round, "test_acc": acc,
               "min_part_rate": counts.min() / (r_dev + 1.0),
               "n_selected": n_sel.to(torch.int32)}
        if async_on:
            n_del = diag["n_delivered"]
            out["n_delivered"] = n_del
            # deliveries lag dispatches, so normalise by the fleet
            out["delivered_rate"] = n_del.float() / n
            out["goodput_mbit_s"] = n_del.float() * up_mbit / tick_s
            out["n_inflight"] = diag["n_inflight"]
            out["n_dropped"] = diag["n_dropped"]
        elif faults_on:
            n_del = delivered.sum().to(torch.int32)
            out["n_delivered"] = n_del
            out["delivered_rate"] = (n_del.float()
                                     / torch.clamp(n_sel, min=1).float())
            out["goodput_mbit_s"] = (n_del.float() * up_mbit
                                     / torch.clamp(t_round, min=1e-9))
        if hier:
            out["handover_rate"] = handover_rate
        elif need_prev:
            prev_bs = serving
        new_state = RoundState(
            world=WorldState(pos=pos, mob_aux=aux),
            clients=ClientState(counts=counts, prev_bs=prev_bs),
            server=ServerState(params=params, edge_params=edge,
                               edge_weight=edge_w, queue=queue),
            sched=sched_state, key=key)
        return new_state, out

    return init_state, step_fn, pattern


class FLSimulation:
    """Owns all state of one FL run; ``run(n_rounds, mode=None)`` yields
    RoundRecords."""

    def __init__(self, cfg: FLConfig, device=None):
        self.cfg = cfg
        # the world: explicit fields beat the scenario, which beats the
        # base WirelessConfig
        spec = get_scenario(cfg.scenario) if cfg.scenario else None
        w = spec.wireless(cfg.wireless) if spec else cfg.wireless
        # shard: every rank runs the run from the same seed and trains its
        # block of the clients
        self.mesh = None
        if cfg.shard:
            self.mesh = make_data_mesh(cfg.mesh_devices, device=device)
            if w.n_users % self.mesh.size:
                raise ValueError(
                    f"shard=True needs n_users ({w.n_users}) divisible by "
                    f"the mesh size ({self.mesh.size}); pass "
                    f"mesh_devices=D for a divisor D")
        self.device = dev = (self.mesh.device if self.mesh is not None
                             else resolve_device(device))
        if cfg.speed_mps is not None:
            if spec and spec.mobility == "static" and cfg.speed_mps > 0.0:
                raise ValueError(
                    f"scenario {spec.name!r} uses the 'static' mobility "
                    f"model, which ignores speed; speed_mps="
                    f"{cfg.speed_mps} would silently do nothing — pick a "
                    f"mobile scenario or drop the speed override")
            w = dataclasses.replace(w, speed_mps=cfg.speed_mps)
        self.scenario = spec
        self.wireless = w
        # aggregation and uplink compression (explicit config beats the
        # scenario)
        agg, tau = resolve_aggregation(spec, cfg.aggregation, cfg.tau_global,
                                       strict=True)
        self.aggregation, self.tau_global = agg, tau
        comp, frac = resolve_compress(spec, cfg.compress, cfg.topk_frac)
        self.compress, self.topk_frac = comp, frac
        # per-user device heterogeneity (scenario-only knobs); like the
        # JAX package, only a tensor-step scheduler takes it
        compute_spread = spec.compute_spread if spec else 1.0
        power_spread_db = spec.power_spread_db if spec else 0.0
        self._hetero = compute_spread != 1.0 or power_spread_db != 0.0
        if self._hetero and cfg.scheduler in sched.HOST_SCHEDULERS:
            raise ValueError(
                f"device heterogeneity lives in the JAX package's traced "
                f"round step; scheduler {cfg.scheduler!r} is host-side — "
                f"pick one of {ASYNC_SCHEDULERS}")
        # the buffered-async engine (the config guards its knobs)
        self.aggregation_async = cfg.aggregation_async
        if self.aggregation_async and agg == "hierarchical":
            raise ValueError(
                "aggregation_async composes with the single-tier Eq. (2) "
                "only; the resolved aggregation is 'hierarchical'")
        if self.aggregation_async and cfg.scheduler in sched.HOST_SCHEDULERS:
            raise ValueError(
                f"aggregation_async runs only in the JAX package's traced "
                f"round step; scheduler {cfg.scheduler!r} is host-side — "
                f"pick one of {ASYNC_SCHEDULERS}")
        buffer_size = (int(cfg.buffer_size) if cfg.buffer_size is not None
                       else w.n_users)
        # the fault model: a preset name, a spec, the scenario's, or the
        # perfect world; deadline_s overrides the spec's deadline
        fs = cfg.faults
        if isinstance(fs, str):
            fs = fl_faults.get_faults(fs)
        if fs is None:
            fs = (spec.faults if spec is not None and spec.faults is not None
                  else fl_faults.NO_FAULTS)
        if cfg.deadline_s is not None:
            fs = dataclasses.replace(fs, deadline_s=cfg.deadline_s)
        self.faults: fl_faults.FaultSpec = fs

        key = rng.PRNGKey(cfg.seed, device=dev)
        k_data, k_part, k_pos, k_model, k_bw, k_run = rng.split(key, 6).unbind(0)
        self.data = make_dataset(cfg.dataset, seed=cfg.seed,
                                 n_train=cfg.n_train, n_test=cfg.n_test,
                                 device=dev)
        # non-IID partition (explicit config beats the scenario)
        part, alpha = resolve_partition(spec, cfg.partition,
                                        cfg.dirichlet_alpha, strict=True)
        y = self.data.y_train
        if part == "dirichlet":
            idx = dirichlet_partition(k_part, y, w.n_users,
                                      int(y.shape[0]) // w.n_users, alpha,
                                      n_classes=int(y.max()) + 1)
        else:
            idx = shard_partition(k_part, y, w.n_users, cfg.shards_per_user)
        self.partition = part
        self.x_clients = self.data.x_train[idx]      # [N, n_i, H, W, C]
        self.y_clients = self.data.y_train[idx]      # [N, n_i]
        self.data_sizes = torch.full((w.n_users,), idx.shape[1],
                                     dtype=torch.int32, device=dev)

        h, wd, c = self.data.x_train.shape[1:]
        self.cnn_cfg = cfg.cnn or cnn.CNNConfig(height=h, width=wd, channels=c)
        params0 = cnn.init(k_model, self.cnn_cfg)

        layout = spec.bs_layout if spec else cfg.bs_layout
        if layout == "uniform":
            mob = mobility.init_positions(k_pos, w)
        else:
            mob = mobility.init_positions_grid_bs(k_pos, w)
        self.bs_pos = mob.bs_pos
        aux0 = mobility.init_aux(rng.fold_in(k_pos, 1), w.n_users, w)
        if cfg.hetero_bw:
            bs_bw = rng.uniform(k_bw, (w.n_bs,), 0.5, 1.5)
        elif spec is not None:
            bs_bw = spec.sample_bs_bw(k_bw, w)
        else:
            bs_bw = torch.full((w.n_bs,), w.bs_bandwidth_mhz, device=dev)
        self.bs_bw = bs_bw
        counts0 = torch.zeros((w.n_users,), device=dev)
        world = {"mob_model": spec.mobility if spec else "rd",
                 "pause_s": spec.pause_s if spec else 0.0,
                 "gm_memory": spec.gm_memory if spec else 0.75,
                 "shadow_sigma": (spec.shadow_sigma_db
                                  if spec and spec.shadowing else 0.0),
                 "compute_spread": compute_spread,
                 "power_spread_db": power_spread_db}

        # the selected gather's size defaults to the Eq. (8h) floor.  The
        # JAX package runs the host schedulers in its eager round, which
        # trains the whole fleet whatever the compute mode: so does the
        # port, to schedule and train as the reference does
        self.compute = (cfg.compute if cfg.scheduler not in
                        sched.HOST_SCHEDULERS else "full")
        self.select_cap = (int(cfg.select_cap) if cfg.select_cap is not None
                           else int(math.ceil(w.rho2 * w.n_users)))

        self.wall_clock = 0.0
        self.round_idx = 0
        self.fused = None       # the fused engine (the card), made on first use
        self.greedy_steps: list[int] = []   # the last fused run's, a round
        self._state, self._step_fn, self._pattern = make_round_step(
            cfg, w, scenario=world, x_clients=self.x_clients,
            y_clients=self.y_clients, data_sizes=self.data_sizes,
            x_test=self.data.x_test, y_test=self.data.y_test,
            bs_pos=self.bs_pos, bs_bw=bs_bw,
            k_shadow=rng.fold_in(k_bw, 7), params0=params0,
            pos0=mob.user_pos, aux0=aux0, counts0=counts0, key0=k_run,
            aggregation=agg, tau_global=tau, compress=comp,
            topk_frac=frac, faults=self.faults,
            async_on=self.aggregation_async,
            tick_s=float(cfg.tick_s) if cfg.tick_s is not None else 1.0,
            staleness_alpha=float(cfg.staleness_alpha),
            buffer_size=buffer_size, compute=self.compute,
            select_cap=self.select_cap, mesh=self.mesh)

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

    @property
    def fused_capable(self) -> bool:
        return self.cfg.scheduler in FUSED_SCHEDULERS

    def _resolve_mode(self, mode: str | None) -> str:
        """``mode`` or its default, refused as the JAX package refuses it
        (``repro.fl.rounds.FLSimulation.run``)."""
        if mode is not None and mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
        sharded = self.mesh is not None and self.mesh.world_size > 1
        if mode is None:
            # a sharded round's all-gather runs on the host (gloo), which a
            # captured graph cannot hold: its default is the host loop
            mode = ("async" if self.aggregation_async
                    else "step" if self.fused_capable and sharded
                    and self.device.type == "cuda"
                    else "fused" if self.fused_capable else "eager")
        if mode == "async" and not self.aggregation_async:
            raise ValueError(
                "mode='async' needs FLConfig(aggregation_async=True, "
                "tick_s=...) — the event-queue carry is sized at init")
        if self.aggregation_async and mode != "async":
            raise ValueError(
                f"aggregation_async=True runs mode='async' only (the event "
                f"queue rides the scan carry); got mode={mode!r}")
        if mode in ("fused", "step") and not self.fused_capable:
            raise ValueError(
                f"scheduler {self.cfg.scheduler!r} does not trace; "
                f"mode={mode!r} needs one of {FUSED_SCHEDULERS} "
                f"(use mode='eager')")
        if mode == "eager" and self.aggregation == "hierarchical":
            raise ValueError(
                "aggregation='hierarchical' lives in the traced round step; "
                "use mode='fused' or mode='step'")
        if mode == "eager" and (self.compress is not None or self._hetero):
            raise ValueError(
                "compressed uplink / device heterogeneity live in the "
                "traced round step; use mode='fused' or mode='step'")
        if mode == "eager" and self.cfg.scheduler in \
                sched.STATEFUL_SCHEDULERS:
            raise ValueError(
                f"stateful scheduler {self.cfg.scheduler!r} carries per-user "
                f"estimates in the fused RoundState; mode='eager' would "
                f"restart them every round — use mode='fused' or 'step'")
        if mode == "fused" and sharded and self.device.type == "cuda":
            raise ValueError(
                "shard=True over several ranks all-gathers each round's "
                "clients through gloo on the host, which a CUDA graph "
                "cannot hold; use mode='step'")
        return mode

    def run(self, n_rounds: int, mode: str | None = None
            ) -> list[RoundRecord]:
        """Run ``n_rounds``; the records cross to the host once, at the end.

        ``mode``, as the JAX package takes it: ``"fused"`` (the default
        when the scheduler is in :data:`FUSED_SCHEDULERS`: on the card a
        round captured as CUDA graphs and replayed, no host sync inside a
        round; on the CPU the same step without a graph), ``"step"`` and
        ``"eager"`` (the host loop, one call of the round step a round;
        ``"eager"`` is the only mode of the host greedies), or ``"async"``
        (the buffered-async tick loop, the default and only mode when
        ``aggregation_async``: on the card a tick captured as CUDA graphs
        and replayed, as ``"fused"`` runs a round; on the CPU, and on a
        ``shard=True`` run over several ranks, whose gloo all-gather a
        graph cannot hold, the host loop of the tick step).  The modes
        take the same steps, so their decisions agree exactly."""
        mode = self._resolve_mode(mode)
        if n_rounds <= 0:
            return []
        sharded = self.mesh is not None and self.mesh.world_size > 1
        if self.device.type != "cuda" or mode in ("step", "eager") or (
                mode == "async" and sharded):
            # the host loop: a fused run or async tick on the CPU is the
            # same step, and a sharded tick's gloo all-gather cannot sit in
            # a graph
            return self._run_host(n_rounds)
        if self.fused is None:
            self.fused = fused_engine.FusedRounds(self._step_fn,
                                                  self._pattern, self.device)
        self._state, stacked = self.fused.run(self._state, self.round_idx,
                                              n_rounds)
        self.greedy_steps = list(stacked.pop("greedy_steps", []))
        return self._records(stacked, n_rounds)

    def _run_host(self, n_rounds: int) -> list[RoundRecord]:
        """``n_rounds`` rounds in the host loop, one call of the round step
        a round, whatever the device (the ``step`` and ``eager`` modes;
        the card's checks hold a captured run to it)."""
        outs = []
        for r in range(self.round_idx, self.round_idx + n_rounds):
            self._state, out = self._step_fn(self._state, r)
            outs.append(out)
        stacked = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
                   for k in outs[0]}                     # the one host copy
        return self._records(stacked, n_rounds)

    def run_round(self) -> RoundRecord:
        """One round as a host :class:`RoundRecord` (JAX's per-round API:
        the step, or the host path of a host greedy, or one async tick)."""
        if self.aggregation_async:
            return self.run(1, mode="async")[0]
        return self.run(1, mode="step" if self.fused_capable
                        else "eager")[0]

    def _records(self, stacked: dict, n_rounds: int) -> list[RoundRecord]:
        """The host columns of ``n_rounds`` rounds -> RoundRecords; the
        round index and the simulated clock advance."""
        first = self.round_idx + 1
        self.round_idx += n_rounds
        wall = self.wall_clock + np.cumsum(stacked["t_round"],
                                           dtype=np.float64)

        def col(name, i, cast, missing):
            v = stacked.get(name)
            return cast(v[i]) if v is not None else missing

        nan = float("nan")
        recs = [RoundRecord(round_idx=first + i,
                            t_round=float(stacked["t_round"][i]),
                            wall_clock=float(wall[i]),
                            n_selected=int(stacked["n_selected"][i]),
                            test_acc=float(stacked["test_acc"][i]),
                            min_part_rate=float(stacked["min_part_rate"][i]),
                            handover_rate=col("handover_rate", i, float, nan),
                            n_delivered=col("n_delivered", i, int, -1),
                            delivered_rate=col("delivered_rate", i, float,
                                               nan),
                            goodput_mbit_s=col("goodput_mbit_s", i, float,
                                               nan),
                            n_inflight=col("n_inflight", i, int, -1),
                            n_dropped=col("n_dropped", i, int, -1))
                for i in range(n_rounds)]
        self.wall_clock = float(wall[-1])
        return recs


def accuracy_at_budget(records: list[RoundRecord],
                       budget_s: float) -> float:
    """Best test accuracy reached within a simulated time budget (the
    paper's comparison metric: accuracy under the same time budget)."""
    accs = [r.test_acc for r in records
            if r.wall_clock <= budget_s and r.test_acc == r.test_acc]
    return max(accs) if accs else float("nan")

"""Multi-scenario, multi-seed wireless and learning sweeps (PyTorch port of
``repro.launch.sweep``).

A wireless cell runs (mobility step -> channel sample -> DAGSA-X
schedule) for ``n_rounds`` rounds; a learning cell adds the full FL data
plane through :func:`repro_torch.fl.rounds.make_round_step`'s ``"sweep"``
world (local SGD, Eq. (2) aggregation single-tier or hierarchical,
faults, the buffered-async engine, compressed uplinks, periodic eval):
the paper's accuracy against simulated wall clock (Figs. 2-4).  Each
scenario's knobs are lowered to parameter rows (``_scenario_params``),
and every (scenario, seed) cell draws its world from the JAX package's
keys, so both packages simulate the same worlds.  The JAX package vmaps
the cells of a shape bucket into one compiled call.  The port advances a
bucket's cells in lockstep as one functional step (a wireless bucket:
each cell draws its world in cell order, mobility dispatched on the host
by model id, then one batched greedy, ``dagsa_jit._schedule_batch``,
schedules the whole bucket; a learning bucket: each cell's round step in
cell order), its outputs stacked to [G].  On the card that step runs as
one captured CUDA graph a host-decided pattern (a learning bucket's
evaluation round or hierarchical global sync; a wireless bucket has one),
replayed once a round and released at the bucket's end, the greedy's
loop a WHILE node (:mod:`repro_torch.fl.fused`); on the CPU the same step
runs in a host loop (``_run_bucket_host``, also the card's uncaptured
route).

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --scenarios paper-default,high-mobility --seeds 2 --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.sweep --learning \\
        --scenarios paper-default,static --seeds 2 --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --scenarios paper-default --channel-dtype int8 --device cpu

Runs on CUDA by default (``--device cpu`` to run on the CPU).  The
records are the JAX package's (its module docstring has the schema);
seeds are paired across scenarios: ``split(key, n_seeds)`` is shared.
``--user-chunk`` / ``user_chunk=`` evaluates the channel in user blocks
(the shadowing field's [N, M, 64] features at most [chunk, M, 64]) and,
on the CPU, streams the greedy's selection through the chunked twins;
on CUDA the selection kernels stream the plane already, so there it
bounds the channel intermediates only.  Same records either way.
``--compute selected --select-cap K`` trains only a static-size gather
of each learning round's scheduled clients (the whole fleet when K is
unset).  ``--shard [--mesh D]`` splits every bucket's cells over the
``torch.distributed`` ranks (:mod:`repro_torch.launch.shard_sweep`); the
records are the same bytes, and rank 0 alone prints or writes them:

    torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --shard \\
        --device cpu --scenarios paper-default,high-mobility --seeds 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch import const, resolve_device, rng
from repro_torch.core import channel, dagsa_jit, mobility
from repro_torch.core.scenario import (BS_LAYOUTS, COMPRESS_MODES, PARTITIONS,
                                       SCENARIOS, ScenarioSpec, get_scenario,
                                       resolve_aggregation, resolve_compress,
                                       resolve_partition)
from repro_torch.core.types import WirelessConfig
# registers the faulty-* scenarios
from repro_torch.fl import faults as fl_faults
from repro_torch.fl import fused as fused_engine
from repro_torch.fl.rounds import COMPUTE_MODES, check_compute, span

# The JAX package's sweep schedulers.
SWEEP_SCHEDULERS = ("dagsa_jit", "dagsa-r", "rs", "ucb", "biased-adaptive",
                    "rr", "pf")


# -------------------------------------------------------------- lowering ---
def _scenario_params(specs: Sequence[ScenarioSpec], cfg: WirelessConfig,
                     device="cpu") -> dict:
    """Lower specs to per-scenario parameter tensors [S] (float32 knobs,
    int32 ids), as the JAX package lowers them; the fault knobs under
    ``f_*`` (``NO_FAULTS`` for a scenario without faults)."""
    def arr(fn, dtype=torch.float32):
        return torch.tensor([fn(s) for s in specs], dtype=dtype,
                            device=device)

    def fp(s):
        return fl_faults.fault_params(
            s.faults if s.faults is not None else fl_faults.NO_FAULTS)

    return {
        "model_id": arr(lambda s: mobility.model_index(s.mobility),
                        torch.int32),
        "layout_id": arr(lambda s: BS_LAYOUTS.index(s.bs_layout),
                         torch.int32),
        "speed": arr(lambda s: s.speed_mps),
        "pause_s": arr(lambda s: s.pause_s),
        "gm_memory": arr(lambda s: s.gm_memory),
        "bw_min": arr(lambda s: s.bw_min_mhz if s.bw_min_mhz is not None
                      else cfg.bs_bandwidth_mhz),
        "bw_max": arr(lambda s: s.bw_max_mhz if s.bw_max_mhz is not None
                      else cfg.bs_bandwidth_mhz),
        "shadow_sigma": arr(lambda s: s.shadow_sigma_db if s.shadowing
                            else 0.0),
        "tcomp_min": arr(lambda s: s.tcomp_min_s if s.tcomp_min_s is not None
                         else cfg.tcomp_min_s),
        "tcomp_max": arr(lambda s: s.tcomp_max_s if s.tcomp_max_s is not None
                         else cfg.tcomp_max_s),
        "compute_spread": arr(lambda s: s.compute_spread),
        "power_spread_db": arr(lambda s: s.power_spread_db),
        **{f"f_{k}": arr(lambda s, k=k: fp(s)[k])
           for k in fl_faults.FAULT_PARAM_KEYS},
    }


def _row(params: dict, i: int) -> dict:
    """Scenario ``i``'s knobs: 0-dim float32 tensors, the ids as ints."""
    return {k: (int(v[i]) if v.dtype == torch.int32 else v[i])
            for k, v in params.items()}


def _bs_positions(key: torch.Tensor, layout_id: int,
                  cfg: WirelessConfig) -> torch.Tensor:
    """[M, 2] BS positions: both layouts are drawn, as the JAX sweep
    draws them, and ``layout_id`` picks one."""
    kg, ku = rng.split(key).unbind(0)
    grid = mobility.grid_bs_positions(kg, cfg.n_bs, cfg.area_m)
    uniform = rng.uniform(ku, (cfg.n_bs, 2), 0.0, cfg.area_m)
    return grid if layout_id == BS_LAYOUTS.index("grid") else uniform


def _check_user_chunk(user_chunk: int | None) -> None:
    if user_chunk is not None and user_chunk < 1:
        raise ValueError(f"user_chunk must be >= 1, got {user_chunk}")


def _cell_world(p: dict, key: torch.Tensor, cfg: WirelessConfig):
    """A cell's initial world from its key: ``(k_shadow, k_run, pos0,
    bs_pos, bs_bw, aux0)``, the JAX sweep's ``split(key, 6)`` layout."""
    k_pos, k_bs, k_bw, k_aux, k_shadow, k_run = rng.split(key, 6).unbind(0)
    pos0 = rng.uniform(k_pos, (cfg.n_users, 2), 0.0, cfg.area_m)
    bs_pos = _bs_positions(k_bs, p["layout_id"], cfg)
    # bw_min + u (bw_max - bw_min): one multiply-add under XLA
    bs_bw = rng.fma(rng.uniform(k_bw, (cfg.n_bs,)), p["bw_max"] - p["bw_min"],
                    p["bw_min"])
    aux0 = mobility.init_aux(k_aux, cfg.n_users, cfg, speed_mps=p["speed"])
    return k_shadow, k_run, pos0, bs_pos, bs_bw, aux0


def _wireless_cell(p: dict, key: torch.Tensor, cfg: WirelessConfig,
                   channel_dtype: str, user_chunk: int | None) -> tuple:
    """One (scenario, seed) wireless cell, drawn from its key as the JAX
    sweep's ``_one_cell`` draws it: ``(state, bs_bw, draw)``, the state
    ``(key, pos, aux)`` and ``draw(state) -> (state', (k_sched, snr_store,
    snr_scale, coeff, loop_coeff, tcomp))`` the round's world: the channel
    plane stored as ``channel_dtype``, its Eq. (11) coefficients
    :func:`channel.plane_coefficients`'.  What stays fixed (``bs_pos``,
    ``k_shadow``, the scenario row) is the closure's; ``shadow_sigma`` is
    read on the host once, here."""
    k_shadow, k_run, pos0, bs_pos, bs_bw, aux0 = _cell_world(p, key, cfg)
    shadow_sigma = float(p["shadow_sigma"])     # the float32 value, exact

    def draw(state: tuple) -> tuple:
        key, pos, aux = state
        key, k_mob, k_snr, k_tc, k_sched = rng.split(key, 5).unbind(0)
        pos, aux = mobility.step_switch(
            p["model_id"], k_mob, pos, aux, cfg.area_m,
            cfg.round_duration_s, p["speed"], p["pause_s"], p["gm_memory"])
        dist, shadow_db = channel.dist_and_shadow(
            pos, bs_pos, shadow_sigma, k_shadow, cfg, user_chunk)
        snr_store, snr_scale, snr_lin = channel.encode_channel(
            channel.sample_snr(k_snr, dist, cfg, shadow_db=shadow_db),
            channel_dtype)
        coeff, loop_coeff = channel.plane_coefficients(
            snr_store, snr_lin, channel_dtype, cfg)
        tcomp = rng.fma(rng.uniform(k_tc, (cfg.n_users,)),
                        p["tcomp_max"] - p["tcomp_min"], p["tcomp_min"])
        return (key, pos, aux), (k_sched, snr_store, snr_scale, coeff,
                                 loop_coeff, tcomp)
    return (k_run, pos0, aux0), bs_bw, draw


def _stack_or_none(xs: list) -> torch.Tensor | None:
    return None if xs[0] is None else torch.stack(xs)


def _wireless_bucket_step(cells: list[tuple[dict, torch.Tensor]],
                          cfg: WirelessConfig, min_participants: int,
                          channel_dtype: str = "f32",
                          user_chunk: int | None = None) -> tuple:
    """The G (scenario row, seed key) cells of a bucket as one step, of
    :func:`_bucket_step`'s form: ``(states, step_fn, pattern)``.  The state
    is each cell's ``(key, pos, aux)`` and the bucket's participation
    counts [G, N]; each cell's ``bs_pos``, ``k_shadow`` and row and the
    stacked ``bs_bw`` [G, M] stay fixed.  ``step_fn(states, r, r_dev)``
    draws the G worlds in cell order, then one batched greedy schedules
    all G cells; it reads the round only from ``r_dev`` (None: made from
    ``r``), so one graph serves every round (the pattern is constant).
    Outputs ``t_round``, ``n_selected`` and ``min_part_rate``, [G] float32
    each.  A cell's results do not depend on which cells share its
    batch."""
    dev = cells[0][1].device
    worlds = [_wireless_cell(p, k, cfg, channel_dtype, user_chunk)
              for p, k in cells]
    draws = [draw for _, _, draw in worlds]
    bs_bw = torch.stack([bw for _, bw, _ in worlds])
    states = (tuple(state for state, _, _ in worlds),
              torch.zeros((len(cells), cfg.n_users), device=dev))

    def step_fn(states: tuple, r: int, r_dev=None):
        if r_dev is None:
            r_dev = const(float(r), torch.float32, dev)
        cell_states, counts = states
        with span("round.world"):
            new, planes = zip(*(draw(state) for draw, state
                                in zip(draws, cell_states)))
            keys, snr, scale, coeff, loop_coeff, tcomp = (
                _stack_or_none(list(x)) for x in zip(*planes))
            # Eq. (8g), the post-round requirement, as make_problem's
            necessary = counts < (const(cfg.rho1, torch.float32, dev)
                                  * (r_dev + 1.0))
        with span("round.schedule"):
            _, selected, _, _, t_round = dagsa_jit._schedule_batch(
                snr, coeff, tcomp, bs_bw, necessary, min_participants, keys,
                selection_block=user_chunk, snr_scale=scale,
                loop_coeff=loop_coeff)
        counts = counts + selected.to(counts.dtype)
        return (tuple(new), counts), {
            "t_round": t_round,
            "n_selected": selected.sum(dim=-1).float(),
            "min_part_rate": counts.amin(dim=-1) / (r_dev + 1.0)}
    return states, step_fn, lambda r: ()


# ------------------------------------------------------------------- API ---
def _wireless_buckets(specs: Sequence[ScenarioSpec], base: WirelessConfig
                      ) -> dict[tuple[int, int],
                                list[tuple[int, ScenarioSpec]]]:
    """(position, spec) pairs grouped by resolved shape (n_users, n_bs):
    the scenarios of a bucket share their base config and seed keys."""
    buckets: dict[tuple[int, int], list[tuple[int, ScenarioSpec]]] = {}
    for pos, spec in enumerate(specs):
        w = spec.wireless(base)
        buckets.setdefault((w.n_users, w.n_bs), []).append((pos, spec))
    return buckets


def _grid_cells(n_scen: int, n_seeds: int) -> list[tuple[int, int]]:
    """A bucket's cells in row-major order: cell ``g`` is (scenario
    ``g // n_seeds``, seed ``g % n_seeds``), the order the outputs
    reshape back to [S, seeds, ...]."""
    return [(g // n_seeds, g % n_seeds) for g in range(n_scen * n_seeds)]


def _grid_shape(outs: dict, n_scen: int, n_seeds: int) -> dict:
    """[G, ...] cell outputs -> the [S, seeds, ...] float32 numpy arrays
    the record builders take."""
    return {k: v.float().reshape(n_scen, n_seeds, *v.shape[1:]).cpu()
            .numpy() for k, v in outs.items()}


def _run_grid(mesh, n_scen: int, n_seeds: int, run) -> dict:
    """A bucket's S x seeds cells through ``run(cells) -> {name:
    [len(cells), ...] tensor}``: every cell here when ``mesh`` is None,
    else this rank's block of the padded grid
    (:meth:`~repro_torch.launch.mesh.DataMesh.block`: the padding, which
    JAX recomputes and cuts off, is not run), the blocks gathered from
    every rank in rank order.  Returns :func:`_grid_shape`'s arrays."""
    cells = _grid_cells(n_scen, n_seeds)
    if mesh is None:
        outs = run(cells)
    else:
        mine = [cells[g] for g in mesh.block(len(cells))]
        part = ({k: v.cpu() for k, v in run(mine).items()} if mine
                else None)
        parts = [p for p in mesh.gather(part) if p is not None]
        outs = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return _grid_shape(outs, n_scen, n_seeds)


def _wireless_records(group: list[tuple[int, ScenarioSpec]], outs: dict,
                      n_seeds: int, n_rounds: int) -> dict[int, dict]:
    """[S, seeds, R] bucket outputs -> per-scenario record dicts."""
    t_round = np.asarray(outs["t_round"])
    n_sel = np.asarray(outs["n_selected"])
    min_pr = np.asarray(outs["min_part_rate"])
    records: dict[int, dict] = {}
    for i, (pos, spec) in enumerate(group):
        records[pos] = {
            "scenario": spec.name,
            "mobility": spec.mobility,
            "speed_mps": spec.speed_mps,
            "n_seeds": n_seeds,
            "n_rounds": n_rounds,
            "t_round_mean_s": float(t_round[i].mean()),
            "t_round_p95_s": float(np.percentile(t_round[i], 95)),
            "participants_mean": float(n_sel[i].mean()),
            "min_part_rate": float(min_pr[i, :, -1].mean()),
            "curves": {
                "t_round_s": t_round[i].mean(axis=0).tolist(),
                "n_selected": n_sel[i].mean(axis=0).tolist(),
                "min_part_rate": min_pr[i].mean(axis=0).tolist(),
            },
        }
    return records


def run_sweep(scenarios: Sequence[str | ScenarioSpec], n_seeds: int = 4,
              n_rounds: int = 10, cfg: WirelessConfig | None = None,
              seed: int = 0, user_chunk: int | None = None,
              channel_dtype: str = "f32", device=None,
              mesh=None) -> list[dict]:
    """The wireless sweep: one record dict per scenario, in the caller's
    order.  Every cell of a shape bucket (n_users, n_bs) uses the bucket's
    seed keys ``split(PRNGKey(seed), n_seeds)``, and the bucket's cells
    run in lockstep, one batched greedy a round (on the card one captured
    graph a bucket, replayed once a round: the module doc).  ``channel_dtype``
    stores the [N, M] channel plane as ``"f32"``, ``"bf16"`` or ``"int8"``
    dB codes with a per-BS scale.  ``user_chunk`` (any size >= 1) bounds
    the channel's per-round intermediates to that many users and, on the
    CPU, streams the greedy's selection in blocks of it; the records do
    not change.  ``mesh`` (a :class:`~repro_torch.launch.mesh.DataMesh`)
    runs this rank's block of each bucket's cells and gathers the rest:
    every rank returns the same records (:mod:`.shard_sweep`)."""
    _check_user_chunk(user_chunk)
    if channel_dtype not in channel.CHANNEL_DTYPES:
        raise ValueError(f"unknown channel_dtype {channel_dtype!r}; "
                         f"choose from {channel.CHANNEL_DTYPES}")
    dev = resolve_device(device)
    specs = [get_scenario(s) if isinstance(s, str) else s for s in scenarios]
    base = cfg or WirelessConfig()
    records: dict[int, dict] = {}
    for (n_users, n_bs), group in _wireless_buckets(specs, base).items():
        bcfg = dataclasses.replace(base, n_bs=n_bs)
        minp = int(np.ceil(bcfg.rho2 * n_users))
        params = _scenario_params([s for _, s in group], bcfg, device=dev)
        rows = [_row(params, i) for i in range(len(group))]
        seed_keys = rng.split(rng.PRNGKey(seed, device=dev), n_seeds)

        def run(cells):
            states, step, pattern = _wireless_bucket_step(
                [(rows[i], seed_keys[j]) for i, j in cells], bcfg, minp,
                channel_dtype, user_chunk)
            return _run_bucket(states, step, pattern, n_rounds, dev)
        outs = _run_grid(mesh, len(group), n_seeds, run)
        records.update(_wireless_records(group, outs, n_seeds, n_rounds))
    return [records[i] for i in range(len(specs))]


# ---------------------------------------------------- learning-curve sweep --
def _learning_cell_step(p: dict, key: torch.Tensor, x_c, y_c, params0,
                        x_test, y_test, *, cfg: WirelessConfig, minp: int,
                        epochs: int, batch_size: int, lr: float,
                        eval_every: int, aggregation: str = "single",
                        tau_global: int = 1, scheduler: str = "dagsa_jit",
                        faults: fl_faults.FaultSpec = fl_faults.NO_FAULTS,
                        async_on: bool = False, tick_s: float = 1.0,
                        staleness_alpha: float = 0.0, buffer_size: int = 1,
                        channel_dtype: str = "f32",
                        compress: str | None = None, topk_frac: float = 1.0,
                        user_chunk: int | None = None, compute: str = "full",
                        select_cap: int | None = None) -> tuple:
    """One (scenario, seed) FL cell: its world drawn from its key, and the
    canonical round step (:func:`repro_torch.fl.rounds.make_round_step`,
    ``world="sweep"``; ticks of ``tick_s`` when ``async_on``).
    ``faults`` is the scenario's resolved fault model; ``select_cap`` None
    trains the whole fleet under ``compute="selected"``.  Returns the
    step's ``(init_state, step_fn, pattern)``."""
    from repro_torch.fl.rounds import FLConfig, make_round_step

    k_shadow, k_run, pos0, bs_pos, bs_bw, aux0 = _cell_world(p, key, cfg)
    dev = pos0.device
    plan = FLConfig(scheduler=scheduler, local_epochs=epochs,
                    batch_size=batch_size, lr=lr, eval_every=eval_every)
    return make_round_step(
        plan, cfg, scenario=p, x_clients=x_c, y_clients=y_c,
        data_sizes=torch.full((cfg.n_users,), x_c.shape[1],
                              dtype=torch.int32, device=dev),
        x_test=x_test, y_test=y_test, bs_pos=bs_pos, bs_bw=bs_bw,
        k_shadow=k_shadow, params0=params0, pos0=pos0, aux0=aux0,
        counts0=torch.zeros((cfg.n_users,), device=dev), key0=k_run,
        world="sweep", min_participants=minp, channel_dtype=channel_dtype,
        aggregation=aggregation, tau_global=tau_global, compress=compress,
        topk_frac=topk_frac, faults=faults, async_on=async_on,
        tick_s=tick_s, staleness_alpha=staleness_alpha,
        buffer_size=buffer_size, user_chunk=user_chunk, compute=compute,
        select_cap=select_cap)


def _bucket_step(cells: list[tuple]) -> tuple:
    """One step over a bucket's G cells, each ``(init_state, step_fn,
    pattern)``: ``(states, step_fn, pattern)`` with the state the tuple of
    the cells' states, each cell's step run in cell order and every output
    stacked to ``[G]``.  A bucket's cells share ``eval_every`` and
    ``tau_global``, so their patterns agree: the first cell's."""
    steps = [step for _, step, _ in cells]

    def step_fn(states: tuple, r: int, r_dev=None):
        new, outs = [], []
        for state, step in zip(states, steps):
            state, out = step(state, r, r_dev)
            new.append(state)
            outs.append(out)
        return tuple(new), {k: torch.stack([o[k] for o in outs])
                            for k in outs[0]}
    return tuple(state for state, _, _ in cells), step_fn, cells[0][2]


def _run_bucket_host(states: tuple, step_fn, pattern, n_rounds: int,
                     dev: torch.device) -> dict:
    """``n_rounds`` of a bucket step in the host loop, one call a round
    (the CPU's route; on the card the uncaptured twin of
    :func:`_run_bucket`): ``{name: [G, R] tensor}``."""
    outs = []
    for r in range(n_rounds):
        states, out = step_fn(states, r)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs], dim=-1) for k in outs[0]}


def _run_bucket(states: tuple, step_fn, pattern, n_rounds: int,
                dev: torch.device) -> dict:
    """``n_rounds`` of a bucket step, as JAX runs a bucket in one compiled
    call: on the card one captured CUDA graph a pattern
    (:class:`repro_torch.fl.fused.FusedRounds`), replayed once a round and
    released when the bucket ends; elsewhere :func:`_run_bucket_host`.
    Returns ``{name: [G, R] tensor}``."""
    if dev.type != "cuda":
        return _run_bucket_host(states, step_fn, pattern, n_rounds, dev)
    engine = fused_engine.FusedRounds(step_fn, pattern, dev)
    try:
        _, cols = engine.run(states, 0, n_rounds)
    finally:
        engine.release()
    cols.pop("greedy_steps", None)
    return {k: torch.from_numpy(np.ascontiguousarray(v.T))
            for k, v in cols.items()}


def _finite_or_none(xs) -> list:
    """nan -> None so the emitted JSON stays strictly parseable."""
    return [float(v) if np.isfinite(v) else None for v in np.asarray(xs)]


def _scalar_or_none(x):
    return float(x) if np.isfinite(x) else None


def _fault_flags(spec: ScenarioSpec) -> tuple[bool, bool]:
    """(faults_on, clip_on): the static part of a scenario's fault model,
    part of the bucket key as in the JAX package."""
    fs = spec.faults
    on = fs is not None and fs.active
    return on, bool(on and fs.clip_norm is not None)


def _learning_buckets(specs: Sequence[ScenarioSpec], base: WirelessConfig,
                      aggregation: str | None, tau_global: int | None,
                      compress: str | None = None,
                      topk_frac: float | None = None,
                      partition: str | None = None,
                      dirichlet_alpha: float | None = None
                      ) -> dict[tuple, list[tuple[int, ScenarioSpec]]]:
    """(position, spec) grouped by (n_users, n_bs, aggregation, tau,
    faults_on, clip_on, compress, topk_frac, partition, alpha): the
    scenarios of a bucket share their per-seed client data and inits."""
    buckets: dict[tuple, list[tuple[int, ScenarioSpec]]] = {}
    for pos, spec in enumerate(specs):
        w = spec.wireless(base)
        agg, tau = resolve_aggregation(spec, aggregation, tau_global)
        faults_on, clip_on = _fault_flags(spec)
        comp, frac = resolve_compress(spec, compress, topk_frac)
        part, alpha = resolve_partition(spec, partition,
                                        dirichlet_alpha)
        buckets.setdefault((w.n_users, w.n_bs, agg, tau, faults_on,
                            clip_on, comp, frac, part, alpha),
                           []).append((pos, spec))
    return buckets


def _learning_seed_inputs(data, cnn_cfg, k_part, k_init, n_seeds: int,
                          n_users: int, shards_per_user: int,
                          partition: str = "shard",
                          dirichlet_alpha: float | None = None):
    """Per-seed non-IID partitions and model inits, ``(x_c, y_c, w0)``
    lists of ``n_seeds``: seed s partitions with ``split(k_part,
    n_seeds)[s]`` and initialises with ``split(k_init, n_seeds)[s]``,
    shared by every scenario of a bucket (paired seeds)."""
    from repro_torch.fl.partition import dirichlet_partition, shard_partition
    from repro_torch.models import cnn

    pkeys = rng.split(k_part, n_seeds)
    ikeys = rng.split(k_init, n_seeds)
    y = data.y_train
    x_c, y_c, w0 = [], [], []
    for s in range(n_seeds):
        if partition == "dirichlet":
            idx = dirichlet_partition(
                pkeys[s], y, n_users, int(y.shape[0]) // n_users,
                float(dirichlet_alpha), n_classes=int(y.max()) + 1)
        else:
            idx = shard_partition(pkeys[s], y, n_users, shards_per_user)
        x_c.append(data.x_train[idx])
        y_c.append(y[idx])
        w0.append(cnn.init(ikeys[s], cnn_cfg))
    return x_c, y_c, w0


def _learning_records(group: list[tuple[int, ScenarioSpec]], outs: dict,
                      n_seeds: int, n_rounds: int, dataset: str, agg: str,
                      tau: int, scheduler: str = "dagsa_jit",
                      async_info: dict | None = None) -> dict[int, dict]:
    """[S, seeds, R] learning-bucket outputs -> per-scenario record dicts
    (float32 curves, the simulated clock their float32 running sum, as in
    the JAX package)."""
    t_round = np.asarray(outs["t_round"])
    n_sel = np.asarray(outs["n_selected"])
    acc = np.asarray(outs["test_acc"])
    hand = outs.get("handover_rate")
    n_del = outs.get("n_delivered")
    n_inf, n_drp = outs.get("n_inflight"), outs.get("n_dropped")
    wall = np.cumsum(t_round, axis=-1)
    records: dict[int, dict] = {}
    for i, (pos, spec) in enumerate(group):
        finals, at_budget = [], []
        budget = float(wall[i, :, -1].mean()) / 2.0
        for s in range(n_seeds):
            finite = np.isfinite(acc[i, s])
            finals.append(acc[i, s][finite][-1] if finite.any()
                          else np.nan)
            in_budget = finite & (wall[i, s] <= budget)
            at_budget.append(acc[i, s][in_budget].max()
                             if in_budget.any() else np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            acc_curve = np.nanmean(acc[i], axis=0)
            at_budget_mean = float(np.nanmean(at_budget))
            final_mean = float(np.nanmean(finals))
            final_std = float(np.nanstd(finals))
        rec = {
            "scenario": spec.name,
            "mobility": spec.mobility,
            "speed_mps": spec.speed_mps,
            "dataset": dataset,
            "aggregation": agg,
            "tau_global": tau,
            "scheduler": scheduler,
            "faults": (spec.faults.to_json()
                       if _fault_flags(spec)[0] else None),
            "n_seeds": n_seeds,
            "n_rounds": n_rounds,
            "final_acc_mean": _scalar_or_none(final_mean),
            "final_acc_std": _scalar_or_none(final_std),
            "wall_clock_mean_s": float(wall[i, :, -1].mean()),
            "acc_at_budget": {"budget_s": budget,
                              "acc_mean": _scalar_or_none(at_budget_mean)},
            "curves": {
                "wall_clock_s": wall[i].mean(axis=0).tolist(),
                "test_acc": _finite_or_none(acc_curve),
                "t_round_s": t_round[i].mean(axis=0).tolist(),
                "n_selected": n_sel[i].mean(axis=0).tolist(),
            },
            "seed_curves": {
                "wall_clock_s": wall[i].tolist(),
                "test_acc": [_finite_or_none(acc[i, s])
                             for s in range(n_seeds)],
            },
        }
        if hand is not None:
            rec["handover_rate_mean"] = float(hand[i].mean())
            rec["curves"]["handover_rate"] = hand[i].mean(axis=0).tolist()
        if n_del is not None:
            del_rate, goodput = outs["delivered_rate"], outs["goodput_mbit_s"]
            rec["delivered_mean"] = float(n_del[i].mean())
            rec["delivered_rate_mean"] = float(del_rate[i].mean())
            rec["goodput_mbit_s_mean"] = float(goodput[i].mean())
            rec["curves"]["n_delivered"] = n_del[i].mean(axis=0).tolist()
            rec["curves"]["delivered_rate"] = \
                del_rate[i].mean(axis=0).tolist()
            rec["curves"]["goodput_mbit_s"] = \
                goodput[i].mean(axis=0).tolist()
        if async_info is not None:
            rec.update(async_info)
            rec["n_inflight_mean"] = float(n_inf[i].mean())
            rec["n_dropped_mean"] = float(n_drp[i].mean())
            rec["curves"]["n_inflight"] = n_inf[i].mean(axis=0).tolist()
            rec["curves"]["n_dropped"] = n_drp[i].mean(axis=0).tolist()
        records[pos] = rec
    return records


def _check_async_args(aggregation_async: bool, tick_s, staleness_alpha,
                      buffer_size, compute: str,
                      aggregation: str | None) -> None:
    """Buffered-async argument validation, as the JAX package's."""
    if aggregation_async:
        if tick_s is None:
            raise ValueError("aggregation_async=True needs tick_s")
        if aggregation == "hierarchical":
            raise ValueError("aggregation_async composes with single-tier "
                             "aggregation only")
    elif (tick_s is not None or staleness_alpha != 0.0
          or buffer_size is not None):
        raise ValueError("tick_s/staleness_alpha/buffer_size only apply "
                         "with aggregation_async=True; they would silently "
                         "do nothing")


def run_learning_sweep(scenarios: Sequence[str | ScenarioSpec],
                       n_seeds: int = 2, n_rounds: int = 10,
                       cfg: WirelessConfig | None = None,
                       dataset: str = "mnist", n_train: int = 600,
                       n_test: int = 200, local_epochs: int = 2,
                       batch_size: int = 10, lr: float = 0.01,
                       eval_every: int = 1, shards_per_user: int = 2,
                       compute: str = "full", select_cap: int | None = None,
                       aggregation: str | None = None,
                       tau_global: int | None = None,
                       scheduler: str = "dagsa_jit",
                       faults=None, deadline_s: float | None = None,
                       aggregation_async: bool = False,
                       tick_s: float | None = None,
                       staleness_alpha: float = 0.0,
                       buffer_size: int | None = None,
                       user_chunk: int | None = None,
                       channel_dtype: str = "f32",
                       compress: str | None = None,
                       topk_frac: float | None = None,
                       partition: str | None = None,
                       dirichlet_alpha: float | None = None,
                       seed: int = 0, cnn_cfg=None,
                       device=None, mesh=None) -> list[dict]:
    """Accuracy against simulated wall clock, one record per scenario.

    The arguments and records are the JAX package's
    (``repro.launch.sweep.run_learning_sweep``): explicit ``aggregation``
    / ``tau_global`` / ``compress`` / ``topk_frac`` / ``partition`` /
    ``dirichlet_alpha`` override each scenario's own; ``faults`` (a
    preset name or FaultSpec) and ``deadline_s`` override its fault
    model; ``scheduler="dagsa-r"`` discounts the greedy's candidates by
    their delivery estimate; ``aggregation_async`` runs ticks of
    ``tick_s``.  The dataset, and each seed's partition and model init,
    are shared across scenarios (paired seeds).  ``cnn_cfg`` picks the
    CNN (None: the JAX sweep's small default).  ``scheduler`` may be a
    stateful policy (``ucb``, ``biased-adaptive``, ``rr``, ``pf``), whose
    estimates ride each cell's round state.  ``user_chunk`` evaluates the
    channel in user blocks, as :func:`run_sweep` does.
    ``compute="selected"`` trains a static ``select_cap``-row gather of
    each round's scheduled (async: dispatched) clients in the sync and
    async engines; unlike :class:`~repro_torch.fl.rounds.FLSimulation`, a
    None cap is the whole fleet, as in the JAX package's sweep.  A
    bucket's cells advance in lockstep, on the card as captured rounds
    (the module doc).  ``mesh`` runs this rank's block of each bucket's
    cells the same way, and gathers the rest, as :func:`run_sweep`
    does."""
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import compress_topk as ct
    from repro_torch.models import cnn

    if scheduler not in SWEEP_SCHEDULERS:
        raise ValueError(f"unknown sweep scheduler {scheduler!r}; "
                         f"choose from {SWEEP_SCHEDULERS}")
    check_compute(compute)
    _check_user_chunk(user_chunk)
    _check_async_args(aggregation_async, tick_s, staleness_alpha,
                      buffer_size, compute, aggregation)
    dev = resolve_device(device)
    specs = [get_scenario(s) if isinstance(s, str) else s for s in scenarios]
    if faults is not None:
        fs = fl_faults.get_faults(faults) if isinstance(faults, str) \
            else faults
        specs = [dataclasses.replace(s, faults=fs) for s in specs]
    if deadline_s is not None:
        specs = [dataclasses.replace(
            s, faults=dataclasses.replace(
                s.faults if s.faults is not None else fl_faults.NO_FAULTS,
                deadline_s=float(deadline_s))) for s in specs]
    base = cfg or WirelessConfig()
    data = make_dataset(dataset, seed=seed, n_train=n_train, n_test=n_test,
                        device=dev)
    h, wd, c = data.x_train.shape[1:]
    cnn_cfg = cnn_cfg or cnn.CNNConfig(height=h, width=wd, channels=c)

    k_cells, k_part, k_init = rng.split(rng.PRNGKey(seed, device=dev),
                                        3).unbind(0)
    seed_keys = rng.split(k_cells, n_seeds)   # paired across scenarios
    records: dict[int, dict] = {}
    buckets = _learning_buckets(specs, base, aggregation, tau_global,
                                compress, topk_frac, partition,
                                dirichlet_alpha)
    for (n_users, n_bs, agg, tau, faults_on, clip_on, comp, frac, part,
            alpha), group in buckets.items():
        if aggregation_async and agg == "hierarchical":
            raise ValueError(
                f"aggregation_async composes with single-tier aggregation "
                f"only; scenario(s) "
                f"{[s.name for _, s in group]} resolve to 'hierarchical'")
        bcfg = dataclasses.replace(base, n_bs=n_bs)
        minp = int(np.ceil(bcfg.rho2 * n_users))
        buf = int(buffer_size) if buffer_size is not None else n_users
        x_c, y_c, w0 = _learning_seed_inputs(
            data, cnn_cfg, k_part, k_init, n_seeds, n_users, shards_per_user,
            partition=part, dirichlet_alpha=alpha)
        params = _scenario_params([s for _, s in group], bcfg, device=dev)
        rows = [_row(params, i) for i in range(len(group))]
        cell_kw = dict(
            cfg=bcfg, minp=minp, epochs=local_epochs,
            batch_size=batch_size, lr=float(lr), eval_every=eval_every,
            aggregation=agg, tau_global=tau, scheduler=scheduler,
            async_on=aggregation_async,
            tick_s=float(tick_s) if aggregation_async else 1.0,
            staleness_alpha=float(staleness_alpha),
            buffer_size=buf if aggregation_async else 1,
            channel_dtype=channel_dtype, compress=comp, topk_frac=frac,
            user_chunk=user_chunk, compute=compute, select_cap=select_cap)

        def run(cells):
            # the graphs read the rows, the seeds' data and inits and the
            # test set in place: all outlive the bucket's graphs
            states, step, pattern = _bucket_step([_learning_cell_step(
                rows[i], seed_keys[j], x_c[j], y_c[j], w0[j],
                data.x_test, data.y_test,
                faults=(group[i][1].faults if faults_on
                        else fl_faults.NO_FAULTS), **cell_kw)
                for i, j in cells])
            return _run_bucket(states, step, pattern, n_rounds, dev)
        async_info = ({"aggregation_async": True, "tick_s": float(tick_s),
                       "staleness_alpha": float(staleness_alpha),
                       "buffer_size": buf}
                      if aggregation_async else None)
        recs = _learning_records(group,
                                 _run_grid(mesh, len(group), n_seeds, run),
                                 n_seeds, n_rounds, dataset, agg, tau,
                                 scheduler, async_info)
        if comp is not None:
            ratio = ct.compression_ratio(w0[0], frac, comp == "topk-int8")
            for pos, _ in group:
                recs[pos].update(
                    compress=comp, topk_frac=frac,
                    uplink_compression_ratio=float(ratio),
                    uplink_mbit_per_client=float(bcfg.model_mbit * ratio))
        if part != "shard":
            for pos, _ in group:
                recs[pos].update(partition=part, dirichlet_alpha=alpha)
        records.update(recs)
    return [records[i] for i in range(len(specs))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Multi-scenario wireless / learning sweep (JSON "
                    "records).")
    ap.add_argument("--scenarios", default="all",
                    help="comma-separated registry names, or 'all' "
                         f"(registered: {','.join(SCENARIOS)})")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    ap.add_argument("--seed", type=int, default=0, help="PRNG root seed")
    ap.add_argument("--shard", action="store_true",
                    help="split the seeds x scenarios grid over the "
                         "torch.distributed ranks (launch with torchrun "
                         "--nproc-per-node D); the output is the same bytes "
                         "as the unsharded sweep's")
    ap.add_argument("--mesh", type=int, default=None, metavar="D",
                    help="ranks that take cells for --shard (default: "
                         "every rank of the torchrun world)")
    ap.add_argument("--user-chunk", type=int, default=None, metavar="B",
                    help="evaluate the channel (and, on the CPU, the "
                         "greedy's selection) in blocks of B users; same "
                         "records")
    ap.add_argument("--n-users", type=int, default=None, metavar="N",
                    help="override WirelessConfig.n_users (fleet size) for "
                         "every scenario")
    ap.add_argument("--rho1", type=float, default=None,
                    help="override WirelessConfig.rho1 (per-user "
                         "participation floor, Eq. (8g))")
    ap.add_argument("--rho2", type=float, default=None,
                    help="override WirelessConfig.rho2 (per-round "
                         "participation fraction floor)")
    ap.add_argument("--channel-dtype", default="f32",
                    choices=channel.CHANNEL_DTYPES,
                    help="storage type of the per-round [N, M] channel "
                         "plane (bf16 halves its bytes, int8 dB codes with "
                         "a per-BS scale quarter them)")
    ap.add_argument("--out", default="-",
                    help="output path for the JSON list ('-' = stdout)")
    ap.add_argument("--learning", action="store_true",
                    help="run the full FL data plane and emit "
                         "accuracy-vs-wall-clock curves per scenario x seed")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--n-train", type=int, default=600)
    ap.add_argument("--n-test", type=int, default=200)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--compute", default="full", choices=COMPUTE_MODES,
                    help="selected: train only a static-size padded top-K "
                         "subset of each round's scheduled clients "
                         "(--learning only)")
    ap.add_argument("--select-cap", type=int, default=None,
                    help="K for --compute selected (default: the whole "
                         "fleet)")
    ap.add_argument("--aggregation", default=None,
                    choices=("single", "hierarchical"),
                    help="override every scenario's aggregation "
                         "architecture (--learning only)")
    ap.add_argument("--tau-global", type=int, default=None,
                    help="global sync period for hierarchical aggregation "
                         "(--learning only)")
    ap.add_argument("--scheduler", default="dagsa_jit",
                    choices=SWEEP_SCHEDULERS,
                    help="round scheduler; 'dagsa-r' discounts candidates "
                         "by estimated delivery probability; ucb, "
                         "biased-adaptive, rr and pf carry per-user "
                         "estimates across rounds (--learning only)")
    ap.add_argument("--faults", default=None,
                    choices=tuple(fl_faults.FAULT_PRESETS),
                    help="override every scenario's fault model with this "
                         "preset (--learning only)")
    ap.add_argument("--deadline", type=float, default=None, metavar="T",
                    help="round deadline in simulated seconds: the server "
                         "stops waiting and drops late updates "
                         "(--learning only)")
    ap.add_argument("--async", dest="async_agg", action="store_true",
                    help="buffered-async aggregation: tick the server every "
                         "--tick simulated seconds and aggregate whatever "
                         "landed, staleness-discounted (--learning only)")
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
                    help="override every scenario's uplink compression "
                         "mode (--learning only)")
    ap.add_argument("--topk-frac", type=float, default=None, metavar="F",
                    help="fraction of each leaf's entries a client uploads "
                         "(requires a compress mode)")
    ap.add_argument("--partition", default=None, choices=PARTITIONS,
                    help="override every scenario's non-IID data split "
                         "(--learning only)")
    ap.add_argument("--dirichlet-alpha", type=float, default=None,
                    metavar="A",
                    help="Dirichlet concentration for --partition dirichlet "
                         "(lower = more pathological)")
    args = ap.parse_args(argv)

    _check_user_chunk(args.user_chunk)
    names = list(SCENARIOS) if args.scenarios == "all" \
        else args.scenarios.split(",")
    overrides = {k: v for k, v in (("n_users", args.n_users),
                                   ("rho1", args.rho1),
                                   ("rho2", args.rho2)) if v is not None}
    cfg = dataclasses.replace(WirelessConfig(), **overrides) \
        if overrides else None
    if args.mesh is not None and not args.shard:
        ap.error("--mesh only applies with --shard; it would silently "
                 "do nothing")
    if not args.learning and (args.faults is not None
                              or args.deadline is not None
                              or args.scheduler != "dagsa_jit"):
        ap.error("--faults/--deadline/--scheduler shape the FL round loop; "
                 "they only apply with --learning")
    if not args.learning and (args.async_agg or args.tick is not None
                              or args.staleness_alpha != 0.0
                              or args.buffer_size is not None):
        ap.error("--async/--tick/--staleness-alpha/--buffer-size shape the "
                 "FL round loop; they only apply with --learning")
    if args.async_agg and args.tick is None:
        ap.error("--async needs --tick (the aggregation period in "
                 "simulated seconds)")
    if not args.learning and (args.compress is not None
                              or args.topk_frac is not None
                              or args.partition is not None
                              or args.dirichlet_alpha is not None):
        ap.error("--compress/--topk-frac/--partition/--dirichlet-alpha "
                 "shape the FL round loop; they only apply with --learning")
    mesh = None
    if args.shard:
        from repro_torch.launch.mesh import make_data_mesh
        mesh = make_data_mesh(args.mesh, device=args.device)
    try:
        records, summary = _run_cli(args, names, cfg, mesh)
    finally:
        if mesh is not None:
            mesh.close()
    if mesh is not None and mesh.rank != 0:
        return
    payload = json.dumps(records, indent=2)
    if args.out == "-":
        print(payload)
    else:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        print(f"wrote {args.out}: {summary}")


def _run_cli(args, names: list[str], cfg, mesh) -> tuple[list[dict], str]:
    """The sweep :func:`main` asked for: (records, a one-line summary)."""
    learning_fn, wireless_fn, device = run_learning_sweep, run_sweep, \
        args.device
    if mesh is not None:
        # local import: shard_sweep imports this module
        from repro_torch.launch import shard_sweep
        learning_fn = shard_sweep.run_shard_learning_sweep
        wireless_fn = shard_sweep.run_shard_sweep
        device = mesh.device
    if args.learning:
        records = learning_fn(
            names, n_seeds=args.seeds, n_rounds=args.rounds, cfg=cfg,
            dataset=args.dataset, n_train=args.n_train, n_test=args.n_test,
            local_epochs=args.local_epochs, batch_size=args.batch_size,
            lr=args.lr, eval_every=args.eval_every, compute=args.compute,
            select_cap=args.select_cap, aggregation=args.aggregation,
            tau_global=args.tau_global, scheduler=args.scheduler,
            faults=args.faults, deadline_s=args.deadline,
            aggregation_async=args.async_agg, tick_s=args.tick,
            staleness_alpha=args.staleness_alpha,
            buffer_size=args.buffer_size, channel_dtype=args.channel_dtype,
            compress=args.compress, topk_frac=args.topk_frac,
            partition=args.partition, dirichlet_alpha=args.dirichlet_alpha,
            user_chunk=args.user_chunk, seed=args.seed, device=device,
            mesh=mesh)
        summary = " ".join(
            f"{r['scenario']}={r['final_acc_mean']:.3f}"
            if r["final_acc_mean"] is not None else f"{r['scenario']}=n/a"
            for r in records)
    else:
        records = wireless_fn(
            names, n_seeds=args.seeds, n_rounds=args.rounds, cfg=cfg,
            channel_dtype=args.channel_dtype, seed=args.seed,
            user_chunk=args.user_chunk, device=device, mesh=mesh)
        summary = " ".join(f"{r['scenario']}={r['t_round_mean_s']:.3f}s"
                           for r in records)
    return records, summary


if __name__ == "__main__":
    main()

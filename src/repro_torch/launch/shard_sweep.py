"""Sharded fleet sweeps: the seeds x scenarios grid over the ranks of a
data mesh (PyTorch port of ``repro.launch.shard_sweep``).

A bucket's S x seeds grid is flattened to G independent (scenario, seed)
cells, cell ``g`` being (scenario ``g // n_seeds``, seed ``g % n_seeds``):
``sweep._grid_cells``, the grid the unsharded sweep runs too.  The cells
pad to ``padded_count(G, D)`` over a mesh of D ranks
(:func:`repro_torch.launch.mesh.make_data_mesh`), and rank ``r`` takes the
contiguous block ``shard_map`` puts on device ``r`` of the JAX package's
mesh.  Each rank runs its block as the unsharded sweep runs a bucket (in
lockstep, a wireless block with one batched greedy a round; on the card
captured by the rank as its own CUDA graphs), moves its outputs to the
host, and one ``all_gather_object`` a bucket hands every rank all G
cells: no collective sits inside a round.  Every rank
then builds the same records as :func:`repro_torch.launch.sweep.run_sweep`
and :func:`~repro_torch.launch.sweep.run_learning_sweep`: cells never
communicate, so the JSON is byte-identical at any world size.

:func:`shard_schedule_batch` splits the fleet axis of
:func:`repro_torch.core.dagsa_jit.dagsa_schedule_batch` the same way.

    torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --shard \\
        --device cpu --scenarios paper-default,high-mobility --seeds 3
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import dagsa_jit
from repro_torch.core.scenario import ScenarioSpec
from repro_torch.core.types import (ScheduleResult, SchedulingProblem,
                                    WirelessConfig)
from repro_torch.launch import sweep
from repro_torch.launch.mesh import DataMesh, make_data_mesh


def _mesh(mesh: DataMesh | None, n_devices: int | None, device) -> DataMesh:
    return mesh if mesh is not None else make_data_mesh(n_devices, device)


def run_shard_sweep(scenarios: Sequence[str | ScenarioSpec],
                    n_seeds: int = 4, n_rounds: int = 10,
                    cfg: WirelessConfig | None = None, seed: int = 0,
                    user_chunk: int | None = None,
                    channel_dtype: str = "f32", device=None,
                    mesh: DataMesh | None = None,
                    n_devices: int | None = None) -> list[dict]:
    """Sharded :func:`repro_torch.launch.sweep.run_sweep`: the same
    arguments and the same records on every rank, plus ``mesh`` (a ready
    :class:`DataMesh`) or ``n_devices`` (the first N ranks of the world;
    default all).  ``device`` defaults to the mesh's."""
    mesh = _mesh(mesh, n_devices, device)
    return sweep.run_sweep(scenarios, n_seeds=n_seeds, n_rounds=n_rounds,
                           cfg=cfg, seed=seed, user_chunk=user_chunk,
                           channel_dtype=channel_dtype,
                           device=device if device is not None
                           else mesh.device, mesh=mesh)


def run_shard_learning_sweep(scenarios: Sequence[str | ScenarioSpec],
                             n_seeds: int = 2, n_rounds: int = 10, *,
                             device=None, mesh: DataMesh | None = None,
                             n_devices: int | None = None,
                             **kw) -> list[dict]:
    """Sharded :func:`repro_torch.launch.sweep.run_learning_sweep` (which
    takes the keywords ``kw``): the same records on every rank; ``mesh``
    and ``n_devices`` as in :func:`run_shard_sweep`.  Every rank draws
    the dataset and each seed's partition and model init, then trains its
    block of cells."""
    mesh = _mesh(mesh, n_devices, device)
    return sweep.run_learning_sweep(
        scenarios, n_seeds=n_seeds, n_rounds=n_rounds,
        device=device if device is not None else mesh.device, mesh=mesh,
        **kw)


def shard_schedule_batch(problems, keys: torch.Tensor,
                         method: str = "newton", iters: int | None = None,
                         selection_block: int | None = None,
                         mesh: DataMesh | None = None,
                         n_devices: int | None = None) -> ScheduleResult:
    """:func:`repro_torch.core.dagsa_jit.dagsa_schedule_batch` over the
    ranks of a mesh: each rank runs its block of the fleet through one
    batched greedy (``dagsa_jit._schedule_batch``) and every rank gets
    the whole fleet's result, equal field for field to the unsharded
    batch, on the problems' device."""
    if not isinstance(problems, SchedulingProblem):
        problems = dagsa_jit.stack_problems(problems)
    dev = problems.snr.device
    mesh = _mesh(mesh, n_devices, dev)
    blk = mesh.block(problems.snr.shape[0])
    sl = slice(blk.start, blk.stop)
    part = None
    if len(blk):
        out = dagsa_jit._schedule_batch(
            problems.snr[sl], problems.coeff[sl], problems.tcomp[sl],
            problems.bs_bw[sl], problems.necessary[sl],
            int(problems.min_participants), keys[sl], method=method,
            iters=iters, selection_block=selection_block)
        part = tuple(x.cpu() for x in out)
    parts = [p for p in mesh.gather(part) if p is not None]
    assign, selected, bw, t_k, t_round = (
        torch.cat([p[i] for p in parts]).to(dev) for i in range(5))
    return ScheduleResult(assign=assign, selected=selected, bw=bw,
                          bs_time=t_k, t_round=t_round)

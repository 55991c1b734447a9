"""The meshes of ranks (PyTorch port of ``repro.launch.mesh``): the data
mesh of the sharded sweeps and the sharded FL round
(``make_data_mesh``), and the LM's ``("data", "model")`` mesh
(``smoke_mesh``).

JAX's ``("data",)`` mesh is one controller driving many devices through
``shard_map``.  The port's cells run as a host loop, so its mesh is a set
of ``torch.distributed`` ranks, one process each with its own host loop
(``torchrun --nproc-per-node D``).  A rank owns one contiguous block of a
padded leading axis, as ``shard_map`` puts one on each device, and the
ranks exchange their results through the gloo backend, which also runs
two ranks on one card (NCCL refuses that, and nothing on these paths is
bound by bandwidth).

The LM's :class:`Mesh` lays ``data x model`` ranks out data-major, as
``np.reshape(devices, (data, model))`` lays out JAX's devices: rank ``r``
is ``data_rank = r // model``, ``model_rank = r % model``.  The ranks of
one ``model`` group hold one copy of the model, sharded by
:mod:`repro_torch.launch.sharding`'s rules; the ranks of one ``data``
group hold the same shard and take different batch rows.  It runs gloo,
as the data mesh does: ranks that share one card need it.  JAX's TPU pod
meshes (``make_production_mesh``: 256 and 512 v5e chips) are not ported.

    torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --shard \\
        --device cpu --scenarios paper-default,high-mobility --seeds 3
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve_decode \\
        --config qwen3_0_6b --reduced --device cpu --mesh 2,2
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.launch.sharding import data_axes, padded_count

__all__ = ["DataMesh", "Mesh", "data_axes", "make_data_mesh", "smoke_mesh"]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``size`` ranks that take work, of the ``world_size`` ranks in the
    process group; this process is ``rank`` and computes on ``device``.
    Ranks at or above ``size`` take no work but join every gather.
    ``group`` is None in a world of one."""

    size: int
    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    owns_group: bool = False

    def block(self, n: int) -> range:
        """This rank's rows of an ``n``-row axis padded to
        ``padded_count(n, size)``: the contiguous block ``shard_map``
        puts on device ``rank``, without the padded tail (it would
        recompute real rows and be cut off)."""
        if self.rank >= self.size:
            return range(0)
        b = padded_count(n, self.size) // self.size
        return range(min(self.rank * b, n), min((self.rank + 1) * b, n))

    def gather(self, obj) -> list:
        """Every working rank's ``obj`` (picklable, host tensors), in rank
        order."""
        if self.world_size == 1:
            return [obj]
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.group)
        return out[:self.size]

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Concatenate every working rank's ``rows`` (the same shape on
        every rank; a rank past ``size`` sends any) along the leading
        axis, staged through the host, onto ``rows``' device."""
        if self.world_size == 1:
            return rows
        host = rows.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.world_size)]
        dist.all_gather(parts, host, group=self.group)
        return torch.cat(parts[:self.size]).to(rows.device)

    def close(self) -> None:
        """Tear down the process group if :func:`make_data_mesh` started
        it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _rank_device(device) -> torch.device:
    """``device`` as given, else the card ``LOCAL_RANK % device_count``
    (ranks share cards round-robin; raises without CUDA, as
    :func:`repro_torch.resolve_device` does)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_data_mesh(n_devices: int | None = None, device=None) -> DataMesh:
    """A mesh over the first ``n_devices`` ranks of the process group
    (default: every rank).

    With a process group already up, it is used.  Without one, under
    ``torchrun`` (``WORLD_SIZE`` above 1) this starts one with the gloo
    backend from the environment; otherwise the world is this process
    alone.  ``n_devices`` below 1 raises ValueError, above the world size
    RuntimeError.  ``device`` overrides the rank's card (the CPU tests
    pass ``"cpu"``)."""
    owns = False
    if (not dist.is_initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        dist.init_process_group("gloo")
        owns = True
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    n = world if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    if n > world:
        raise RuntimeError(
            f"need {n} ranks, have {world}; run under "
            f"torchrun --nproc-per-node {n}")
    return DataMesh(size=n, rank=dist.get_rank() if on else 0,
                    world_size=world, device=_rank_device(device),
                    group=dist.group.WORLD if on else None, owns_group=owns)


def _host_collective(op, t: torch.Tensor, group) -> torch.Tensor:
    """``op`` (an in-place gloo collective on a host tensor) over a host
    copy of ``t``, the result back on ``t``'s device.  Every exchange of
    the LM mesh is staged through the host here: gloo runs on host
    memory (its CUDA path copies to the host as well), and one helper
    keeps the card's and the CPU's runs on the same code.  Half-width
    floats cross as float32, which holds them exactly."""
    wide = (torch.float32 if t.dtype in (torch.bfloat16, torch.float16)
            else t.dtype)
    host = t.detach().to("cpu", wide, copy=True).contiguous()
    return op(host, group).to(t.device, t.dtype)


def _sum(host: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(host, group=group)
    return host


def _gather(host: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(host)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, host, group=group)
    return torch.stack(parts)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh of ``torch.distributed`` ranks; this
    process is ``rank`` and computes on ``device``.  ``model_group`` is
    the gloo group of this rank's model replica (None where ``model`` is
    1), ``data_group`` the ranks that hold the same shard (None where
    ``data`` is 1)."""

    data: int
    model: int
    rank: int
    device: torch.device
    model_group: Any = None
    data_group: Any = None
    owns_group: bool = False

    axis_names = ("data", "model")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model group (the same shape on every
        rank), on ``t``'s device and in its dtype."""
        if self.model == 1:
            return t
        return _host_collective(_sum, t, self.model_group)

    def model_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every model rank's ``t`` stacked in rank order: [model, ...]."""
        if self.model == 1:
            return t[None]
        return _host_collective(_gather, t, self.model_group)

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``t`` stacked in rank order: [data, ...]."""
        if self.data == 1:
            return t[None]
        return _host_collective(_gather, t, self.data_group)

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    def close(self) -> None:
        """Tear down the process group if :func:`smoke_mesh` started
        it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def smoke_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh over every rank of the process group,
    which must hold ``data * model`` ranks.

    With a process group already up, it is used; without one, under
    ``torchrun`` (``WORLD_SIZE`` above 1) this starts one with the gloo
    backend from the environment; otherwise the world is this process
    alone.  Sizes below 1 raise ValueError, a world of another size
    RuntimeError.  ``device`` overrides the rank's card (the CPU tests
    pass ``"cpu"``)."""
    data, model = int(data), int(model)
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got ({data}, {model})")
    owns = False
    if (not dist.is_initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        dist.init_process_group("gloo")
        owns = True
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    if world != data * model:
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs {data * model} ranks, have "
            f"{world}; run under torchrun --nproc-per-node {data * model}")
    rank = dist.get_rank() if on else 0
    model_group = data_group = None
    # every rank creates every group, in one order, as new_group requires
    if model > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * model, (d + 1) * model)),
                               backend="gloo")
            if rank // model == d:
                model_group = g
    if data > 1:
        for m in range(model):
            g = dist.new_group(list(range(m, data * model, model)),
                               backend="gloo")
            if rank % model == m:
                data_group = g
    return Mesh(data=data, model=model, rank=rank,
                device=_rank_device(device), model_group=model_group,
                data_group=data_group, owns_group=owns)

"""The data mesh of the sharded sweeps and the sharded FL round (PyTorch
port of ``repro.launch.mesh.make_data_mesh``).

JAX's ``("data",)`` mesh is one controller driving many devices through
``shard_map``.  The port's cells run as a host loop, so its mesh is a set
of ``torch.distributed`` ranks, one process each with its own host loop
(``torchrun --nproc-per-node D``).  A rank owns one contiguous block of a
padded leading axis, as ``shard_map`` puts one on each device, and the
ranks exchange their results through the gloo backend, which also runs
two ranks on one card (NCCL refuses that, and nothing on these paths is
bound by bandwidth).

JAX's TPU pod meshes (``make_production_mesh``, ``data_axes``,
``smoke_mesh``) are not ported: they lay out the LM over a pod's
``data`` and ``model`` axes, and the port's models fit one card.

    torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --shard \\
        --device cpu --scenarios paper-default,high-mobility --seeds 3
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.launch.sharding import padded_count


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

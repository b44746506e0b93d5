"""1-D 'shards' meshes for the port's distributed bulk-access engine.

Two kinds, both partitioning the table's *address range* over one axis
(the multi-accelerator deployment of paper §6.6; distinct from a training
mesh's data/model axes):

  Mesh         *logical*: a shard count on one torch device. One card (or
               the CPU) holds every shard of any mesh size and the whole
               table, as the reference's forced host devices all live on
               one CPU; ``as_mesh(None)`` keeps the reference's count, one
               shard per visible device.
  ProcessMesh  one shard per process of a ``torch.distributed`` group
               (``torchrun --nproc-per-node=N`` or
               ``torch.multiprocessing``): rank ``r`` holds only its rows
               ``shard_row_ranges(n_rows, m)[r]`` on its own device, and
               the exchange is a collective over the group.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from repro_torch.core.device import resolve_device

DEFAULT_AXIS = "shards"


def shard_row_ranges(n_rows: int, num_shards: int) -> list:
    """Half-open ``(lo, hi)`` row range each shard owns under the equal
    address-range split (ceil-div ``rows_per``; the last shard may own a
    short — possibly empty — remainder), mirroring
    ``reorder.shard_bulk_indices``'s owner layout."""
    n_rows, num_shards = int(n_rows), int(num_shards)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    rows_per = -(-n_rows // num_shards)
    return [(min(o * rows_per, n_rows), min((o + 1) * rows_per, n_rows))
            for o in range(num_shards)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``num_shards`` logical shards, all on ``device``."""
    num_shards: int
    device: torch.device
    axis: str = DEFAULT_AXIS

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.num_shards}


def device_mesh(num_shards: int | None = None, *, device=None,
                axis: str = DEFAULT_AXIS) -> Mesh:
    """A logical mesh of ``num_shards`` shards (default: the reference's
    count, one per visible device) on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    if num_shards is None:
        num_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    return Mesh(int(num_shards), dev, axis)


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """One shard per rank of a ``torch.distributed`` process group.

    ``group`` the process group, ``rank``/``num_shards`` this process's
    rank in it and its size, ``device`` where this rank's table slice and
    streams live, ``backend`` the group's ("nccl" sends CUDA tensors
    directly; "gloo" exchanges CPU tensors, and CUDA ones through pinned
    host buffers)."""
    group: object
    rank: int
    num_shards: int
    device: torch.device
    backend: str
    axis: str = DEFAULT_AXIS

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.num_shards}


def _rank_device(rank: int) -> torch.device:
    """``cuda:{LOCAL_RANK}`` under a launcher that sets it, else
    ``cuda:{rank % device_count}``."""
    resolve_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    n = torch.cuda.device_count()
    return torch.device("cuda", int(local) if local is not None
                        else rank % n)


def process_mesh(group=None, *, device=None,
                 axis: str = DEFAULT_AXIS) -> ProcessMesh:
    """The ``ProcessMesh`` of ``group`` (default: the initialised default
    group) for this process. ``device`` defaults to this rank's card
    (``cuda:{LOCAL_RANK}``, or ``rank % device_count``); pass
    ``device="cpu"`` for a gloo group on the CPU. Raises if no group has
    been initialised."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "process_mesh needs an initialised torch.distributed group: "
            "call torch.distributed.init_process_group first (torchrun "
            "sets the rendezvous variables)")
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    dev = _rank_device(rank) if device is None else resolve_device(device)
    return ProcessMesh(group, rank, dist.get_world_size(group), dev,
                       str(dist.get_backend(group)).lower(), axis)


def as_mesh(mesh, *, device=None, axis: str = DEFAULT_AXIS):
    """Coerce ``None`` (one shard per visible device) / an int (shard
    count) / a ``Mesh`` / a ``ProcessMesh`` into a mesh usable by the
    sharded engine."""
    if mesh is None or isinstance(mesh, int):
        return device_mesh(mesh, device=device, axis=axis)
    if isinstance(mesh, (Mesh, ProcessMesh)):
        return mesh
    raise TypeError(f"mesh must be None, an int, a Mesh or a ProcessMesh, "
                    f"got {type(mesh).__name__}")

"""1-D 'shards' mesh for the port's distributed bulk-access engine.

The JAX package's mesh is a ``jax.sharding.Mesh`` over JAX devices; on a
CPU host it forces extra host devices, all of them on one CPU. The port's
mesh is *logical*: a shard count and a list of torch devices, the shards
placed on them round-robin. One card holds every shard of any mesh size,
as the reference's forced host devices all live on one CPU; ``as_mesh(None)``
is one shard per visible card. Distinct from a training mesh (data/model
axes): the access engine partitions the *address range* over one axis, the
multi-accelerator deployment of paper §6.6.
"""
from __future__ import annotations

import dataclasses
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
    """``num_shards`` logical shards over ``devices``, shard ``s`` on
    ``devices[s % len(devices)]``."""
    num_shards: int
    devices: Tuple[torch.device, ...]
    axis: str = DEFAULT_AXIS

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got "
                             f"{self.num_shards}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.num_shards}

    def device_of(self, shard: int) -> torch.device:
        return self.devices[shard % len(self.devices)]


def _visible(device) -> Tuple[torch.device, ...]:
    """Every visible card for a CUDA device, else the device itself."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def device_mesh(num_shards: int | None = None, *, device=None,
                axis: str = DEFAULT_AXIS) -> Mesh:
    """A mesh of ``num_shards`` shards (default: one per visible card)
    over the visible cards (``device=None`` means CUDA), or over
    ``device`` itself when it is not a CUDA device."""
    devices = _visible(device)
    n = len(devices) if num_shards is None else int(num_shards)
    return Mesh(n, devices, axis)


def as_mesh(mesh, *, device=None, axis: str = DEFAULT_AXIS) -> Mesh:
    """Coerce ``None`` (one shard per visible card) / an int (shard count)
    / a ``Mesh`` into a mesh usable by the sharded engine."""
    if mesh is None or isinstance(mesh, int):
        return device_mesh(mesh, device=device, axis=axis)
    if isinstance(mesh, Mesh):
        return mesh
    raise TypeError(f"mesh must be None, an int or a Mesh, got "
                    f"{type(mesh).__name__}")

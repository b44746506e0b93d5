"""Tensor and data parallelism of the layers over a process mesh.

Under a ``launch.mesh.RankMesh`` made ambient by ``launch.mesh.set_mesh``
(the train step does it), each rank runs the model on its shards: the
columns or rows of each weight that ``launch.mesh.param_specs`` gives it
over ``model``, and its block of the batch over the data-parallel axes.
The layers keep the whole-tensor semantics with the pair of Megatron's
tensor-parallel functions over the ``model`` line:

  copy     the identity forward, an all-reduce of the gradient backward:
           where an activation (or weight) replicated across ``model``
           enters a computation that each rank does on its own part;
  reduce   an all-reduce forward, the identity backward: after a product
           over the rank's rows, or to sum what each rank computed on
           its part.

``reduce`` also sums over the data-parallel axes where a loss term is a
mean over the whole batch: every rank then holds the global value, its
backward seeds only the rank's own tokens, and the step sums the
gradients over those axes. ``torch.distributed.nn.functional.all_reduce``
is not ``reduce``: its backward all-reduces too, which would multiply
each gradient by the line's size.

Whether the batch in flight is cut over the data-parallel axes is known
here only: the step makes ``batch_mesh(mesh, split)`` ambient, whose
data-parallel line is None where every rank holds the batch whole, and
``dp_line``/``dp_shards`` read it. Without a process mesh (``mesh`` None)
every function here is the identity, so one body serves both.

A weight that ``param_specs`` leaves whole (its dimension does not divide
over ``model``) is used whole: ``sharded`` tells the two apart by its
local shape against the full one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.launch.mesh import RankMesh, get_mesh


def rank_mesh() -> Optional[RankMesh]:
    """The ambient mesh where it is a process mesh, else None."""
    mesh = get_mesh()
    return mesh if isinstance(mesh, RankMesh) else None


def model_split(mesh: Optional[RankMesh]) -> int:
    """The ``model`` axis size of a process mesh (1 without one)."""
    return mesh.shape.get("model", 1) if mesh is not None else 1


def batch_mesh(mesh: RankMesh, split: bool) -> RankMesh:
    """``mesh`` for a batch that is cut over its data-parallel axes
    (``split``) or that every rank holds whole: then its data-parallel
    line is None, and nothing is summed over it."""
    if split:
        return mesh
    from repro_torch.launch.mesh import _key
    return dataclasses.replace(
        mesh, lines={**mesh.lines, _key(mesh.dp_axes): None})


def dp_line(mesh: Optional[RankMesh]):
    """The data-parallel line over which the batch in flight is cut, or
    None (no process mesh, one data-parallel rank, or a batch every rank
    holds whole)."""
    return None if mesh is None else mesh.line(mesh.dp_axes)


def dp_shards(mesh: Optional[RankMesh]) -> int:
    """The number of blocks the global batch in flight is cut into."""
    line = dp_line(mesh)
    return 1 if line is None else line.num_shards


def _line(mesh: Optional[RankMesh], axes):
    if mesh is None:
        return None
    return dp_line(mesh) if axes == "dp" else mesh.line(axes)


def sharded(local: int, full: int) -> bool:
    return int(local) != int(full)


def _all_reduce(x: torch.Tensor, line, op: str = "sum") -> torch.Tensor:
    from repro_torch.distributed import exchange
    return x if line is None else exchange.all_reduce(x, line, op)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.line), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        return _all_reduce(x, line)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """All-gather along the last dimension; the gradient goes back as a
    reduce-scatter (each rank keeps the sum over ranks of its columns)."""

    @staticmethod
    def forward(ctx, x, line):
        from repro_torch.distributed import exchange
        ctx.line = line
        parts = exchange.all_gather(x.contiguous(), line)
        return torch.cat(list(parts), dim=-1)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed import exchange
        m = ctx.line.num_shards
        cols = g.shape[-1] // m
        blocks = torch.stack(torch.split(g, cols, dim=-1))
        mine = exchange.reduce_scatter(blocks.contiguous(), ctx.line)
        return mine[0], None


def copy(x: torch.Tensor, mesh: Optional[RankMesh]) -> torch.Tensor:
    """Megatron's *f* over ``model``: identity forward, gradient summed."""
    line = _line(mesh, "model")
    return x if line is None else _Copy.apply(x, line)


def reduce(x: torch.Tensor, mesh: Optional[RankMesh],
           axes="model") -> torch.Tensor:
    """Megatron's *g*: the sum over ``axes`` forward, identity backward.
    ``axes="dp"`` sums over the data-parallel line of the batch in flight
    (nothing where the batch is whole on every rank)."""
    line = _line(mesh, axes)
    return x if line is None else _Reduce.apply(x, line)


def gather_last(x: torch.Tensor, mesh: Optional[RankMesh]) -> torch.Tensor:
    """Every ``model`` rank's ``x`` side by side along the last dim."""
    line = _line(mesh, "model")
    return x if line is None else _GatherLast.apply(x, line)


@torch.no_grad()
def all_max(x: torch.Tensor, mesh: Optional[RankMesh],
            axes="model") -> torch.Tensor:
    """The elementwise maximum over ``axes`` (no gradient)."""
    return _all_reduce(x.detach(), _line(mesh, axes), "max")


@torch.no_grad()
def all_sum(x: torch.Tensor, mesh: Optional[RankMesh],
            axes="dp") -> torch.Tensor:
    """The sum over ``axes`` (as ``reduce``), with no gradient."""
    return _all_reduce(x.detach(), _line(mesh, axes))

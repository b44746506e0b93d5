"""The train step: loss and gradients by autograd, global-norm clip,
AdamW with quantized moments.

The port of the JAX package's ``train.trainer``. The step is one eager
function of (params, opt_state, batch): the gradients of ``model.loss``
(remat applies per layer body, ``models.remat``), global-norm clip, the
schedule's lr at the optimizer's step, then AdamW, out of place.
``shard_train_step`` computes the reference's spec trees (params TP over
``model``, moments ZeRO-1 over ``data``, the batch over the DP axes):

  * on a logical mesh (``launch.mesh.Mesh``) it runs the same step on the
    mesh's device: GSPMD runs the same function, so the results are those
    of the unsharded step;
  * on a process mesh (``launch.mesh.RankMesh``, one rank per position)
    it runs SPMD, each rank on its shards (``ProcessStep``): the layers
    tensor-parallel over ``model`` (``models.parallel``), the loss a mean
    over the global batch, the gradients summed over the DP axes, the
    clip's norm summed over the axes that shard each leaf, AdamW on the
    rank's ZeRO-1 slice, then an all-gather over ``data`` of the updated
    slices — GSPMD's reduce/all-gather pair, made explicit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.tree import (tree_leaves, tree_leaves_with_path,
                                   tree_map, tree_map_with_path)
from repro_torch.launch import mesh as meshlib
from repro_torch.models import parallel as P
from repro_torch.optim import adamw_init, adamw_update, global_norm_clip
from repro_torch.optim.schedules import make_schedule


def value_and_grad(loss_fn: Callable, params, *args):
    """``(loss_fn(params, *args), d loss / d params)`` — the counterpart of
    ``jax.value_and_grad``: the gradient tree has the params' structure,
    zeros where a leaf does not reach the loss."""
    leaves = tree_leaves_with_path(params)
    req = {p: leaf.detach().requires_grad_(True) for p, leaf in leaves}
    with torch.enable_grad():
        loss = loss_fn(tree_map_with_path(lambda p, _: req[p], params),
                       *args)
        grads = torch.autograd.grad(loss, list(req.values()),
                                    allow_unused=True)
    by_path = {p: torch.zeros_like(t) if g is None else g
               for (p, t), g in zip(req.items(), grads)}
    return loss.detach(), tree_map_with_path(lambda p, _: by_path[p], params)


def loss_and_clipped_grads(model, params, batch, clip_norm: float = 1.0):
    """The step's gradient half: (loss, clipped grads, global norm)."""
    loss, grads = value_and_grad(model.loss, params, batch)
    grads, gnorm = global_norm_clip(grads, clip_norm)
    return loss, grads, gnorm


def make_train_step(model, *, schedule: Optional[Callable] = None,
                    clip_norm: float = 1.0, weight_decay: float = 0.1):
    schedule = schedule or make_schedule(model.cfg.schedule)

    def train_step(params, opt_state, batch):
        loss, grads, gnorm = loss_and_clipped_grads(model, params, batch,
                                                    clip_norm)
        lr = schedule(opt_state["step"])
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                         weight_decay=weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


@dataclasses.dataclass(frozen=True)
class ShardedStep:
    """The train step on a logical mesh, with the spec trees it runs
    under (``in_specs``: params, optimizer state, batch; ``out_specs``:
    params, optimizer state). Calling it moves the inputs to the mesh's
    device and runs the step."""
    step: Callable
    mesh: meshlib.Mesh
    in_specs: tuple
    out_specs: tuple

    def __call__(self, params, opt_state, batch):
        to_dev = lambda tree: tree_map(lambda t: t.to(self.mesh.device),
                                       tree)
        return self.step(to_dev(params), to_dev(opt_state), to_dev(batch))


def _data_dim(pspec, zspec):
    """The dim ZeRO-1 adds ``data`` to (None where it adds none)."""
    for d, (a, b) in enumerate(zip(pspec, zspec)):
        if b == "data" and a != "data":
            return d
    return None


def _all_reduce_tree(tree, line):
    """Every leaf summed over ``line``: one all-reduce per dtype over the
    leaves laid end to end."""
    from repro_torch.distributed import exchange
    leaves = tree_leaves_with_path(tree)
    groups = {}
    for p, t in leaves:
        groups.setdefault(t.dtype, []).append((p, t))
    out = {}
    for items in groups.values():
        flat = exchange.all_reduce(
            torch.cat([t.reshape(-1) for _, t in items]), line)
        for (p, t), piece in zip(items, torch.split(
                flat, [t.numel() for _, t in items])):
            out[p] = piece.view(t.shape)
    return tree_map_with_path(lambda p, _: out[p], tree)


def _gather_slices(tree, dims, line):
    """Rebuild each leaf cut along its ``dims`` entry over ``line``: one
    all-gather of every such leaf's bytes laid end to end."""
    from repro_torch.distributed import exchange
    cut = [(p, t, d) for (p, t), d in zip(tree_leaves_with_path(tree),
                                          tree_leaves(dims))
           if d is not None]
    if line is None or not cut:
        return tree
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for _, t, _ in cut])
    got = exchange.all_gather(flat, line)                # (m, bytes)
    out, at = {}, 0
    for p, t, d in cut:
        n = t.numel() * t.element_size()
        parts = [got[r, at:at + n].view(t.dtype).view(t.shape)
                 for r in range(line.num_shards)]
        out[p] = torch.cat(parts, dim=d)
        at += n
    return tree_map_with_path(lambda p, t: out.get(p, t), tree)


@dataclasses.dataclass(frozen=True)
class ProcessStep:
    """The train step on this rank of a process mesh. Calling it takes
    and returns this rank's shards: params under ``in_specs[0]``, the
    optimizer state under ``in_specs[1]`` (moments ZeRO-1 over ``data``),
    the batch under ``in_specs[2]`` (the rank's block, or the whole batch
    where the specs replicate it; a leaf whose batch is not dim 0, the
    VLM's ``positions3``, the rows of the rank's block:
    ``launch.mesh.batch_block``); ``metrics`` are equal on every rank.
    A batch every rank holds whole is computed whole on every
    data-parallel rank and its gradients are not summed."""
    model: Any
    mesh: meshlib.RankMesh
    in_specs: tuple
    out_specs: tuple
    shapes: tuple                # (params, batch) local shapes, checked
    schedule: Callable
    clip_norm: float = 1.0
    weight_decay: float = 0.1

    @property
    def batch_split(self) -> bool:
        bspecs = self.in_specs[2]
        return any(ax is not None for k, spec in bspecs.items()
                   for ax in meshlib.block_spec(k, len(spec), bspecs))

    def _check(self, params, batch):
        got = tree_map(lambda t: tuple(t.shape), (params, batch))
        if got != self.shapes:
            raise ValueError(
                "a process-mesh step takes this rank's shards "
                "(launch.mesh.shard_tree under its in_specs); got leaves "
                f"of shapes {got}, want {self.shapes}")

    def __call__(self, params, opt_state, batch):
        self._check(params, batch)
        mesh = P.batch_mesh(self.mesh, self.batch_split)
        pspecs, ospecs, _ = self.in_specs
        with meshlib.set_mesh(mesh):
            loss, grads = value_and_grad(self.model.loss, params, batch)
        if P.dp_line(mesh) is not None:
            grads = _all_reduce_tree(grads, P.dp_line(mesh))
        grads, gnorm = global_norm_clip(grads, self.clip_norm,
                                        specs=pspecs, mesh=self.mesh)
        lr = self.schedule(opt_state["step"])
        # ZeRO-1: the rank's ``data`` slice of each gradient and param
        data = self.mesh.line("data")
        dims = tree_map(_data_dim, pspecs, ospecs["mu"],
                        is_leaf=meshlib.is_spec)

        def cut(t, d):
            if d is None or data is None:
                return t
            n = t.shape[d] // data.num_shards
            return t.narrow(d, data.rank * n, n)
        new, opt_state = adamw_update(
            tree_map(cut, params, dims), tree_map(cut, grads, dims),
            opt_state, lr=lr, weight_decay=self.weight_decay)
        params = _gather_slices(new, dims, data)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}


def shard_train_step(model, mesh, params_shape, opt_shape, batch_shape,
                     **kw):
    """The train step with explicit specs for ``mesh``: a ``ShardedStep``
    on a logical mesh, a ``ProcessStep`` on a process mesh (every
    family).

    params_shape/opt_shape/batch_shape: trees of tensors or
    ``data.ShapeDtypeStruct`` of the WHOLE leaves (``opt_shape`` is read
    for its structure only, as in the reference). ``kw``: ``schedule``,
    ``clip_norm``, ``weight_decay`` of ``make_train_step``.
    """
    pspecs = meshlib.param_specs(params_shape, mesh)
    zspecs = meshlib.zero1_specs(pspecs, params_shape, mesh)
    ospecs = {"mu": zspecs, "nu": zspecs, "step": ()}
    bspecs = meshlib.batch_specs(batch_shape, mesh)
    if isinstance(mesh, meshlib.RankMesh):
        local_params = tree_map(
            lambda s, t: meshlib.shard_shape(t.shape, s, mesh), pspecs,
            params_shape, is_leaf=meshlib.is_spec)
        local_batch = {k: meshlib.shard_shape(
            t.shape, meshlib.block_spec(k, len(t.shape), bspecs), mesh)
            for k, t in batch_shape.items()}
        schedule = kw.pop("schedule", None) or \
            make_schedule(model.cfg.schedule)
        return ProcessStep(model, mesh, (pspecs, ospecs, bspecs),
                           (pspecs, ospecs), (local_params, local_batch),
                           schedule, **kw)
    return ShardedStep(make_train_step(model, **kw), mesh,
                       (pspecs, ospecs, bspecs), (pspecs, ospecs))


@dataclasses.dataclass
class Trainer:
    """End-to-end training loop with checkpoint/restart (see
    launch/train.py for the CLI). Kept deliberately thin: all state is
    (params, opt_state, step); everything else is a pure function."""
    model: Any
    mesh: Any
    clip_norm: float = 1.0
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000

    def init_state(self, seed: int = 0):
        """(params, optimizer state); on a process mesh, this rank's
        shards of them (every rank draws the whole params from ``seed``
        and keeps its blocks)."""
        params = self.model.init(seed)
        if isinstance(self.mesh, meshlib.RankMesh):
            pspecs = meshlib.param_specs(params, self.mesh)
            zspecs = meshlib.zero1_specs(pspecs, params, self.mesh)
            moments = meshlib.shard_tree(params, zspecs, self.mesh)
            return (meshlib.shard_tree(params, pspecs, self.mesh),
                    adamw_init(moments))
        opt = adamw_init(params)
        return params, opt

    def jitted_step(self, batch_shape=None):
        """The eager step (the name is the reference's; nothing is
        compiled). On a process mesh, the ``ProcessStep`` for batches of
        ``batch_shape`` (the global batch's shapes)."""
        sched = make_schedule(self.model.cfg.schedule,
                              peak_lr=self.peak_lr, warmup=self.warmup,
                              total=self.total_steps)
        if isinstance(self.mesh, meshlib.RankMesh):
            if batch_shape is None:
                raise ValueError("a process-mesh step needs the global "
                                 "batch's shapes (batch_shape=)")
            from repro_torch.launch.dryrun import abstract_params
            _, shapes, _ = abstract_params(self.model.cfg)
            return shard_train_step(self.model, self.mesh, shapes, None,
                                    batch_shape, schedule=sched,
                                    clip_norm=self.clip_norm)
        return make_train_step(self.model, schedule=sched,
                               clip_norm=self.clip_norm)

"""The train step: loss and gradients by autograd, global-norm clip,
AdamW with quantized moments.

The port of the JAX package's ``train.trainer``. The step is one eager
function of (params, opt_state, batch): the gradients of ``model.loss``
(remat applies per layer body, ``models.remat``), global-norm clip, the
schedule's lr at the optimizer's step, then AdamW, out of place. On a
logical mesh (``launch.mesh``) ``shard_train_step`` computes and checks
the reference's spec trees (params TP over ``model``, moments ZeRO-1
over ``data``, the batch over the DP axes) and runs the same step on the
mesh's device: GSPMD runs the same function, so the results are those of
the unsharded step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.tree import (tree_leaves_with_path, tree_map,
                                   tree_map_with_path)
from repro_torch.launch import mesh as meshlib
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


def shard_train_step(model, mesh, params_shape, opt_shape, batch_shape,
                     **kw) -> ShardedStep:
    """The train step with explicit specs for ``mesh``.

    params_shape/opt_shape/batch_shape: trees of tensors or
    ``data.ShapeDtypeStruct`` (``opt_shape`` is read for its structure
    only, as in the reference).
    """
    pspecs = meshlib.param_specs(params_shape, mesh)
    zspecs = meshlib.zero1_specs(pspecs, params_shape, mesh)
    ospecs = {"mu": zspecs, "nu": zspecs, "step": ()}
    bspecs = meshlib.batch_specs(batch_shape, mesh)
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
        params = self.model.init(seed)
        opt = adamw_init(params)
        return params, opt

    def jitted_step(self):
        """The eager step (the name is the reference's; nothing is
        compiled)."""
        sched = make_schedule(self.model.cfg.schedule,
                              peak_lr=self.peak_lr, warmup=self.warmup,
                              total=self.total_steps)
        return make_train_step(self.model, schedule=sched,
                               clip_norm=self.clip_norm)

"""Elastic scaling: resume a run on a different device count / mesh shape.

Scenario: a pod drops out of a (2,16,16) job. The controller rebuilds a
(16,16) mesh, recomputes sharding trees for the SAME tree structure,
reloads the last checkpoint onto the new mesh, and adjusts the data
pipeline's shard count. Checkpoints store whole leaves, so any (old mesh
-> new mesh) transition is a placement.

The port of the JAX package's ``train.elastic``. On a logical mesh
(``launch.mesh.Mesh``) the restore loads every leaf onto the new mesh's
device under the specs the reference computes. On a process mesh
(``launch.mesh.RankMesh``) every rank reads the whole leaves on its host
and keeps its shards under the new mesh's specs (``shard_tree``): the
reference's ``device_put`` of whole leaves, one rank at a time.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core.tree import tree_map
from repro_torch.launch import mesh as meshlib
from repro_torch.train import checkpoint as ckpt


def remesh_plan(params_shape, old_mesh_shape: tuple, new_mesh,
                global_batch: int):
    """Describe the transition; raises if the new topology can't run it."""
    axis = dict(zip(new_mesh.axis_names, new_mesh.devices.shape))
    dp = axis.get("data", 1) * axis.get("pod", 1)
    if global_batch % dp != 0:
        raise ValueError(
            f"global_batch {global_batch} not divisible by new DP={dp}; "
            f"adjust batch or grad-accumulation factor")
    return {
        "old_mesh": tuple(old_mesh_shape),
        "new_mesh": tuple(new_mesh.devices.shape),
        "per_device_batch": global_batch // dp,
        "grad_accum": 1,
    }


def elastic_restore(directory: str, template: Any, new_mesh, *,
                    step: Optional[int] = None):
    """Load the latest checkpoint placed for ``new_mesh``: returns
    (state, manifest_extra, step) as ``load_checkpoint``."""
    pspecs = meshlib.param_specs(template["params"], new_mesh)
    zspecs = meshlib.zero1_specs(pspecs, template["params"], new_mesh)
    if isinstance(new_mesh, meshlib.RankMesh):
        specs = {"params": pspecs,
                 "opt": {"mu": zspecs, "nu": zspecs, "step": ()}}
        host = tree_map(lambda _: None, template)      # whole, on the CPU
        state, extra, step = ckpt.load_checkpoint(directory, host,
                                                  step=step)
        return meshlib.shard_tree(state, specs, new_mesh), extra, step
    zshard = meshlib.named_shardings(new_mesh, zspecs)
    shardings = {
        "params": meshlib.named_shardings(new_mesh, pspecs),
        "opt": {"mu": zshard, "nu": zshard,
                "step": meshlib.NamedSharding(new_mesh, ())},
    }
    return ckpt.load_checkpoint(directory, template, step=step,
                                shardings=shardings)

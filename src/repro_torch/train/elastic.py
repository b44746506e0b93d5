"""Elastic scaling: resume a run on a different device count / mesh shape.

Scenario: a pod drops out of a (2,16,16) job. The controller rebuilds a
(16,16) mesh, recomputes sharding trees for the SAME tree structure,
reloads the last checkpoint onto the new mesh, and adjusts the data
pipeline's shard count. Checkpoints store whole leaves, so any (old mesh
-> new mesh) transition is a placement.

The port of the JAX package's ``train.elastic``. The port's meshes are
logical over one device (``launch.mesh``), so the restore loads every
leaf onto the new mesh's device under the specs the reference computes.
"""
from __future__ import annotations

from typing import Any, Optional

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
    zshard = meshlib.named_shardings(new_mesh, zspecs)
    shardings = {
        "params": meshlib.named_shardings(new_mesh, pspecs),
        "opt": {"mu": zshard, "nu": zshard,
                "step": meshlib.NamedSharding(new_mesh, ())},
    }
    return ckpt.load_checkpoint(directory, template, step=step,
                                shardings=shardings)

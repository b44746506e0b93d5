"""Activation-checkpoint policies for the layer loops.

The port of the JAX package's ``models.remat``: "full" and "dots" both
recompute the layer in the backward (``torch.utils.checkpoint``; torch has
no save-the-matmuls policy to match "dots"), "none" saves everything.
Checkpointing changes what the backward stores, never what the forward
returns, and applies only where autograd records the layer. The
recompute runs under the ambient mesh of the forward
(``launch.mesh.set_mesh``): the backward may run on another thread (a
CUDA device's autograd thread) or after the ``with`` block has closed,
and the MoE layer picks its path from that mesh.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import get_mesh, set_mesh


def wrap_scan_body(body, cfg):
    """Apply the config's remat policy to a layer body function."""
    mode = getattr(cfg, "remat", "full")
    if mode == "none":
        return body

    def remat_body(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        mesh = get_mesh()
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              set_mesh(mesh)))
    return remat_body

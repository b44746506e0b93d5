"""Activation-checkpoint policies for the layer loops.

The port of the JAX package's ``models.remat``: "full" and "dots" both
recompute the layer in the backward (``torch.utils.checkpoint``; torch has
no save-the-matmuls policy to match "dots"), "none" saves everything.
Checkpointing changes what the backward stores, never what the forward
returns, and applies only where autograd records the layer.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def wrap_scan_body(body, cfg):
    """Apply the config's remat policy to a layer body function."""
    mode = getattr(cfg, "remat", "full")
    if mode == "none":
        return body

    def remat_body(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False)
    return remat_body

"""Gradient compression + clipping for cross-pod all-reduce.

int8 block-quantized gradient exchange: each block of 256 values shares an
f32 absmax scale, ~4x less traffic on the gradient all-reduce. Error
feedback (a residual carried to the next step) keeps the compression
unbiased over steps.

The port of the JAX package's ``optim.compress``. ``torch.round`` rounds
half to even, as ``jnp.round`` does, so ``q`` is the reference's bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map

BLOCK = 256


def _quantize(x: torch.Tensor):
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def _pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[0], torch.Tensor)


def compress_grads(grads, residual=None):
    """Returns (compressed pair of trees (q, scale), new_residual)."""
    if residual is None:
        residual = tree_map(torch.zeros_like, grads)
    carried = tree_map(lambda g, r: g + r.to(g.dtype), grads, residual)
    comp = tree_map(_quantize, carried)
    q = tree_map(lambda t: t[0], comp, is_leaf=_pair)
    s = tree_map(lambda t: t[1], comp, is_leaf=_pair)
    decomp = decompress_grads((q, s), grads)
    new_residual = tree_map(lambda c, d: c - d, carried, decomp)
    return (q, s), new_residual


def decompress_grads(comp, like):
    q, s = comp
    return tree_map(lambda qq, ss, g: _dequantize(qq, ss, g.shape, g.dtype),
                    q, s, like)


def _acc(g: torch.Tensor) -> torch.Tensor:
    """``g`` in f32, or float64 for a float64 leaf (the port's float64
    check of a train step; the reference has no float64 model)."""
    return g.to(torch.promote_types(g.dtype, torch.float32))


def _axes(spec) -> tuple:
    """The mesh axes that shard a leaf under ``spec``."""
    names = set()
    for entry in spec:
        if entry is not None:
            names.update((entry,) if isinstance(entry, str) else entry)
    return tuple(sorted(names))


def global_norm_clip(grads, max_norm: float = 1.0, *, specs=None,
                     mesh=None):
    """Scale every leaf by min(1, max_norm / ||grads||); returns
    (clipped grads, the global norm before clipping).

    On a process mesh (``mesh`` a ``launch.mesh.RankMesh``, ``specs`` the
    gradient tree's specs, each leaf the rank's block) each leaf's squared
    norm is summed over the axes that shard it, once: a leaf every rank
    holds whole counts once, not once per rank."""
    from repro_torch.launch.mesh import is_spec
    leaves = tree_leaves(grads)
    keys = [()] * len(leaves) if mesh is None else \
        [_axes(s) for s in tree_leaves(specs, is_leaf=is_spec)]
    parts = {}
    for g, key in zip(leaves, keys):
        sq = torch.sum(torch.square(_acc(g)))
        parts[key] = parts[key] + sq if key in parts else sq
    total = 0
    for key in sorted(parts):                # the same order on every rank
        sq = parts[key]
        for axis in key:
            line = mesh.line(axis)
            if line is not None:
                from repro_torch.distributed import exchange
                sq = exchange.all_reduce(sq, line)
        total = total + sq
    norm = torch.sqrt(total)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (_acc(g) * factor).to(g.dtype), grads), norm

"""Production mesh + sharding rules.

Mesh axes: (pod, data, model).
  data  : DP batch axis (+ ZeRO-1 optimizer-state sharding)
  model : TP for dense kernels, EP(xTP) for experts, vocab axis for the
          embedding table (= the paper's §6.6 address-range partitioning),
          SP for long-context KV caches
  pod   : second DP axis across pods (gradient all-reduce crosses it once
          per step; int8 compression available, optim/compress.py)

The port of the JAX package's ``launch.mesh``. The mesh is *logical*, as
``repro_torch.distributed.mesh``'s: named axes and their sizes over one
torch device, which holds every tensor whole. The rules compute the same
specs as the reference's: a spec is a tuple with one entry per dimension,
an axis name, a tuple of axis names or None, equal entry for entry to the
reference's ``PartitionSpec``. Running a step under them changes no
result (GSPMD runs the same function), so the port checks the specs and
runs the step on the mesh's device. A mesh over more than one CUDA device
needs ``torch.distributed`` and raises ``NotImplementedError``.

``set_mesh`` makes a mesh ambient, as ``jax.sharding.set_mesh`` does; the
MoE layer's expert-parallel path reads it (``models.moe.moe_ffn_auto``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_map, tree_map_with_path

Spec = Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` of ``axis_sizes`` over one ``device``."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got "
                             f"{self.axis_sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def devices(self) -> np.ndarray:
        """The device at every mesh position (all the one device), shaped
        like the mesh, as ``jax.sharding.Mesh.devices``."""
        out = np.empty(self.axis_sizes, dtype=object)
        out.fill(self.device)
        return out

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; a tensor under it lives on ``mesh.device``."""
    mesh: Mesh
    spec: Spec

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str], *,
              device=None, devices: Optional[Sequence] = None) -> Mesh:
    """A logical mesh on ``device`` (None = CUDA). ``devices`` (as
    ``jax.make_mesh`` takes) may name one device only: a mesh over more
    than one CUDA device needs ``torch.distributed``."""
    if devices is not None:
        devs = {torch.device(d) for d in devices}
        if len(devs) > 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} devices needs torch.distributed; "
                "the port's training mesh is logical over one device")
        (device,) = devs
    return Mesh(tuple(int(n) for n in axis_sizes), tuple(axis_names),
                resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A small (data, model) mesh — tests/examples."""
    return make_mesh((data, model), ("data", "model"), device=device)


def batch_axes(mesh: Mesh):
    """The composite DP axis: ('pod','data') on multi-pod meshes."""
    return (("pod", "data") if "pod" in mesh.axis_names else ("data",))


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_mesh() -> Optional[Mesh]:
    """The ambient mesh, or None outside ``set_mesh``."""
    return _AMBIENT.get()


def _sizes(mesh) -> dict:
    """Axis name -> size of a port mesh or of anything with the JAX mesh's
    ``axis_names`` and ``devices.shape``."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def is_spec(x) -> bool:
    """A spec is a tuple: a leaf of a spec tree."""
    return isinstance(x, tuple)


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------
# Keyed by leaf name; the spec applies to the RIGHTMOST dims and is padded
# left with None, so the same rule covers plain and stacked params
# ((L, ...) or (blocks, slots, ...)).

_RULES = {
    # embedding: vocab axis sharded over `model` — DX100 address-range
    # partitioning of the indirect table (§6.6 option 1)
    "embed": ("model", None),
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    # mlp
    "w_gate": (None, "model"), "w_up": (None, "model"),
    "w_down": ("model", None),
    # moe (expert dim over `model`: EP)
    "router": (None, None),
    # mamba
    "in_proj": (None, "model"), "conv_w": (None, "model"),
    "x_proj": ("model", None), "dt_proj": (None, "model"),
    "A_log": ("model", None), "D": ("model",), "out_proj": ("model", None),
    # rwkv
    "wr": (None, "model"), "w_dd": (None, "model"), "u": ("model", None),
    "w_base": (None,), "mix_r": (None,), "mix_k": (None,), "mix_v": (None,),
    "mix_w": (None,),
}

_MOE_RULES = {  # (E, D, F) / (E, F, D): experts over `model`
    "w_gate": ("model", None, None), "w_up": ("model", None, None),
    "w_down": ("model", None, None),
}


def _spec_for(path, leaf) -> Spec:
    names = [str(k) for k in path]
    leafname = names[-1] if names else ""
    rule = None
    if "moe" in names and leafname in _MOE_RULES:
        rule = _MOE_RULES[leafname]
    elif leafname in _RULES:
        rule = _RULES[leafname]
    if rule is None or len(rule) > leaf.ndim:
        return ()                # norms, scalars: replicated
    return (None,) * (leaf.ndim - len(rule)) + tuple(rule)


def param_specs(params, mesh) -> dict:
    """Spec tree for a param tree (divisibility-checked: a dim the axis
    does not divide is replicated)."""
    axis_size = _sizes(mesh)

    def fix(path, leaf):
        spec = _spec_for(path, leaf)
        fixed = []
        for dim, ax in zip(leaf.shape, spec + (None,) * leaf.ndim):
            if ax is not None and dim % axis_size.get(ax, 1) != 0:
                ax = None
            fixed.append(ax)
        return tuple(fixed[:leaf.ndim])

    return tree_map_with_path(fix, params)


def named_shardings(mesh: Mesh, specs):
    """A spec tree as a tree of ``NamedSharding``s on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs,
                    is_leaf=is_spec)


def param_shardings(params, mesh: Mesh):
    return named_shardings(mesh, param_specs(params, mesh))


def zero1_specs(pspecs, params, mesh):
    """Optimizer-moment specs: param spec + ZeRO-1 sharding over `data` on
    the largest still-unsharded, divisible dim."""
    dsize = _sizes(mesh).get("data", 1)

    def add_data(spec, leaf):
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        best, best_dim = None, 0
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
            if ax is None and dim % dsize == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is None:
            return spec
        return spec[:best] + ("data",) + spec[best + 1:]

    return tree_map(add_data, pspecs, params, is_leaf=is_spec)


def _dp(mesh):
    axes = batch_axes(mesh)
    sizes = _sizes(mesh)
    dp = 1
    for a in axes:
        dp *= sizes[a]
    return (axes if len(axes) > 1 else axes[0]), dp


def batch_specs(batch_tree, mesh):
    """Shard every input's leading (batch) dim over the DP axes (replicate
    when the batch doesn't divide, e.g. long_500k's global_batch=1)."""
    ax, dp = _dp(mesh)

    def spec(leaf):
        if leaf.shape and leaf.shape[0] % dp == 0:
            return (ax,) + (None,) * (leaf.ndim - 1)
        return (None,) * leaf.ndim

    return tree_map(spec, batch_tree)


def cache_specs(cache_tree, mesh, batch: int, *,
                seq_shard: bool = False, seq_len: int = 0):
    """KV-cache sharding: the batch dim (located by size) over DP axes;
    optionally the sequence dim over `model` (SP for long-context decode —
    KV layouts are (L, B, S, K, hd)). A Python int (the port's ``"len"``)
    is a 0-d leaf."""
    ax, dp = _dp(mesh)
    model = _sizes(mesh).get("model", 1)

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        s = [None] * len(shape)
        bidx = next((i for i, dim in enumerate(shape) if dim == batch),
                    None)
        if bidx is not None and batch % dp == 0:
            s[bidx] = ax
        if seq_shard and seq_len and bidx is not None:
            for j in range(bidx + 1, len(shape)):
                if shape[j] == seq_len and seq_len % model == 0:
                    s[j] = "model"
                    break
        return tuple(s)

    return tree_map(spec, cache_tree)

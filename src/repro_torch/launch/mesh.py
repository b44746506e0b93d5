"""Production mesh + sharding rules.

Mesh axes: (pod, data, model).
  data  : DP batch axis (+ ZeRO-1 optimizer-state sharding)
  model : TP for dense kernels, EP(xTP) for experts, vocab axis for the
          embedding table (= the paper's §6.6 address-range partitioning),
          SP for long-context KV caches
  pod   : second DP axis across pods (gradient all-reduce crosses it once
          per step; int8 compression available, optim/compress.py)

The port of the JAX package's ``launch.mesh``. Two kinds of mesh:

  Mesh      *logical*, as ``repro_torch.distributed.mesh``'s: named axes
            and their sizes over one torch device, which holds every
            tensor whole. Running a step under the specs changes no
            result (GSPMD runs the same function), so the port checks the
            specs and runs the step on the mesh's device.
  RankMesh  one position per rank of a ``torch.distributed`` group
            (``make_process_mesh``): rank ``r`` sits at the row-major
            coordinates of position ``r``, as ``jax.make_mesh`` orders its
            devices, holds only its shards (``shard_tree``) on its own
            device, and reaches the ranks along each axis through one
            subgroup per axis line (``RankMesh.line``). The train step
            runs SPMD over it (``train.trainer.shard_train_step``).

The rules compute the same specs as the reference's on both: a spec is a
tuple with one entry per dimension, an axis name, a tuple of axis names
or None, equal entry for entry to the reference's ``PartitionSpec``.

``set_mesh`` makes a mesh ambient, as ``jax.sharding.set_mesh`` does; the
MoE layer's expert-parallel path and, on a ``RankMesh``, the layers'
tensor-parallel paths read it (``models.parallel``).
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
    ``jax.make_mesh`` takes) may name one device only: a mesh over several
    devices is one process per device over torch.distributed
    (``make_process_mesh``)."""
    if devices is not None:
        devs = {torch.device(d) for d in devices}
        if len(devs) > 1:
            raise NotImplementedError(
                f"a mesh over {len(devs)} devices runs one process per "
                "device over torch.distributed: call make_process_mesh on "
                "every rank; make_mesh builds a logical mesh over one "
                "device")
        (device,) = devs
    return Mesh(tuple(int(n) for n in axis_sizes), tuple(axis_names),
                resolve_device(device))


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """This rank's place in a mesh whose positions are the ranks of a
    ``torch.distributed`` group.

    ``coords`` this rank's coordinates (row-major position ``rank``),
    ``device`` where its shards live, ``backend`` the group's. ``lines``
    maps an axis name, or the tuple of the data-parallel axes, to the 1-D
    ``distributed.ProcessMesh`` over the ranks that differ from this one
    along those axes only (None where they number one), in the axes'
    composite order."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    rank: int
    backend: str
    coords: Tuple[int, ...]
    lines: dict

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def devices(self) -> np.ndarray:
        """The rank at every mesh position, shaped like the mesh."""
        return np.arange(self.size).reshape(self.axis_sizes)

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (a name or a tuple of names,
        composite in row-major order)."""
        idx = 0
        for a in _names(axes):
            i = self.axis_names.index(a)
            idx = idx * self.axis_sizes[i] + self.coords[i]
        return idx

    def count(self, axes) -> int:
        """The number of positions along ``axes``."""
        return int(np.prod([self.shape[a] for a in _names(axes)]))

    def line(self, axes):
        """The 1-D process mesh along ``axes``; None where it is one rank."""
        return self.lines[_key(axes)]

    @property
    def dp_axes(self) -> tuple:
        return tuple(batch_axes(self))


def _names(axes) -> tuple:
    """An axis entry of a spec (a name or a tuple of names) as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _key(axes):
    """The ``RankMesh.lines`` key of ``axes``: a name, or a tuple of
    several names."""
    return axes if isinstance(axes, str) or len(axes) > 1 else axes[0]


def _line_keys(axis_names) -> list:
    """Every axis, then the composite data-parallel axes where there are
    several: the lines a rank mesh builds, in the order every rank builds
    them."""
    dp = tuple(a for a in ("pod", "data") if a in axis_names)
    return list(axis_names) + ([dp] if len(dp) > 1 else [])


def make_process_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
                      device=None) -> RankMesh:
    """This rank's ``RankMesh`` over the initialised default group; every
    rank calls it, with the same arguments. The mesh's size must be the
    world size. ``device`` defaults to
    this rank's card (``cuda:{LOCAL_RANK}``, or ``rank % device_count``);
    pass ``device="cpu"`` for a gloo group on the CPU. Builds one subgroup
    per line of each axis (and of the composite data-parallel axes), every
    rank all of them in the same order."""
    import torch.distributed as dist
    from repro_torch.distributed.mesh import ProcessMesh, _rank_device
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_process_mesh needs an initialised torch.distributed "
            "group: call torch.distributed.init_process_group first "
            "(torchrun sets the rendezvous variables)")
    sizes = tuple(int(n) for n in axis_sizes)
    names = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(names)} axis names for {len(sizes)} axis "
                         "sizes")
    rank, world = dist.get_rank(), dist.get_world_size()
    if int(np.prod(sizes)) != world:
        raise ValueError(f"a mesh of {sizes} ({int(np.prod(sizes))} "
                         f"positions) over a group of {world} ranks")
    dev = _rank_device(rank) if device is None else resolve_device(device)
    backend = str(dist.get_backend()).lower()
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    ranks = np.arange(world).reshape(sizes)
    lines = {}
    for key in _line_keys(names):
        axes = _names(key)
        dims = [names.index(a) for a in axes]
        n = int(np.prod([sizes[d] for d in dims]))
        if n == 1:
            lines[key] = None
            continue
        rows = np.moveaxis(ranks, dims, range(-len(dims), 0)).reshape(-1, n)
        for row in rows:
            g = dist.new_group(ranks=[int(r) for r in row])
            if rank in row:
                lines[key] = ProcessMesh(g, row.tolist().index(rank), n,
                                         dev, backend, "+".join(axes))
    return RankMesh(sizes, names, dev, rank, backend, coords, lines)


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


# batch leaves whose batch dimension is not dim 0: the VLM's M-RoPE
# position streams, (3, B, S)
BATCH_DIM = {"positions3": 1}


def block_spec(key: str, ndim: int, specs: dict) -> Spec:
    """The spec by which a rank of a process mesh cuts batch leaf ``key``
    out of a batch under ``specs`` (``batch_specs``, the reference's,
    which cut dim 0 of every leaf). A leaf whose batch is dim d > 0
    (``BATCH_DIM``) is cut on d by the data-parallel axes that cut
    ``tokens``, so that it holds the rows of the rank's own tokens: the
    reference's spec replicates it where the DP size does not divide its
    dim 0 (GSPMD then feeds each device the rows it needs)."""
    if key not in BATCH_DIM:
        return specs[key]
    spec = [None] * ndim
    spec[BATCH_DIM[key]] = specs["tokens"][0]
    return tuple(spec)


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


# ---------------------------------------------------------------------------
# a rank's shards of a tree, and back (``RankMesh``)
# ---------------------------------------------------------------------------

def _dims(spec, ndim: int):
    """``(dim, axes)`` of every sharded dimension of a spec."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [(d, ax) for d, ax in enumerate(spec[:ndim]) if ax is not None]


def shard_shape(shape, spec, mesh: RankMesh) -> tuple:
    """The shape of a rank's block of a whole ``shape`` under ``spec``."""
    out = list(shape)
    for d, ax in _dims(spec, len(out)):
        out[d] //= mesh.count(ax)
    return tuple(out)


def shard_of(t: torch.Tensor, spec, mesh: RankMesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``, a new
    contiguous tensor on the mesh's device (never a view of ``t``)."""
    block = t
    for d, ax in _dims(spec, t.ndim):
        n = mesh.count(ax)
        if block.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {ax} ({n})")
        size = block.shape[d] // n
        block = block.narrow(d, mesh.index(ax) * size, size)
    out = torch.empty(tuple(block.shape), dtype=t.dtype, device=mesh.device)
    return out.copy_(block)


def shard_tree(tree, specs, mesh: RankMesh):
    """Every whole leaf of ``tree`` cut to this rank's block under the
    spec tree ``specs`` (an axis tuple such as ``('pod', 'data')`` is the
    composite index), on the mesh's device."""
    return tree_map(lambda s, t: shard_of(torch.as_tensor(t), s, mesh),
                    specs, tree, is_leaf=is_spec)


def batch_block(batch: dict, specs: dict, mesh: RankMesh) -> dict:
    """This rank's block of a batch of whole leaves under ``batch_specs``
    (``block_spec``), on the mesh's device."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = shard_of(t, block_spec(k, t.ndim, specs), mesh)
    return out


def whole_of(t: torch.Tensor, spec, mesh: RankMesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block under
    ``spec``: one all-gather along each sharded dimension."""
    from repro_torch.distributed import exchange
    for d, ax in _dims(spec, t.ndim):
        line = mesh.line(ax)
        if line is not None:
            t = torch.cat(list(exchange.all_gather(t.contiguous(), line)),
                          dim=d)
    return t


def gather_tree(tree, specs, mesh: RankMesh):
    """Whole leaves from this rank's blocks (every rank gets them)."""
    return tree_map(lambda s, t: whole_of(t, s, mesh), specs, tree,
                    is_leaf=is_spec)

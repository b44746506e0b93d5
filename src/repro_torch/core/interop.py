"""NumPy <-> torch hand-off for environments (memory regions) and tiles.

The JAX package keeps regions as arrays of their own dtypes. The port keeps
them as tensors in the containers of ``core.isa.DTYPES``: u32 as int32
holding the same bits, bf16 as ``torch.bfloat16``; with 64-bit types off
(``isa.X64`` false) u64 and i64 as int32 (wrapped) and f64 as float32, with
them on u64 as int64 holding the same bits, i64 as int64, f64 as float64.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.isa import X64

_ISA_NAMES = {
    "uint32": "u32", "int32": "i32", "float32": "f32", "uint64": "u64",
    "int64": "i64", "float64": "f64", "bfloat16": "bf16",
}


def isa_dtype(dtype) -> str:
    """ISA dtype name (``u32``, ``bf16``, ...) of a NumPy dtype."""
    return _ISA_NAMES[np.dtype(dtype).name]


def to_tensor(a, *, device) -> torch.Tensor:
    """One NumPy array as a tensor in the port's container."""
    a = np.asarray(a)
    name = a.dtype.name
    if name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    if name == "uint32" or name in ("uint64", "int64") and not X64:
        # (32-bit wrap, then) the bits as int32
        a = a.astype(np.uint32).view(np.int32)
    elif name == "uint64":
        a = a.view(np.int64)
    elif name == "float64" and not X64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(t: torch.Tensor, dtype=None) -> np.ndarray:
    """A tensor back as NumPy; ``dtype`` (NumPy dtype or ISA name) restores
    the type the container stands for (``uint32`` from int32, a bfloat16
    NumPy dtype from ``torch.bfloat16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy()
        if dtype is not None and not isinstance(dtype, str) and \
                np.dtype(dtype).name == "bfloat16":
            return bits.view(np.dtype(dtype))
        return t.to(torch.float32).numpy()
    a = t.numpy()
    if dtype is None:
        return a
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name in ("u32", "u64", "uint32", "uint64"):
        return a.view(np.uint32 if a.itemsize == 4 else np.uint64)
    return a


def env_from_numpy(env: Mapping, *, device) -> dict:
    """The JAX package's regions (NumPy arrays) -> the port's tensors."""
    return {k: to_tensor(v, device=device) for k, v in env.items()}


def env_to_numpy(env: Mapping, dtypes: Mapping | None = None) -> dict:
    """The port's tensors -> NumPy, restoring ``dtypes[name]`` (NumPy dtype
    or ISA name) where given — ``uint32`` from its int32 container."""
    dtypes = dict(dtypes or {})
    return {k: to_numpy(v, dtypes.get(k)) for k, v in env.items()}


def dtypes_of(env: Mapping) -> dict:
    """ISA dtype names of a NumPy environment, for ``Engine.run(dtypes=)``
    and ``env_to_numpy``."""
    return {k: isa_dtype(np.asarray(v).dtype) for k, v in env.items()}


def params_from_numpy(tree, *, device, dtype=None):
    """A parameter tree of NumPy arrays (the JAX package's pytree of dicts,
    layers stacked on axis 0) as the port's params: the same keys and
    layouts, every leaf a tensor on ``device``. ``dtype`` casts the
    floating-point leaves; None keeps each leaf's own type."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    t = to_tensor(tree, device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


# JAX's indexing rules, for ports of code that indexes with ``x[idx]`` and
# ``x.at[idx]``: torch indexing asserts on the device where JAX wraps,
# clamps or drops


def jax_gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Where ``x[idx]`` reads in JAX: negatives wrap once, then clamp."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def jax_scatter_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Where ``x.at[idx]`` writes in JAX: negatives wrap once; what is
    still outside ``[0, n)`` is dropped (routed to a spare row ``n``)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)

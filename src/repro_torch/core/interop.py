"""NumPy <-> torch hand-off for environments (memory regions) and tiles.

The JAX package keeps regions as arrays of their own dtypes, with 64-bit
types off. The port keeps them as tensors in the containers of
``core.isa.DTYPES``: u32 (and u64, which runs at 32 bits) as int32 holding
the same bits, i64 as int32, f64 as float32, bf16 as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

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
    if name in ("uint32", "uint64", "int64"):
        # 32-bit wrap, then the bits as int32 (x64-off widths)
        a = a.astype(np.uint32).view(np.int32)
    elif name == "float64":
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
        return a.view(np.uint32)
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

"""Canonical index-stream distributions (the paper's microbenchmark
regimes): the port's copy of the JAX package's ``testing.streams``, the
same NumPy draws in the same order, for the sharded parity harness."""
from __future__ import annotations

import numpy as np


def make_indices(rng, n_rows: int, n_idx: int, locality: str) -> np.ndarray:
    """Index distributions matching the paper's microbenchmark regimes."""
    if locality == "sequential":      # all-hits analogue (B[i] = i)
        return (np.arange(n_idx) % n_rows).astype(np.int32)
    if locality == "uniform":         # all-miss, worst row locality
        return rng.integers(0, n_rows, size=n_idx).astype(np.int32)
    if locality == "zipf":            # skewed: high coalescing potential
        return (rng.zipf(1.3, size=n_idx) % n_rows).astype(np.int32)
    if locality == "blocked":         # high row-buffer locality
        base = rng.integers(0, max(n_rows // 64, 1), size=n_idx // 16 + 1)
        idx = (base[:, None] * 64 + rng.integers(0, 64, size=(len(base), 16))
               ).reshape(-1)[:n_idx]
        return np.clip(idx, 0, n_rows - 1).astype(np.int32)
    raise ValueError(locality)

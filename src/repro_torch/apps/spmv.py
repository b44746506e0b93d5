"""SpMV power iteration — the paper's scientific-computing domain (NAS CG).

Iterated sparse matrix-vector products ``x_{k+1} = scale(A @ x_k)`` over a
CSR matrix: the access phase gathers ``x[col[j]]`` for every stored
nonzero (the indirect stream DX100 exists for), the compute phase does the
multiply + per-row reduction + rescale. Pipelined, iteration k+1's gather
is queued while iteration k's reduction may still be running on the
device (``DecoupledLoop.run``).

Bit-exactness by construction: values and iterates are kept
integer-valued and bounded (``val < 8``, ``x < 256``, row nnz capped)
so every f32 product and sum is exact (< 2^24) and therefore
*order-independent* — the per-row reduction (``index_add_``, atomics on
the card) may sum in any order and still match the sequential NumPy
oracle bit for bit, f32 included. The rescale floor-divides by the power
of two 32 and wraps mod 256 — both exact on integer-valued f32 — closing
the loop invariant while keeping the iterates alive. ``dtype="i32"`` runs
the same recurrence in integers (shift + mask instead of floor-divide +
mod). ``d > 1`` makes the gather a 2-D row-table fetch (the row-table
gather kernel on an ``Engine(use_kernel=True)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.apps import _common
from repro_torch.core import bulk_ops
from repro_torch.core.device import synchronize
from repro_torch.pipeline import DecoupledLoop, run_sequential

_SCALE = 32   # power of two: the floor-divide rescale is exact in f32
_MOD = 256    # power of two: iterates wrap into [0, 256)


@dataclasses.dataclass
class SpmvProblem:
    """CSR matrix + start vector (NumPy; ``run`` moves them to device)."""
    indptr: np.ndarray    # (n+1,) int32
    col: np.ndarray       # (nnz,) int32
    val: np.ndarray       # (nnz,) f32/i32, integer-valued in [0, 8)
    x0: np.ndarray        # (n,)   f32/i32, integer-valued in [0, _MOD)

    @property
    def n(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def rows(self) -> np.ndarray:
        """Row id of each stored nonzero (segment ids of the reduction)."""
        return np.repeat(np.arange(self.n, dtype=np.int32),
                         np.diff(self.indptr)).astype(np.int32)


def make_problem(seed: int = 0, *, n: int = 512, avg_nnz: int = 8,
                 d: int = 1, dtype: str = "f32") -> SpmvProblem:
    """Random CSR matrix with the boundedness invariants documented above
    (row nnz <= 32, val in [0, 8), x0 in [0, 256)).

    ``d > 1`` iterates a *block* of vectors (``x0`` shaped (n, d) — the
    PageRank-over-feature-blocks shape): same recurrence per column, and
    the gather becomes a 2-D row-table fetch.
    """
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, min(2 * avg_nnz, 32), size=n)
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(lens)
    nnz = int(indptr[-1])
    col = rng.integers(0, n, size=nnz).astype(np.int32)
    np_dt = np.float32 if dtype == "f32" else np.int32
    val = rng.integers(0, 8, size=nnz).astype(np_dt)
    shape = (n,) if d == 1 else (n, d)
    x0 = rng.integers(0, _MOD, size=shape).astype(np_dt)
    return SpmvProblem(indptr, col, val, x0)


def _rescale(y: torch.Tensor) -> torch.Tensor:
    """x' = floor(y / 32) mod 256 — exact for integer-valued y < 2^24
    (y <= 32 nnz * 7 * 255 < 2^17, so the invariant holds forever)."""
    if y.is_floating_point():
        return torch.remainder(torch.floor(y * (1.0 / _SCALE)), float(_MOD))
    return (y >> int(np.log2(_SCALE))) & (_MOD - 1)


def reference(prob: SpmvProblem, n_iters: int) -> np.ndarray:
    """Sequential NumPy oracle: per-lane products accumulated in index
    order, rescaled per iteration."""
    x = prob.x0.copy()
    rows = prob.rows
    vshape = (-1,) + (1,) * (x.ndim - 1)
    for _ in range(n_iters):
        y = np.zeros(x.shape, x.dtype)
        np.add.at(y, rows, prob.val.reshape(vshape) * x[prob.col])
        if np.issubdtype(x.dtype, np.floating):
            x = np.mod(np.floor(y * (1.0 / _SCALE)), float(_MOD))
        else:
            x = (y >> int(np.log2(_SCALE))) & (_MOD - 1)
    return x


def run(prob: SpmvProblem, n_iters: int, *, mode: str = "pipelined",
        service=None, mesh=None, device=None) -> np.ndarray:
    """Run ``n_iters`` iterations; returns the final vector (NumPy).

    mode:
      "eager"      direct bulk_gather + compute, hard barrier per phase
      "sequential" scheduler-submitted access, barrier per phase (the
                   pipeline's baseline)
      "pipelined"  DecoupledLoop: iteration k+1's gather is queued while
                   iteration k's reduction may still run on the device
    service: an ``AccessService`` to share (default: a private one on
    ``device``, ``None`` = CUDA); its engine's device is used. mesh: must
    be None (ROADMAP A11).
    """
    service, dev = _common.placement(mode, service, mesh, device)
    col = torch.as_tensor(prob.col, device=dev)
    val = torch.as_tensor(prob.val, device=dev)
    rows = torch.as_tensor(prob.rows, device=dev).long()
    x = torch.as_tensor(prob.x0, device=dev)
    vshape = (-1,) + (1,) * (x.ndim - 1)

    def compute_y(xg):
        return torch.zeros_like(x).index_add_(0, rows,
                                              val.reshape(vshape) * xg)

    if mode == "eager":
        for _ in range(n_iters):
            xg = bulk_ops.bulk_gather(x, col, device=dev)
            x = _rescale(compute_y(xg))
            synchronize(dev)
        return x.cpu().numpy()

    def access(loop, k, state):
        return loop.submit_gather(state, col)

    def compute(k, state, xg):
        return _rescale(compute_y(xg))

    if mode == "sequential":
        x = run_sequential(service, x, n_iters, access, compute)
    else:
        x = DecoupledLoop(service).run(x, n_iters, access, compute)
    return x.cpu().numpy()


def demo(seed: int = 0, *, mode: str = "pipelined", mesh=None,
         n_iters: int = 6, service=None, device=None) -> np.ndarray:
    return run(make_problem(seed), n_iters, mode=mode, mesh=mesh,
               service=service, device=device)


def demo_reference(seed: int = 0, *, n_iters: int = 6) -> np.ndarray:
    return reference(make_problem(seed), n_iters)

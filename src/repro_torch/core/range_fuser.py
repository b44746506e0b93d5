"""Range Fuser unit (paper §3.4, Fig. 5).

Flattens many short range loops — ``for i: for j in [lo[i], hi[i])`` — into
one bulk (i, j) stream so the Indirect unit sees a full tile of future
accesses. This is CSR row expansion: graph frontiers (GAP), UME zone->point
ranges, and NAS CG row loops are all this shape (Table 1).

Static output capacity (the tile size) + a validity count, implemented with
cumsum + searchsorted.
"""
from __future__ import annotations

import torch


def fuse_ranges(lo: torch.Tensor, hi: torch.Tensor, *, capacity: int,
                cond: torch.Tensor | None = None):
    """Fuse range loops into bulk (outer_i, inner_j) streams.

    Args:
      lo, hi: (n,) integer range boundaries per outer iteration
              (e.g. H[K[i]] and H[K[i]+1]).
      capacity: static output tile capacity.
      cond: optional (n,) bool condition tile (TC operand).

    Returns:
      (outer, inner, total): each (capacity,) int32, plus scalar total count
      (clamped to ``capacity``). For p < total: outer[p] = i of the p-th
      fused iteration, inner[p] = j value; entries past the total are 0.
    """
    dev = lo.device
    if lo.shape[0] == 0:
        # zero outer iterations (an empty BFS frontier): all-invalid output
        z = torch.zeros((capacity,), dtype=torch.int32, device=dev)
        return z, z.clone(), torch.zeros((), dtype=torch.int32, device=dev)
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    lens = (hi - lo).clamp(min=0)
    if cond is not None:
        lens = torch.where(cond, lens, 0)
    offs = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                      torch.cumsum(lens, 0)])                     # (n+1,)
    total = offs[-1]
    p = torch.arange(capacity, dtype=torch.int64, device=dev)
    outer = torch.searchsorted(offs, p, right=True) - 1
    outer = outer.clamp(0, lo.shape[0] - 1)
    inner = lo[outer] + (p - offs[outer])
    valid = p < total
    return (torch.where(valid, outer, 0).to(torch.int32),
            torch.where(valid, inner, 0).to(torch.int32),
            torch.clamp(total, max=capacity).to(torch.int32))


def fused_valid_mask(total: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.arange(capacity, dtype=torch.int32,
                        device=total.device) < total

"""Wrapper: coalesced (sorted-unique) RMW -> row-table kernel."""
from __future__ import annotations

import torch

from repro_torch.core.isa import rmw_identity
from repro_torch.core.reorder import make_row_table_plan
from repro_torch.kernels.scatter_rmw import ref as _ref
from repro_torch.kernels.scatter_rmw import scatter_rmw as _k


def plan_updates(n: int, dest: torch.Tensor, vals: torch.Tensor, *,
                 op: str, block_rows: int, lanes: int,
                 unsigned: bool = False):
    """Plan ``table[dest[u]] op= vals[u]`` on an ``n``-row table padded to
    ``block_rows``: out-of-range entries get the op identity and a clamped
    destination, and the values are permuted into plan order (invalid lanes
    take the identity). Returns ``(plan, v_planned)``."""
    lane_shape = (-1,) + (1,) * (vals.ndim - 1)
    ident = rmw_identity(op, vals.dtype, unsigned=unsigned)
    ok = (dest >= 0) & (dest < n)
    vals = torch.where(ok.view(lane_shape), vals, ident)
    # neutralised lanes keep the stream sorted: negatives (stream head)
    # clamp to row 0, pads/overshoots (stream tail) to the last row
    dest_c = torch.where(dest < 0, 0, torch.where(dest < n, dest, n - 1))
    n_pad = -(-n // block_rows) * block_rows
    plan = make_row_table_plan(dest_c, n_rows=n_pad, block_rows=block_rows,
                               lanes=lanes)
    v_planned = vals[plan.src_pos.reshape(-1)]
    v_planned = torch.where(plan.valid.reshape(lane_shape), v_planned, ident)
    return plan, v_planned


def row_table_rmw(table: torch.Tensor, dest: torch.Tensor,
                  vals: torch.Tensor, *, op: str = "ADD",
                  block_rows: int = 512, lanes: int = 128,
                  use_ref: bool = False,
                  unsigned: bool = False) -> torch.Tensor:
    """table[dest[u]] op= vals[u] for unique, *sorted* dest.

    Stores drop (the repo-wide OOB policy): entries with dest outside
    ``[0, n)`` — scatter padding, empty-segment markers, negative or
    overshooting destinations — are neutralised with the RMW identity.
    Returns the updated table; ``table`` itself is not modified (the kernel
    updates a padded copy this function owns). ``use_ref`` runs the plain
    PyTorch version on any device (the CPU always runs it).
    """
    n = table.shape[0]
    plan, v_planned = plan_updates(n, dest, vals.to(table.dtype), op=op,
                                   block_rows=block_rows, lanes=lanes,
                                   unsigned=unsigned)
    padded = table.new_empty((plan.num_blocks * block_rows,)
                             + tuple(table.shape[1:]))
    padded[:n] = table
    padded[n:] = 0
    args = (padded, plan.tile_block, plan.tile_first.to(torch.int32),
            plan.offsets, v_planned)
    kw = dict(block_rows=block_rows, lanes=lanes, op=op, unsigned=unsigned)
    out = _ref.row_table_rmw_ref_(*args, **kw) if use_ref \
        else _k.row_table_rmw_(*args, **kw)
    return out[:n]

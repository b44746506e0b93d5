"""Wrapper: RowTablePlan -> kernel call (+ padding management)."""
from __future__ import annotations

import torch

from repro_torch.core.reorder import RowTablePlan
from repro_torch.kernels.gather import gather as _k
from repro_torch.kernels.gather import ref as _ref


def _pad_table(table: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Zero-pad the rows to a multiple of ``block_rows`` (a new tensor;
    the table itself when no padding is needed)."""
    rem = (-table.shape[0]) % block_rows
    if rem:
        table = torch.cat([table, table.new_zeros(
            (rem,) + tuple(table.shape[1:]))])
    return table


def row_table_gather(table: torch.Tensor, plan: RowTablePlan, *,
                     use_ref: bool = False) -> torch.Tensor:
    """Execute a planned gather. Returns (num_tiles*lanes, D) packed rows.

    ``use_ref`` runs the plain PyTorch version on any device (the CPU
    always runs it)."""
    table = _pad_table(table, plan.block_rows)
    if use_ref:
        return _ref.row_table_gather_ref(
            table, plan.tile_block, plan.offsets,
            block_rows=plan.block_rows, lanes=plan.lanes)
    return _k.row_table_gather(
        table, plan.tile_block, plan.offsets,
        block_rows=plan.block_rows, lanes=plan.lanes)

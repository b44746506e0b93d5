"""Plain PyTorch version of the row-table scatter-RMW kernel."""
from __future__ import annotations

import torch

from repro_torch.core.bulk_ops import _reduce_into, _segment_bitwise
from repro_torch.core.isa import RMW_OPS


def row_table_rmw_ref_(table: torch.Tensor, tile_block: torch.Tensor,
                       tile_first: torch.Tensor, offsets: torch.Tensor,
                       vals: torch.Tensor, *, block_rows: int, lanes: int,
                       op: str = "ADD", unsigned: bool = False
                       ) -> torch.Tensor:
    """Sequential semantics of the kernel, **in place** like the kernel's
    wrapper: every lane, padded ones included, updates
    ``table[tile_block[t]*block_rows + offsets[t, l]]`` with
    ``vals[t*lanes + l]``; duplicate rows accumulate. Stores drop (the
    repo-wide OOB policy): rows outside the table are discarded. ``table``
    is updated and returned; pass a copy you own.

    Covers all of RMW_OPS (AND/OR/XOR too, which the kernel takes);
    ``unsigned`` marks u32 containers for MIN/MAX. ``tile_first`` is not
    needed here and is taken for signature parity with the kernel.
    """
    del tile_first
    if op not in RMW_OPS:
        raise ValueError(f"op {op!r} is not a legal IRMW op")
    n = table.shape[0]
    num_tiles = tile_block.shape[0]
    rows = (tile_block[:, None].to(torch.int64) * block_rows
            + offsets).reshape(-1)
    keep = (rows >= 0) & (rows < n)
    v = vals.reshape((num_tiles * lanes,) + tuple(table.shape[1:]))[keep]
    rows = rows[keep]
    if op in ("AND", "OR", "XOR"):
        red = _segment_bitwise(v, rows, n, op)
        return {"AND": table.bitwise_and_, "OR": table.bitwise_or_,
                "XOR": table.bitwise_xor_}[op](red)
    out = _reduce_into(table, rows, v, op, unsigned)
    return out if out is table else table.copy_(out)

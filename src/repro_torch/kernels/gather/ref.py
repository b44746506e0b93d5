"""Plain PyTorch version of the row-table gather kernel."""
from __future__ import annotations

import torch


def row_table_gather_ref(table: torch.Tensor, tile_block: torch.Tensor,
                         offsets: torch.Tensor, *, block_rows: int,
                         lanes: int) -> torch.Tensor:
    """out[t*lanes + l] = table[tile_block[t]*block_rows + offsets[t, l]].

    Equals the kernel bit for bit, padded lanes included (they read offset
    0 of the tile's block). Loads clamp (the repo-wide OOB policy): a row
    outside the table reads the nearest valid row instead of wrapping."""
    num_tiles = tile_block.shape[0]
    rows = tile_block[:, None].to(torch.int64) * block_rows + offsets
    rows = rows.clamp(0, table.shape[0] - 1)
    return table[rows.reshape(-1)].reshape(
        (num_tiles * lanes,) + tuple(table.shape[1:]))

"""Row-table gather kernel (Indirect Access unit, paper §3.2) for Hopper.

Wraps ``csrc/row_table_gather.cu`` (see the note there for the design):
each plan tile serves up to ``lanes`` rows of ONE table block; the
``tile_block`` array *is* the Row Table and ``offsets`` the Word Table.

``row_table_gather`` takes the plain PyTorch version (``ref.py``) for CPU
tensors and launches the CUDA kernel for CUDA tensors; a CUDA tensor never
falls back to the plain version. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather import ref as _ref

SOURCE = "row_table_gather.cu"
launches = 0


def _check(table, tile_block, offsets, *, block_rows: int, lanes: int):
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D (N, D), got {tuple(table.shape)}")
    n = table.shape[0]
    if n % block_rows:
        raise ValueError(f"table rows {n} are not a multiple of "
                         f"block_rows={block_rows}: pad first (ops.py)")
    num_tiles = tile_block.shape[0]
    if tuple(offsets.shape) != (num_tiles, lanes):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != "
                         f"({num_tiles}, {lanes})")
    for name, t in (("tile_block", tile_block), ("offsets", offsets)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")


def _launch(table, tile_block, offsets, *, block_rows: int, lanes: int):
    import ctypes

    from repro_torch.kernels import build
    if table.element_size() not in (2, 4, 8):
        raise TypeError(f"unsupported element size {table.element_size()} "
                        f"({table.dtype})")
    for name, t in (("table", table), ("tile_block", tile_block),
                    ("offsets", offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_tiles = tile_block.shape[0]
    out = torch.empty((num_tiles * lanes, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    lib = build.library(SOURCE)
    fn = lib.dx_row_table_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(table.data_ptr(), tile_block.data_ptr(), offsets.data_ptr(),
                out.data_ptr(), table.shape[0],
                table.shape[1] * table.element_size(), num_tiles, block_rows,
                lanes, build.current_stream(table.device))
    build.check(lib, status, "row_table_gather launch")
    if num_tiles:
        global launches
        launches += 1
    return out


def row_table_gather(table: torch.Tensor, tile_block: torch.Tensor,
                     offsets: torch.Tensor, *, block_rows: int,
                     lanes: int) -> torch.Tensor:
    """Gather planned by a row table.

    Args:
      table:      (N, D) — N % block_rows == 0 after padding by the wrapper.
      tile_block: (num_tiles,) int32 block id per plan tile.
      offsets:    (num_tiles, lanes) int32 word offsets within the block.
    Returns:
      (num_tiles * lanes, D) packed rows in plan order.
    """
    _check(table, tile_block, offsets, block_rows=block_rows, lanes=lanes)
    if table.device.type == "cpu":
        return _ref.row_table_gather_ref(table, tile_block, offsets,
                                         block_rows=block_rows, lanes=lanes)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    return _launch(table, tile_block, offsets, block_rows=block_rows,
                   lanes=lanes)

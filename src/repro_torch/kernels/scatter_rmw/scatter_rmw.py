"""Row-table scatter-RMW kernel (Indirect Access unit, store/RMW path).

Dual of the gather kernel: destinations arrive sorted and pre-reduced (the
engine's coalesce stage leaves at most one update per row), so most rows
have one writer in their block's run and are updated by whichever warp
streams their values; the few rows with several writers (a block's offset
0, clamped and empty-segment lanes) are updated by one warp per block, in
plan order — the paper's exclusive-writer bulk-store pipeline. Wraps
``csrc/row_table_rmw.cu`` (see the note there for the design).

``row_table_rmw_`` updates its ``table`` argument in place and returns it;
callers pass a copy they own (``ops.row_table_rmw`` does). It takes the
plain PyTorch version (``ref.py``) for CPU tensors and launches the CUDA
kernel for CUDA tensors, with no fallback. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.isa import RMW_OPS
from repro_torch.kernels.scatter_rmw import ref as _ref

SOURCE = "row_table_rmw.cu"
OP_CODES = {"ADD": 0, "MIN": 1, "MAX": 2, "AND": 3, "OR": 4, "XOR": 5,
            "MUL": 6}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_U32_CODE = 3
launches = 0


def _check(table, tile_block, tile_first, offsets, vals, *, block_rows: int,
           lanes: int, op: str, unsigned: bool):
    if op not in RMW_OPS:
        raise ValueError(f"op {op!r} is not a legal IRMW op ({RMW_OPS})")
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D (N, D), got {tuple(table.shape)}")
    n, d = table.shape
    if n % block_rows:
        raise ValueError(f"table rows {n} are not a multiple of "
                         f"block_rows={block_rows}: pad first (ops.py)")
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported table dtype {table.dtype}")
    if unsigned and table.dtype != torch.int32:
        raise TypeError("unsigned=True needs an int32 (u32 container) table")
    if op in ("AND", "OR", "XOR") and table.is_floating_point():
        raise ValueError(f"bitwise RMW {op} requires an integer table, "
                         f"got {table.dtype}")
    num_tiles = tile_block.shape[0]
    if tuple(tile_first.shape) != (num_tiles,) or \
            tuple(offsets.shape) != (num_tiles, lanes):
        raise ValueError("plan arrays disagree on (num_tiles, lanes)")
    if tuple(vals.shape) != (num_tiles * lanes, d) or \
            vals.dtype != table.dtype:
        raise ValueError(f"vals must be ({num_tiles * lanes}, {d}) "
                         f"{table.dtype}, got {tuple(vals.shape)} "
                         f"{vals.dtype}")
    for name, t in (("tile_block", tile_block), ("tile_first", tile_first),
                    ("offsets", offsets)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("tile_block", tile_block), ("tile_first", tile_first),
                    ("offsets", offsets), ("vals", vals)):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")


def _launch(table, tile_block, tile_first, offsets, vals, *,
            block_rows: int, lanes: int, op: str, unsigned: bool):
    import ctypes

    from repro_torch.kernels import build
    for name, t in (("table", table), ("tile_block", tile_block),
                    ("tile_first", tile_first), ("offsets", offsets),
                    ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_tiles = tile_block.shape[0]
    # one bit per lane for the kernel's streaming pass (left for the chains
    # pass or not), in 32-bit words; dropping it after the launch is safe:
    # the caching allocator reuses a freed block only in the order of its
    # stream
    scratch = torch.empty((-(-num_tiles * lanes // 32),), dtype=torch.int32,
                          device=table.device)
    lib = build.library(SOURCE)
    fn = lib.dx_row_table_rmw
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dtype_code = _U32_CODE if unsigned else _DTYPE_CODES[table.dtype]
    status = fn(table.data_ptr(), tile_block.data_ptr(),
                tile_first.data_ptr(), offsets.data_ptr(), vals.data_ptr(),
                scratch.data_ptr(), table.shape[0], table.shape[1],
                num_tiles, block_rows, lanes, dtype_code, OP_CODES[op],
                build.current_stream(table.device))
    build.check(lib, status, f"row_table_rmw launch (op={op})")
    if num_tiles:
        global launches
        launches += 1


def row_table_rmw_(table: torch.Tensor, tile_block: torch.Tensor,
                   tile_first: torch.Tensor, offsets: torch.Tensor,
                   vals: torch.Tensor, *, block_rows: int, lanes: int,
                   op: str = "ADD", unsigned: bool = False) -> torch.Tensor:
    """Apply planned RMW updates block by block, **in place**: ``table`` is
    updated and returned. Pass a copy you own (``ops.row_table_rmw`` does).

    Args:
      table:      (N, D), N % block_rows == 0; f32, bf16 or int32.
      tile_block: (num_tiles,) int32 — the row table, each block in one run.
      tile_first: (num_tiles,) int32 — 1 where a tile opens its block.
      offsets:    (num_tiles, lanes) int32 within-block destinations,
                  laid out as ``make_row_table_plan`` lays out a sorted
                  stream: within a block's run the valid offsets do not
                  decrease and the padded lanes follow them at offset 0.
      vals:       (num_tiles * lanes, D) update rows in plan order; padded
                  lanes must hold the RMW identity.
      unsigned:   the int32 table holds u32 bits (MIN/MAX compare
                  unsigned).
    """
    _check(table, tile_block, tile_first, offsets, vals,
           block_rows=block_rows, lanes=lanes, op=op, unsigned=unsigned)
    if table.device.type == "cpu":
        return _ref.row_table_rmw_ref_(
            table, tile_block, tile_first, offsets, vals,
            block_rows=block_rows, lanes=lanes, op=op, unsigned=unsigned)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    _launch(table, tile_block, tile_first, offsets, vals,
            block_rows=block_rows, lanes=lanes, op=op, unsigned=unsigned)
    return table

"""repro_torch.core — DX100 as a composable PyTorch module.

Public API (the counterparts of ``repro.core``'s):
  isa           the 8-instruction ISA + AccessProgram
  Engine        program executor (runs on CUDA unless told otherwise)
  bulk_gather / bulk_scatter / bulk_rmw   functional bulk-access ops
  fuse_ranges   range fuser
  compile_pattern / Pattern / ...         compiler passes
  reorder       sort / coalesce / row-table plan / interleave primitives
  interop       NumPy <-> tensor hand-off with the u32 container
  Scheduler     shared multi-tenant frontend (plan IR, fused windows)
"""
from repro_torch.core import interop, isa, reorder
from repro_torch.core.bulk_ops import (bulk_gather, bulk_rmw, bulk_scatter,
                                       segment_combine)
from repro_torch.core.compiler import (Access, BinOp, Compare, LegalityError,
                                       Load, Pattern, RangeLoop, Var,
                                       compile_pattern, run_tiled)
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import (BatchUnsupported, Engine,
                                     TracedExecutable, structural_signature)
from repro_torch.core.range_fuser import fuse_ranges
from repro_torch.core.reorder import (RowTablePlan, coalesce,
                                      coalesce_streams, coalescing_factor,
                                      cross_stream_gain, make_row_table_plan,
                                      sort_indices)
from repro_torch.core.scheduler import (FailedResult, FlushHandle,
                                        FlushReport, Scheduler, Ticket)

__all__ = [
    "isa", "reorder", "interop", "Engine", "bulk_gather", "bulk_scatter",
    "bulk_rmw", "segment_combine", "fuse_ranges", "compile_pattern",
    "Pattern", "Access", "Load", "BinOp", "Compare", "RangeLoop", "Var",
    "LegalityError", "run_tiled", "RowTablePlan", "coalesce",
    "coalescing_factor", "make_row_table_plan", "sort_indices",
    "coalesce_streams", "cross_stream_gain", "TracedExecutable",
    "structural_signature", "resolve_device", "BatchUnsupported",
    "Scheduler", "Ticket", "FlushReport", "FlushHandle", "FailedResult",
]

"""Window hazard detector: order-dependence checks over a pending leaf set.

The scheduler is free to reorder, fuse and shard everything inside one
flush window (§3.1 reorder freedom) — which is only sound when the
window's accesses commute. ``scan_window`` inspects the lowered leaves
of a window and reports the ways they can fail to:

  DX010  ERROR  two different RMW ops against one table (ADD then MAX
                is not the same as MAX then ADD)
  DX011  WARN   gather and RMW on one table (defined — gathers read the
                window-initial snapshot — but order-sensitive if the
                caller expected read-after-write)
  DX012  ERROR  differently-shaped program launches (distinct group
                keys) each writing one caller array — batch waves
                decide who writes last
  DX013  WARN   a program-written caller array is also touched by some
                other leaf in the window
  DX020  WARN   floating-point ADD/MUL RMW: reordering the reduction
                changes rounding (tolerance-only reproducible)

This scan runs on *every* lowering (inside ``Scheduler._lower_pending``,
riding the fingerprint cache), so it must stay O(leaves): leaf table
identity and shallow instruction scans by region name only (the JAX
package's interval analyzer, ``analysis.program``, is lint/test-time work
and is not on the flush path). Diagnostics aggregate to one per (code,
table), collecting the tenants and tickets involved.

Same-``group_key`` program launches are exempt from DX012/DX013 among
themselves: structurally identical launches over one array are the
normal tiled-execution idiom (``run_tiled``), ordered by the batch pass.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.analysis import diagnostics as diag
from repro_torch.analysis.diagnostics import HazardError  # noqa: F401  (re-export)
from repro_torch.core import isa
from repro_torch.plan import nodes


def _is_float(table) -> bool:
    if isinstance(table, torch.Tensor):
        return table.is_floating_point()
    try:
        dt = np.dtype(table.dtype)
    except (TypeError, AttributeError):
        return False
    return dt.kind == "f" or dt.name == "bfloat16"


def _label(table_id: int, rows: int) -> str:
    return f"0x{table_id:x}/rows={rows}"


def _who(leaves):
    tenants = sorted({lf.ticket.tenant for lf in leaves})
    tids = tuple(sorted(lf.ticket.tid for lf in leaves))
    return tenants, tids


def scan_window(leaves) -> tuple:
    """-> tuple of ``Diagnostic`` for one window's leaf set (fair order).

    Leaves already marked failed (``.error``) are skipped — they never
    execute, so they cannot race anything.
    """
    readers: dict = {}            # table_id -> [GatherNode]
    rmws: dict = {}               # table_id -> OrderedDict(op -> [RmwNode])
    meta: dict = {}               # table_id -> (rows, is_float)
    prog_writes: dict = {}        # caller array id -> [(leaf, base)]
    prog_reads: dict = {}         # caller array id -> [(leaf, base)]

    for leaf in leaves:
        if getattr(leaf, "error", None) is not None:
            continue
        if isinstance(leaf, nodes.GatherNode):
            readers.setdefault(leaf.table_id, []).append(leaf)
            meta.setdefault(leaf.table_id,
                            (leaf.table_rows, _is_float(leaf.table)))
        elif isinstance(leaf, nodes.RmwNode):
            by_op = rmws.setdefault(leaf.table_id, OrderedDict())
            by_op.setdefault(leaf.op, []).append(leaf)
            meta.setdefault(leaf.table_id,
                            (leaf.table_rows, _is_float(leaf.table)))
        elif isinstance(leaf, nodes.ProgramNode):
            # shallow name-only scan: which caller arrays does this
            # launch write (IST/IRMW/SST) or read (ILD/SLD)?
            for ins in leaf.program.instrs:
                base = getattr(ins, "base", None)
                if base is None:
                    continue
                aid = leaf.src_ids.get(base)
                if aid is None:
                    continue
                sink = (prog_writes
                        if isinstance(ins, (isa.IST, isa.IRMW, isa.SST))
                        else prog_reads)
                entries = sink.setdefault(aid, [])
                if not any(lf is leaf and b == base for lf, b in entries):
                    entries.append((leaf, base))

    out = []

    # DX010: mixed RMW ops on one table
    for tid, by_op in rmws.items():
        if len(by_op) > 1:
            involved = [lf for lst in by_op.values() for lf in lst]
            tenants, tks = _who(involved)
            rows, _ = meta[tid]
            out.append(diag.make(
                "DX010",
                f"RMW ops {tuple(by_op)} mixed on one table in one "
                f"window: the combined update is order-dependent",
                table=_label(tid, rows), tenants=tenants, tids=tks))

    # DX011: gather + RMW on one table
    for tid in readers:
        if tid in rmws:
            involved = readers[tid] + [lf for lst in rmws[tid].values()
                                       for lf in lst]
            tenants, tks = _who(involved)
            rows, _ = meta[tid]
            out.append(diag.make(
                "DX011",
                "gather and RMW target one table in one window; the "
                "gather reads the window-initial snapshot",
                table=_label(tid, rows), tenants=tenants, tids=tks))

    # DX020: float ADD/MUL RMW
    for tid, by_op in rmws.items():
        rows, is_float = meta[tid]
        hot = [lf for op in ("ADD", "MUL") for lf in by_op.get(op, ())]
        if is_float and hot:
            tenants, tks = _who(hot)
            ops = sorted({lf.op for lf in hot})
            out.append(diag.make(
                "DX020",
                f"floating-point {'/'.join(ops)} RMW: lane order is "
                "scheduler-chosen, so results reproduce only to "
                "tolerance",
                table=_label(tid, rows), tenants=tenants, tids=tks))

    # DX012/DX013: program-written caller arrays
    for aid, writers in prog_writes.items():
        keys = {lf.group_key for lf, _ in writers}
        base = writers[0][1]
        if len(keys) > 1:
            involved = [lf for lf, _ in writers]
            tenants, tks = _who(involved)
            out.append(diag.make(
                "DX012",
                f"{len(writers)} differently-shaped program launches all "
                f"write region {base!r} (one caller array): batch-wave "
                "order decides the final contents",
                table=base, tenants=tenants, tids=tks))
        others = []
        others += [lf for lf, _ in prog_reads.get(aid, ())
                   if lf.group_key not in keys]
        others += [lf for lf in readers.get(aid, ())]
        others += [lf for by_op in ([rmws[aid]] if aid in rmws else ())
                   for lst in by_op.values() for lf in lst]
        if others:
            involved = [lf for lf, _ in writers] + others
            tenants, tks = _who(involved)
            out.append(diag.make(
                "DX013",
                f"region {base!r} is written by a program and also "
                "touched by another leaf in the same window; snapshot "
                "semantics apply",
                table=base, tenants=tenants, tids=tks))

    return tuple(out)

"""High-level bulk access ops: the functional API models use directly.

Each op applies the paper's pipeline — reorder (sort), coalesce (dedup),
interleave (block-sequential access) — before touching memory:

  bulk_gather       C[i] = A[B[i]]          (ILD)
  bulk_scatter      A[B[i]] = C[i]          (IST; duplicate policy = last)
  bulk_rmw          A[B[i]] op= C[i]        (IRMW; op in RMW_OPS)

Tables may be 1-D (engine/scalar use) or 2-D row tables (embeddings, KV
pages, expert buffers). 2-D paths can use the hand-written row-table CUDA
kernels (``use_kernel=True``); 1-D paths use plain PyTorch ops.
``optimize=False`` gives the naive baselines.

Every op runs on ``device`` (``None`` = ``"cuda"``, see ``core.device``);
inputs elsewhere are moved there. No op mutates its inputs: results are new
tensors (or the table itself when there is nothing to do).

Out-of-range index policy: **loads clamp, stores drop**. ``bulk_gather``
clamps every index into ``[0, n-1]`` on every path; ``bulk_scatter`` and
``bulk_rmw`` drop negative and ``>= n`` destinations on every path. Stores
route dropped lanes to a spare row ``n`` of a working copy, which is cut off
before returning — no boolean masking, so no host synchronisation.

u32 (u64) tables are int32 (int64) containers; ``unsigned=True`` makes
MIN/MAX compare them unsigned (see ``core.isa``).
"""
from __future__ import annotations

import torch

from repro_torch.core import reorder
from repro_torch.core.device import on, resolve_device
from repro_torch.core.isa import (alu_apply, convert, flip_sign, kind_of,
                                  rmw_identity, to_u64, wrap32)

_REDUCE = {"MIN": "amin", "MAX": "amax", "MUL": "prod"}
_BITWISE_OPS = ("AND", "OR", "XOR")
_INT32_MIN = -(2 ** 31)


def _as_index(idx: torch.Tensor) -> torch.Tensor:
    """``astype(int32)``: float indices saturate as XLA's convert does."""
    if idx.dtype == torch.int32:
        return idx
    if idx.is_floating_point():
        return convert(idx, kind_of(idx), "i32")
    return idx.to(torch.int32)


def _lane_shape(x: torch.Tensor, ndim: int):
    return (-1,) + (1,) * (ndim - 1)


def _with_spare_row(table: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with one zero row appended at index n, where
    dropped lanes land."""
    return torch.cat([table, torch.zeros_like(table[:1])])


def _segment_bitwise(vals, seg, num_segments: int, op: str):
    """Per-bit segment reduction for AND/OR/XOR (integer containers).

    Bits are extracted in int64: AND per bit holds where a segment has no
    zero bit, OR where it has a one bit, XOR is the parity of its one bits.
    Empty segments come out as the op identity, mirroring ``rmw_identity``.
    """
    if vals.is_floating_point():
        raise ValueError(f"bitwise RMW {op} requires an integer table, "
                         f"got {vals.dtype}")
    wide = vals.dtype == torch.int64
    u = vals if wide else to_u64(vals)
    seg = seg.to(torch.int64)
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                      dtype=torch.int64, device=vals.device)
    for b in range(64 if wide else 32):
        bit = (u >> b) & 1
        if op == "AND":
            cnt = torch.zeros_like(out).index_add_(0, seg, 1 - bit)
            rb = cnt == 0
        else:
            cnt = torch.zeros_like(out).index_add_(0, seg, bit)
            rb = cnt > 0 if op == "OR" else (cnt & 1) == 1
        out |= rb.to(torch.int64) << b
    return out if wide else wrap32(out)


def _reduce_into(out: torch.Tensor, index: torch.Tensor, vals: torch.Tensor,
                 op: str, unsigned: bool) -> torch.Tensor:
    """``out[index[i]] = op(out[index[i]], vals[i])`` for ADD/MIN/MAX/MUL
    with duplicate indices (returns a new tensor for MIN/MAX/MUL)."""
    index = index.to(torch.int64)
    if op == "ADD":
        return out.index_add_(0, index, vals)
    full = index.view(_lane_shape(index, vals.ndim)).expand_as(vals)
    if unsigned and op != "MUL":
        return flip_sign(flip_sign(out).scatter_reduce(
            0, full, flip_sign(vals), _REDUCE[op]))
    return out.scatter_reduce(0, full, vals, _REDUCE[op])


def segment_combine(vals, seg, *, num_segments: int, op: str,
                    unsigned: bool = False):
    """Combine same-segment lanes with ``op`` (any RMW_OPS member): the
    reorder-safe segment reduction ``bulk_rmw`` applies at the table.
    Empty segments read the op identity for ADD/MUL/bitwise ops and the
    dtype extremum for MIN/MAX (which is their identity too)."""
    if op in _BITWISE_OPS:
        return _segment_bitwise(vals, seg, num_segments, op)
    if op not in ("ADD",) + tuple(_REDUCE):
        raise ValueError(f"op {op!r} has no segment reduction "
                         "(RMW_OPS only)")
    ident = rmw_identity(op, vals.dtype, unsigned=unsigned)
    out = torch.full((num_segments,) + tuple(vals.shape[1:]), ident.item(),
                     dtype=vals.dtype, device=vals.device)
    return _reduce_into(out, seg, vals, op, unsigned)


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------

def gather_unique_rows(table: torch.Tensor, uniq: torch.Tensor, *,
                       block_rows: int = 1024, lanes: int = 256):
    """Rows of a 2-D ``table`` at the sorted indices ``uniq`` through the
    row-table gather kernel (its plain version for CPU tensors), planned
    over ``uniq`` as it is: no second sort. Returns ``(tiles, lane_of)``:
    ``tiles`` is ``(num_tiles * lanes, D)`` in plan order and
    ``tiles[lane_of[k]]`` is row ``uniq[k]``."""
    from repro_torch.kernels.gather import ops as gops
    plan = reorder.make_row_table_plan(
        uniq, n_rows=table.shape[0], block_rows=block_rows, lanes=lanes)
    tiles = gops.row_table_gather(table, plan)
    # Each sorted position is served by exactly one valid lane, and the
    # valid lanes serve them in order, so the k-th valid lane holds
    # uniq[k]: a search over the running count of valid lanes finds it,
    # and the caller reads rows with one gather through it (a scatter by
    # src_pos would pile every invalid lane on one row)
    served = torch.cumsum(plan.valid.reshape(-1), 0)
    lane_of = torch.searchsorted(served, torch.arange(
        1, uniq.shape[0] + 1, dtype=served.dtype, device=uniq.device))
    return tiles, lane_of


def bulk_gather(table: torch.Tensor, idx: torch.Tensor, *, sort: bool = True,
                dedup: bool = True, use_kernel: bool = False,
                block_rows: int = 1024, lanes: int = 256,
                device=None) -> torch.Tensor:
    """C = A[B] with reorder+coalesce. Works for (N,) or (N, D) tables.

    use_kernel: route the packed fetch of a 2-D table through the row-table
    gather kernel (its plain version for CPU tensors).
    """
    dev = resolve_device(device)
    table, idx = on(table, dev), _as_index(on(idx, dev))
    n = table.shape[0]
    row_shape = tuple(table.shape[1:])
    # loads clamp (policy): negatives to row 0, >= n to the last row
    flat_idx = idx.reshape(-1).clamp(0, n - 1)
    if not sort and not dedup:
        return table[flat_idx].reshape(tuple(idx.shape) + row_shape)

    if dedup:
        uniq, inv, _ = reorder.coalesce(flat_idx)
        if use_kernel and table.ndim == 2:
            packed_tiles, lane_of = gather_unique_rows(
                table, uniq, block_rows=block_rows, lanes=lanes)
            out = packed_tiles[lane_of[inv]]
        else:
            packed = table[uniq]          # sorted unique fetch ("scratchpad")
            out = packed[inv]             # cores read packed data
        return out.reshape(tuple(idx.shape) + row_shape)

    # sort-only path (no dedup): fetch in sorted order, unsort.
    sorted_idx, perm = reorder.sort_indices(flat_idx)
    fetched = table[sorted_idx]
    out = torch.empty_like(fetched)
    out[perm] = fetched
    return out.reshape(tuple(idx.shape) + row_shape)


# ---------------------------------------------------------------------------
# scatter (IST): duplicate destinations resolved to the *last* write in
# program order, matching sequential-loop semantics of A[B[i]] = C[i].
# ---------------------------------------------------------------------------

def bulk_scatter(table: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor, *, cond: torch.Tensor | None = None,
                 optimize: bool = True, device=None) -> torch.Tensor:
    """A[B[i]] = C[i]; the last write in program order wins.

    ``optimize=False`` is the naive baseline, one ``index_put_`` with
    duplicate destinations: which of them lands is then unspecified, as
    for XLA's scatter (the CPU applies them in order).
    """
    dev = resolve_device(device)
    table = on(table, dev)
    idx = _as_index(on(idx, dev)).reshape(-1)
    if idx.shape[0] == 0:
        return table
    n = table.shape[0]
    values = on(values, dev).reshape((idx.shape[0],) + tuple(table.shape[1:]))
    # stores drop (policy): negative and >= n destinations go to spare row n
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    if cond is not None:
        idx = torch.where(on(cond, dev).reshape(-1).to(torch.bool), idx, n)
    out = _with_spare_row(table)
    if not optimize:
        out[idx] = values
        return out[:n]
    # reorder+coalesce: keep only the last write per destination — every
    # surviving write has a unique destination (single-writer)
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    last_of_run = torch.cat([sidx[1:] != sidx[:-1],
                             torch.ones((1,), dtype=torch.bool, device=dev)])
    dest = torch.where(last_of_run, sidx, n)
    out[dest] = values[order]
    return out[:n]


# ---------------------------------------------------------------------------
# RMW (IRMW): sort-by-destination -> segment-reduce -> unique scatter.
# ---------------------------------------------------------------------------

def coalesce_updates(idx: torch.Tensor, values: torch.Tensor, *, n: int,
                     op: str, unsigned: bool = False):
    """Reorder + coalesce an RMW stream: one combined update per distinct
    destination. ``idx`` (int32, out-of-range lanes already routed to
    ``n``) and ``values`` are lane-aligned. Returns ``(seg_dest, packed)``,
    both of the stream's length: segment k's destination (``n`` for the
    empty segments past the last one) and its combined value."""
    # (1) reorder: sort by destination
    sidx, perm = reorder.sort_indices(idx)
    svals = values[perm]
    # (2) coalesce: segment-reduce runs of equal destinations to one value
    seg = torch.cumsum(torch.cat([
        torch.zeros((1,), dtype=torch.int64, device=idx.device),
        (sidx[1:] != sidx[:-1]).to(torch.int64)]), 0)
    nseg = idx.shape[0]  # static bound
    packed = segment_combine(svals, seg, num_segments=nseg, op=op,
                             unsigned=unsigned)
    # destination row of each segment (empty segments -> dtype-min -> routed
    # out of range and dropped)
    seg_dest = torch.full((nseg,), _INT32_MIN, dtype=torch.int32,
                          device=idx.device).scatter_reduce(
        0, seg, sidx, "amax", include_self=False)
    return torch.where(seg_dest < 0, n, seg_dest), packed


def bulk_rmw(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
             *, op: str = "ADD", cond: torch.Tensor | None = None,
             optimize: bool = True, use_kernel: bool = False,
             block_rows: int = 1024, lanes: int = 256,
             unsigned: bool = False, device=None) -> torch.Tensor:
    """A[B[i]] op= C[i]; op must be associative+commutative (RMW_OPS).

    use_kernel: apply the segment-combined updates of a 2-D table with the
    row-table scatter-RMW kernel (its plain version for CPU tensors).
    """
    dev = resolve_device(device)
    table = on(table, dev)
    idx = _as_index(on(idx, dev)).reshape(-1)
    if idx.shape[0] == 0:
        return table
    n = table.shape[0]
    values = on(values, dev).reshape((idx.shape[0],) + tuple(table.shape[1:]))
    ident = rmw_identity(op, table.dtype, unsigned=unsigned)
    # stores drop (policy): route negative/OOB destinations past the end
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    if cond is not None:
        cond = on(cond, dev).reshape(-1).to(torch.bool)
        values = torch.where(cond.view(_lane_shape(cond, values.ndim)),
                             values, ident)
    if not optimize and op not in _BITWISE_OPS:
        # naive baseline: one scatter with duplicate indices (the paper's
        # RMW-Atomic analogue)
        return _reduce_into(_with_spare_row(table), idx, values, op,
                            unsigned)[:n]
    # Bitwise ops have no scatter reduction, so both optimize settings take
    # the segment path below — exact either way.

    seg_dest, packed = coalesce_updates(idx, values, n=n, op=op,
                                        unsigned=unsigned)
    if use_kernel and table.ndim == 2:
        from repro_torch.kernels.scatter_rmw import ops as sops
        return sops.row_table_rmw(table, seg_dest, packed, op=op,
                                  block_rows=block_rows, lanes=lanes,
                                  unsigned=unsigned)
    # (3) unique scatter — every destination written exactly once
    out = _with_spare_row(table)
    out[seg_dest] = alu_apply(op, out[seg_dest], packed, unsigned=unsigned)
    return out[:n]

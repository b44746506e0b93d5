"""The lowering pass pipeline: submission leaves -> executable plan tree.

Mirror of the paper's §4.2 compiler stack, run per flush window (the JAX
package's ``repro.plan.passes``, with PyTorch ops on the leaves' tensors):

  normalize   assign node ids, apply the unified OOB policy (gather
              indices clamp), canonicalize RMW value shapes/dtypes
  group       partition program leaves by structural signature
  fuse        merge gather leaves per table and RMW leaves per
              (table, op) into Fused* nodes (concatenated streams)
  coalesce    decide eager-vs-coalesced per fused gather (cost model)
              and compute the static-shape dedup for coalesced nodes
  shard       pick the bulk backend per fused node ("bulk" locally; the
              sharded backend registered by ``repro_torch.distributed``
              additionally wraps mesh-placed nodes in ``ShardedNode``)
  batch       split groups into ≤ max_batch waves, compute shared
              regions, pick "vmap"-vs-"eager" per wave (cost model)

Every pass is a pure function ``(Plan, LowerContext) -> Plan``: nodes are
replaced, never mutated, and the pass appends a ``PassDelta`` to the
plan's trace. ``lower()`` drives the pipeline for a backend's pass table.

The plan cache: ``window_signature`` fingerprints a window's *structure*
(signatures, stream shapes, table-identity equivalence classes — never
data values). ``skeleton_of`` records the decisions a fresh lowering
made; a later window with the same signature replays them
(``LowerContext.replay``), skipping the cost model's measurements while
still computing the per-window data (clamps, unique sets) fresh.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.plan import nodes

PIPELINE = ("normalize", "group", "fuse", "coalesce", "shard", "batch")

_DTYPE_STRS: dict = {}


def dtype_str(dt) -> str:
    """Memoized ``str(dtype)``: both the submit path and
    ``window_signature`` pay it per leaf."""
    s = _DTYPE_STRS.get(dt)
    if s is None:
        s = _DTYPE_STRS[dt] = str(dt)
    return s


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Replayable decision record of one lowering (plan-cache value).

    Tuples are indexed by the in-order position of the derived node of
    that kind — root order is stable across passes, so a replayed
    lowering consumes them in lockstep.
    """
    gather_paths: tuple = ()       # "eager" | "coalesce" per FusedGather
    gather_backends: tuple = ()    # "eager" | "bulk" | "sharded"
    rmw_backends: tuple = ()       # "bulk" | "sharded"
    group_backends: tuple = ()     # "eager" | "vmap" per wave
    group_shared: tuple = ()       # frozenset per wave
    # (placement, codec) per ShardedNode in root order. Policy only: the
    # measured capacity is data-dependent and is re-measured per window
    # (a replayed buffer bound could drop lanes on different data).
    exchange_plans: tuple = ()


@dataclasses.dataclass
class LowerContext:
    """Everything the passes may consult; owned by one lowering."""
    max_batch: int = 32
    cost: object = None            # repro_torch.plan.cost.CostModel
    engine: object = None          # compile-cache probes (peek_cached)
    num_shards: int = 1
    sharded_capable: bool = False
    # the engine spans a process mesh: a node is mesh-placed iff its table
    # is a rank's slice (``sliced``), and a replicated table stays local
    process: bool = False
    replay: Optional[Skeleton] = None
    # run repro_torch.analysis.verify.check_pass after every pass (the
    # test suite turns this on via DX100_PLAN_VERIFY)
    verify: bool = False
    _next_nid: int = 0

    def nid(self) -> int:
        n = self._next_nid
        self._next_nid += 1
        return n


def _delta(plan: nodes.Plan, name: str, before: int,
           notes=()) -> nodes.Plan:
    d = nodes.PassDelta(name, before, len(plan.roots) + len(plan.leaves),
                        tuple(notes))
    return dataclasses.replace(plan, trace=plan.trace + (d,))


def _n(plan: nodes.Plan) -> int:
    return len(plan.roots) + len(plan.leaves)


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def normalize(plan: nodes.Plan, ctx: LowerContext) -> nodes.Plan:
    """Assign deterministic node ids and canonicalize leaf payloads:
    gather indices clamp into range (loads clamp — DESIGN.md §8), RMW
    values reshape/cast to the table's row shape and dtype."""
    before = _n(plan)
    out = []
    for leaf in plan.leaves:
        nid = ctx.nid()
        try:
            if isinstance(leaf, nodes.GatherNode):
                hi = max(leaf.table_rows - 1, 0)
                host = leaf.host_idx
                if host is not None:
                    host = np.clip(host, 0, hi)
                leaf = dataclasses.replace(
                    leaf, nid=nid, idx=leaf.idx.clamp(0, hi), host_idx=host)
            elif isinstance(leaf, nodes.RmwNode):
                vals = leaf.values.reshape(
                    (leaf.n_lanes,) + tuple(leaf.table.shape[1:])).to(
                    leaf.table.dtype)
                leaf = dataclasses.replace(leaf, nid=nid, values=vals)
            else:
                leaf = dataclasses.replace(leaf, nid=nid)
        except Exception as e:
            # malformed submission (e.g. an RMW value count that cannot
            # reshape to the index stream): the leaf becomes an error
            # node — its ticket fails at emit, the window survives
            leaf = dataclasses.replace(leaf, nid=nid, error=e)
        out.append(leaf)
    plan = dataclasses.replace(plan, leaves=tuple(out))
    c = plan.counts()
    return _delta(plan, "normalize", before,
                  [f"{c['programs']} programs / {c['gathers']} gathers / "
                   f"{c['rmws']} rmws"])


def group(plan: nodes.Plan, ctx: LowerContext) -> nodes.Plan:
    """Partition program leaves by structural signature (first-appearance
    order, fair order within a group)."""
    before = _n(plan)
    by_key: "OrderedDict[tuple, list]" = OrderedDict()
    for leaf in plan.leaves:
        if isinstance(leaf, nodes.ProgramNode):
            by_key.setdefault(leaf.group_key, []).append(leaf)
    roots = tuple(plan.roots) + tuple(
        nodes.BatchedGroup(nid=ctx.nid(), members=tuple(ms), key=key)
        for key, ms in by_key.items())
    plan = dataclasses.replace(plan, roots=roots)
    n_prog = sum(len(g) for g in by_key.values())
    return _delta(plan, "group", before,
                  [f"{n_prog} programs -> {len(by_key)} signature groups"])


def fuse(plan: nodes.Plan, ctx: LowerContext) -> nodes.Plan:
    """Merge gather leaves per table and RMW leaves per (table, op):
    the cross-request fusion that makes one fetch/update serve every
    tenant in the window (§2.3 shared-row reuse)."""
    before = _n(plan)
    roots = list(plan.roots)

    # a leaf whose canonicalization failed becomes its own error node —
    # healthy submissions against the same table still fuse and execute
    by_table: "OrderedDict[int, list]" = OrderedDict()
    for leaf in plan.leaves:
        if not isinstance(leaf, nodes.GatherNode):
            continue
        if leaf.error is not None:
            roots.append(nodes.FusedGather(
                nid=ctx.nid(), members=(leaf,), table_id=leaf.table_id,
                n_lanes=leaf.n_lanes, table_rows=leaf.table_rows,
                sliced=leaf.sliced, error=leaf.error))
            continue
        by_table.setdefault(leaf.table_id, []).append(leaf)
    for tid, ms in by_table.items():
        roots.append(_refused(nodes.FusedGather(
            nid=ctx.nid(), members=tuple(ms), table_id=tid,
            table=ms[0].table, streams=tuple(m.idx for m in ms),
            n_lanes=sum(m.n_lanes for m in ms),
            table_rows=ms[0].table_rows, sliced=ms[0].sliced), ctx))

    by_op: "OrderedDict[tuple, list]" = OrderedDict()
    for leaf in plan.leaves:
        if not isinstance(leaf, nodes.RmwNode):
            continue
        if leaf.error is not None:
            roots.append(nodes.FusedRmw(
                nid=ctx.nid(), members=(leaf,), table_id=leaf.table_id,
                op=leaf.op, n_lanes=leaf.n_lanes,
                table_rows=leaf.table_rows, sliced=leaf.sliced,
                error=leaf.error))
            continue
        by_op.setdefault((leaf.table_id, leaf.op), []).append(leaf)
    for (tid, op), ms in by_op.items():
        node = nodes.FusedRmw(
            nid=ctx.nid(), members=tuple(ms), table_id=tid, op=op,
            table=ms[0].table, n_lanes=sum(m.n_lanes for m in ms),
            table_rows=ms[0].table_rows, unsigned=ms[0].unsigned,
            sliced=ms[0].sliced)
        if node.error is None:
            try:
                idx = ms[0].idx if len(ms) == 1 else torch.cat(
                    [m.idx for m in ms])
                values = ms[0].values if len(ms) == 1 else \
                    torch.cat([m.values for m in ms])
                cond = None
                if any(m.cond is not None for m in ms):
                    cond = torch.cat(
                        [m.cond if m.cond is not None
                         else torch.ones((m.n_lanes,), dtype=torch.bool,
                                         device=m.idx.device)
                         for m in ms])
                node = dataclasses.replace(node, idx=idx, values=values,
                                           cond=cond)
            except Exception as e:       # incompatible member payloads
                node = dataclasses.replace(node, error=e)
        roots.append(_refused(node, ctx))
    plan = dataclasses.replace(plan, roots=tuple(roots))
    return _delta(plan, "fuse", before,
                  [f"{sum(len(v) for v in by_table.values())} gather "
                   f"streams -> {len(by_table)} fused tables",
                   f"{sum(len(v) for v in by_op.values())} rmw streams "
                   f"-> {len(by_op)} fused (table, op) groups"])


def _refused(node, ctx: LowerContext):
    """``node``, failed when the cost model forces a local path on a
    rank's table slice (``CostModel.local_refusal``): refused before any
    decision is made, so replayed skeletons stay aligned."""
    err = None if ctx.cost is None or node.error is not None \
        else ctx.cost.local_refusal(node)
    return node if err is None else dataclasses.replace(node, error=err)


def coalesce(plan: nodes.Plan, ctx: LowerContext) -> nodes.Plan:
    """Per fused gather: decide (cost model, or replayed skeleton)
    whether the fused stream is worth coalescing, and compute the
    static-shape dedup (sorted unique rows + per-member inverses + pad
    validity mask) for the nodes that are. The distinct-row count is read
    on the host: the dedup's ``torch.unique`` has already synchronised to
    size its output, and the emitters fetch only the distinct rows."""
    from repro_torch.core import reorder
    before = _n(plan)
    roots, notes, gi = [], [], 0
    replay = ctx.replay
    for node in plan.roots:
        if not isinstance(node, nodes.FusedGather) or \
                node.error is not None:
            roots.append(node)
            continue
        if replay is not None and gi < len(replay.gather_paths):
            path, est = replay.gather_paths[gi], None
        else:
            path, est = ctx.cost.gather_path(node, ctx)
        gi += 1
        if path == "eager":
            node = dataclasses.replace(node, backend="eager",
                                       est_factor=est)
            notes.append(f"gather#{node.nid} table[{node.table_rows}] "
                         f"-> eager (single stream, factor~"
                         f"{est if est is not None else '?'})")
        else:
            uniq, invs, n_uniq = reorder.coalesce_streams(node.streams)
            n_uniq = int(n_uniq)
            pad_valid = torch.arange(uniq.shape[0], dtype=torch.int32,
                                     device=uniq.device) < n_uniq
            node = dataclasses.replace(
                node, unique_idx=uniq, inverses=invs, n_unique=n_uniq,
                pad_valid=pad_valid, est_factor=est)
            notes.append(f"gather#{node.nid} table[{node.table_rows}] "
                         f"-> coalesce {node.n_lanes} lanes across "
                         f"{len(node.streams)} streams")
        roots.append(node)
    plan = dataclasses.replace(plan, roots=tuple(roots))
    return _delta(plan, "coalesce", before, notes)


def shard_local(plan: nodes.Plan, ctx: LowerContext) -> nodes.Plan:
    """Backend selection on a single-device engine: every coalesced
    fused node executes through the local bulk path. (The mesh variant
    of this slot is registered by ``repro_torch.distributed.engine``.)"""
    before = _n(plan)
    roots = []
    for node in plan.roots:
        if getattr(node, "error", None) is not None:
            pass                                 # error nodes never place
        elif isinstance(node, nodes.FusedGather) and node.backend == "":
            node = dataclasses.replace(node, backend="bulk")
        elif isinstance(node, nodes.FusedRmw):
            node = dataclasses.replace(node, backend="bulk")
        roots.append(node)
    plan = dataclasses.replace(plan, roots=tuple(roots))
    return _delta(plan, "shard", before, ["single device: all bulk"])


def batch(plan: nodes.Plan, ctx: LowerContext) -> nodes.Plan:
    """Split signature groups into ≤ max_batch waves; per wave compute
    the shared (read-only, identical caller array) regions and pick the
    "vmap"-vs-"eager" backend via the cost model / replayed skeleton."""
    before = _n(plan)
    roots, notes, gidx = [], [], 0
    replay = ctx.replay
    for node in plan.roots:
        if not isinstance(node, nodes.BatchedGroup):
            roots.append(node)
            continue
        members = node.members
        waves = [members[i:i + ctx.max_batch]
                 for i in range(0, len(members), ctx.max_batch)]
        for w, ms in enumerate(waves):
            if replay is not None and gidx < len(replay.group_backends):
                backend = replay.group_backends[gidx]
                shared = replay.group_shared[gidx]
            else:
                backend = ctx.cost.program_backend(ms, ctx)
                shared = _shared_regions(ms) if backend == "vmap" \
                    else frozenset()
            gidx += 1
            cached = None
            if ctx.engine is not None and hasattr(ctx.engine,
                                                  "peek_cached"):
                cached = ctx.engine.peek_cached(
                    ms[0].program,
                    batch=len(ms) if backend == "vmap" else None,
                    shared=shared if backend == "vmap" else frozenset())
            roots.append(nodes.BatchedGroup(
                nid=node.nid if w == 0 else ctx.nid(),
                members=tuple(ms), key=node.key, wave=w, backend=backend,
                shared=shared, cache_hit=cached))
            notes.append(
                f"group#{roots[-1].nid} n={len(ms)} backend={backend} "
                f"shared={sorted(shared) if shared else '[]'} "
                f"trace={'cached' if cached else 'cold'}")
    plan = dataclasses.replace(plan, roots=tuple(roots))
    return _delta(plan, "batch", before, notes)


def _shared_regions(members) -> frozenset:
    """Regions backed by the same caller array in every member and never
    written by the program — safe to close over (one copy read by every
    lane) instead of stacking across the batch's lanes."""
    from repro_torch.core import isa
    prog = members[0].program
    written = {ins.base for ins in prog.instrs
               if isinstance(ins, (isa.IST, isa.IRMW, isa.SST))}
    return frozenset(
        k for k in members[0].env
        if k not in written
        and len({m.src_ids.get(k) for m in members}) == 1)


DEFAULT_PASSES = {
    "normalize": normalize,
    "group": group,
    "fuse": fuse,
    "coalesce": coalesce,
    "shard": shard_local,
    "batch": batch,
}


# ---------------------------------------------------------------------------
# driver, signature, skeleton
# ---------------------------------------------------------------------------

def lower(leaves, order, ctx: LowerContext, backend) -> nodes.Plan:
    """Run the backend's pass table over a fresh plan of ``leaves``."""
    plan = nodes.Plan(leaves=tuple(leaves), order=tuple(order),
                      backend=backend.name)
    if ctx.verify:
        from repro_torch.analysis import verify as _verify
    for name in PIPELINE:
        plan = backend.passes[name](plan, ctx)
        if ctx.verify:
            _verify.check_pass(plan, name, ctx)
    return plan


def window_signature(leaves, max_batch: int, backend: str) -> tuple:
    """Structural fingerprint of a window (the plan-cache key).

    Table identity enters as *equivalence classes* (dense renumbering by
    first occurrence), not raw ``id()`` values — two windows that group
    identically hit the same cache line even when the concrete arrays
    differ (the decoupled pipeline's per-iteration tables).
    """
    canon: dict = {}

    def cid(obj_id):
        if obj_id not in canon:
            canon[obj_id] = len(canon)
        return canon[obj_id]

    rows = []
    for leaf in leaves:
        if isinstance(leaf, nodes.ProgramNode):
            rows.append(("p", leaf.group_key,
                         tuple(sorted((k, cid(v))
                                      for k, v in leaf.src_ids.items()))))
        elif isinstance(leaf, nodes.GatherNode):
            rows.append(("g", cid(leaf.table_id), leaf.n_lanes,
                         dtype_str(leaf.idx.dtype), _extent(leaf),
                         dtype_str(leaf.table.dtype)))
        elif isinstance(leaf, nodes.RmwNode):
            rows.append(("r", cid(leaf.table_id), leaf.op, leaf.n_lanes,
                         leaf.cond is not None, _extent(leaf),
                         dtype_str(leaf.table.dtype), leaf.unsigned,
                         tuple(getattr(leaf.values, "shape", ()))))
    return (tuple(rows), int(max_batch), backend)


def _extent(leaf) -> tuple:
    """A leaf's table shape with the *whole* table's rows (a rank's
    slice differs by a row between ranks; the plan must not), marked
    when the table is a slice."""
    shape = (leaf.table_rows,) + tuple(leaf.table.shape[1:])
    return shape + ("sliced",) if leaf.sliced else shape


def skeleton_of(plan: nodes.Plan) -> Skeleton:
    """Decision record of a fresh lowering, replayable on a later window
    with the same ``window_signature``."""
    gp, gb, rb, pb, ps, xp = [], [], [], [], [], []
    for root in plan.roots:
        if isinstance(root, nodes.ShardedNode):
            xp.append((root.placement, root.codec))
        node = nodes.unwrap(root)
        if getattr(node, "error", None) is not None:
            continue                   # error nodes carry no decisions
        if node.kind == "gather":
            gp.append("eager" if node.backend == "eager" else "coalesce")
            gb.append(node.backend)
        elif node.kind == "rmw":
            rb.append(node.backend)
        elif node.kind == "program_group":
            pb.append(node.backend)
            ps.append(node.shared)
    return Skeleton(gather_paths=tuple(gp), gather_backends=tuple(gb),
                    rmw_backends=tuple(rb), group_backends=tuple(pb),
                    group_shared=tuple(ps), exchange_plans=tuple(xp))

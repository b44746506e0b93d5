"""AccessPlan IR: the typed plan tree every flush window lowers through.

The paper programs DX100 through compiler passes over an MLIR-style IR
(§4.2); the runtime analogue is this module. A flush window is *lowered*
— ``normalize → group → fuse → coalesce → shard → batch`` (see
``repro_torch.plan.passes``) — into a tree of the node types below, and the
backend then *emits* each root node through a registered emitter
(``repro_torch.plan.emit``). Every decision the scheduler used to hard-code in
its three execution paths (which programs batch together, which gather
streams fuse, whether a fused stream crosses the device mesh) is now an
annotation on a plan node, made by a pass, and inspectable via
``repro_torch.plan.explain``.

Leaf nodes (one per submission, created by ``Scheduler.submit*``):

  ProgramNode   one AccessProgram launch (program + env + regs)
  GatherNode    one bulk ``table[idx]`` request
  RmwNode       one bulk ``table[idx] op= values`` request

Derived nodes (created by passes):

  BatchedGroup  ≤ max_batch structurally identical programs; backend
                "vmap" (one lane-batched engine run: each indirect
                instruction is one bulk op over every lane) or "eager"
  FusedGather   all gathers against one table; backend "eager" (direct
                indexed read), "bulk" (coalesced fetch) or "sharded"
  FusedRmw      all RMWs per (table, op); backend "bulk" or "sharded"
  ShardedNode   wrapper marking a fused node for mesh execution

``nid`` is assigned by the ``normalize`` pass (leaves first, in fair
order, then derived nodes in pipeline creation order) and is
deterministic for a given window — the round-trip guarantee behind
``explain()``: the plan it reports is the plan the flush executes.

After execution the plan is ``strip()``-ed: array payloads are dropped
(a long-lived ``FlushReport`` must not pin tables or index streams — the
same lifetime discipline as the lazy coalescing thunks) while the
structure, node ids, backends and per-pass trace stay readable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class PassDelta:
    """Record of one pass application: node counts plus human-readable
    notes (the per-pass delta ``explain()`` renders)."""
    name: str
    nodes_before: int
    nodes_after: int
    notes: Tuple[str, ...] = ()


class PlanNode:
    """Base marker; concrete nodes are dataclasses carrying ``nid``.

    ``error`` (present on leaves and fused nodes) records a lowering-time
    failure — a malformed submission whose canonicalization or fusion
    raised. Error nodes flow through the remaining passes untouched and
    the emit stage resolves their tickets to the scheduler's
    ``FailedResult`` without executing them: a bad submission fails its
    own ticket, never the window (let alone the scheduler).
    """
    kind = "node"

    def tickets(self):
        """Tickets retired by this node (leaves: one; fused: members')."""
        return ()


# ---------------------------------------------------------------------------
# leaf nodes — one per submission
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramNode(PlanNode):
    kind = "program"
    nid: int
    ticket: object
    program: object                  # isa.AccessProgram
    env: Dict = dataclasses.field(repr=False, default_factory=dict)
    regs: Dict = dataclasses.field(default_factory=dict)
    group_key: tuple = ()
    src_ids: Dict = dataclasses.field(default_factory=dict)
    # strong refs to the caller's original env objects: keeps src_ids
    # valid while queued (CPython reuses a freed object's id, which would
    # otherwise let two different tables alias one group)
    src_refs: tuple = dataclasses.field(repr=False, default=())
    # ISA dtype names of regions whose int32 container stands for u32
    # (``Engine.run(dtypes=)``)
    dtypes: Dict = dataclasses.field(default_factory=dict)

    def tickets(self):
        return (self.ticket,)


@dataclasses.dataclass
class GatherNode(PlanNode):
    kind = "gather_leaf"
    nid: int
    ticket: object
    table: object = dataclasses.field(repr=False, default=None)
    idx: object = dataclasses.field(repr=False, default=None)
    table_id: int = 0                # id() of the caller's table (fuse key)
    table_ref: object = dataclasses.field(repr=False, default=None)
    n_lanes: int = 0
    table_rows: int = 0
    # the caller's index stream as int32 NumPy when it was submitted as
    # one (clamped by normalize): the cost model may measure it without
    # reading the device
    host_idx: object = dataclasses.field(repr=False, default=None)
    error: Optional[Exception] = dataclasses.field(
        repr=False, default=None)

    def tickets(self):
        return (self.ticket,)


@dataclasses.dataclass
class RmwNode(PlanNode):
    kind = "rmw_leaf"
    nid: int
    ticket: object
    table: object = dataclasses.field(repr=False, default=None)
    idx: object = dataclasses.field(repr=False, default=None)
    values: object = dataclasses.field(repr=False, default=None)
    op: str = "ADD"
    cond: object = dataclasses.field(repr=False, default=None)
    table_id: int = 0
    table_ref: object = dataclasses.field(repr=False, default=None)
    n_lanes: int = 0
    table_rows: int = 0
    unsigned: bool = False           # int32 container holds u32
    error: Optional[Exception] = dataclasses.field(
        repr=False, default=None)

    def tickets(self):
        return (self.ticket,)


# ---------------------------------------------------------------------------
# derived nodes — created by passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchedGroup(PlanNode):
    """One wave of structurally identical programs.

    ``backend``: "vmap" (one lane-batched run, ``TracedExecutable
    .run_batch``; the name is the reference's) or "eager" (per-program
    cached executables). ``shared``: read-only regions
    backed by the same caller array in every member — closed over, not
    stacked. ``cache_hit``: whether the engine's compile cache already
    holds this (signature, batch, shared) executable at lowering time.
    """
    kind = "program_group"
    nid: int
    members: Tuple[ProgramNode, ...]
    key: tuple = ()
    wave: int = 0
    backend: str = ""
    shared: frozenset = frozenset()
    cache_hit: Optional[bool] = None

    def tickets(self):
        return tuple(m.ticket for m in self.members)


@dataclasses.dataclass
class FusedGather(PlanNode):
    """All pending gathers against one table, fused.

    ``backend``: "eager" | "bulk" | "sharded" (annotated by the
    coalesce/shard passes via the cost model). For coalesced backends the
    coalesce pass attaches ``unique_idx``/``inverses``/``n_unique``/
    ``pad_valid`` (the static-shape dedup the emitters consume).
    ``n_unique`` is the number of distinct rows, a Python int (the
    dedup's ``torch.unique`` sizes its output on the host anyway).
    ``est_factor`` is the cost model's measured coalescing factor
    (lanes / distinct rows), None when a stream was not host-resident.
    """
    kind = "gather"
    nid: int
    members: Tuple[GatherNode, ...]
    table_id: int = 0
    table: object = dataclasses.field(repr=False, default=None)
    streams: tuple = dataclasses.field(repr=False, default=())
    backend: str = ""
    unique_idx: object = dataclasses.field(repr=False, default=None)
    inverses: tuple = dataclasses.field(repr=False, default=())
    n_unique: object = dataclasses.field(repr=False, default=None)
    pad_valid: object = dataclasses.field(repr=False, default=None)
    n_lanes: int = 0
    table_rows: int = 0
    est_factor: Optional[float] = None
    error: Optional[Exception] = dataclasses.field(
        repr=False, default=None)

    def tickets(self):
        return tuple(m.ticket for m in self.members)


@dataclasses.dataclass
class FusedRmw(PlanNode):
    """All pending RMWs per (table, op), concatenated into one stream.

    ``backend``: "bulk" (single segment-combined ``bulk_rmw``) or
    "sharded" (owner-local mesh update). Different ops against one table
    produce separate nodes that chain in first-appearance order; every
    member ticket resolves to the table's end-of-window state.
    """
    kind = "rmw"
    nid: int
    members: Tuple[RmwNode, ...]
    table_id: int = 0
    op: str = "ADD"
    table: object = dataclasses.field(repr=False, default=None)
    idx: object = dataclasses.field(repr=False, default=None)
    values: object = dataclasses.field(repr=False, default=None)
    cond: object = dataclasses.field(repr=False, default=None)
    backend: str = ""
    n_lanes: int = 0
    table_rows: int = 0
    unsigned: bool = False
    error: Optional[Exception] = dataclasses.field(
        repr=False, default=None)

    def tickets(self):
        return tuple(m.ticket for m in self.members)


@dataclasses.dataclass
class ShardedNode(PlanNode):
    """Mesh-placement wrapper: ``inner`` executes owner-locally across
    ``num_shards`` devices. No backend of the port creates it yet (the
    sharded engine is still to be ported); the verifier and ``explain``
    already know its shape.

    The shard pass additionally annotates the *exchange plan* chosen for
    this node:
    ``placement`` ("block" | "owner" lane placement), ``codec`` ("raw" |
    "bitmap" | "delta" wire encoding of the remote index spill) and the
    measured estimates ``explain()`` renders. ``capacity`` is the
    lowering-time capacity *estimate*; the engine re-measures it at
    emission (data-dependent buffer sizes are never replayed from the
    plan cache).
    """
    kind = "sharded"
    nid: int
    inner: PlanNode = None
    num_shards: int = 1
    axis: str = "shards"
    placement: str = "block"
    codec: str = "raw"
    capacity: int = 0
    est_local_fraction: Optional[float] = None

    def tickets(self):
        return self.inner.tickets()


def unwrap(node: PlanNode) -> PlanNode:
    """The payload node: ShardedNode's inner, anything else itself."""
    return node.inner if isinstance(node, ShardedNode) else node


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """One lowered flush window.

    ``leaves`` are the fair-ordered submissions; ``roots`` the derived
    nodes in execution order (program groups, fused gathers, fused
    RMWs); ``trace`` the per-pass deltas; ``signature`` the structural
    window signature (the plan-cache key); ``cache_hit`` whether this
    lowering replayed a cached skeleton's decisions.
    """
    leaves: Tuple[PlanNode, ...] = ()
    roots: Tuple[PlanNode, ...] = ()
    order: Tuple[Tuple[str, int], ...] = ()    # (tenant, tid) fair order
    trace: Tuple[PassDelta, ...] = ()
    signature: tuple = dataclasses.field(repr=False, default=())
    cache_hit: bool = False
    backend: str = "local"
    executed: bool = False
    # window hazard diagnostics (repro_torch.analysis.hazards.scan_window):
    # array-free Diagnostic tuples, so they survive strip()
    diagnostics: Tuple = ()

    def nodes(self):
        """Every node: leaves, roots and sharded inners."""
        for leaf in self.leaves:
            yield leaf
        for root in self.roots:
            yield root
            if isinstance(root, ShardedNode):
                yield root.inner

    def node_ids(self) -> tuple:
        return tuple(n.nid for n in self.nodes())

    def fused(self, kind: str):
        """Derived nodes of ``kind`` ("program_group"|"gather"|"rmw"),
        unwrapping mesh placement."""
        return tuple(n for n in map(unwrap, self.roots) if n.kind == kind)

    def counts(self) -> Dict[str, int]:
        out = {"programs": 0, "gathers": 0, "rmws": 0}
        for leaf in self.leaves:
            if isinstance(leaf, ProgramNode):
                out["programs"] += 1
            elif isinstance(leaf, GatherNode):
                out["gathers"] += 1
            elif isinstance(leaf, RmwNode):
                out["rmws"] += 1
        return out

    def strip(self) -> "Plan":
        """Drop array payloads after execution; keep structure + stats.

        A ``FlushReport`` outlives its window (``AccessService
        .last_report``), so the plan it carries must not pin tables,
        index streams or envs — exactly the lifetime rule the report's
        lazy coalescing thunks follow.
        """
        for node in self.nodes():
            if isinstance(node, ProgramNode):
                node.env, node.src_refs = {}, ()
            elif isinstance(node, GatherNode):
                node.table = node.idx = node.table_ref = None
                node.host_idx = None
            elif isinstance(node, RmwNode):
                node.table = node.idx = node.values = None
                node.cond = node.table_ref = None
            elif isinstance(node, FusedGather):
                node.table, node.streams = None, ()
                node.unique_idx = node.n_unique = node.pad_valid = None
                node.inverses = ()
            elif isinstance(node, FusedRmw):
                node.table = node.idx = node.values = node.cond = None
        return self

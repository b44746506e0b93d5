"""Shared multi-tenant access engine: cross-program batching + coalescing.

The paper's defining system property is that one DX100 serves *many* cores
(Fig. 2): each core posts bulk access programs through MMIO queues and the
accelerator reorders, interleaves and coalesces accesses *across* the
outstanding requests. This module is that shared frontend, the port of the
JAX package's ``repro.core.scheduler``:

  * ``Scheduler.submit`` / ``submit_gather`` / ``submit_rmw`` enqueue work
    from a logical core (``tenant``) as **AccessPlan IR leaves**
    (``repro_torch.plan.nodes``) and return ``Ticket``s; ``poll``/``result``
    read the retired results back — the async MMIO submit/poll protocol.
  * ``flush_async`` drains the queues in weighted-fair tenant order and
    **lowers the window through the plan pass pipeline**
    (``normalize -> group -> fuse -> coalesce -> shard -> batch``,
    ``repro_torch.plan.passes``); this module's ``_execute_*`` methods are
    only the registered *emitters* that execute the annotated nodes.
  * ``explain()`` returns the lowered plan for the pending window with
    per-pass deltas; the same plan object is then executed by the next
    flush and travels on ``FlushReport.plan`` (node ids round-trip).
  * Lowering *decisions* are cached per structural window signature (the
    plan cache): repeat windows replay the recorded skeleton.

On the card: submissions become tensors on the engine's device at submit
(NumPy arrays through ``core.interop``'s containers), every emitter keeps
its streams there, and ``flush_async`` returns once the window's work is
queued on the current CUDA stream, with an event recorded behind it
(``FlushHandle``). With ``Engine(use_kernel=True)`` the fused gathers and
RMWs on 2-D tables run through the row-table kernels: the fused gather
plans its already-sorted distinct rows straight into the gather kernel,
the fused RMW goes through ``bulk_rmw(use_kernel=True)``. With
``use_kernel=False`` they take the JAX package's plain paths.

Failures stay local: a group whose lanes cannot share one batched run
(``BatchUnsupported``, and only that) falls back to per-program runs, and
any plan node whose emission raises resolves its tickets to
``FailedResult`` without poisoning the rest of the window.

Over a process mesh (``ShardedEngine(ProcessMesh)``: one scheduler per
rank, SPMD) every rank makes the same submissions in the same order, and
a row-sharded table is submitted as the rank's slice with the whole
table's ``n_rows``. Each rank lowers its own window; one agreement per
window (``_agree``: an all-gather of a small host object) holds every
rank's digest of the window signature, the lowering's decisions and the
inputs that cut the window against rank 0's, and agrees the exchange
capacities (the largest any rank measured) and the submissions refused
before any collective (every rank poisons the union). A window that
differs between ranks raises ``PlanDivergence`` on every rank, naming the
first leaf that differs, instead of issuing mismatched collectives.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import hazards as analysis_hazards
from repro_torch.analysis.diagnostics import HazardError
from repro_torch.core import bulk_ops, interop, isa, reorder
from repro_torch.core.engine import (BatchUnsupported, Engine,
                                     structural_signature)
from repro_torch.plan import cost as plan_cost
from repro_torch.plan import emit as plan_emit
from repro_torch.plan import nodes as plan_nodes
from repro_torch.plan import passes as plan_passes
from repro_torch.plan.explain import Explanation

# lowering-decision cache entries kept per scheduler (LRU)
PLAN_CACHE_SIZE = 256


# ---------------------------------------------------------------------------
# tickets and results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ticket:
    """Handle returned by submit; redeem via ``poll``/``result``."""
    tid: int
    tenant: str


@dataclasses.dataclass
class FailedResult:
    """Stored in place of a result when the owning plan node's execution
    raised; ``Scheduler.result`` re-raises ``error``."""
    error: Exception


class PlanDivergence(RuntimeError):
    """Over a process mesh, this rank's window is not rank 0's (another
    submission, stream shape or cut): raised on every rank by the window's
    agreement, before any collective of the window is issued."""


class QueueFullError(RuntimeError):
    """Raised by ``Scheduler.result`` for a submission that admission
    control rejected (the tenant's bounded queue was full at submit)."""


@dataclasses.dataclass
class QueueFull(FailedResult):
    """Terminal ticket state for a rejected submission.

    Stored at *submit* time — the leaf is never enqueued, so a rejected
    submission can never reach a flush window or mutate a table. ``poll``
    returns it (callers branch on ``isinstance``); ``result`` re-raises
    the carried ``QueueFullError``.
    """
    tenant: str = ""


@dataclasses.dataclass
class GroupReport:
    """Per-group execution record of one flush.

    ``cross_coalescing`` maps region -> (cross-request gain, sum of
    per-request unique counts, fused unique count). It is computed lazily
    on first access (it reads index streams back to the host), and the
    thunk reference is dropped on first materialization so a long-lived
    report does not pin the streams the thunk closed over.
    """
    n_programs: int
    program_name: str
    vmapped: bool               # executed as one lane-batched run
    fell_back: bool             # lanes could not batch -> per-program loop
    error: Optional[str] = None  # repr of the exception, if the group died
    _coalescing_thunk: Optional[object] = dataclasses.field(
        default=None, repr=False)
    _coalescing: Optional[Dict[str, Tuple[float, int, int]]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def cross_coalescing(self) -> Dict[str, Tuple[float, int, int]]:
        if self._coalescing is None:
            thunk, self._coalescing_thunk = self._coalescing_thunk, None
            self._coalescing = thunk() if thunk else {}
        return self._coalescing


@dataclasses.dataclass
class FlushReport:
    """Execution record of one flush window.

    ``gather_coalescing`` maps table id -> (cross-request gain, sum of
    per-request unique counts, fused unique count); ``rmw_coalescing``
    maps (table id, op) likewise. Both are computed lazily on first access
    — the streams they measure live on the device, and reading them on
    the flush hot path would synchronise with it. As with
    ``GroupReport``, the thunk reference is dropped after first
    materialization so a long-lived report releases the streams.

    ``plan`` is the executed (and stripped — tensor payloads released)
    AccessPlan: render it via ``repro_torch.plan.explain(report)``.
    """
    order: Tuple[Tuple[str, int], ...]    # (tenant, tid) execution order
    groups: Tuple[GroupReport, ...]
    n_programs: int
    n_gathers: int
    # table id ("gather") / ("rmw", table id, op) -> per-shard exchange/
    # coalescing record (ShardStats), filled only when the engine spans a
    # mesh
    shard_stats: Dict[object, object] = dataclasses.field(
        default_factory=dict)
    n_rmws: int = 0
    plan: Optional[plan_nodes.Plan] = dataclasses.field(
        default=None, repr=False)
    # window hazard diagnostics (analysis.hazards; array-free tuples)
    diagnostics: Tuple = ()
    _gather_thunk: Optional[object] = dataclasses.field(
        default=None, repr=False)
    _gather_coalescing: Optional[Dict] = dataclasses.field(
        default=None, repr=False)
    _rmw_thunk: Optional[object] = dataclasses.field(
        default=None, repr=False)
    _rmw_coalescing: Optional[Dict] = dataclasses.field(
        default=None, repr=False)

    @property
    def gather_coalescing(self) -> Dict[int, Tuple[float, int, int]]:
        if self._gather_coalescing is None:
            thunk, self._gather_thunk = self._gather_thunk, None
            self._gather_coalescing = thunk() if thunk else {}
        return self._gather_coalescing

    @property
    def rmw_coalescing(self) -> Dict[tuple, Tuple[float, int, int]]:
        if self._rmw_coalescing is None:
            thunk, self._rmw_thunk = self._rmw_thunk, None
            self._rmw_coalescing = thunk() if thunk else {}
        return self._rmw_coalescing

    def exchange_summary(self) -> Optional[Dict[str, object]]:
        """Fold the window's per-stream ``ShardStats`` into one
        wire-level record: post-dedup lane count, fraction served
        without fabric traffic, bytes shipped (chosen codec vs raw),
        and the mean route/exec overlap over split-dispatched nodes
        (None when every node ran fused). Returns None for
        single-device windows. Reading the stats copies them to the host
        (a device sync) — call off the flush hot path, as
        ``serve.telemetry`` does."""
        if not self.shard_stats:
            return None
        lanes = local = idx_b = idx_raw = wire = 0
        ov_sum, ov_n = 0.0, 0
        for st in self.shard_stats.values():
            s = st.sent
            lanes += int(s.sum())
            local += int(np.trace(s))
            idx_b += st.idx_bytes
            idx_raw += st.idx_bytes_raw
            wire += st.bytes_on_wire
            if st.overlap_fraction is not None:
                ov_sum += st.overlap_fraction
                ov_n += 1
        return {
            "nodes": len(self.shard_stats),
            "lanes": lanes,
            "local_fraction": local / max(lanes, 1),
            "bytes_on_wire": wire,
            "idx_bytes": idx_b,
            "compression_ratio": (idx_raw / idx_b) if idx_b else 1.0,
            "overlap_fraction": (ov_sum / ov_n) if ov_n else None,
        }

    def exchange_record(self) -> Optional[Dict[str, object]]:
        """``exchange_summary`` with, over a process mesh, how the window's
        exchanges moved (``transport``) and how many collectives its
        sharded nodes issued on this rank (``collectives``, from
        ``ShardStats``): the record ``serve.telemetry`` folds."""
        out = self.exchange_summary()
        ways = {st.transport for st in self.shard_stats.values()}
        if out is None or ways == {"logical"}:
            return out
        return {**out, "transport": "/".join(sorted(ways)),
                "collectives": sum(st.collectives
                                   for st in self.shard_stats.values())}


class FlushHandle:
    """Non-blocking handle for one dispatched flush window.

    ``flush_async`` emits every plan node and returns as soon as the
    window's work is queued on the engine device's current CUDA stream,
    with a ``torch.cuda.Event`` recorded behind it. ``poll()`` is the
    event's ``query()`` and never blocks; ``result()`` waits on the event
    and returns the window's ``FlushReport``, idempotently. On the CPU
    every op ran as it was issued, so the handle is done at once. Tickets
    stay redeemable through ``Scheduler.poll``/``result`` exactly as for a
    blocking flush: redeeming one whose tensors are still being computed
    hands back tensors that later work on the same stream may consume.
    """

    def __init__(self, report: FlushReport,
                 event: Optional["torch.cuda.Event"] = None):
        self.report = report
        self._event = event
        self._done = event is None
        self.resolved = event is None    # result() was called (or no event)

    def poll(self) -> bool:
        """True once the window's work has finished on the device."""
        if not self._done and self._event.query():
            self._event = None
            self._done = True
        return self._done

    @property
    def done(self) -> bool:
        """Retired (or explicitly resolved) — the in-flight guard's test."""
        return self.poll()

    def result(self) -> FlushReport:
        """Block until the window has fully retired; returns its report.
        Idempotent — a second call never blocks."""
        if not self._done:
            self._event.synchronize()
            self._event = None
            self._done = True
        self.resolved = True
        return self.report


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _env_struct(env: Mapping, dtypes: Mapping) -> tuple:
    return tuple(sorted((k, tuple(v.shape), plan_passes.dtype_str(v.dtype),
                         dtypes.get(k)) for k, v in env.items()))


class Scheduler:
    """Shared access-engine frontend over one (long-lived) ``Engine``.

    Parameters:
      engine     : the backing engine; defaults to a fresh one on the
                   card. Long-lived — its compile cache holds the batched
                   executables.
      max_batch  : cap on programs fused into one batched group per flush.
      cost_model : ``repro_torch.plan.CostModel`` override (forced
                   backends, measurement budget); defaults to the standard
                   model.
      verify     : run the plan-IR structural verifier after every
                   lowering pass (``repro_torch.analysis.verify``);
                   default from env ``DX100_PLAN_VERIFY``.
      strict     : refuse to flush a window carrying ERROR-severity
                   hazard diagnostics (``HazardError``; queues are left
                   intact); default from env ``DX100_STRICT_HAZARDS``.
    """

    def __init__(self, engine: Optional[Engine] = None, *,
                 tile_size: int = 16384, optimize: bool = True,
                 use_kernel: bool = False, max_batch: int = 32,
                 cost_model: Optional[plan_cost.CostModel] = None,
                 verify: Optional[bool] = None,
                 strict: Optional[bool] = None):
        self.engine = engine if engine is not None else Engine(
            tile_size=tile_size, optimize=optimize, use_kernel=use_kernel)
        # a sharded engine over a process mesh: one scheduler per rank,
        # every window agreed across the ranks (``_agree``)
        self.process = bool(getattr(self.engine, "process", False))
        self.max_batch = int(max_batch)
        if verify is None:
            verify = os.environ.get(
                "DX100_PLAN_VERIFY", "") not in ("", "0")
        if strict is None:
            strict = os.environ.get(
                "DX100_STRICT_HAZARDS", "") not in ("", "0")
        self.verify = bool(verify)
        self.strict = bool(strict)
        self.cost = cost_model if cost_model is not None \
            else plan_cost.CostModel()
        self._queue: List[plan_nodes.ProgramNode] = []
        self._gather_queue: List[plan_nodes.GatherNode] = []
        self._rmw_queue: List[plan_nodes.RmwNode] = []
        self._results: Dict[int, object] = {}
        self._next_tid = 0
        self._rr_cursor = 0          # rotates the round-robin start tenant
        # weakref: the guard must observe the last window's done-ness, but
        # must not pin an abandoned handle's report for the scheduler's
        # lifetime (a dropped handle releases its window)
        self._inflight: Optional[weakref.ref] = None
        # queue-fingerprint -> lowered Plan (explain()/flush share one
        # lowering); plan cache: window signature -> decision Skeleton
        self._lowered: Optional[tuple] = None
        self._plan_cache: "OrderedDict[tuple, plan_passes.Skeleton]" = \
            OrderedDict()
        # per-tenant serving policy (configure_tenant): SLO weight drives
        # WFQ drain order, max_pending bounds the tenant's queue share
        self._tenant_weight: Dict[str, float] = {}
        self._tenant_cap: Dict[str, int] = {}
        self._tenant_pending: Dict[str, int] = {}
        # WFQ virtual time, advanced only across drain-limited windows
        # (a full drain resets it — nobody is waiting, history is moot)
        self._vtime: Dict[str, float] = {}
        self.stats = {"flushes": 0, "programs": 0, "gathers": 0,
                      "rmws": 0, "vmap_groups": 0, "vmap_fallbacks": 0,
                      "singleton_groups": 0, "group_errors": 0,
                      "plan_cache_hits": 0, "plan_cache_misses": 0,
                      "rejects": 0, "deferrals": 0,
                      "hazard_errors": 0, "hazard_warnings": 0,
                      "hazards_by_tenant": {}}
        if self.process:
            # per-window plan agreement: all-gathers issued and their
            # host time (seconds)
            self.stats.update(agreements=0, agreement_s=0.0)

    # -- submission ----------------------------------------------------------

    @property
    def pending(self) -> int:
        return (len(self._queue) + len(self._gather_queue)
                + len(self._rmw_queue))

    def _ticket(self, tenant: str) -> Ticket:
        t = Ticket(self._next_tid, tenant)
        self._next_tid += 1
        return t

    def _on_device(self, x) -> torch.Tensor:
        """``x`` as a tensor on the engine's device: a tensor moves (a
        no-op when it is there), anything else goes through
        ``core.interop``'s containers (u32 as int32 bits)."""
        if isinstance(x, torch.Tensor):
            return x.to(self.engine.device)
        return interop.to_tensor(np.asarray(x), device=self.engine.device)

    def _extent(self, dtable: torch.Tensor, n_rows: Optional[int]):
        """``(table_rows, sliced, error)`` of a submitted table: its own
        rows, or with ``n_rows`` over a process mesh the whole table's,
        the submission then carrying the rank's slice. A slice that is
        not this rank's ``rank_rows`` fails its ticket (an error leaf,
        agreed across ranks at the flush) rather than raising here."""
        rows = int(dtable.shape[0])
        if n_rows is None:
            return rows, False, None
        n_rows = int(n_rows)
        if not self.process:
            if n_rows != rows:
                raise ValueError(
                    f"n_rows={n_rows} but the table has {rows} rows: only "
                    "a process mesh takes a rank's slice of a table")
            return rows, False, None
        lo, hi = self.engine.rank_rows(n_rows)
        err = None
        if rows != hi - lo:
            err = ValueError(
                f"rank {self.engine.rank} submitted {rows} table rows; its "
                f"slice of a {n_rows}-row table is rows [{lo}, {hi}): "
                "submit each rank its own slice (rank_rows)")
        return n_rows, True, err

    def configure_tenant(self, tenant: str, *,
                         weight: Optional[float] = None,
                         max_pending: Optional[int] = None) -> None:
        """Set a tenant's serving policy.

        ``weight``: SLO weight for weighted-fair drain order (default 1.0;
        higher = served earlier inside a window and a larger share of
        drain-limited windows). ``max_pending``: bound on the tenant's
        queued-but-unflushed submissions — submits past it are rejected
        with a ``QueueFull`` ticket (admission control; None = unbounded).
        """
        if weight is not None:
            if weight <= 0:
                raise ValueError(f"weight must be > 0, got {weight}")
            self._tenant_weight[tenant] = float(weight)
        if max_pending is not None:
            if max_pending < 0:
                raise ValueError(
                    f"max_pending must be >= 0, got {max_pending}")
            self._tenant_cap[tenant] = int(max_pending)

    def _admit(self, tenant: str) -> Optional[Ticket]:
        """Admission control: None if the tenant may enqueue, else a
        ticket already resolved to ``QueueFull`` (nothing was enqueued —
        a rejected submission can never mutate a table)."""
        cap = self._tenant_cap.get(tenant)
        if cap is not None and self._tenant_pending.get(tenant, 0) >= cap:
            t = self._ticket(tenant)
            self.stats["rejects"] += 1
            self._results[t.tid] = QueueFull(
                QueueFullError(
                    f"tenant {tenant!r} queue full ({cap} pending): "
                    "submission rejected by admission control"),
                tenant=tenant)
            return t
        self._tenant_pending[tenant] = \
            self._tenant_pending.get(tenant, 0) + 1
        return None

    def submit(self, program: isa.AccessProgram, env: Mapping,
               regs: Mapping | None = None, *, tenant: str = "core0",
               dtypes: Mapping | None = None) -> Ticket:
        """Enqueue one program launch from ``tenant``; returns a Ticket.

        ``env`` maps region names to tensors or NumPy arrays (NumPy goes
        to the engine's device here, its ISA type recorded — a uint32
        array is a u32 region); ``dtypes`` names region types explicitly
        (``Engine.run``). ``regs`` holds scalar registers
        (``tile_base``/``N``/... — python numbers). Execution is deferred
        to ``flush``.
        """
        rejected = self._admit(tenant)
        if rejected is not None:
            return rejected
        src_refs = tuple(env.values())   # pin caller objects (id stability)
        src_ids = {k: id(v) for k, v in env.items()}
        kinds = {}
        for k, v in env.items():
            if not isinstance(v, torch.Tensor):
                try:
                    kinds[k] = interop.isa_dtype(np.asarray(v).dtype)
                except KeyError:     # bool and the like: the tensor's type
                    pass
        kinds.update(dtypes or {})
        env = {k: self._on_device(v) for k, v in env.items()}
        regs = dict(regs or {})
        key = (structural_signature(program), _env_struct(env, kinds),
               tuple(sorted(regs)))
        leaf = plan_nodes.ProgramNode(
            nid=-1, ticket=self._ticket(tenant), program=program, env=env,
            regs=regs, group_key=key, src_ids=src_ids, src_refs=src_refs,
            dtypes=kinds)
        self._queue.append(leaf)
        return leaf.ticket

    def submit_gather(self, table, idx, *, tenant: str = "core0",
                      n_rows: Optional[int] = None) -> Ticket:
        """Bulk fast-path: C = table[idx] with *cross-request* coalescing.

        All pending gathers against the same table object are fused into a
        single plan node at flush time (whose backend — direct or
        coalesced — the cost model picks); the result for this ticket is
        the (N,)- or (N, D)-shaped gathered tensor.

        Over a process mesh, ``table`` with ``n_rows`` (the whole table's
        rows) is this rank's slice ``rank_rows(n_rows)``; the gather is
        sharded and the ticket resolves to the whole result on every
        rank. A table passed without ``n_rows`` is one every rank holds
        whole, read locally.
        """
        rejected = self._admit(tenant)
        if rejected is not None:
            return rejected
        dtable = self._on_device(table)
        host_idx = None
        if isinstance(idx, torch.Tensor):
            didx = bulk_ops._as_index(idx.to(self.engine.device))
        else:
            # keep the caller's host stream for the cost model's
            # measurement: it never reads the device
            host_idx = bulk_ops._as_index(interop.to_tensor(
                np.asarray(idx), device="cpu")).reshape(-1).numpy()
            didx = torch.from_numpy(host_idx).to(self.engine.device)
        # flatten up front: one canonical stream shape for every path
        didx = didx.reshape(-1)
        rows, sliced, err = self._extent(dtable, n_rows)
        leaf = plan_nodes.GatherNode(
            nid=-1, ticket=self._ticket(tenant), table=dtable, idx=didx,
            table_id=id(table), table_ref=table,
            n_lanes=int(didx.shape[0]), table_rows=rows, sliced=sliced,
            host_idx=host_idx, error=err)
        self._gather_queue.append(leaf)
        return leaf.ticket

    def submit_rmw(self, table, idx, values, *, op: str = "ADD",
                   cond=None, tenant: str = "core0",
                   unsigned: Optional[bool] = None,
                   n_rows: Optional[int] = None) -> Ticket:
        """Bulk RMW fast-path: ``table[idx] op= values`` with cross-request
        fusion.

        All pending RMWs with the same ``op`` against the same table object
        are concatenated into ONE ``bulk_rmw`` (sort -> segment-combine ->
        unique scatter) at flush time, so duplicate destinations across
        tenants merge before touching memory. ``op`` must be in
        ``isa.RMW_OPS``. ``cond``: an optional bool mask — False lanes are
        no-ops. ``unsigned`` says an int32 tensor holds u32 (MIN/MAX
        compare unsigned); it defaults to whether ``table`` is a uint32
        NumPy array. The ticket resolves to the table's state at the *end
        of the flush window*; gathers in the same window read the window's
        initial state — don't mix reads and writes of one table inside a
        window. Over a process mesh, ``table`` with ``n_rows`` is this
        rank's slice (as for ``submit_gather``) and the ticket resolves
        to the rank's updated slice.
        """
        if op not in isa.RMW_OPS:
            raise ValueError(f"op {op!r} not in RMW_OPS {isa.RMW_OPS}")
        rejected = self._admit(tenant)
        if rejected is not None:
            return rejected
        if unsigned is None:
            unsigned = not isinstance(table, torch.Tensor) and \
                np.asarray(table).dtype.name in ("uint32", "uint64")
        dtable = self._on_device(table)
        didx = bulk_ops._as_index(self._on_device(idx)).reshape(-1)
        rows, sliced, err = self._extent(dtable, n_rows)
        leaf = plan_nodes.RmwNode(
            nid=-1, ticket=self._ticket(tenant), table=dtable, idx=didx,
            values=self._on_device(values), op=op,
            cond=None if cond is None
            else self._on_device(cond).reshape(-1).to(torch.bool),
            table_id=id(table), table_ref=table,
            n_lanes=int(didx.shape[0]), table_rows=rows,
            unsigned=bool(unsigned), sliced=sliced, error=err)
        self._rmw_queue.append(leaf)
        return leaf.ticket

    # -- retrieval -----------------------------------------------------------

    def poll(self, ticket: Ticket):
        """Non-blocking: the retired result, a ``FailedResult`` if the
        owning plan node's execution raised, or None while still queued."""
        return self._results.get(ticket.tid)

    def result(self, ticket: Ticket):
        """Retrieve (and forget) a result, flushing first if needed.
        Re-raises the execution error if this ticket's node failed."""
        if ticket.tid not in self._results:
            if any(leaf.ticket.tid == ticket.tid
                   for q in (self._queue, self._gather_queue,
                             self._rmw_queue) for leaf in q):
                self.flush(inflight_ok=True)
            if ticket.tid not in self._results:
                raise KeyError(f"unknown ticket {ticket}")
        out = self._results.pop(ticket.tid)
        if isinstance(out, FailedResult):
            raise out.error
        return out

    # -- fairness ------------------------------------------------------------

    def _wfq_keyed(self, queue: Sequence, cursor: int,
                   queue_rank: int) -> List[tuple]:
        """Weighted-fair drain keys for one queue: ``(key, leaf)`` pairs.

        Virtual-finish-time WFQ: tenant ``t``'s ``j``-th queued leaf
        (FIFO within a tenant) finishes at ``vtime[t] + (j+1)/weight[t]``.
        Ties break by the cursor-rotated tenant rank, so with equal weights
        and idle vtime the order is exactly a rotating round-robin: every
        tenant's j-th leaf, start tenant rotating per flush.
        ``queue_rank`` orders programs before gathers before RMWs on
        cross-queue key ties (joint drain-limited selection).
        """
        by_tenant: "OrderedDict[str, list]" = OrderedDict()
        for leaf in queue:
            by_tenant.setdefault(leaf.ticket.tenant, []).append(leaf)
        tenants = list(by_tenant)
        if not tenants:
            return []
        start = cursor % len(tenants)
        rank = {t: i for i, t in
                enumerate(tenants[start:] + tenants[:start])}
        keyed = []
        for t, leaves in by_tenant.items():
            w = self._tenant_weight.get(t, 1.0)
            base = self._vtime.get(t, 0.0)
            for j, leaf in enumerate(leaves):
                keyed.append(((base + (j + 1) / w, rank[t], j, queue_rank),
                              leaf))
        return keyed

    def _fair_order(self, queue: Sequence, cursor: int) -> List:
        """Weighted-fair order across tenants, FIFO within a tenant."""
        keyed = self._wfq_keyed(queue, cursor, 0)
        keyed.sort(key=lambda e: e[0])
        return [leaf for _, leaf in keyed]

    # -- lowering (submission leaves -> AccessPlan) --------------------------

    def _lower_pending(self, drain_limit: Optional[int] = None) \
            -> plan_nodes.Plan:
        """Lower the pending queues through the plan pass pipeline.

        The lowering is cached against the exact queue contents (and
        round-robin cursor), so ``explain()`` followed by ``flush()``
        lowers once and executes the very plan it reported. Lowering
        *decisions* additionally hit the structural plan cache
        (``window_signature`` -> ``Skeleton``) across windows.

        ``drain_limit`` caps the window: the limit leaves with the
        smallest WFQ keys — selected jointly across all three queues —
        form the window; the rest stay queued (FIFO preserved) for the
        next flush.
        """
        fingerprint = (tuple(id(leaf) for leaf in self._queue),
                       tuple(id(leaf) for leaf in self._gather_queue),
                       tuple(id(leaf) for leaf in self._rmw_queue),
                       self._rr_cursor, drain_limit)
        if self._lowered is not None and self._lowered[0] == fingerprint:
            return self._lowered[1]
        cursor = self._rr_cursor
        queues = (self._queue, self._gather_queue, self._rmw_queue)
        deferred = None
        if drain_limit is not None and 0 <= drain_limit < self.pending:
            keyed = []
            for qi, q in enumerate(queues):
                keyed.extend(self._wfq_keyed(q, cursor, qi))
            keyed.sort(key=lambda e: e[0])
            take = {id(leaf) for _, leaf in keyed[:drain_limit]}
            # window keeps kind blocks (programs, gathers, RMWs) with the
            # selected leaves in WFQ order inside each block
            leaves = tuple(
                leaf for qi in range(3)
                for _, leaf in sorted(
                    (e for e in keyed if id(e[1]) in take
                     and e[0][3] == qi), key=lambda e: e[0]))
            deferred = tuple([leaf for leaf in q if id(leaf) not in take]
                             for q in queues)
        else:
            leaves = (tuple(self._fair_order(self._queue, cursor))
                      + tuple(self._fair_order(self._gather_queue, cursor))
                      + tuple(self._fair_order(self._rmw_queue, cursor)))
        order = tuple((leaf.ticket.tenant, leaf.ticket.tid)
                      for leaf in leaves)
        backend = plan_emit.backend_for(self.engine)
        signature = plan_passes.window_signature(
            leaves, self.max_batch, backend.name)
        skeleton = None
        if leaves:
            skeleton = self._plan_cache.get(signature)
            if skeleton is not None:
                self._plan_cache.move_to_end(signature)
                self.stats["plan_cache_hits"] += 1
            else:
                self.stats["plan_cache_misses"] += 1
        ctx = plan_passes.LowerContext(
            max_batch=self.max_batch, cost=self.cost, engine=self.engine,
            num_shards=int(getattr(self.engine, "num_shards", 1)),
            sharded_capable=backend.sharded, process=self.process,
            replay=skeleton, verify=self.verify)
        plan = plan_passes.lower(leaves, order, ctx, backend)
        plan.signature = signature
        plan.cache_hit = skeleton is not None
        # hazard scan rides the cached lowering: explain() and the flush
        # see one scan, and it is O(leaves) by design (analysis.hazards)
        plan.diagnostics = analysis_hazards.scan_window(plan.leaves)
        if leaves and skeleton is None:
            self._plan_cache[signature] = plan_passes.skeleton_of(plan)
            while len(self._plan_cache) > PLAN_CACHE_SIZE:
                self._plan_cache.popitem(last=False)
        self._lowered = (fingerprint, plan, deferred)
        return plan

    def explain(self) -> Explanation:
        """Lower the *pending* window (without executing or consuming it)
        and return the renderable plan — per-pass deltas, fusion and
        coalescing decisions, chosen backends. The next ``flush`` executes
        exactly this plan (same object, same node ids), which then rides
        on ``FlushReport.plan``.
        """
        return Explanation(self._lower_pending())

    # -- execution -----------------------------------------------------------

    def flush(self, *, inflight_ok: bool = False,
              drain_limit: Optional[int] = None, cut=None) -> FlushReport:
        """Blocking flush: dispatch the window and wait for retirement.

        A thin wrapper over ``flush_async`` — the decoupled access/execute
        pipeline (``repro_torch.pipeline``) uses the async form directly.
        """
        return self.flush_async(inflight_ok=inflight_ok,
                                drain_limit=drain_limit, cut=cut).result()

    def flush_async(self, *, inflight_ok: bool = False,
                    drain_limit: Optional[int] = None,
                    cut=None) -> FlushHandle:
        """Drain the queues: lower to a plan, emit every node, retire.

        Non-blocking on the card: every node's work is queued on the
        current CUDA stream and an event is recorded behind it; ``poll``/
        ``result`` on the returned ``FlushHandle`` observe/await it. (The
        planning itself synchronises where it must size a tensor on the
        host: ``torch.unique`` in the coalesce pass and in the bulk ops.)
        A node whose execution raises does not poison the flush: its
        members' tickets resolve to ``FailedResult`` (re-raised by
        ``result``) and every other node still executes.

        While a previous async window is still in flight (its handle
        neither resolved via ``result()`` nor observed retired via
        ``poll()``), another flush raises ``RuntimeError`` unless
        ``inflight_ok=True`` — what the decoupled pipeline does
        deliberately.

        ``drain_limit`` bounds the window to the limit leaves with the
        smallest WFQ keys (per-tenant SLO weights, ``configure_tenant``);
        deferred leaves stay queued and their tenants' virtual times
        advance so the next window carries the fairness debt forward.

        Over a process mesh the window is agreed across ranks first
        (``_agree``); ``cut`` names the inputs that decided to cut it here
        (a service's clock reading), which must then be equal on every
        rank, as must ``drain_limit``. The in-flight guard there tests
        whether the last handle was resolved (``result()``), never the
        device: a branch on an event query could differ between ranks.
        """
        prev = self._inflight() if self._inflight is not None else None
        busy = prev is not None and not (prev.resolved if self.process
                                         else prev.done)
        if busy and not inflight_ok:
            raise RuntimeError(
                "flush while a previous async flush window is still in "
                "flight: resolve its FlushHandle (result()) or poll() it "
                "to retirement first, or pass inflight_ok=True to overlap "
                "windows deliberately (what repro_torch.pipeline"
                ".DecoupledLoop does)")
        try:
            plan, lower_err = self._lower_pending(drain_limit), None
        except Exception as e:
            plan, lower_err = None, e
        if self.process:
            plan, lower_err = self._agree(plan, lower_err, drain_limit, cut)
        if lower_err is not None:
            e = lower_err
            # last resort: per-leaf/per-node isolation lives in the
            # passes, but an unforeseen lowering failure must still fail
            # the WINDOW, never poison the scheduler — drain the queues,
            # resolve every pending ticket to FailedResult, and leave
            # future flushes healthy
            pending = (self._queue + self._gather_queue + self._rmw_queue)
            self._queue, self._gather_queue, self._rmw_queue = [], [], []
            self._lowered = None
            self._tenant_pending.clear()
            self._vtime.clear()
            self._rr_cursor += 1
            self.stats["flushes"] += 1
            self.stats["group_errors"] += 1
            failed = FailedResult(e)
            for leaf in pending:
                self._results.setdefault(leaf.ticket.tid, failed)
            report = FlushReport(
                order=tuple((lf.ticket.tenant, lf.ticket.tid)
                            for lf in pending),
                groups=(), n_programs=0, n_gathers=0, n_rmws=0)
            handle = FlushHandle(report)
            self._inflight = weakref.ref(handle)
            return handle
        if self.strict:
            errs = [d for d in plan.diagnostics if d.severity == "ERROR"]
            if errs:
                # refuse BEFORE any queue mutation: the window stays
                # pending, so the caller can explain() the offending
                # plan, drop submissions, or re-flush non-strict
                raise HazardError(errs)
        deferred = self._lowered[2] if self._lowered is not None else None
        if deferred is None:
            self._queue, self._gather_queue, self._rmw_queue = [], [], []
            self._vtime.clear()              # full drain: no fairness debt
            self._tenant_pending.clear()
        else:
            # drain-limited window: deferred leaves stay queued (FIFO);
            # drained tenants' virtual time advances by served/weight so
            # the next window's WFQ keys carry the debt forward
            self._queue, self._gather_queue, self._rmw_queue = \
                (list(q) for q in deferred)
            self.stats["deferrals"] += sum(len(q) for q in deferred)
            for tenant, _ in plan.order:
                w = self._tenant_weight.get(tenant, 1.0)
                self._vtime[tenant] = self._vtime.get(tenant, 0.0) + 1.0 / w
            self._tenant_pending.clear()
            for q in (self._queue, self._gather_queue, self._rmw_queue):
                for leaf in q:
                    t = leaf.ticket.tenant
                    self._tenant_pending[t] = \
                        self._tenant_pending.get(t, 0) + 1
        self._lowered = None
        self._rr_cursor += 1                 # once per flush, not per queue

        ctx = plan_emit.EmitContext(
            scheduler=self, engine=self.engine, results=self._results,
            stats=self.stats, make_failed=FailedResult,
            make_group_error=lambda node, e: GroupReport(
                len(node.members), node.members[0].program.name,
                vmapped=False, fell_back=False, error=repr(e)))
        plan_emit.execute(plan, ctx, plan_emit.backend_for(self.engine))

        counts = plan.counts()
        self.stats["flushes"] += 1
        self.stats["programs"] += counts["programs"]
        self.stats["gathers"] += counts["gathers"]
        self.stats["rmws"] += counts["rmws"]
        for d in plan.diagnostics:
            bucket = ("hazard_errors" if d.severity == "ERROR"
                      else "hazard_warnings")
            self.stats[bucket] += 1
            for tenant in d.tenants:
                per = self.stats["hazards_by_tenant"].setdefault(
                    tenant, {"errors": 0, "warnings": 0})
                per["errors" if d.severity == "ERROR"
                    else "warnings"] += 1

        gather_streams = {g.table_id: tuple(g.streams)
                          for g in plan.fused("gather")}
        rmw_streams = {(r.table_id, r.op): tuple(m.idx for m in r.members)
                       for r in plan.fused("rmw")}
        report = FlushReport(
            order=plan.order,
            groups=tuple(ctx.group_reports),
            n_programs=counts["programs"],
            n_gathers=counts["gathers"],
            shard_stats=ctx.shard_stats,
            n_rmws=counts["rmws"],
            plan=plan,
            diagnostics=plan.diagnostics,
            _gather_thunk=(lambda s=gather_streams: {
                k: reorder.cross_stream_gain(v) for k, v in s.items()}),
            _rmw_thunk=(lambda s=rmw_streams: {
                k: reorder.cross_stream_gain(v) for k, v in s.items()}))
        plan.strip()   # release tensor payloads; structure stays readable
        event = None
        if self.engine.device.type == "cuda" and plan.order:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.engine.device))
        handle = FlushHandle(report, event)
        self._inflight = weakref.ref(handle)
        return handle

    # -- agreement over a process mesh ----------------------------------------

    def _agree(self, plan, lower_err, drain_limit, cut):
        """One window's agreement across the ranks of a process mesh: an
        all-gather of each rank's digest of the window (signature, drain
        limit, cut), of its lowering's decisions (the skeleton) and of the
        leaves it refused, with its exchange capacities. Returns the plan
        to execute and the window's failure (None when it runs).

        A window or a decision that differs from rank 0's raises
        ``PlanDivergence`` on every rank. A lowering that failed on any
        rank fails the window on every rank. Leaves refused on some rank
        (a wrong slice) are refused on every rank: the window is lowered
        again with the union refused, its exchanges on the safe plan
        (block placement, raw wire, worst-case capacity). Otherwise each
        mesh-placed node takes the largest capacity any rank measured."""
        t0 = time.perf_counter()
        sig = None if plan is None else plan.signature
        sharded = [] if plan is None else [
            n for n in plan.roots if isinstance(n, plan_nodes.ShardedNode)]
        refused = {} if plan is None else {
            lf.ticket.tid: repr(lf.error) for lf in plan.leaves
            if getattr(lf, "error", None) is not None}
        mine = {"window": _digest((sig, drain_limit, cut)),
                "cut": (drain_limit, cut),
                "decisions": None if plan is None
                else _digest(plan_passes.skeleton_of(plan)),
                "refused": refused,
                "caps": [n.capacity for n in sharded],
                "failed": None if lower_err is None else repr(lower_err)}
        got = self.engine.agree(mine)
        self.stats["agreements"] += 1
        try:
            bad = [r for r, g in enumerate(got)
                   if g["window"] != got[0]["window"]]
            if bad:
                # every rank sees the same list: every rank takes this
                # second exchange, to name what differs, and raises
                sigs = self.engine.agree(sig)
                self.stats["agreements"] += 1
                raise PlanDivergence(_divergence(sigs, got, bad))
            failed = [(r, g["failed"]) for r, g in enumerate(got)
                      if g["failed"]]
            if failed:
                return plan, lower_err or RuntimeError(
                    f"rank {failed[0][0]} failed to lower this window: "
                    f"{failed[0][1]}")
            union: Dict[int, tuple] = {}
            for r, g in enumerate(got):
                for tid, msg in g["refused"].items():
                    union.setdefault(tid, (r, msg))
            if any(set(g["refused"]) != set(union) for g in got):
                return self._relower_refusing(plan, union, drain_limit), None
            bad = [r for r, g in enumerate(got)
                   if g["decisions"] != got[0]["decisions"]]
            if bad:
                raise PlanDivergence(
                    f"over a process mesh every rank must lower the same "
                    f"plan (ROADMAP A14b): rank(s) {bad} decided otherwise "
                    f"than rank 0 on the same window (their streams' "
                    f"values or residence differ)")
            for node, caps in zip(sharded, zip(*(g["caps"] for g in got))):
                node.capacity = max(caps)
            return plan, None
        finally:
            self.stats["agreement_s"] += time.perf_counter() - t0

    def _relower_refusing(self, plan, union, drain_limit):
        """Lower the window again with every leaf in ``union`` (ticket id
        -> (rank, error)) refused, as on the rank that refused it; the
        mesh-placed nodes take the safe exchange plan, which needs no
        agreed measurement."""
        # only gather and RMW leaves are validated against the mesh
        for q in (self._gather_queue, self._rmw_queue):
            for leaf in q:
                hit = union.get(leaf.ticket.tid)
                if hit is not None and leaf.error is None:
                    leaf.error = ValueError(
                        f"refused on rank {hit[0]}: {hit[1]}")
        self._lowered = None
        self._plan_cache.pop(plan.signature, None)
        plan = self._lower_pending(drain_limit)
        # the skeleton of a partly refused window must not be replayed on
        # a later, whole one with the same signature
        self._plan_cache.pop(plan.signature, None)
        for node in plan.roots:
            if isinstance(node, plan_nodes.ShardedNode):
                node.placement, node.codec, node.capacity = "block", "raw", 0
        return plan

    # -- emitters (registered on the "local" backend) ------------------------
    # Thin by contract: every fusion/grouping/backend decision was made by
    # the passes; these only execute the annotated node.

    def _execute_group(self, node: plan_nodes.BatchedGroup,
                       ctx: plan_emit.EmitContext) -> None:
        members = node.members
        prog = members[0].program
        # index streams are extracted now (small device tensors, so the
        # report never pins the members' envs); the gain computation that
        # reads them back stays lazy — it runs only if the report is read
        entries = _coalescing_entries(members)
        thunk = (lambda e=entries: _coalescing_gains(e))

        def one_by_one():
            for sub in members:
                exe = self.engine.executable(sub.program)
                self._results[sub.ticket.tid] = exe(
                    sub.env, sub.regs, {}, dtypes=sub.dtypes)

        if node.backend != "vmap":
            if len(members) == 1:
                self.stats["singleton_groups"] += 1
            one_by_one()
            ctx.group_reports.append(GroupReport(
                len(members), prog.name, vmapped=False, fell_back=False,
                _coalescing_thunk=thunk))
            return

        exe = self.engine.executable(prog, batch=len(members),
                                     shared=node.shared)
        try:
            outs = exe.run_batch([s.env for s in members],
                                 [s.regs for s in members],
                                 dtypes=members[0].dtypes)
        except BatchUnsupported:
            # the lanes cannot share one run: run each member through the
            # (still cached) single-program executable. Any other error
            # fails the node (emit.execute), as it should.
            self.stats["vmap_fallbacks"] += 1
            one_by_one()
            ctx.group_reports.append(GroupReport(
                len(members), prog.name, vmapped=False, fell_back=True,
                _coalescing_thunk=thunk))
            return
        for sub, out in zip(members, outs):
            self._results[sub.ticket.tid] = out
        self.stats["vmap_groups"] += 1
        ctx.group_reports.append(GroupReport(
            len(members), prog.name, vmapped=True, fell_back=False,
            _coalescing_thunk=thunk))

    def _execute_gathers(self, node: plan_nodes.FusedGather,
                         ctx: plan_emit.EmitContext) -> None:
        table = node.table
        if node.backend == "eager":
            # direct clamped read — the coalesce pass decided dedup
            # cannot pay for itself on this stream
            for m, stream in zip(node.members, node.streams):
                self._results[m.ticket.tid] = table[stream]
            return
        # the distinct rows, sorted: the padding past n_unique repeats the
        # last row and is never read through an inverse
        uniq = node.unique_idx[:node.n_unique]
        if self.engine.use_kernel and table.ndim == 2 and node.n_unique:
            # the gather kernel over the row-table plan of the sorted
            # distinct rows (no second sort); rows come out in plan order
            tiles, lane_of = bulk_ops.gather_unique_rows(table, uniq)
            for m, inv in zip(node.members, node.inverses):
                self._results[m.ticket.tid] = tiles[lane_of[inv]]
            return
        packed = table[uniq]                   # single fused fetch
        for m, inv in zip(node.members, node.inverses):
            self._results[m.ticket.tid] = packed[inv]

    def _execute_rmws(self, node: plan_nodes.FusedRmw,
                      ctx: plan_emit.EmitContext) -> None:
        table = ctx.tables.get(node.table_id, node.table)
        new = bulk_ops.bulk_rmw(
            table, node.idx, node.values, op=node.op, cond=node.cond,
            optimize=self.engine.optimize,
            use_kernel=self.engine.use_kernel and table.ndim == 2,
            unsigned=node.unsigned, device=self.engine.device)
        ctx.tables[node.table_id] = new
        ctx.rmw_members.setdefault(node.table_id, []).extend(node.members)


# ---------------------------------------------------------------------------
# process-mesh agreement helpers
# ---------------------------------------------------------------------------

def _canon(x):
    """``x`` with its sets sorted and dataclasses as tuples, so that its
    ``repr`` is the same in every process (set order follows the string
    hash, which each process seeds anew)."""
    if isinstance(x, (set, frozenset)):
        return ("set",) + tuple(sorted((_canon(v) for v in x), key=repr))
    if isinstance(x, (tuple, list)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted(
            ((repr(_canon(k)), _canon(v)) for k, v in x.items())))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _canon(getattr(x, f.name)) for f in dataclasses.fields(x))
    return x


def _digest(x) -> str:
    return hashlib.sha256(repr(_canon(x)).encode()).hexdigest()


def _divergence(sigs, got, bad) -> str:
    """What differs between rank 0's window and the first diverging
    rank's: the first leaf, the leaf count, or the cut."""
    r = bad[0]
    head = (f"over a process mesh every rank must submit the same window "
            f"(ROADMAP A14b): rank(s) {bad} differ from rank 0")
    a, b = sigs[0], sigs[r]
    if a is None or b is None:
        return f"{head}: a lowering failed before its signature"
    rows_a, rows_b = a[0], b[0]
    for i, (x, y) in enumerate(zip(rows_a, rows_b)):
        if x != y:
            return (f"{head} first at leaf {i} (fair order): rank 0 "
                    f"{x!r:.300}, rank {r} {y!r:.300}")
    if len(rows_a) != len(rows_b):
        return (f"{head}: rank 0 has {len(rows_a)} leaves, rank {r} "
                f"{len(rows_b)}")
    return (f"{head} in the window's cut (drain_limit, cut): rank 0 "
            f"{got[0]['cut']!r}, rank {r} {got[r]['cut']!r}")


# ---------------------------------------------------------------------------
# cross-program coalescing measurement (module-level so the lazy report
# thunk closes over extracted index streams only — never over plan leaves
# or their envs)
# ---------------------------------------------------------------------------

def _coalescing_entries(members: Sequence) -> Dict[str, list]:
    """Per target region: [(caller-array id, static index stream), ...]
    across the group's members."""
    per_region: Dict[str, list] = {}
    for sub in members:
        for region, stream in _static_index_streams(sub).items():
            per_region.setdefault(region, []).append(
                (sub.src_ids.get(region), stream))
    return per_region


def _coalescing_gains(per_region: Dict[str, list]) -> Dict:
    """Score the coalescing the shared engine could apply across the
    group's indirect streams, per target region (reporting only).

    Only regions backed by the *same caller array* across members count —
    two tenants indexing private tables that happen to share a region name
    have no rows to reuse.
    """
    out = {}
    for region, entries in per_region.items():
        ids = {i for i, _ in entries}
        if len(entries) < 2 or len(ids) != 1 or None in ids:
            continue
        out[region] = reorder.cross_stream_gain([s for _, s in entries])
    return out


def _static_index_streams(sub: plan_nodes.ProgramNode) \
        -> Dict[str, torch.Tensor]:
    """Best-effort static evaluation of each ILD's index stream, on the
    engine's device (nothing is read back here).

    Walks the program propagating tiles computable from python-int regs and
    env contents (SLD with int start/stride, ILD through a known tile, ALUS
    with int operands). Unresolvable tiles (RNG outputs, tensor regs,
    condition-masked chains) simply drop out — this feeds *reporting* only.
    """
    known: Dict[str, torch.Tensor] = {}
    streams: Dict[str, list] = {}
    ts = sub.program.tile_size

    def _reg(r):
        if isinstance(r, str):
            v = sub.regs.get(r)
            return v if isinstance(v, (int, float, np.integer)) else None
        return r

    for ins in sub.program.instrs:
        if isinstance(ins, isa.SLD) and ins.tc is None:
            start, stride = _reg(ins.rs1), _reg(ins.rs3)
            if start is None or stride is None or ins.base not in sub.env:
                continue
            base = sub.env[ins.base]
            addr = int(start) + torch.arange(
                ts, dtype=torch.int64, device=base.device) * int(stride)
            known[ins.td] = base[addr.clamp(0, base.shape[0] - 1)]
        elif isinstance(ins, isa.ILD):
            idx = known.get(ins.ts1)
            if idx is None or ins.base not in sub.env or \
                    idx.is_floating_point():
                continue
            count = ts
            n = _reg("N")
            if n is not None:
                count = min(ts, int(n))
            streams.setdefault(ins.base, []).append(
                idx[:count].to(torch.int64))
            base = sub.env[ins.base]
            if base.ndim == 1:
                # propagate ignoring the condition mask: lanes past the trip
                # count are cut by [:count] above; this feeds reporting only.
                known[ins.td] = base[
                    idx.to(torch.int64).clamp(0, base.shape[0] - 1)]
        elif isinstance(ins, isa.ALUS):
            a, b = known.get(ins.ts), _reg(ins.rs)
            if a is None or b is None:
                continue
            try:
                known[ins.td] = isa.alu_apply(ins.op, a, b)
            except (TypeError, ValueError, RuntimeError):
                continue
    return {r: torch.cat(s) for r, s in streams.items() if s}


# ---------------------------------------------------------------------------
# "local" backend registration: the default pass table plus this module's
# thin emitters.
# ---------------------------------------------------------------------------

def _emit_program_group(node, ctx):
    ctx.scheduler._execute_group(plan_nodes.unwrap(node), ctx)


def _emit_fused_gather(node, ctx):
    ctx.scheduler._execute_gathers(plan_nodes.unwrap(node), ctx)


def _emit_fused_rmw(node, ctx):
    ctx.scheduler._execute_rmws(plan_nodes.unwrap(node), ctx)


plan_emit.register_backend("local", emitters={
    ("program_group", "vmap"): _emit_program_group,
    ("program_group", "eager"): _emit_program_group,
    ("gather", "bulk"): _emit_fused_gather,
    ("gather", "eager"): _emit_fused_gather,
    ("rmw", "bulk"): _emit_fused_rmw,
})

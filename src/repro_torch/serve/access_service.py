"""Async access-service frontend: N logical cores share one Scheduler.

The paper's deployment model (Fig. 2): every core owns an MMIO submission
queue into the single shared DX100; the accelerator batches and coalesces
across whatever is outstanding. ``AccessService`` is that queue fabric for
the serving layer (the port of the JAX package's
``serve.access_service``):

    svc = AccessService(controller=AdaptiveFlushController())
    core = svc.connect("decode-worker-3", weight=2.0, max_pending=64)
    t = core.submit(program, env, regs)          # async: returns a Ticket
    ...                                          # other cores submit too
    env_out, spd = core.wait(t)                  # flushes shared queue

``submit`` never executes anything — work is deferred until the flush
*controller* triggers (or, without one, until ``auto_flush`` submissions
are pending), an explicit ``flush()``, or a ``wait`` that needs the
result. ``submit_gather`` routes bulk table gathers through the
cross-request coalescing fast path: rows requested by several cores in
the same flush window are fetched once.

Open-loop serving adds three pieces:

  * **flush controllers** — ``AdaptiveFlushController`` sizes the window
    from measured arrival rate, flush overhead, and the coalescing gain
    the plan IR reports (small windows under light load, deep windows
    under bursts, a deadline so nothing waits forever);
    ``FixedWindowController`` is the fixed-threshold baseline.
  * **per-tenant serving policy** — ``connect(weight=, max_pending=)``
    forwards to ``Scheduler.configure_tenant``: SLO weights drive the
    weighted-fair drain order inside a window, ``max_pending`` bounds the
    tenant's queue (``QueueFull`` rejection — admission control).
  * **telemetry** — every submit/reject/flush feeds ``self.telemetry``
    (per-tenant p50/p99 submit->redeem latency, throughput, drop counts,
    window-depth histograms), surfaced by ``stats()``.

The service clock is microseconds from ``time.perf_counter``; replace
``svc.clock`` to drive the service on a virtual clock. The service runs on
one device (``device=None`` means CUDA), or over a mesh (``mesh=``,
``distributed.ShardedEngine``): logical shards on one device, or a
``distributed.ProcessMesh``, one service per rank.

Over a process mesh every rank must cut the same windows: the count
triggers (``auto_flush``, ``FixedWindowController``'s threshold) are
deterministic, but the wall clock is not, so a controller (whose deadline
and measured flush overhead read the clock) needs ``clock=`` a clock the
caller drives identically on every rank, and each window's clock reading
is held equal across ranks by the window's agreement (a rank that
differs raises ``core.PlanDivergence`` on every rank). ``serve.traffic
.replay_trace`` runs over a process mesh too: it takes every time from
the trace, never from the service clock, so a replayed service with a
controller is built with ``clock=VirtualClock()``; it cuts each window at
its trigger time and agrees each wall-measured flush duration across the
ranks (their maximum).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Mapping, Optional

from repro_torch.core.engine import Engine
from repro_torch.core.scheduler import (FlushHandle, FlushReport, QueueFull,
                                        Scheduler, Ticket)
from repro_torch.serve.telemetry import Telemetry


def _wall_us() -> float:
    return time.perf_counter() * 1e6


class VirtualClock:
    """A service clock its caller sets (microseconds): reads ``now``,
    the same on every rank of a process mesh while the caller sets it
    alike. The clock of a replayed service (``serve.traffic
    .replay_trace`` takes its times from the trace)."""

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def __call__(self) -> float:
        return self.now


def plan_gain(report: Optional[FlushReport]) -> Optional[float]:
    """Mean coalescing factor the plan IR measured for a window's fused
    gathers (``FusedGather.est_factor`` survives ``plan.strip()``) — the
    controller's 'g': how much a deeper window amortizes."""
    if report is None or report.plan is None:
        return None
    factors = [g.est_factor for g in report.plan.fused("gather")
               if getattr(g, "est_factor", None)]
    if not factors:
        return None
    return float(sum(factors) / len(factors))


class FlushController:
    """Base flush-trigger policy: oldest-pending deadline bookkeeping.

    Subclasses decide *when* a window closes (``should_flush``) and how
    deep a drain-limited window may go (``drain_limit``). The service
    feeds ``observe_submit``/``observe_flush`` and polls ``deadline()`` —
    the controller never owns a timer thread; deadline firing is the
    caller's loop (``AccessService.tick``).
    """

    def __init__(self, *, max_wait_us: float = 1000.0,
                 drain_cap: Optional[int] = None):
        self.max_wait_us = float(max_wait_us)
        self.drain_cap = drain_cap
        self._oldest: Optional[float] = None

    def observe_submit(self, now: float) -> None:
        if self._oldest is None:
            self._oldest = float(now)

    def observe_flush(self, depth: int, duration_us: float,
                      report: Optional[FlushReport], now: float, *,
                      pending_after: int = 0) -> None:
        # deferred leaves (drain-limited window) restart the wait clock
        self._oldest = float(now) if pending_after else None

    def deadline(self) -> Optional[float]:
        """Virtual/wall time by which a flush must fire (oldest pending
        submission + max_wait), or None when nothing is pending."""
        if self._oldest is None:
            return None
        return self._oldest + self.max_wait_us

    def should_flush(self, pending: int, now: float) -> bool:
        raise NotImplementedError

    def drain_limit(self, pending: int) -> Optional[int]:
        if self.drain_cap is None:
            return None
        return min(int(pending), int(self.drain_cap))

    def snapshot(self) -> dict:
        return {"kind": type(self).__name__,
                "max_wait_us": self.max_wait_us}


class FixedWindowController(FlushController):
    """Fixed pending-count trigger — the classic auto-flush threshold,
    expressed as a controller (fixed-small and fixed-deep baselines)."""

    def __init__(self, threshold: int, *, max_wait_us: float = 1000.0,
                 drain_cap: Optional[int] = None):
        super().__init__(max_wait_us=max_wait_us, drain_cap=drain_cap)
        self.threshold = max(1, int(threshold))

    def target_depth(self) -> int:
        return self.threshold

    def should_flush(self, pending: int, now: float) -> bool:
        if pending <= 0:
            return False
        if pending >= self.threshold:
            return True
        dl = self.deadline()
        return dl is not None and now >= dl

    def snapshot(self) -> dict:
        return {**super().snapshot(), "threshold": self.threshold}


class AdaptiveFlushController(FlushController):
    """Adaptive window sizing from measured load and plan-IR stats.

    Deep windows amortize per-flush overhead and feed the coalescing
    passes more duplicates; small windows bound submit->redeem latency.
    The controller closes a window when pending reaches a **target
    depth** computed from three EWMAs:

      * ``lam``  — arrival rate (1 / mean interarrival), from
        ``observe_submit``;
      * ``C``    — per-flush service time, from measured flush durations
        (``observe_flush``), or pinned via ``overhead_us`` for
        deterministic replays;
      * ``g``    — coalescing gain the executed plan reported
        (``FusedGather.est_factor``).

    Target = ``sqrt(2*lam*C*g)`` — the EOQ/batching square-root law —
    floored by a **utilization guard** ``2*lam*C`` so a burst's inflated
    service time keeps the window deep enough that the server does not
    re-pay overhead faster than it drains. Clamped to
    ``[min_window, max_window]``; a deadline (``max_wait_us`` past the
    oldest pending submit) bounds latency when arrivals stall mid-window.
    """

    def __init__(self, *, min_window: int = 1, max_window: int = 64,
                 max_wait_us: float = 500.0, alpha: float = 0.3,
                 overhead_us: Optional[float] = None,
                 drain_cap: Optional[int] = None):
        super().__init__(max_wait_us=max_wait_us, drain_cap=drain_cap)
        self.min_window = max(1, int(min_window))
        self.max_window = max(self.min_window, int(max_window))
        self.alpha = float(alpha)
        self._pinned = overhead_us is not None
        self._overhead_us = float(overhead_us) if self._pinned else 250.0
        self._gain = 1.5
        self._ia_us: Optional[float] = None      # EWMA interarrival
        self._last_arrival: Optional[float] = None

    # -- observations --------------------------------------------------------

    def observe_submit(self, now: float) -> None:
        super().observe_submit(now)
        if self._last_arrival is not None:
            dt = max(float(now) - self._last_arrival, 0.0)
            self._ia_us = dt if self._ia_us is None else \
                (1 - self.alpha) * self._ia_us + self.alpha * dt
        self._last_arrival = float(now)

    def observe_flush(self, depth: int, duration_us: float,
                      report: Optional[FlushReport], now: float, *,
                      pending_after: int = 0) -> None:
        super().observe_flush(depth, duration_us, report, now,
                              pending_after=pending_after)
        if depth > 0 and not self._pinned:
            self._overhead_us = ((1 - self.alpha) * self._overhead_us
                                 + self.alpha * max(float(duration_us), 0.0))
        g = plan_gain(report)
        if g is not None:
            self._gain = (1 - self.alpha) * self._gain + self.alpha * g

    # -- policy --------------------------------------------------------------

    def target_depth(self) -> int:
        if self._ia_us is None or self._ia_us <= 0:
            return self.min_window
        lam = 1.0 / max(self._ia_us, 1e-6)       # arrivals per us
        c = self._overhead_us
        n = max(math.sqrt(2.0 * lam * c * max(self._gain, 1.0)),
                2.0 * lam * c)                   # sqrt law, util guard
        return int(min(max(round(n), self.min_window), self.max_window))

    def should_flush(self, pending: int, now: float) -> bool:
        if pending <= 0:
            return False
        if pending >= self.target_depth():
            return True
        dl = self.deadline()
        return dl is not None and now >= dl

    def snapshot(self) -> dict:
        return {**super().snapshot(), "target_depth": self.target_depth(),
                "interarrival_us": self._ia_us,
                "overhead_us": self._overhead_us, "gain": self._gain,
                "min_window": self.min_window,
                "max_window": self.max_window}


class AccessService:
    """Shared submit/poll frontend over one long-lived ``Scheduler``.

    ``auto_flush``: pending-submission threshold that triggers a flush on
    the next submit (0 disables auto-flushing; callers then flush/wait).

    ``controller``: a ``FlushController`` that replaces the plain
    ``auto_flush`` threshold — ``AdaptiveFlushController`` for measured
    window sizing; its deadline fires via ``tick()`` (call it from the
    serving loop; there is no timer thread).

    ``device``: where a service built here runs its engine (``None`` =
    CUDA, ``core.device``); a prebuilt ``scheduler`` brings its own.
    ``mesh``: None for the single-device engine, or an int shard count /
    ``distributed.Mesh`` / ``distributed.ProcessMesh`` to back the service
    with a ``distributed.ShardedEngine`` — fused gathers and RMWs then
    span the mesh's shards, and each ``FlushReport`` carries the
    per-shard exchange stats (``shard_stats``). Over a ``ProcessMesh``
    each rank builds its own service and submits the same work (a
    row-sharded table as the rank's slice with ``n_rows``); a controller
    then needs a ``clock`` that reads the same on every rank.
    ``use_kernel``: a service built here runs the fused nodes' row-table
    kernels (``Engine(use_kernel=True)``).
    """

    def __init__(self, scheduler: Optional[Scheduler] = None, *,
                 tile_size: int = 16384, optimize: bool = True,
                 max_batch: int = 32, auto_flush: int = 16, mesh=None,
                 controller: Optional[FlushController] = None,
                 telemetry: Optional[Telemetry] = None,
                 clock: Optional[Callable[[], float]] = None, device=None,
                 use_kernel: bool = False):
        if scheduler is None:
            if mesh is not None:
                from repro_torch.distributed import ShardedEngine
                engine = ShardedEngine(mesh, tile_size=tile_size,
                                       optimize=optimize,
                                       use_kernel=use_kernel, device=device)
            else:
                engine = Engine(tile_size=tile_size, optimize=optimize,
                                use_kernel=use_kernel, device=device)
            scheduler = Scheduler(engine=engine, max_batch=max_batch)
        elif mesh is not None:
            raise ValueError("pass either a prebuilt scheduler or a mesh, "
                             "not both")
        if getattr(scheduler, "process", False) and controller is not None \
                and clock is None:
            raise ValueError(
                "over a ProcessMesh every input that cuts a window must be "
                "the same on every rank (ROADMAP A14b): a flush controller "
                "reads the wall clock for its deadline and flush overhead, "
                "so pass clock= a clock driven identically on every rank, "
                "or cut windows by count (auto_flush) or explicitly")
        # the clock's reading is part of a window's cut when the caller
        # drives it (over a process mesh it is agreed across ranks)
        self._own_clock = clock is not None
        self.scheduler = scheduler
        self.auto_flush = int(auto_flush)
        self.controller = controller
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.clock = clock if clock is not None else _wall_us
        self.last_report: Optional[FlushReport] = None

    # -- core handles --------------------------------------------------------

    def connect(self, tenant: str, *, weight: Optional[float] = None,
                max_pending: Optional[int] = None) -> "CoreClient":
        """A per-core handle; all handles share this service's queue.

        ``weight``/``max_pending`` set the tenant's serving policy
        (``Scheduler.configure_tenant``): WFQ drain share and bounded
        queue depth (admission control).
        """
        if weight is not None or max_pending is not None:
            self.scheduler.configure_tenant(tenant, weight=weight,
                                            max_pending=max_pending)
        return CoreClient(self, tenant)

    # -- submission / retrieval ---------------------------------------------

    def submit(self, program, env: Mapping, regs: Mapping | None = None, *,
               tenant: str = "core0") -> Ticket:
        t = self.scheduler.submit(program, env, regs, tenant=tenant)
        self._note_submit(t)
        self._maybe_flush()
        return t

    def submit_gather(self, table, idx, *, tenant: str = "core0",
                      n_rows: Optional[int] = None) -> Ticket:
        """Bulk gather fast path (see ``Scheduler.submit_gather``; over a
        process mesh ``n_rows`` marks ``table`` as the rank's slice)."""
        t = self.scheduler.submit_gather(table, idx, tenant=tenant,
                                         n_rows=n_rows)
        self._note_submit(t)
        self._maybe_flush()
        return t

    def submit_rmw(self, table, idx, values, *, op: str = "ADD",
                   cond=None, tenant: str = "core0",
                   n_rows: Optional[int] = None) -> Ticket:
        """Bulk RMW fast path (see ``Scheduler.submit_rmw``): the ticket
        resolves to the table's end-of-window state."""
        t = self.scheduler.submit_rmw(table, idx, values, op=op, cond=cond,
                                      tenant=tenant, n_rows=n_rows)
        self._note_submit(t)
        self._maybe_flush()
        return t

    def poll(self, ticket: Ticket):
        """Non-blocking: result if retired, else None."""
        return self.scheduler.poll(ticket)

    def wait(self, ticket: Ticket):
        """Retrieve a result, flushing the shared queue if still pending.
        The flush goes through ``self.flush_async`` so ``last_report``
        always describes the window that retired this ticket; the result
        comes back as soon as it is *queued* on the device (callers that
        need a barrier synchronise the stream or read the tensors)."""
        if self.scheduler.poll(ticket) is None and self.scheduler.pending:
            self.flush_async(inflight_ok=True)   # implicit resolve point
        return self.scheduler.result(ticket)

    def flush(self, *, inflight_ok: bool = False,
              drain_limit: Optional[int] = None) -> FlushReport:
        return self.flush_async(inflight_ok=inflight_ok,
                                drain_limit=drain_limit).result()

    def flush_async(self, *, inflight_ok: bool = False,
                    drain_limit: Optional[int] = None) -> FlushHandle:
        """Non-blocking flush (see ``Scheduler.flush_async``): dispatches
        the window and returns its ``FlushHandle``; ``last_report`` is set
        immediately (the report describes the dispatched window). Raises
        ``RuntimeError`` if a previous async window is still in flight,
        unless ``inflight_ok`` (deliberate multi-window overlap).

        Every flush feeds telemetry (window depth + dispatch interval on
        the service clock) and the controller's EWMAs.
        """
        pending = self.scheduler.pending
        t0 = self.clock()
        handle = self.scheduler.flush_async(
            inflight_ok=inflight_ok, drain_limit=drain_limit,
            cut=t0 if self._own_clock else None)
        t1 = self.clock()
        self.last_report = handle.report
        self.telemetry.on_flush(handle.report.order, t0, max(t1, t0),
                                pending_before=pending)
        self.telemetry.on_diagnostics(handle.report.diagnostics)
        if handle.report.shard_stats:
            # bound method, not its result: folding the exchange stats
            # copies device counts to the host, which summary() defers
            self.telemetry.on_exchange(handle.report.exchange_record)
        if self.controller is not None:
            self.controller.observe_flush(
                len(handle.report.order), t1 - t0, handle.report, t1,
                pending_after=self.scheduler.pending)
        return handle

    def tick(self, now: Optional[float] = None, *,
             force: bool = False) -> Optional[FlushReport]:
        """Deadline pump: flush if the controller's max-wait deadline has
        passed (call from the serving loop — there is no timer thread).
        ``force=True`` flushes unconditionally, including an *empty*
        window (a deadline that fires after the queue already drained
        must be harmless). Returns the flushed window's report, or None
        if nothing fired.
        """
        now = self.clock() if now is None else float(now)
        due = force
        if not due and self.controller is not None:
            dl = self.controller.deadline()
            due = dl is not None and now >= dl
        if not due:
            return None
        return self.flush_async(inflight_ok=True).report

    def explain(self):
        """Lower (without executing) the pending shared window: the
        plan-IR view of what the next flush will do, per pass — see
        ``Scheduler.explain``."""
        return self.scheduler.explain()

    def _note_submit(self, t: Ticket) -> bool:
        """Telemetry + controller bookkeeping for one submission; returns
        False (and counts a reject, not an arrival) when admission
        control refused it."""
        now = self.clock()
        if isinstance(self.scheduler.poll(t), QueueFull):
            self.telemetry.on_reject(t.tenant, now)
            return False
        self.telemetry.on_submit(t, now)
        if self.controller is not None:
            self.controller.observe_submit(now)
        return True

    def _maybe_flush(self):
        # auto-flush dispatches without blocking: the whole point of the
        # threshold is to keep the device fed, not to stall the submitter
        if self.controller is not None:
            now = self.clock()
            pending = self.scheduler.pending
            if self.controller.should_flush(pending, now):
                self.flush_async(
                    inflight_ok=True,
                    drain_limit=self.controller.drain_limit(pending))
        elif self.auto_flush and self.scheduler.pending >= self.auto_flush:
            self.flush_async(inflight_ok=True)

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def stats(self) -> dict:
        """Merged serving report: scheduler + engine cache counters, the
        telemetry summary (per-tenant latency percentiles, throughput,
        rejects, window-depth histogram) under ``traffic``, and the
        controller's state snapshot."""
        return {**self.scheduler.stats,
                "engine": dict(self.scheduler.engine.stats),
                "traffic": self.telemetry.summary(),
                "controller": (None if self.controller is None
                               else self.controller.snapshot())}


@dataclasses.dataclass
class CoreClient:
    """One logical core's view of the shared service (fixed tenant id)."""
    service: AccessService
    tenant: str

    def submit(self, program, env, regs=None) -> Ticket:
        return self.service.submit(program, env, regs, tenant=self.tenant)

    def submit_gather(self, table, idx, *, n_rows=None) -> Ticket:
        return self.service.submit_gather(table, idx, tenant=self.tenant,
                                          n_rows=n_rows)

    def submit_rmw(self, table, idx, values, *, op="ADD", cond=None,
                   n_rows=None) -> Ticket:
        return self.service.submit_rmw(table, idx, values, op=op, cond=cond,
                                       tenant=self.tenant, n_rows=n_rows)

    def poll(self, ticket: Ticket):
        return self.service.poll(ticket)

    def wait(self, ticket: Ticket):
        return self.service.wait(ticket)

"""Seeded open-loop traffic: workload generator + virtual-time replay.

The missing half of the paper's shared-accelerator story: DX100 is sized
by *open-loop* arrivals from many cores, not by closed-loop tests that
flush whatever happens to be queued. This module generates that load and
replays it deterministically:

  * ``generate_trace(TrafficConfig)`` — Poisson arrivals whose rate is
    modulated by alternating idle/burst phases (mean gap
    ``idle_gap_us`` vs ``idle_gap_us / burst_factor``), zipf-skewed
    tenant popularity over thousands of logical tenants and zipf-skewed
    table popularity, emitting a deterministic, replayable sequence of
    gather / RMW / program submissions (plus occasional explicit ``tick``
    events that model a deadline timer firing — sometimes with an empty
    queue). Index-stream lengths and table rows come from small fixed
    menus so the engine's jitted bulk ops hit their compile cache across
    the whole trace (the same trick as ``testing.fuzzer``).

  * ``replay_trace(trace, service)`` — drives the service's scheduler
    with the trace on a **virtual clock**: arrivals occur at the trace's
    timestamps; each flush's service time is either wall-measured or
    supplied by a deterministic model; completions land on a single-server
    busy timeline (a flush starts at ``max(trigger, server_free)``).
    The service's flush *controller* decides when windows close — count
    triggers inline with arrivals, deadline triggers simulated exactly
    (a deadline earlier than the next arrival fires first). Telemetry is
    fed with virtual times, so p50/p99 submit->redeem latency,
    throughput, and window-depth histograms all come out in trace time —
    comparable across machines when a service-time model is used.

This is the port of the JAX package's ``serve.traffic``. Generation is the
reference's NumPy, draw for draw, so a config gives the same trace and the
same ``Trace.digest()`` in both packages; replay submits to the port's
scheduler, whose results are tensors on the service's device. Replay also
runs SPMD over a process mesh, each rank holding its rows of every table
(see ``replay_trace``).

Parity-friendly by construction (as the JAX package's
``fuzzer.generate_mixed_case``):
gather tables (``G*``) and RMW tables (``R*``) are disjoint, each RMW
table has a single op, and RMW tables are integer by default
(``float_rmw=False``) — so every ticket's expected value is bit-exact
however the controller windows the trace (gathers read the submit-time
snapshot; an RMW ticket resolves to its window's end state, recoverable
from ``FlushReport.order``). The JAX package's
``testing.harness.check_traffic_parity`` holds each ticket to that.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compiler, interop
from repro_torch.core.scheduler import FlushReport, QueueFull, Ticket

# menus (not knobs): the reference's, fixed so its jit caches hit across
# the trace (and so a seed draws the same trace here)
_GATHER_ROWS = (64, 128, 256)
_RMW_ROWS = (16, 64, 128)
_STREAM_LENS = (16, 32, 64, 128)
_RMW_OP_MENU = ("ADD", "MIN", "MAX", "AND", "OR", "XOR")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Deterministic trace recipe — the trace IS this config (plus the
    generator version): commit the config + digest, not the event list."""
    seed: int = 0
    n_events: int = 2000
    n_tenants: int = 2000          # logical tenants; zipf-ranked popularity
    n_gather_tables: int = 3
    n_rmw_tables: int = 2
    zipf_tenant: float = 1.2       # popularity exponent (higher = skew)
    zipf_table: float = 1.1
    idle_gap_us: float = 500.0     # mean Poisson interarrival, idle phase
    burst_factor: float = 100.0    # burst rate = idle rate * factor
    mean_phase_events: int = 120   # mean events per idle/burst phase
    p_rmw: float = 0.30            # event mix: rest are gathers
    p_program: float = 0.04        # compiled-program submissions
    p_tick: float = 0.01           # explicit deadline-timer events
    p_cond: float = 0.25           # conditional RMW probability
    p_oob: float = 0.125           # OOB-poisoned index streams (clamp/drop)
    float_rmw: bool = False        # True adds float-ADD RMW tables (bench
    #                                only — parity then needs allclose)
    n_program_shapes: int = 3      # distinct fuzzer programs reused
    # -- paged-KV load (apps.kv_serve's access shape as open-loop traffic).
    # Both probabilities default to 0.0: the KV pool table, its rng, and
    # the kv_decode/kv_append event kinds only exist when enabled, so
    # pre-existing configs generate byte-identical traces (pinned digests
    # like benchmarks/traffic_bench.DIGEST stay valid).
    p_kv_decode: float = 0.0       # page-table history gathers on the pool
    p_kv_append: float = 0.0       # unique-slot ADD appends into the pool
    kv_seqs: int = 6               # concurrent sequences sharing the pool
    kv_page_size: int = 8          # slots per physical page
    kv_pages: int = 48             # pool capacity (pages); appends wrap by
    #                                resetting the longest sequence
    kv_prefix_pages: int = 2       # shared-prefix pages (hot across seqs)
    kv_d: int = 4                  # K/V row width


@dataclasses.dataclass
class TrafficEvent:
    """One trace entry.

    ``kind``: gather | rmw | program | tick | kv_decode | kv_append.
    ``kv_decode`` is a gather whose index stream walks a sequence's page
    table (shared-prefix pages hot across tenants); ``kv_append`` is an
    ADD RMW into freshly allocated pool slots (integer-valued f32, so the
    parity oracle can hold it bit-exact). Replay lowers them through
    ``submit_gather``/``submit_rmw`` like their plain counterparts — the
    *kinds* exist so load generators and telemetry can distinguish KV
    serving traffic from generic bulk traffic.
    """
    t_us: float
    kind: str
    tenant: str
    table: str = ""
    idx: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None
    op: str = ""
    cond: Optional[np.ndarray] = None
    program_id: int = -1


@dataclasses.dataclass
class Trace:
    config: TrafficConfig
    events: List[TrafficEvent]
    tables: Dict[str, np.ndarray]
    table_ops: Dict[str, str]
    programs: List[tuple]          # (pattern, env, n) via fuzzer seeds

    def digest(self) -> str:
        """Content hash over every event field and table — the committed
        fingerprint that pins 'the fixed trace' across generator runs."""
        h = hashlib.sha256()
        for name in sorted(self.tables):
            h.update(name.encode())
            h.update(np.ascontiguousarray(self.tables[name]).tobytes())
        for ev in self.events:
            h.update(f"{ev.t_us:.3f}|{ev.kind}|{ev.tenant}|{ev.table}|"
                     f"{ev.op}|{ev.program_id}".encode())
            for a in (ev.idx, ev.values, ev.cond):
                if a is not None:
                    h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]

    def to_json(self) -> str:
        """Compact committed form: the config + digest (the event list is
        deterministic from the config; ``from_json`` regenerates and
        verifies)."""
        return json.dumps({"config": dataclasses.asdict(self.config),
                           "digest": self.digest()}, indent=1)

    @staticmethod
    def from_json(text: str) -> "Trace":
        doc = json.loads(text)
        trace = generate_trace(TrafficConfig(**doc["config"]))
        got = trace.digest()
        if got != doc["digest"]:
            raise ValueError(
                f"trace digest mismatch: committed {doc['digest']}, "
                f"regenerated {got} — the generator changed; re-commit "
                "the trace (and re-baseline BENCH_traffic.json)")
        return trace

    def summary(self) -> dict:
        kinds: Dict[str, int] = {}
        tenants = set()
        for ev in self.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
            tenants.add(ev.tenant)
        return {"n_events": len(self.events), "kinds": kinds,
                "n_active_tenants": len(tenants),
                "makespan_us": self.events[-1].t_us if self.events else 0.0,
                "digest": self.digest()}


def _zipf_probs(n: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return p / p.sum()


def _poison(rng: np.random.Generator, idx: np.ndarray, rows: int,
            p_oob: float) -> np.ndarray:
    if idx.size and rng.random() < p_oob:
        k = max(1, idx.size // 8)
        pos = rng.choice(idx.size, size=k, replace=False)
        bad = np.where(rng.random(k) < 0.5,
                       -rng.integers(1, rows + 2, size=k),
                       rows + rng.integers(0, rows + 2, size=k))
        idx[pos] = bad.astype(np.int32)
    return idx


def generate_trace(cfg: TrafficConfig) -> Trace:
    """Deterministically generate one open-loop trace from ``cfg``."""
    rng = np.random.default_rng(0xD100 + cfg.seed)

    tables: Dict[str, np.ndarray] = {}
    table_ops: Dict[str, str] = {}
    for t in range(cfg.n_gather_tables):
        rows = int(_GATHER_ROWS[t % len(_GATHER_ROWS)])
        if rng.random() < 0.5:
            tables[f"G{t}"] = rng.normal(size=(rows,)).astype(np.float32)
        else:
            d = int(rng.integers(2, 7))
            tables[f"G{t}"] = rng.normal(size=(rows, d)).astype(np.float32)
    for t in range(cfg.n_rmw_tables):
        rows = int(_RMW_ROWS[t % len(_RMW_ROWS)])
        if cfg.float_rmw and rng.random() < 0.3:
            tables[f"R{t}"] = rng.normal(size=(rows,)).astype(np.float32)
            table_ops[f"R{t}"] = "ADD"
        else:
            dt = np.int32 if rng.random() < 0.5 else np.uint32
            tables[f"R{t}"] = rng.integers(
                0, 2 ** 12, size=(rows,)).astype(dt)
            table_ops[f"R{t}"] = str(rng.choice(_RMW_OP_MENU))

    programs: List[tuple] = []
    if cfg.p_program > 0:
        from repro_torch.testing.fuzzer import generate_case
        for k in range(cfg.n_program_shapes):
            c = generate_case(0xD1_0000 + cfg.seed * 31 + k)
            programs.append((c.pattern, c.env, min(c.n, 128)))

    # paged-KV load (fully gated: a disabled config draws nothing from the
    # main rng here and adds no tables — pinned digests stay valid). KV
    # internals use their own rng so enabling KV perturbs only KV events.
    kv_on = cfg.p_kv_decode > 0 or cfg.p_kv_append > 0
    if kv_on:
        if cfg.kv_pages <= cfg.kv_prefix_pages:
            raise ValueError("kv_pages must exceed kv_prefix_pages")
        krng = np.random.default_rng(0xD1_00F0 + cfg.seed)
        p = cfg.kv_page_size
        tables["K0"] = krng.integers(
            0, 8, size=(cfg.kv_pages * p, cfg.kv_d)).astype(np.float32)
        table_ops["K0"] = "ADD"
        kv_lens = [cfg.kv_prefix_pages * p] * cfg.kv_seqs
        kv_tables = [list(range(cfg.kv_prefix_pages))
                     for _ in range(cfg.kv_seqs)]
        kv_free = list(range(cfg.kv_prefix_pages, cfg.kv_pages))

        def kv_slots(s: int) -> np.ndarray:
            pages = np.asarray(kv_tables[s], np.int32)
            flat = (pages[:, None] * p
                    + np.arange(p, dtype=np.int32)[None, :]).reshape(-1)
            return flat[:kv_lens[s]]

        def kv_alloc(s: int, want: int) -> np.ndarray:
            """Slots for ``want`` new tokens of seq ``s``; when the pool
            is exhausted the longest sequence is reset (its private pages
            return to the free list) so the trace wraps instead of OOMing."""
            dests = []
            for _ in range(want):
                page_i, off = divmod(kv_lens[s], p)
                if page_i == len(kv_tables[s]):
                    if not kv_free:
                        victim = int(np.argmax(kv_lens))
                        kv_free.extend(kv_tables[victim]
                                       [cfg.kv_prefix_pages:])
                        del kv_tables[victim][cfg.kv_prefix_pages:]
                        kv_lens[victim] = cfg.kv_prefix_pages * p
                        if victim == s:
                            page_i, off = divmod(kv_lens[s], p)
                    kv_tables[s].append(kv_free.pop(0))
                dests.append(kv_tables[s][page_i] * p + off)
                kv_lens[s] += 1
            return np.asarray(dests, np.int32)

    # zipf popularity over tenant/table ranks; a seeded shuffle maps rank
    # to identity so "the hot tenant" isn't always t0000 across seeds
    tenant_ids = rng.permutation(cfg.n_tenants)
    p_tenant = _zipf_probs(cfg.n_tenants, cfg.zipf_tenant)
    tenant_draw = rng.choice(cfg.n_tenants, size=cfg.n_events, p=p_tenant)
    p_gt = _zipf_probs(cfg.n_gather_tables, cfg.zipf_table)
    p_rt = _zipf_probs(cfg.n_rmw_tables, cfg.zipf_table)

    events: List[TrafficEvent] = []
    t_us = 0.0
    burst = False
    phase_left = 0
    for k in range(cfg.n_events):
        if phase_left <= 0:
            burst = not burst
            phase_left = max(1, int(rng.geometric(
                1.0 / max(cfg.mean_phase_events, 1))))
        phase_left -= 1
        gap = cfg.idle_gap_us / (cfg.burst_factor if burst else 1.0)
        t_us += float(rng.exponential(gap))
        tenant = f"t{int(tenant_ids[tenant_draw[k]]):04d}"

        r = rng.random()
        if r < cfg.p_tick:
            events.append(TrafficEvent(t_us=t_us, kind="tick",
                                       tenant=tenant))
            continue
        if r < cfg.p_tick + cfg.p_program and programs:
            events.append(TrafficEvent(
                t_us=t_us, kind="program", tenant=tenant,
                program_id=int(rng.integers(0, len(programs)))))
            continue
        n = int(rng.choice(_STREAM_LENS))
        if r < cfg.p_tick + cfg.p_program + cfg.p_rmw:
            name = f"R{int(rng.choice(cfg.n_rmw_tables, p=p_rt))}"
            table = tables[name]
            rows = table.shape[0]
            idx = _poison(rng, rng.integers(0, rows, size=n).astype(
                np.int32), rows, cfg.p_oob)
            if table.dtype == np.float32:
                vals = rng.normal(size=n).astype(np.float32)
            else:
                vals = rng.integers(0, 2 ** 10, size=n).astype(table.dtype)
            cond = ((rng.random(n) < 0.7)
                    if rng.random() < cfg.p_cond else None)
            events.append(TrafficEvent(
                t_us=t_us, kind="rmw", tenant=tenant, table=name, idx=idx,
                values=vals, op=table_ops[name], cond=cond))
        elif kv_on and r < (cfg.p_tick + cfg.p_program + cfg.p_rmw
                            + cfg.p_kv_decode):
            s = int(krng.integers(0, cfg.kv_seqs))
            events.append(TrafficEvent(
                t_us=t_us, kind="kv_decode", tenant=tenant, table="K0",
                idx=kv_slots(s)))
        elif kv_on and r < (cfg.p_tick + cfg.p_program + cfg.p_rmw
                            + cfg.p_kv_decode + cfg.p_kv_append):
            s = int(krng.integers(0, cfg.kv_seqs))
            want = int(krng.integers(1, cfg.kv_page_size + 1))
            dests = kv_alloc(s, want)
            vals = krng.integers(
                0, 8, size=(want, cfg.kv_d)).astype(np.float32)
            events.append(TrafficEvent(
                t_us=t_us, kind="kv_append", tenant=tenant, table="K0",
                idx=dests, values=vals, op="ADD"))
        else:
            name = f"G{int(rng.choice(cfg.n_gather_tables, p=p_gt))}"
            rows = tables[name].shape[0]
            idx = _poison(rng, rng.integers(0, rows, size=n).astype(
                np.int32), rows, cfg.p_oob)
            events.append(TrafficEvent(
                t_us=t_us, kind="gather", tenant=tenant, table=name,
                idx=idx))
    return Trace(config=cfg, events=events, tables=tables,
                 table_ops=table_ops, programs=programs)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayResult:
    """One replay run: admitted tickets (paired with their events),
    rejected tickets, and the (start_us, FlushReport) window log. The
    telemetry that accumulated the run rides on the service
    (``service.telemetry`` / ``service.stats()``)."""
    trace: Trace
    tickets: List[Tuple[TrafficEvent, Ticket]]
    rejected: List[Tuple[TrafficEvent, Ticket]]
    windows: List[Tuple[float, FlushReport]]
    makespan_us: float

    @property
    def n_flushes(self) -> int:
        return len(self.windows)

    def window_of(self) -> Dict[int, int]:
        """ticket tid -> index of the window that drained it (recovers
        window membership for the RMW end-of-window oracle)."""
        return {tid: wi for wi, (_, rep) in enumerate(self.windows)
                for _, tid in rep.order}


def replay_trace(trace: Trace, service, *,
                 service_time: Optional[Callable] = None,
                 tile_size: Optional[int] = None) -> ReplayResult:
    """Replay ``trace`` through ``service`` on a virtual clock.

    ``service_time``: None wall-measures each flush dispatch
    (``time.perf_counter``); or a callable ``(depth, report) ->
    duration_us`` for a deterministic service-time model (what the
    committed bench and the parity/property tests use — results are then
    machine-independent). Flush triggering is the service's controller
    (count threshold inline with arrivals, deadline simulated exactly
    between arrivals; no controller falls back to ``service.auto_flush``).
    Completions land on a single-server busy timeline; telemetry sees
    virtual times throughout.

    ``tile_size`` only affects how the trace's *programs* are compiled
    for submission; it defaults to the service engine's own tile so the
    scratchpad shapes always agree with the executor.

    Over a process mesh (a service over ``ShardedEngine(ProcessMesh)``,
    SPMD: every rank replays the same trace) each rank cuts every trace
    table to its rows once (``ShardedEngine.slice_of``), on its device,
    and submits the slices with ``n_rows``; programs keep their whole
    envs. Each window is cut at its trigger time (``cut=``, held equal by
    the window's agreement), and a wall-measured flush duration is agreed
    across the ranks (their maximum: a window ends when its slowest unit
    does) before it reaches the busy timeline, the telemetry or the
    controller. The service's own clock is never read: every time comes
    from the trace. The ``ReplayResult`` and the
    telemetry are then the same on every rank; a gather ticket resolves
    to its whole result, an RMW ticket to the rank's slice.
    """
    sched = service.scheduler
    process = getattr(sched, "process", False)
    if tile_size is None:
        tile_size = sched.engine.tile_size
    ctl = service.controller
    tel = service.telemetry
    # table name -> (what to submit, submit kwargs)
    tables = {name: sched.engine.slice_of(t)
              for name, t in trace.tables.items()}
    now = 0.0
    server_free = 0.0
    windows: List[Tuple[float, FlushReport]] = []
    tickets: List[Tuple[TrafficEvent, Ticket]] = []
    rejected: List[Tuple[TrafficEvent, Ticket]] = []
    compiled: Dict[int, tuple] = {}

    def do_flush(trigger_us: float) -> FlushReport:
        nonlocal server_free
        pending = sched.pending
        limit = ctl.drain_limit(pending) if ctl is not None else None
        w0 = time.perf_counter()
        handle = sched.flush_async(inflight_ok=True, drain_limit=limit,
                                   cut=float(trigger_us) if process
                                   else None)
        handle.result()
        rep = handle.report
        if service_time is None:
            d = (time.perf_counter() - w0) * 1e6
            if process:
                d = max(sched.engine.agree(d))
        else:
            d = float(service_time(len(rep.order), rep))
        start = max(float(trigger_us), server_free)
        end = start + d
        server_free = end
        tel.on_flush(rep.order, start, end, pending_before=pending)
        tel.on_diagnostics(rep.diagnostics)
        if ctl is not None:
            ctl.observe_flush(len(rep.order), d, rep, end,
                              pending_after=sched.pending)
        service.last_report = rep
        windows.append((start, rep))
        return rep

    def submit(ev: TrafficEvent) -> Ticket:
        # kv_decode/kv_append are page-structured load generators; they
        # lower to the same two bulk submissions as their plain kinds
        if ev.kind in ("gather", "kv_decode"):
            table, kw = tables[ev.table]
            return sched.submit_gather(table, ev.idx, tenant=ev.tenant,
                                       n_rows=kw.get("n_rows"))
        if ev.kind in ("rmw", "kv_append"):
            table, kw = tables[ev.table]
            return sched.submit_rmw(table, ev.idx, ev.values, op=ev.op,
                                    cond=ev.cond, tenant=ev.tenant, **kw)
        # program: compile each distinct shape once, submit with its env
        if ev.program_id not in compiled:
            pattern, env, n = trace.programs[ev.program_id]
            prog, _ = compiler.compile_pattern(pattern, tile_size=tile_size)
            dev = sched.engine.device
            denv = interop.env_from_numpy(env, device=dev)
            denv["__iota__"] = torch.arange(tile_size, dtype=torch.int32,
                                            device=dev)
            compiled[ev.program_id] = (
                prog, denv, {"tile_base": 0, "N": n, "tile_end": n},
                interop.dtypes_of(env))
        prog, denv, regs, dtypes = compiled[ev.program_id]
        return sched.submit(prog, denv, regs, tenant=ev.tenant,
                            dtypes=dtypes)

    for ev in trace.events:
        # a controller deadline earlier than this arrival fires first
        while ctl is not None:
            dl = ctl.deadline()
            if dl is None or dl > ev.t_us:
                break
            do_flush(dl)
        now = ev.t_us
        if ev.kind == "tick":
            # explicit timer pop — must be harmless even with an empty
            # queue (the deadline-fires-with-zero-pending case)
            do_flush(now)
            continue
        t = submit(ev)
        if isinstance(sched.poll(t), QueueFull):
            tel.on_reject(ev.tenant, now)
            rejected.append((ev, t))
            continue
        tel.on_submit(t, now)
        tickets.append((ev, t))
        if ctl is not None:
            ctl.observe_submit(now)
            while (sched.pending
                   and ctl.should_flush(sched.pending, now)):
                do_flush(now)
        elif service.auto_flush and sched.pending >= service.auto_flush:
            do_flush(now)

    while sched.pending:                      # final drain
        do_flush(max(now, server_free))
    return ReplayResult(trace=trace, tickets=tickets, rejected=rejected,
                        windows=windows,
                        makespan_us=max(now, server_free))

"""Tail-latency telemetry for the shared access service (NumPy only; the
port of the JAX package's ``serve.telemetry``, decision for decision).

Under open-loop traffic the question a shared accelerator has to answer
is not "how fast is one flush" but "what latency distribution does each
tenant see between submitting a request and being able to redeem it" —
the p99 the window-sizing controller trades against coalescing depth.
This module is the measurement layer:

  * ``Telemetry.on_submit`` / ``on_reject`` stamp each ticket's arrival
    (admission-control rejects are counted per tenant, never timed — a
    rejected submission has no latency, it has a drop);
  * ``on_flush`` records one drained window: its depth and its
    ``[start, end]`` service interval. Ticket completion times are
    interpolated across the window's **drain order** — position ``i`` of
    ``n`` completes at ``start + (end - start) * (i + 1) / n`` — which is
    what makes weighted-fair-queueing drain order *observable*: a tenant
    whose SLO weight moves its requests to the front of the window sees
    strictly earlier completions;
  * ``summary()`` folds everything into per-tenant p50/p99/mean
    submit->redeem latency, reject/drop counts, throughput over the
    observed makespan, and a power-of-two window-depth histogram.

Timestamps are caller-supplied floats in **microseconds** on any
monotone clock: the live service feeds wall time
(``time.perf_counter() * 1e6``), the traffic replay feeds virtual time
(arrivals from the trace, service intervals from measured or modeled
flush durations). The math never cares which.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _percentile(xs: Sequence[float], q: float) -> float:
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


@dataclasses.dataclass
class TenantStats:
    """Folded per-tenant record (one row of ``summary()['tenants']``)."""
    n: int
    p50_us: float
    p99_us: float
    mean_us: float
    max_us: float
    rejects: int
    drops: int


class Telemetry:
    """Per-tenant submit->redeem latency + window-shape accounting.

    One instance rides on an ``AccessService`` (``service.telemetry``)
    and is additionally fed by ``serve.traffic.replay_trace`` when a
    trace drives the service on a virtual clock. All methods are O(1)-ish
    per event; percentile math happens only in ``summary()``.
    """

    def __init__(self):
        # tid -> (tenant, submit time); completed latencies per tenant
        self._open: Dict[int, Tuple[str, float]] = {}
        self._lat: Dict[str, List[float]] = {}
        self._rejects: Dict[str, int] = {}
        self._drops: Dict[str, int] = {}
        self._depths: List[int] = []
        self._window_spans: List[Tuple[float, float]] = []
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self.n_submits = 0
        self.n_completed = 0
        # hazard diagnostics (analysis.hazards via on_diagnostics)
        self._diag_by_code: Dict[str, int] = {}
        self._diag_by_tenant: Dict[str, Dict[str, int]] = {}
        self.n_diag_errors = 0
        self.n_diag_warnings = 0
        # mesh exchange accounting: queued thunks (one per sharded
        # window, typically ``FlushReport.exchange_summary``) fold into
        # the accumulator only when read — evaluating one reads the
        # shard stats back (a device sync), which must never happen on
        # the flush hot path. Nothing feeds it until the sharded engine
        # is ported.
        self._exchange_thunks: List = []
        self._exchange_acc: Optional[Dict[str, float]] = None

    # -- event feed ----------------------------------------------------------

    def on_submit(self, ticket, now: float) -> None:
        """Stamp one admitted submission (``ticket`` carries tenant+tid)."""
        self._open[ticket.tid] = (ticket.tenant, float(now))
        self.n_submits += 1
        if self._t_first is None or now < self._t_first:
            self._t_first = float(now)

    def on_reject(self, tenant: str, now: float) -> None:
        """Count one admission-control rejection (``QueueFull``)."""
        self._rejects[tenant] = self._rejects.get(tenant, 0) + 1

    def on_drop(self, tenant: str, now: float = 0.0) -> None:
        """Count one admitted-but-failed ticket (``FailedResult``)."""
        self._drops[tenant] = self._drops.get(tenant, 0) + 1

    def on_flush(self, order: Sequence[Tuple[str, int]], start: float,
                 end: float, *, pending_before: Optional[int] = None) -> None:
        """Record one drained window.

        ``order``: the window's drain order — ``FlushReport.order``'s
        (tenant, tid) pairs. ``start``/``end``: the service interval on
        the caller's clock. Completion times interpolate linearly across
        the drain order; tickets this telemetry never saw submitted
        (another client's traffic) are skipped.
        """
        n = len(order)
        self._depths.append(n if pending_before is None
                            else int(pending_before))
        self._window_spans.append((float(start), float(end)))
        if n == 0:
            return
        span = float(end) - float(start)
        for i, (_, tid) in enumerate(order):
            entry = self._open.pop(tid, None)
            if entry is None:
                continue
            tenant, t_sub = entry
            t_done = float(start) + span * (i + 1) / n
            self._lat.setdefault(tenant, []).append(t_done - t_sub)
            self.n_completed += 1
            if self._t_last is None or t_done > self._t_last:
                self._t_last = t_done

    def on_diagnostics(self, diagnostics) -> None:
        """Count one window's hazard diagnostics
        (``FlushReport.diagnostics`` — analysis.hazards DX0xx codes),
        per code, severity and involved tenant."""
        for d in diagnostics:
            self._diag_by_code[d.code] = \
                self._diag_by_code.get(d.code, 0) + 1
            if d.severity == "ERROR":
                self.n_diag_errors += 1
            else:
                self.n_diag_warnings += 1
            for tenant in d.tenants:
                per = self._diag_by_tenant.setdefault(
                    tenant, {"errors": 0, "warnings": 0})
                per["errors" if d.severity == "ERROR"
                    else "warnings"] += 1

    def on_exchange(self, summarize) -> None:
        """Queue one sharded window's exchange record. ``summarize`` is a
        zero-arg callable returning ``FlushReport.exchange_summary()``'s
        dict (or None) — pass the *bound method*, not its result, so the
        device sync it implies is deferred to ``summary()`` time."""
        self._exchange_thunks.append(summarize)

    # -- folding -------------------------------------------------------------

    def exchange_summary(self) -> Optional[dict]:
        """Folded mesh-exchange record across every sharded window seen
        so far: post-dedup lanes, the fraction served without fabric
        traffic, bytes on the wire (and the codec's compression ratio
        over raw int32 lanes), and the mean route/exec overlap; over a
        process mesh also this rank's ``transport`` and the collectives
        its sharded nodes issued. None until a sharded window reports. Draining the queued thunks may
        sync the device — call off the flush hot path."""
        thunks, self._exchange_thunks = self._exchange_thunks, []
        for thunk in thunks:
            s = thunk()
            if s is None:
                continue
            acc = self._exchange_acc
            if acc is None:
                acc = self._exchange_acc = {
                    "windows": 0, "nodes": 0, "lanes": 0,
                    "local_lanes": 0.0, "bytes_on_wire": 0,
                    "idx_bytes": 0, "idx_bytes_raw": 0.0,
                    "overlap_sum": 0.0, "overlap_n": 0}
            acc["windows"] += 1
            if "collectives" in s:       # a process mesh's rank
                acc["collectives"] = acc.get("collectives", 0) + \
                    s["collectives"]
                acc["transport"] = s["transport"]
            acc["nodes"] += s["nodes"]
            acc["lanes"] += s["lanes"]
            acc["local_lanes"] += s["local_fraction"] * s["lanes"]
            acc["bytes_on_wire"] += s["bytes_on_wire"]
            acc["idx_bytes"] += s["idx_bytes"]
            acc["idx_bytes_raw"] += s["compression_ratio"] * s["idx_bytes"]
            if s["overlap_fraction"] is not None:
                acc["overlap_sum"] += s["overlap_fraction"]
                acc["overlap_n"] += 1
        acc = self._exchange_acc
        if acc is None:
            return None
        rank = {k: acc[k] for k in ("transport", "collectives") if k in acc}
        return {
            **rank,
            "windows": acc["windows"],
            "nodes": acc["nodes"],
            "lanes": acc["lanes"],
            "local_fraction": acc["local_lanes"] / max(acc["lanes"], 1),
            "bytes_on_wire": acc["bytes_on_wire"],
            "compression_ratio": (acc["idx_bytes_raw"] / acc["idx_bytes"]
                                  if acc["idx_bytes"] else 1.0),
            "overlap_fraction": (acc["overlap_sum"] / acc["overlap_n"]
                                 if acc["overlap_n"] else None),
        }

    def tenant_stats(self, tenant: str) -> TenantStats:
        xs = self._lat.get(tenant, [])
        return TenantStats(
            n=len(xs), p50_us=_percentile(xs, 50), p99_us=_percentile(xs, 99),
            mean_us=float(np.mean(xs)) if xs else float("nan"),
            max_us=float(np.max(xs)) if xs else float("nan"),
            rejects=self._rejects.get(tenant, 0),
            drops=self._drops.get(tenant, 0))

    def depth_histogram(self) -> Dict[str, int]:
        """Power-of-two window-depth buckets ("0", "1", "2", "3-4", ...)."""
        hist: Dict[str, int] = {}
        for d in self._depths:
            if d <= 2:
                key = str(d)
            else:
                hi = 1 << (d - 1).bit_length()
                key = f"{hi // 2 + 1}-{hi}"
            hist[key] = hist.get(key, 0) + 1
        return hist

    def summary(self) -> dict:
        """The full folded report (what ``AccessService.stats()`` embeds).

        ``overall.throughput_per_s`` is completed tickets over the
        first-submit -> last-completion makespan, in events per *second*
        of the feeding clock (1e6 us).
        """
        all_lat = [x for xs in self._lat.values() for x in xs]
        makespan = ((self._t_last - self._t_first)
                    if self._t_first is not None and self._t_last is not None
                    else 0.0)
        tenants = {t: dataclasses.asdict(self.tenant_stats(t))
                   for t in sorted(set(self._lat) | set(self._rejects)
                                   | set(self._drops))}
        return {
            "tenants": tenants,
            "overall": {
                "n_submits": self.n_submits,
                "n_completed": self.n_completed,
                "inflight": len(self._open),
                "rejects": sum(self._rejects.values()),
                "drops": sum(self._drops.values()),
                "p50_us": _percentile(all_lat, 50),
                "p99_us": _percentile(all_lat, 99),
                "mean_us": (float(np.mean(all_lat)) if all_lat
                            else float("nan")),
                "makespan_us": makespan,
                "throughput_per_s": (self.n_completed / makespan * 1e6
                                     if makespan > 0 else float("nan")),
            },
            "windows": {
                "n_flushes": len(self._depths),
                "mean_depth": (float(np.mean(self._depths))
                               if self._depths else 0.0),
                "max_depth": max(self._depths, default=0),
                "depth_hist": self.depth_histogram(),
            },
            "diagnostics": {
                "errors": self.n_diag_errors,
                "warnings": self.n_diag_warnings,
                "by_code": dict(sorted(self._diag_by_code.items())),
                "by_tenant": {t: dict(v) for t, v in
                              sorted(self._diag_by_tenant.items())},
            },
            "exchange": self.exchange_summary(),
        }

    def render(self, *, top: int = 8) -> str:
        """Human-readable report: overall line, worst-p99 tenants, window
        histogram — the quick look the README quickstart prints."""
        s = self.summary()
        o, w = s["overall"], s["windows"]
        lines = [
            f"traffic: {o['n_completed']}/{o['n_submits']} completed, "
            f"{o['rejects']} rejected, {o['drops']} dropped",
            f"latency us: p50={o['p50_us']:.0f} p99={o['p99_us']:.0f} "
            f"mean={o['mean_us']:.0f}  "
            f"throughput={o['throughput_per_s']:.0f}/s",
            f"windows: {w['n_flushes']} flushes, mean depth "
            f"{w['mean_depth']:.1f}, max {w['max_depth']}, "
            f"hist {w['depth_hist']}",
        ]
        dg = s["diagnostics"]
        if dg["errors"] or dg["warnings"]:
            lines.append(
                f"hazards: {dg['errors']} errors, {dg['warnings']} "
                f"warnings, by code {dg['by_code']}")
        ex = s["exchange"]
        if ex is not None:
            ov = ("n/a" if ex["overlap_fraction"] is None
                  else f"{ex['overlap_fraction']:.2f}")
            lines.append(
                f"exchange: {ex['lanes']} lanes over {ex['windows']} "
                f"sharded windows, local={ex['local_fraction']:.2f}, "
                f"wire={ex['bytes_on_wire']}B "
                f"(cx={ex['compression_ratio']:.2f}), overlap={ov}")
        rows = sorted(((t, r) for t, r in s["tenants"].items() if r["n"]),
                      key=lambda e: -e[1]["p99_us"])[:top]
        if rows:
            lines.append("worst-p99 tenants:")
            for t, r in rows:
                lines.append(
                    f"  {t:>12s}  n={r['n']:<5d} p50={r['p50_us']:8.0f} "
                    f"p99={r['p99_us']:8.0f} rej={r['rejects']}")
        return "\n".join(lines)

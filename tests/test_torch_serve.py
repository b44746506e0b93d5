"""The port's serving front end against the JAX package's on the CPU.

``Telemetry`` fed one scripted event sequence on a fixed clock must fold
into the same ``summary()`` dict and ``render()`` text as the reference's;
both flush controllers must take the same decisions (``should_flush``,
``deadline``, ``drain_limit``, ``target_depth``, ``snapshot``) on the same
observations; and ``AccessService`` driven by the same submissions on a
virtual clock must flush the same windows in the same order, with the
same telemetry, as the reference's. Plus the service's own contract:
``auto_flush``, ``wait``, ``tick(force=True)`` on an empty queue,
``stats()`` and the refusal of a mesh.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.core import Engine as RefEngine
from repro.core import Scheduler as RefScheduler
from repro_torch.core import Engine, Scheduler
from repro_torch.serve import (AccessService, AdaptiveFlushController,
                               FixedWindowController, Telemetry, plan_gain)


def same(a, b) -> bool:
    """Structural equality with NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return type(a) is type(b) and a == b


def _diag(code, severity, tenants):
    return SimpleNamespace(code=code, severity=severity, tenants=tenants)


def _exchange(lanes, overlap):
    return {"nodes": 2, "lanes": lanes, "local_fraction": 0.25,
            "bytes_on_wire": 4 * lanes, "idx_bytes": 2 * lanes,
            "compression_ratio": 2.0, "overlap_fraction": overlap}


def feed(tel):
    """One scripted event sequence on a fixed clock (microseconds)."""
    t = [SimpleNamespace(tid=i, tenant=f"core{i % 3}") for i in range(9)]
    for i, tk in enumerate(t[:6]):
        tel.on_submit(tk, 10.0 * i + 3.0)
    tel.on_reject("core1", 55.0)
    tel.on_reject("core7", 56.0)             # a tenant seen only rejected
    tel.on_flush([(x.tenant, x.tid) for x in (t[2], t[0], t[1])], 60.0,
                 90.0, pending_before=4)
    tel.on_diagnostics([_diag("DX001", "ERROR", ("core0", "core2")),
                        _diag("DX010", "WARNING", ("core1",))])
    tel.on_flush([], 95.0, 95.0)             # an empty forced window
    for tk in t[6:]:
        tel.on_submit(tk, 100.0 + tk.tid)
    tel.on_drop("core2", 120.0)
    tel.on_exchange(lambda: _exchange(64, 0.5))
    tel.on_exchange(lambda: None)
    # ("other", 999): a ticket this telemetry never saw submitted
    tel.on_flush([(x.tenant, x.tid) for x in (t[3], t[4], t[6], t[7])]
                 + [("other", 999)], 130.0, 170.0)
    tel.on_exchange(lambda: _exchange(32, None))
    tel.on_flush([(t[5].tenant, t[5].tid)], 180.0, 181.0, pending_before=9)


def test_telemetry_summary_and_render_match_reference():
    port, ref = Telemetry(), ref_serve.Telemetry()
    feed(port)
    feed(ref)
    got, want = port.summary(), ref.summary()
    assert same(got, want), (got, want)
    assert port.render() == ref.render()
    assert port.render(top=2) == ref.render(top=2)
    assert got["overall"]["inflight"] == 1       # t[8] never completed
    assert got["exchange"]["windows"] == 2
    assert same(Telemetry().summary(), ref_serve.Telemetry().summary())
    assert Telemetry().render() == ref_serve.Telemetry().render()


def _report(*factors):
    """A stand-in flush report whose plan carries fused gathers with the
    given measured coalescing factors."""
    gathers = [SimpleNamespace(est_factor=f) for f in factors]
    plan = SimpleNamespace(fused=lambda kind: gathers if kind == "gather"
                           else [])
    return SimpleNamespace(plan=plan)


def _controller_pairs():
    return [
        (FixedWindowController(3), ref_serve.FixedWindowController(3)),
        (FixedWindowController(2, max_wait_us=40.0, drain_cap=2),
         ref_serve.FixedWindowController(2, max_wait_us=40.0, drain_cap=2)),
        (AdaptiveFlushController(),
         ref_serve.AdaptiveFlushController()),
        (AdaptiveFlushController(min_window=2, max_window=8,
                                 max_wait_us=50.0, overhead_us=30.0,
                                 drain_cap=5),
         ref_serve.AdaptiveFlushController(min_window=2, max_window=8,
                                           max_wait_us=50.0,
                                           overhead_us=30.0, drain_cap=5)),
    ]


@pytest.mark.parametrize("k", range(4))
def test_controllers_decide_as_reference(k):
    port, ref = _controller_pairs()[k]
    rng = np.random.default_rng(k)
    now, pending = 0.0, 0
    reports = [None, _report(2.5), _report(), _report(1.0, 4.0), None]
    for step in range(60):
        now += float(rng.exponential(7.0))
        if rng.random() < 0.7:
            port.observe_submit(now)
            ref.observe_submit(now)
            pending += 1
        assert port.deadline() == ref.deadline()
        assert port.should_flush(pending, now) == ref.should_flush(pending,
                                                                   now)
        assert port.drain_limit(pending) == ref.drain_limit(pending)
        assert port.target_depth() == ref.target_depth()
        assert same(port.snapshot(), ref.snapshot())
        if port.should_flush(pending, now):
            depth = port.drain_limit(pending) or pending
            pending -= depth
            rep = reports[step % len(reports)]
            dur = float(rng.uniform(5.0, 80.0))
            for c in (port, ref):
                c.observe_flush(depth, dur, rep, now + dur,
                                pending_after=pending)
            now += dur
            assert plan_gain(rep) == ref_serve.plan_gain(rep)
    assert same(port.snapshot(), ref.snapshot())


class Clock:
    """A virtual clock: every read advances it by a fixed step."""

    def __init__(self, step=7.0):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _drive(svc, table):
    """Submissions from three tenants, NumPy streams, one explicit flush
    at the end; returns the flushed windows' orders."""
    rng = np.random.default_rng(4)
    orders = []
    for i in range(14):
        idx = rng.integers(0, table.shape[0], size=8).astype(np.int32)
        svc.submit_gather(table, idx, tenant=f"core{i % 3}")
        if svc.last_report is not None:
            orders.append(svc.last_report.order)
            svc.last_report = None
    svc.flush()
    orders.append(svc.last_report.order)
    return orders


@pytest.mark.parametrize("make", [
    lambda m: dict(auto_flush=4),
    lambda m: dict(auto_flush=0, controller=m.FixedWindowController(
        3, drain_cap=2)),
    lambda m: dict(auto_flush=0, controller=m.AdaptiveFlushController(
        max_window=5, overhead_us=100.0)),
], ids=["auto_flush", "fixed", "adaptive"])
def test_service_flushes_as_reference(make):
    import repro_torch.serve as port_serve
    table = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    port = AccessService(Scheduler(engine=Engine(tile_size=64,
                                                 device="cpu")),
                         clock=Clock(), **make(port_serve))
    ref = ref_serve.AccessService(RefScheduler(engine=RefEngine(
        tile_size=64)), clock=Clock(), **make(ref_serve))
    assert _drive(port, table) == _drive(ref, table)
    got, want = port.stats(), ref.stats()
    assert same(got["traffic"], want["traffic"])
    assert same(got["controller"], want["controller"])
    assert got.keys() == want.keys()
    assert same({k: v for k, v in got.items()
                 if k not in ("engine", "traffic", "controller")},
                {k: v for k, v in want.items()
                 if k not in ("engine", "traffic", "controller")})


def _service(**kw):
    return AccessService(Scheduler(engine=Engine(tile_size=64,
                                                 device="cpu")), **kw)


def test_auto_flush_dispatches_at_threshold():
    svc = _service(auto_flush=3)
    table = torch.arange(40, dtype=torch.float32)
    t = [svc.submit_gather(table, np.array([i, i + 1], np.int32))
         for i in range(2)]
    assert svc.pending == 2 and svc.last_report is None
    t.append(svc.submit_gather(table, np.array([5], np.int32)))
    assert svc.pending == 0 and len(svc.last_report.order) == 3
    assert torch.equal(svc.poll(t[2]), table[5:6])


def test_wait_flushes_a_pending_ticket():
    svc = _service(auto_flush=0)
    table = torch.arange(40, dtype=torch.float32)
    core = svc.connect("core5", weight=2.0, max_pending=4)
    t = core.submit_gather(table, np.array([3, 1, 3], np.int32))
    assert core.poll(t) is None and svc.pending == 1
    assert torch.equal(core.wait(t), table[[3, 1, 3]])
    assert svc.last_report.order == (("core5", t.tid),)
    assert svc.stats()["traffic"]["overall"]["n_completed"] == 1


def test_tick_force_on_empty_queue_is_harmless():
    svc = _service(auto_flush=0, clock=Clock(),
                   controller=FixedWindowController(8, max_wait_us=20.0))
    assert svc.tick() is None                   # nothing pending, no deadline
    report = svc.tick(force=True)
    assert report.order == () and svc.pending == 0
    table = torch.arange(40, dtype=torch.float32)
    t = svc.submit_gather(table, np.array([2], np.int32))
    assert svc.tick(now=svc.clock.t + 1.0) is None      # before deadline
    report = svc.tick(now=svc.clock.t + 100.0)           # past it
    assert report.order == (("core0", t.tid),)
    stats = svc.stats()
    assert {"flushes", "plan_cache_hits", "engine", "traffic",
            "controller"} <= stats.keys()
    assert stats["controller"]["kind"] == "FixedWindowController"
    assert stats["traffic"]["windows"]["depth_hist"] == {"0": 1, "1": 1}


def test_admission_control_counts_rejects():
    svc = _service(auto_flush=0)
    core = svc.connect("core1", max_pending=1)
    table = torch.arange(8, dtype=torch.float32)
    core.submit_gather(table, np.array([1], np.int32))
    core.submit_gather(table, np.array([2], np.int32))    # rejected
    assert svc.pending == 1
    assert svc.stats()["traffic"]["overall"]["rejects"] == 1


def test_service_defaults_to_cuda_and_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="A11"):
        AccessService(mesh=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AccessService()
    svc = AccessService(device="cpu", tile_size=128, max_batch=4)
    assert svc.scheduler.engine.device.type == "cpu"
    assert svc.scheduler.engine.tile_size == 128
    assert svc.scheduler.max_batch == 4

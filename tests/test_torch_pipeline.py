"""Port flush handles and decoupled access/execute loop vs the JAX
reference on the CPU.

The same dependent and independent iterations run through the port's
``DecoupledLoop`` (``run`` / ``run_windows``), its ``run_sequential``
baseline and the reference's loop; the results must agree bit for bit
(gathers and integer updates only, so no tolerance is needed). The
``FlushHandle`` event protocol is checked with a stand-in event on the
CPU, where a real handle is done at once (the card's own test is in
test_torch_cuda.py).
"""
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Scheduler as RefScheduler
from repro.core.engine import Engine as RefEngine
from repro.pipeline import DecoupledLoop as RefLoop
from repro_torch.core import Engine, Scheduler
from repro_torch.core.scheduler import FlushHandle, FlushReport
from repro_torch.pipeline import AccessWindow, DecoupledLoop, run_sequential
from repro_torch.pipeline.decoupled import tree_map

TILE = 256


def _sched():
    return Scheduler(engine=Engine(tile_size=TILE, device="cpu"))


class FakeEvent:
    """Stands in for a ``torch.cuda.Event``: not done until released."""

    def __init__(self):
        self.released = False
        self.waits = 0

    def query(self):
        return self.released

    def synchronize(self):
        self.waits += 1
        self.released = True


# ---------------------------------------------------------------------------
# flush_async / FlushHandle
# ---------------------------------------------------------------------------

def test_cpu_handle_is_done_at_once_and_result_idempotent():
    sched = _sched()
    table = np.arange(16, dtype=np.float32)
    t = sched.submit_gather(table, [3, 1])
    h = sched.flush_async()
    assert h.poll() and h.done
    report = h.result()
    assert report is h.result() and report.n_gathers == 1
    assert sched.result(t).tolist() == [3.0, 1.0]
    assert sched.flush_async().poll()          # empty window


def test_handle_polls_its_event_without_waiting():
    report = FlushReport(order=(), groups=(), n_programs=0, n_gathers=0)
    ev = FakeEvent()
    h = FlushHandle(report, ev)
    assert not h.poll() and not h.done and ev.waits == 0
    ev.released = True
    assert h.poll() and h.done
    h2 = FlushHandle(report, FakeEvent())
    assert h2.result() is report and h2.result() is report
    assert h2.poll()


def test_flush_while_inflight_raises_unless_ok():
    sched = _sched()
    table = np.arange(8, dtype=np.int32)
    held = FlushHandle(FlushReport(order=(), groups=(), n_programs=0,
                                   n_gathers=0), FakeEvent())
    sched._inflight = weakref.ref(held)
    sched.submit_gather(table, [1])
    with pytest.raises(RuntimeError, match="in flight"):
        sched.flush()
    assert sched.pending == 1                   # nothing consumed
    sched.flush(inflight_ok=True)
    held._event.released = True                 # polled to retirement
    sched.submit_gather(table, [2])
    sched.flush()
    del held                                    # a dropped handle: no guard
    sched._inflight = weakref.ref(FlushHandle(
        FlushReport(order=(), groups=(), n_programs=0, n_gathers=0),
        FakeEvent()))
    sched.flush()


# ---------------------------------------------------------------------------
# DecoupledLoop drivers
# ---------------------------------------------------------------------------

def _dependent(perm, table):
    """x_{k+1} = (table[x_k[perm]] + k) % rows, with an RMW count of
    every row the window touched: a pure dependence chain."""
    def access(loop, k, state):
        x, counts = state
        return {"g": loop.submit_gather(table, x[perm]),
                "c": [loop.submit_rmw(counts, x, np.ones(len(perm),
                                                         np.int32)
                                      if not isinstance(x, torch.Tensor)
                                      else torch.ones(len(perm),
                                                      dtype=torch.int32),
                                      op="ADD")]}

    def compute(k, state, res):
        return (res["g"] + k) % len(table), res["c"][0]

    return access, compute


def test_dependent_run_matches_sequential_and_reference():
    rng = np.random.default_rng(3)
    n = 64
    perm = rng.permutation(n).astype(np.int32)
    table = rng.integers(0, n, size=n).astype(np.int32)
    x0 = rng.integers(0, n, size=n).astype(np.int32)
    c0 = np.zeros(n, np.int32)
    access, compute = _dependent(perm, table)

    sched_p, sched_s = _sched(), _sched()
    loop = DecoupledLoop(sched_p)
    got_p = loop.run((torch.from_numpy(x0), torch.from_numpy(c0)), 5,
                     access, compute)
    got_s = run_sequential(sched_s, (torch.from_numpy(x0),
                                     torch.from_numpy(c0)), 5, access,
                           compute)
    ref = RefScheduler(engine=RefEngine(tile_size=TILE))
    want = RefLoop(ref).run((jnp.asarray(x0), jnp.asarray(c0)), 5, access,
                            compute)
    x, c = x0, c0
    for k in range(5):
        c = c.copy()
        np.add.at(c, x, 1)
        x = (table[x[perm]] + k) % n
    for got in (got_p, got_s, want):
        np.testing.assert_array_equal(np.asarray(got[0]), x)
        np.testing.assert_array_equal(np.asarray(got[1]), c)
    assert loop.stats == {"windows": 5, "iterations": 5}
    assert sched_p.stats["flushes"] == sched_s.stats["flushes"] == 5


@pytest.mark.parametrize("depth", (1, 2, 3))
def test_run_windows_matches_reference(depth):
    rng = np.random.default_rng(depth)
    table = rng.normal(size=(128, 4)).astype(np.float32)
    items = [rng.integers(-4, 132, size=16).astype(np.int32)
             for _ in range(7)]

    def access(loop, k, item):
        return (loop.submit_gather(table, item),)

    def compute(k, item, res):
        return np.asarray(res[0]) * 2

    loop = DecoupledLoop(_sched(), depth=depth)
    got = loop.run_windows(items, access, compute)
    want = RefLoop(RefScheduler(engine=RefEngine(tile_size=TILE)),
                   depth=depth).run_windows(items, access, compute)
    assert len(got) == len(want) == 7
    for g, w, item in zip(got, want, items):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, table[np.clip(item, 0, 127)] * 2)
    assert loop.stats == {"windows": 7, "iterations": 7}


def test_zero_iterations_and_bad_depth():
    sched = _sched()
    state = object()
    assert DecoupledLoop(sched).run(state, 0, None, None) is state
    assert DecoupledLoop(sched).run_windows([], None, None) == []
    with pytest.raises(ValueError, match="depth"):
        DecoupledLoop(sched, depth=0)


def test_access_window_redeem_structure():
    sched = _sched()
    table = torch.arange(32.0)
    t1 = sched.submit_gather(table, torch.tensor([1], dtype=torch.int32))
    t2 = sched.submit_gather(table, torch.tensor([2, 3], dtype=torch.int32))
    h = sched.flush_async()
    win = AccessWindow(sched, {"a": t1, "b": [t2], "c": (None,)}, h)
    res = win.redeem()
    assert res["a"].tolist() == [1.0]
    assert res["b"][0].tolist() == [2.0, 3.0]
    assert res["c"] == (None,)
    assert win.wait() is win and win.ready


def test_tree_map_keeps_structure():
    tree = {"x": [1, (2, 3)], "y": 4, "z": "s"}
    out = tree_map(lambda v: v * 10, tree,
                   lambda v: isinstance(v, int))
    assert out == {"x": [10, (20, 30)], "y": 40, "z": "s"}


def test_report_thunks_release_what_they_hold():
    """The lazy coalescing measurement runs once, then drops its thunk
    (and the streams it closed over)."""
    sched = _sched()
    table = np.arange(64, dtype=np.float32)
    sched.submit_gather(table, [1, 2, 3], tenant="a")
    sched.submit_gather(table, [3, 4], tenant="b")
    sched.submit_rmw(np.zeros(8, np.int32), [1, 1], [2, 3], op="ADD")
    report = sched.flush()
    ((gain, per, fused),) = report.gather_coalescing.values()
    assert (per, fused) == (5, 4) and gain == pytest.approx(1.25)
    assert report._gather_thunk is None
    assert list(report.rmw_coalescing.values())[0][2] == 1
    assert report._rmw_thunk is None

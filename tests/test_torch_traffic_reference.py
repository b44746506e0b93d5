"""The port's traffic replay against the JAX package's own replay of the
same trace, on the CPU.

Each corpus trace (``generate_traffic_case``) replays through both
packages' ``AccessService`` under the corpus's controller for its seed, on
the service-time model ``200 + 8 * depth`` us (``test_torch_traffic``'s
helpers). They must cut the same windows (``FlushReport.order`` and start
time of every flush), admit and reject the same tickets, report the same
telemetry, and give every ticket the same result: bit for bit, except the
float regions of programs, within rtol=1e-5 / atol=1e-6 (the port's fuzz
tolerance: segment sums of float RMWs round in another order).

The reference replay compiles XLA executables per stream shape (10-45 s a
trace), so tier-1 runs four seeds that cover the four controllers, KV
events with pool wrap-around, programs and admission rejects;
``--runslow`` runs the other fifteen. Seed 17 is left to
``test_torch_traffic``'s NumPy expectations: its reference replay
segfaults inside XLA in whole-file runs (ROADMAP C).
"""
import numpy as np
import pytest

from repro import serve as ref_serve
from repro.core import Engine as RefEngine
from repro.core import Scheduler as RefScheduler
from repro.core.scheduler import QueueFullError as RefQueueFullError
from repro.testing import generate_traffic_case as ref_traffic_case
from repro_torch.core.scheduler import QueueFullError
from test_torch_traffic import (N_TRAFFIC, TILE, as_np, corpus_service,
                                port_replay, service_time)

REF_SEEDS = (9, 16, 18, 19)                # kinds 1, 0, 2, 3
SLOW_SEEDS = tuple(s for s in range(N_TRAFFIC)
                   if s not in REF_SEEDS and s != 17)


_REF_ENGINE = []


def compare_with_reference_replay(seed):
    if not _REF_ENGINE:
        _REF_ENGINE.append(RefEngine(tile_size=TILE))
    rtrace = ref_traffic_case(seed)
    rsvc = corpus_service(ref_serve, RefScheduler(engine=_REF_ENGINE[0]),
                          seed, rtrace)
    rres = ref_serve.replay_trace(rtrace, rsvc, service_time=service_time)
    trace, svc, res = port_replay(seed)
    assert [rep.order for _, rep in res.windows] == \
        [rep.order for _, rep in rres.windows]
    assert [s for s, _ in res.windows] == [s for s, _ in rres.windows]
    assert res.makespan_us == rres.makespan_us
    assert [t.tid for _, t in res.tickets] == \
        [t.tid for _, t in rres.tickets]
    assert [t.tid for _, t in res.rejected] == \
        [t.tid for _, t in rres.rejected]
    for (ev, t), (_, rt) in zip(res.tickets, rres.tickets):
        got, want = svc.scheduler.result(t), rsvc.scheduler.result(rt)
        if ev.kind != "program":
            want = np.asarray(want)
            np.testing.assert_array_equal(as_np(got, want), want)
            continue
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                wk = np.asarray(w[k])
                if wk.dtype == np.float32:
                    np.testing.assert_allclose(as_np(g[k], wk), wk,
                                               rtol=1e-5, atol=1e-6)
                else:
                    np.testing.assert_array_equal(as_np(g[k], wk), wk)
    for (_, t), (_, rt) in zip(res.rejected, rres.rejected):
        with pytest.raises(QueueFullError):
            svc.scheduler.result(t)
        with pytest.raises(RefQueueFullError):
            rsvc.scheduler.result(rt)
    assert svc.telemetry.summary()["overall"] == \
        rsvc.telemetry.summary()["overall"]


@pytest.mark.parametrize("seed", REF_SEEDS)
def test_replay_matches_reference_replay(seed):
    compare_with_reference_replay(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", SLOW_SEEDS)
def test_replay_matches_reference_replay_rest_of_corpus(seed):
    compare_with_reference_replay(seed)

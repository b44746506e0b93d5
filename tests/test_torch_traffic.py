"""The port's open-loop traffic generator and replay
(``repro_torch.serve.traffic``) against the JAX package's on the CPU.

* Generation is NumPy in both packages: every trace of the 20-seed
  differential corpus (``generate_traffic_case``) and the committed bench
  trace (``benchmarks/traffic_bench.py``, digest ``891dd37224095fcf``) must
  have the reference's digest, and the same fuzzer programs.
* Replay: each corpus trace goes through the port's ``AccessService`` on
  ``device="cpu"`` under the corpus's controller for its seed
  (``tests/test_fuzz_parity.py::_corpus_service``, hot tenants capped for
  kind 3) on the deterministic service-time model ``200 + 8 * depth`` us.
  Every ticket is held to the NumPy expectations of the reference's
  ``check_traffic_parity``: gathers the submit-time table (OOB clamped) and
  RMWs their window's end state, bit for bit; programs the reference's
  NumPy ``OracleEngine`` within its rtol=1e-4 / atol=1e-5; rejected
  tickets raise. Seed 17 is judged this way only (its reference replay
  segfaults inside XLA in whole-file runs, ROADMAP C).

``tests/test_torch_traffic_reference.py`` holds the port's replay against
the reference's own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import compiler as ref_compiler
from repro.testing import generate_traffic_case as ref_traffic_case
from repro.testing import oracle
from repro.testing.harness import _np_rmw
from repro_torch import serve
from repro_torch.core import Engine, Scheduler, interop
from repro_torch.core.scheduler import QueueFullError
from repro_torch.serve import traffic
from repro_torch.testing import generate_traffic_case

N_TRAFFIC = 20
TILE = 256
BENCH_CONFIG = dict(seed=2028, n_events=1200, n_tenants=2000,
                    idle_gap_us=150.0, burst_factor=25.0,
                    mean_phase_events=40, p_program=0.0, p_tick=0.005)
BENCH_DIGEST = "891dd37224095fcf"


def service_time(depth, report):
    return 200.0 + 8.0 * depth


def corpus_service(mod, sched, seed, trace):
    """``test_fuzz_parity._corpus_service`` for either package."""
    kind = seed % 4
    if kind == 0:
        ctl = mod.AdaptiveFlushController(overhead_us=200.0)
    elif kind == 1:
        ctl = mod.FixedWindowController(2)
    elif kind == 2:
        ctl = mod.FixedWindowController(16, drain_cap=6)
    else:
        ctl = mod.AdaptiveFlushController(overhead_us=200.0, drain_cap=8)
    svc = mod.AccessService(sched, auto_flush=0, controller=ctl)
    if kind == 3:
        counts = {}
        for e in trace.events:
            counts[e.tenant] = counts.get(e.tenant, 0) + 1
        hot = sorted(counts, key=counts.get, reverse=True)[:2]
        svc.connect(hot[0], weight=4.0, max_pending=4)
        if len(hot) > 1:
            svc.connect(hot[1], weight=0.5, max_pending=2)
    return svc


_PORT_ENGINE = []


def port_replay(seed):
    if not _PORT_ENGINE:
        _PORT_ENGINE.append(Engine(tile_size=TILE, device="cpu"))
    trace = generate_traffic_case(seed)
    svc = corpus_service(serve, Scheduler(engine=_PORT_ENGINE[0]), seed,
                         trace)
    return trace, svc, traffic.replay_trace(trace, svc,
                                            service_time=service_time)


def as_np(got, like):
    return interop.to_numpy(got, np.asarray(like).dtype)


def test_trace_digests_match_reference():
    for seed in range(N_TRAFFIC):
        mine, ref = generate_traffic_case(seed), ref_traffic_case(seed)
        assert mine.digest() == ref.digest(), seed
        assert mine.config == type(mine.config)(
            **dataclasses.asdict(ref.config))
        assert len(mine.programs) == len(ref.programs)
        for (p, env, n), (rp, renv, rn) in zip(mine.programs, ref.programs):
            assert n == rn and p.name == rp.name
            assert repr(p) == repr(rp)
            assert sorted(env) == sorted(renv)
            for k in env:
                np.testing.assert_array_equal(env[k], renv[k])


def test_bench_trace_digest_and_json_round_trip():
    trace = serve.generate_trace(serve.TrafficConfig(**BENCH_CONFIG))
    assert trace.digest() == BENCH_DIGEST
    again = serve.Trace.from_json(trace.to_json())
    assert again.digest() == BENCH_DIGEST
    assert trace.summary() == again.summary()
    bad = trace.to_json().replace(BENCH_DIGEST, "0" * 16)
    with pytest.raises(ValueError, match="digest mismatch"):
        serve.Trace.from_json(bad)


def check_against_numpy(seed, trace, svc, res):
    """``check_traffic_parity``'s expectations for each ticket."""
    sched = svc.scheduler
    win_of = res.window_of()
    end_state = {}
    for ev, t in res.tickets:
        if ev.kind in ("rmw", "kv_append"):
            key = (win_of[t.tid], ev.table)
            want = end_state.get(key, trace.tables[ev.table])
            end_state[key] = _np_rmw(want, ev.idx, ev.values, ev.op,
                                     cond=ev.cond)
    programs = ref_traffic_case(seed).programs
    oracle_cache = {}
    checked = 0
    for ev, t in res.tickets:
        got = sched.result(t)
        if ev.kind in ("gather", "kv_decode"):
            table = trace.tables[ev.table]
            want = table[np.clip(ev.idx, 0, table.shape[0] - 1)]
            np.testing.assert_array_equal(as_np(got, want), want)
        elif ev.kind in ("rmw", "kv_append"):
            want = end_state[(win_of[t.tid], ev.table)]
            np.testing.assert_array_equal(as_np(got, want), want)
        else:
            if ev.program_id not in oracle_cache:
                pattern, env, n = programs[ev.program_id]
                prog, _ = ref_compiler.compile_pattern(pattern,
                                                       tile_size=TILE)
                oenv = dict(env)
                oenv["__iota__"] = np.arange(TILE, dtype=np.int32)
                oracle_cache[ev.program_id] = oracle.OracleEngine(
                    tile_size=TILE).run(prog, oenv, {
                        "tile_base": 0, "N": n, "tile_end": n})
            (genv, gspd), (oenv, ospd) = got, oracle_cache[ev.program_id]
            for name in oenv:
                if name != "__iota__":
                    np.testing.assert_allclose(
                        as_np(genv[name], oenv[name]), oenv[name],
                        rtol=1e-4, atol=1e-5)
            for name in ospd:
                np.testing.assert_allclose(as_np(gspd[name], ospd[name]),
                                           ospd[name], rtol=1e-4, atol=1e-5)
        checked += 1
    for _, t in res.rejected:
        with pytest.raises(QueueFullError):
            sched.result(t)
    return checked


@pytest.mark.parametrize("seed", range(N_TRAFFIC))
def test_replay_meets_numpy_expectations(seed):
    trace, svc, res = port_replay(seed)
    checked = check_against_numpy(seed, trace, svc, res)
    assert checked == len(res.tickets) > 0
    assert res.n_flushes > 1
    assert svc.stats()["rejects"] == len(res.rejected)


def test_replay_hits_empty_window_and_rejects():
    """``test_fuzz_parity``'s awkward serving edges, on the port."""
    trace = generate_traffic_case(0)
    svc = serve.AccessService(
        Scheduler(engine=Engine(tile_size=TILE, device="cpu")),
        auto_flush=0,
        controller=serve.AdaptiveFlushController(overhead_us=200.0))
    counts = {}
    for e in trace.events:
        counts[e.tenant] = counts.get(e.tenant, 0) + 1
    svc.connect(max(counts, key=counts.get), max_pending=2)
    res = traffic.replay_trace(trace, svc, service_time=service_time)
    assert check_against_numpy(0, trace, svc, res) > 0
    assert any(len(rep.order) == 0 for _, rep in res.windows)
    assert len(res.rejected) > 0
    assert svc.stats()["rejects"] == len(res.rejected)


def test_wall_measured_replay():
    """No service-time model: each flush is wall-measured, and every
    ticket still meets its expectation."""
    trace = generate_traffic_case(9)
    svc = serve.AccessService(
        Scheduler(engine=Engine(tile_size=TILE, device="cpu")),
        auto_flush=0,
        controller=serve.AdaptiveFlushController(overhead_us=200.0))
    res = traffic.replay_trace(trace, svc)
    assert res.makespan_us >= trace.events[-1].t_us
    assert svc.stats()["traffic"]["overall"]["n_completed"] == \
        len(res.tickets)
    assert check_against_numpy(9, trace, svc, res) == len(res.tickets)


def test_replay_results_live_on_the_service_device():
    trace = serve.generate_trace(serve.TrafficConfig(
        seed=3, n_events=60, p_kv_decode=0.2, p_kv_append=0.2,
        kv_pages=12))
    svc = serve.AccessService(
        Scheduler(engine=Engine(tile_size=TILE, device="cpu")),
        auto_flush=0)
    res = traffic.replay_trace(trace, svc, service_time=service_time)
    kinds = {ev.kind for ev, _ in res.tickets}
    assert {"kv_decode", "kv_append"} <= kinds
    for _, t in res.tickets:
        got = svc.scheduler.result(t)
        got = got if isinstance(got, torch.Tensor) else got[0]["__iota__"]
        assert got.device.type == "cpu"

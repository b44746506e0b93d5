"""``replay_trace`` and ``KvPoolServer`` over a process mesh
(``distributed.ProcessMesh``: one rank per process, each holding its
slice of every trace table and of the KV pool, the exchange over
``torch.distributed``) on the CPU with gloo, at worlds 2 and 4 (8 with
``--runslow``).

Each world is spawned once for the module (``spawn.run_ranks``, a
``FileStore`` under the module's temp dir); its ranks
(``process_mesh_ranks.serving_main``) replay the reference's mesh trace,
the traffic corpus through ``check_traffic_parity`` (on each seed's
service over the mesh, and seed 0 on the service ``mesh=`` builds there)
and a trace with wall-measured flushes, run the KV pool server with
growth while decoding, re-cut row-sharded tables
(``ShardedEngine.regrow``) and probe the refusals, and write what they
saw. Held:

  * against the reference's ``AccessService(mesh=m)`` replay of the same
    trace in a subprocess on 8 forced host devices
    (``tests/test_traffic.py:146``: seed 11, 120 events, no programs, at
    world 4; ``--runslow`` adds its seed 43 soak trace and world 2): the
    same windows (order and start), admissions, rejections, makespan and
    telemetry, every gather ticket whole and every RMW ticket as the
    rank's rows of the reference's, bit for bit;
  * against the NumPy oracle (``check_traffic_parity``, verdict
    all-reduced) and the port's one-device replay: traffic corpus seeds
    0-3 (the rest with ``--runslow``);
  * every rank's replay, telemetry and controller state identical, also
    when flush durations are wall-measured (each window's agreed);
  * the KV pool server (``tests/test_kv_embedding.py:66``'s widths) bit
    for bit the reference's one-device server and a NumPy model: every
    history, each rank's slice the reference pool's rows, the stats.
"""
import math
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import process_mesh_ranks as pr
from spawn_once import once
from repro_torch.distributed import ShardedEngine, shard_row_ranges
from repro_torch.distributed.spawn import run_ranks

ROOT = Path(__file__).resolve().parents[1]
CORPUS = tuple(range(4))
SLOW_CORPUS = tuple(range(4, 20))
SPAWN_LIMIT = 120.0
slow = pytest.mark.slow

#: (world, trace) replays held against the reference's mesh of that size
REF_CASES = ((4, pr.MESH_TRACE),)
SLOW_REF_CASES = ((4, pr.LONG_TRACE), (2, pr.MESH_TRACE))
WORLDS = (2, 4, pytest.param(8, marks=slow))


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    slow_run = request.config.getoption("--runslow")
    return once(tmp_path_factory, f"process_serving-slow{int(slow_run)}",
                lambda: _spawn(slow_run,
                               tmp_path_factory.mktemp("process_serving")))


def _spawn(slow_run, tmp):
    """The reference's replays and KV pool server and each gloo world,
    once."""
    worlds = [2, 4] + ([8] if slow_run else [])
    cases = REF_CASES + (SLOW_REF_CASES if slow_run else ())
    corpus = CORPUS + (SLOW_CORPUS if slow_run else ())
    # --runslow replays ~7x the events
    limit = SPAWN_LIMIT * (8 if slow_run else 1)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    # the reference's replays and its KV pool server, concurrently with
    # the worlds
    jobs = {(m, cfg["seed"]): [str(m), repr(cfg)] for m, cfg in cases}
    jobs["kv"] = ["kv"]
    refs = {}
    for key, args in jobs.items():
        out = tmp / f"ref{len(refs)}.pkl"
        refs[key] = (out, subprocess.Popen(
            [sys.executable, __file__, "--ref", str(out)] + args, env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    got = {}
    try:
        for w in worlds:
            out = tmp / f"world{w}"
            out.mkdir()
            mine = tuple(cfg for m, cfg in cases if m == w)
            t0 = time.perf_counter()
            run_ranks(pr.serving_main, w, args=(str(out), corpus, mine),
                      backend="gloo", init_method=f"file://{out}/store",
                      timeout=60, join_timeout=limit)
            got[w] = {"ranks": [pickle.loads((out / f"rank{r}.pkl")
                                             .read_bytes())
                                for r in range(w)],
                      "seconds": time.perf_counter() - t0}
        ref = {}
        for key, (out, proc) in refs.items():
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            ref[key] = pickle.loads(out.read_bytes())
    finally:
        for _, proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"world": got, "ref": ref, "limit": limit}


def _ranks(runs, w):
    return runs["world"][w]["ranks"]


def _same(a, b) -> bool:
    """Equality of nested records, NaN equal to NaN."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _bits(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype != want.dtype and got.dtype.itemsize == want.dtype.itemsize:
        got = got.view(want.dtype)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(got, want), what


def test_worlds_finish_in_time(runs):
    for w, run in runs["world"].items():
        assert run["seconds"] < runs["limit"], (w, run["seconds"])


# ---------------------------------------------------------------------------
# replay against the reference's mesh replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,cfg", [
    *(pytest.param(w, c, id=f"{w}-seed{c['seed']}") for w, c in REF_CASES),
    *(pytest.param(w, c, id=f"{w}-seed{c['seed']}", marks=slow)
      for w, c in SLOW_REF_CASES)])
def test_replay_equals_reference_mesh(runs, w, cfg):
    """Every rank cuts the reference's windows (order and start time),
    admits and rejects the same tickets, reports the same makespan and
    telemetry, and gives every ticket the reference's result: a gather
    whole, an RMW as the rank's rows, bit for bit."""
    want = runs["ref"][(w, cfg["seed"])]
    for r, rank in enumerate(_ranks(runs, w)):
        got = rank["ref"][cfg["seed"]]
        what = f"world {w} rank {r} seed {cfg['seed']}"
        assert got["windows"] == want["windows"], what
        assert got["tickets"] == want["tickets"], what
        assert got["rejected"] == want["rejected"], what
        assert got["makespan"] == want["makespan"], what
        assert _same(got["telemetry"], want["telemetry"]), what
        assert len(got["results"]) == len(want["results"]), what
        for k, ((mine, rows), full) in enumerate(zip(got["results"],
                                                     want["results"])):
            if rows is not None:
                full = full[slice(*rows)]
            _bits(f"{what} ticket {k}", mine, full)


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_replays_alike(runs, w):
    """The ReplayResult (windows, admissions, rejections, makespan) and
    the telemetry are the same on every rank, for every replay."""
    ranks = _ranks(runs, w)
    for rank in ranks[1:]:
        for seed, rec in ranks[0]["ref"].items():
            mine = rank["ref"][seed]
            for key in ("windows", "tickets", "rejected", "makespan"):
                assert mine[key] == rec[key], (w, seed, key)
            assert _same(mine["telemetry"], rec["telemetry"]), (w, seed)
        for seed, rec in ranks[0]["corpus"].items():
            assert _same(rank["corpus"][seed], rec), (w, seed)


# ---------------------------------------------------------------------------
# the traffic corpus through check_traffic_parity over the mesh
# ---------------------------------------------------------------------------

def _one_device_replay(seed):
    """The port's one-device replay of a corpus seed (its controller)."""
    from test_torch_traffic import port_replay
    _, svc, res = port_replay(seed)
    return svc, res


@pytest.mark.parametrize("w,seed", [
    *(pytest.param(w, s) for w in (2, 4) for s in CORPUS),
    *(pytest.param(w, s, marks=slow) for w in (2, 4, 8)
      for s in SLOW_CORPUS),
    *(pytest.param(8, s, marks=slow) for s in CORPUS)])
def test_corpus_replay_against_oracle(runs, w, seed):
    """check_traffic_parity held every ticket on every rank against the
    NumPy oracle (each RMW as the rank's rows; the verdict all-reduced),
    and the ranks cut the windows of the port's one-device replay."""
    svc, res = _one_device_replay(seed)
    want = [(s, rep.order) for s, rep in res.windows]
    rejected = [t.tid for _, t in res.rejected]
    for r, rank in enumerate(_ranks(runs, w)):
        got = rank["corpus"][seed]
        assert got["checked"] == len(res.tickets) > 0, (w, r, seed)
        assert got["windows"] == want, (w, r, seed)
        assert got["rejected"] == rejected, (w, r, seed)
        assert _same(got["telemetry"], svc.telemetry.summary()), (w, r)


@pytest.mark.parametrize("w", WORLDS)
def test_corpus_on_a_service_built_on_the_mesh(runs, w):
    """``check_traffic_parity(trace, mesh=ProcessMesh)`` builds its own
    service over the mesh (its adaptive controller, corpus seed 0's) and
    holds every ticket on every rank: the windows and rejections are the
    port's one-device replay's and the same on every rank."""
    _, res = _one_device_replay(0)
    want = [(s, rep.order) for s, rep in res.windows]
    rejected = [t.tid for _, t in res.rejected]
    for r, rank in enumerate(_ranks(runs, w)):
        got = rank["mesh_built"]
        assert got["checked"] == len(res.tickets) > 0, (w, r)
        assert got["windows"] == want, (w, r)
        assert got["rejected"] == rejected, (w, r)


@pytest.mark.parametrize("w", WORLDS)
def test_wall_measured_replay_agrees(runs, w):
    """With wall-measured flushes (each rank measures its own duration,
    the window's is agreed: their maximum) every rank's window log,
    makespan, telemetry and controller state are identical, and each
    window took one plan agreement."""
    ranks = _ranks(runs, w)
    first = ranks[0]["wall"]
    assert len(first["windows"]) > 1
    assert first["agreements"] == len(first["windows"])
    assert first["controller"]["overhead_us"] != 250.0   # it measured
    for rank in ranks[1:]:
        assert _same(rank["wall"], first), w


# ---------------------------------------------------------------------------
# the KV pool server
# ---------------------------------------------------------------------------

def _model_pool():
    """The NumPy model: a bump page allocator growing by
    ``growth_pages``, each sequence's rows, the pool they imply, and each
    growth's (old, new) row counts."""
    p, d = pr.KV_WIDTHS["page_size"], pr.KV_WIDTHS["d"]
    growth = pr.KV_WIDTHS["growth_pages"]
    prefix, prompts, steps = pr.kv_scenario()
    state = {"cap": pr.KV_WIDTHS["init_pages"], "head": 0, "grown": []}
    pages, rows = {}, {}

    def alloc(n):
        out = list(range(state["head"], state["head"] + n))
        state["head"] += n
        if state["head"] > state["cap"]:
            old = state["cap"]
            while state["cap"] < state["head"]:
                state["cap"] += growth
            state["grown"].append((old * p, state["cap"] * p))
        return out
    shared = alloc(prefix.shape[0] // p)
    for i, kv in enumerate(prompts):
        rows[f"s{i}"] = np.concatenate([prefix, kv])
        pages[f"s{i}"] = shared + alloc(-(-rows[f"s{i}"].shape[0] // p)
                                        - len(shared))
    hists = []
    for t in range(steps.shape[0]):
        hists.append({k: v.copy() for k, v in rows.items()})
        for i in range(steps.shape[1]):
            name = f"s{i}"
            if rows[name].shape[0] == p * len(pages[name]):
                pages[name] += alloc(1)
            rows[name] = np.concatenate([rows[name], steps[t, i][None]])
    pool = np.zeros((state["cap"] * p, 2 * d), np.float32)
    for name, r in rows.items():
        slots = (np.asarray(pages[name])[:, None] * p
                 + np.arange(p)[None, :]).reshape(-1)
        pool[slots[:r.shape[0]]] = r
    return hists, pool, state


@pytest.fixture(scope="module")
def kv_want(runs):
    return runs["ref"]["kv"], _model_pool()


@pytest.mark.parametrize("w", WORLDS)
def test_kv_pool_equals_reference_and_model(runs, kv_want, w):
    """Every history on every rank is bit for bit the reference's and the
    NumPy model's; after every step each rank's slice is the reference
    pool's rows ``rank_rows`` and its stats the reference's (plus the
    rank's rows and what its growths moved); the pool grew while
    decoding, as the model's did."""
    (ref_hists, ref_steps), (model_hists, model_pool, state) = kv_want
    assert len(state["grown"]) > 1
    for r, rank in enumerate(_ranks(runs, w)):
        kv = rank["kv"]
        for t, (got, want, model) in enumerate(zip(kv["hists"], ref_hists,
                                                   model_hists)):
            assert sorted(got) == sorted(want) == sorted(model)
            for name in want:
                _bits(f"world {w} rank {r} step {t} {name}", got[name],
                      want[name])
                _bits(f"world {w} rank {r} step {t} {name} model",
                      got[name], model[name])
        for t, (got, want) in enumerate(zip(kv["steps"], ref_steps)):
            st = dict(got["stats"])
            lo, hi = st.pop("rank_rows")
            st.pop("moved_rows"), st.pop("growth_collectives")
            assert st == want["stats"], (w, r, t)
            _bits(f"world {w} rank {r} step {t} slice", got["slice"],
                  want["pool"][lo:hi])
        lo, hi = kv["steps"][-1]["stats"]["rank_rows"]
        _bits(f"world {w} rank {r} final slice vs model",
              kv["steps"][-1]["slice"], model_pool[lo:hi])
        assert kv["steps"][-1]["stats"]["growths"] == len(state["grown"])


def _owner_changes(n_old, n_new, w, r):
    """Rows rank ``r`` sends and receives when an ``n_old``-row table
    grows to ``n_new`` rows, from the two splits."""
    old, new = shard_row_ranges(n_old, w), shard_row_ranges(n_new, w)
    own_old, own_new = set(range(*old[r])), set(range(*new[r]))
    return (len(own_old - own_new),
            len((own_new & set(range(n_old))) - own_old))


@pytest.mark.parametrize("w", WORLDS)
def test_kv_pool_slices_never_whole(runs, kv_want, w):
    """Each rank holds exactly its rows of the pool after every step,
    never the whole pool; across its growths it sent and received
    exactly the rows whose owner changed, in one collective per growth
    that moved any."""
    _, (_, _, state) = kv_want
    grown = state["grown"]
    for r, rank in enumerate(_ranks(runs, w)):
        steps = rank["kv"]["steps"]
        for got in steps:
            lo, hi = got["stats"]["rank_rows"]
            assert (lo, hi) == shard_row_ranges(
                got["stats"]["pool_rows"], w)[r]
            assert got["slice"].shape[0] == hi - lo
            assert hi - lo < got["stats"]["pool_rows"]
        st = steps[-1]["stats"]
        moved = [_owner_changes(a, b, w, r) for a, b in grown]
        assert st["moved_rows"] == tuple(map(sum, zip(*moved))), (w, r)
        moving = sum(any(any(_owner_changes(a, b, w, q)) for q in range(w))
                     for a, b in grown)
        assert st["growth_collectives"] == moving > 0, (w, r)


# ---------------------------------------------------------------------------
# the re-cut helper, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
def test_regrow_moves_only_rows_that_change_owner(runs, w):
    """``ShardedEngine.regrow``: each rank's new slice is its rows of the
    old table followed by zero rows, as a new tensor (the old slice is
    untouched); the rows it sent and received are those whose owner
    changed; one collective when any row moves, none otherwise; a wrong
    slice is refused."""
    for r, rank in enumerate(_ranks(runs, w)):
        cases = rank["regrow"]
        for (n_old, n_new), got in zip(pr.REGROW_CASES, cases):
            whole = np.zeros((n_new, 3), np.float32)
            whole[:n_old] = np.arange(1, n_old + 1)[:, None]
            lo, hi = shard_row_ranges(n_new, w)[r]
            _bits(f"world {w} rank {r} regrow {n_old}->{n_new}",
                  got["slice"], whole[lo:hi])
            assert got["moved"] == _owner_changes(n_old, n_new, w, r)
            moves = any(any(_owner_changes(n_old, n_new, w, q))
                        for q in range(w))
            assert got["collectives"] == int(moves), (n_old, n_new)
            assert got["untouched"] and got["new_object"]
        assert "slice" in cases[-1] and "rows [" in cases[-1]


def test_a_logical_mesh_keeps_tables_whole():
    """On a logical mesh (every shard on one device) a table is
    submitted whole, and ``regrow``, a re-cut across processes, is
    refused."""
    eng = ShardedEngine(4, device="cpu")
    table = torch.arange(10.0)
    part, kw = eng.slice_of(table)
    assert part is table and kw == {}
    with pytest.raises(ValueError, match="process mesh"):
        eng.regrow(table, 10, 12)


@pytest.mark.parametrize("w", WORLDS)
def test_refusals_and_divergence_on_every_rank(runs, w):
    """A flush controller without ``clock=`` over a process mesh is still
    refused; a rank whose trace differs in one event raises
    ``PlanDivergence`` on every rank, naming it."""
    for rank in _ranks(runs, w):
        ref = rank["refusals"]
        assert "clock" in ref["no_clock"] and "A14b" in ref["no_clock"]
        assert ref["diverge"] is not None and "rank(s) [1]" in \
            ref["diverge"]


# ---------------------------------------------------------------------------
# the reference side (a subprocess with 8 forced host devices)
# ---------------------------------------------------------------------------

def _ref_kv(out_path):
    """The reference's one-device KvPoolServer on the same draws: every
    step's histories, the pool and stats after each step."""
    from repro.serve import KvPoolServer
    srv = KvPoolServer(**pr.KV_WIDTHS)
    steps = []

    def on_step(t):
        steps.append({"pool": np.asarray(srv.pool), "stats": srv.stats()})
    hists = pr.kv_run(srv, pr.kv_scenario(), on_step)
    Path(out_path).write_bytes(pickle.dumps((hists, steps)))


def _ref_replay(out_path, m, cfg):
    """The reference's replay of ``cfg``'s trace over a mesh of ``m``
    (``tests/test_traffic.py:146``'s service)."""
    from repro.serve import (AccessService, AdaptiveFlushController,
                             TrafficConfig, generate_trace, replay_trace)
    trace = generate_trace(TrafficConfig(**cfg))
    svc = AccessService(tile_size=pr.SERVING_TILE, auto_flush=0, mesh=m,
                        controller=AdaptiveFlushController(
                            overhead_us=200.0))
    res = replay_trace(trace, svc, service_time=pr.service_time)
    out = {"windows": [(s, rep.order) for s, rep in res.windows],
           "tickets": [t.tid for _, t in res.tickets],
           "rejected": [t.tid for _, t in res.rejected],
           "makespan": res.makespan_us,
           "telemetry": svc.telemetry.summary(),
           "results": [np.asarray(svc.scheduler.result(t))
                       for _, t in res.tickets]}
    Path(out_path).write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    import ast
    assert sys.argv[1] == "--ref"
    if sys.argv[3] == "kv":
        _ref_kv(sys.argv[2])
    else:
        _ref_replay(sys.argv[2], int(sys.argv[3]),
                    ast.literal_eval(sys.argv[4]))

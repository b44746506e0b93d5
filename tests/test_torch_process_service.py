"""The Scheduler, the "sharded" plan backend, AccessService and the five
apps over a process mesh (``distributed.ProcessMesh``: one rank per
process, each holding its slice of every row-sharded table, the exchange
over ``torch.distributed``) on the CPU with gloo, at worlds 2 and 4 (8
with ``--runslow``).

Each world is spawned once for the module (``spawn.run_ranks``, a
``FileStore`` under the module's temp dir); its ranks
(``process_mesh_ranks.service_main``) run every mixed window of
``generate_mixed_case`` seeds 0-15 through one ``Scheduler`` per window,
every app's ``demo(seed, mode="pipelined", mesh=...)`` for seeds 0-1, the
harness's process-mesh checks, a batched program group, the refusals and
a diverging-stream probe, and write what they saw. Held:

  * against the reference's scheduler over a ``ShardedEngine`` mesh of the
    same size and its apps, run in subprocesses on 8 forced host devices
    with ``use_kernel=False`` (its Pallas kernels fail on the installed
    JAX). The reference compiles every window anew (~5 s each on the
    CPU), so tier-1 holds each mixed seed at one world (even seeds at 2,
    odd at 4) and the apps' seed 0 at 2 and seed 1 at 4; ``--runslow``
    holds every seed and app at every world;
  * against the port's logical mesh of the same size and the NumPy
    oracle, every seed at every world;
  * gathers and integer RMWs bit for bit, the apps bit for bit (their
    float sums are integer-valued), float RMWs within rtol 1e-5 / atol
    1e-6 (DESIGN.md §3); ``explain()`` and the skeleton identical on
    every rank.
"""
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
from repro_torch.apps import APPS
from repro_torch.core import Scheduler, interop
from repro_torch.distributed import ShardedEngine
from repro_torch.distributed.spawn import run_ranks

ROOT = Path(__file__).resolve().parents[1]
SEEDS = tuple(range(16))
APP_SEEDS = (0, 1)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
SPAWN_LIMIT = 120.0
slow = pytest.mark.slow


def _ref_pairs(slow_run: bool):
    """The (world, seed) pairs held against the reference: mixed windows
    and apps."""
    if slow_run:
        worlds = (2, 4, 8)
        return ({(w, s) for w in worlds for s in SEEDS},
                {(w, s) for w in worlds for s in APP_SEEDS})
    return ({(2 if s % 2 == 0 else 4, s) for s in SEEDS},
            {(2, 0), (4, 1)})


TIER1_MIXED, TIER1_APPS = _ref_pairs(False)


def _param(w, *rest, tier1=True):
    marks = () if tier1 and w != 8 else (slow,)
    return pytest.param(w, *rest, marks=marks)


WORLDS = (2, 4, pytest.param(8, marks=slow))


# ---------------------------------------------------------------------------
# the runs: the reference in subprocesses, each world spawned once
# ---------------------------------------------------------------------------

#: the reference's apps in two subprocesses per (mesh size, seed), each
#: about a third of the work of the heaviest mixed-window job
REF_APP_GROUPS = (("bfs", "hashjoin"), ("spmv", "kv_serve", "embedding_bag"))
REF_MIXED_CHUNK = 4                # mixed seeds per reference subprocess


def _ref_jobs(mixed, apps):
    """The reference subprocesses: ``(kind, mesh size, seeds, apps)``,
    small enough that they finish together while the worlds run."""
    jobs = []
    for m in sorted({w for w, _ in mixed}):
        seeds = sorted(s for w, s in mixed if w == m)
        jobs += [("mixed", m, seeds[i:i + REF_MIXED_CHUNK], ())
                 for i in range(0, len(seeds), REF_MIXED_CHUNK)]
    jobs += [("apps", m, [s], group) for m, s in sorted(apps)
             for group in REF_APP_GROUPS]
    return jobs


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    slow_run = request.config.getoption("--runslow")
    return once(tmp_path_factory, f"process_service-slow{int(slow_run)}",
                lambda: _spawn(slow_run,
                               tmp_path_factory.mktemp("process_service")))


def _spawn(slow_run, tmp):
    """The reference's jobs and each gloo world, once."""
    worlds = [2, 4] + ([8] if slow_run else [])
    mixed, apps = _ref_pairs(slow_run)
    # the reference compiles every window anew: its compiles at LLVM's
    # lowest optimisation level are ~20% cheaper, and every compared
    # result is exact or held within FLOAT_TOL either way
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    refs = {}
    for k, (kind, m, seeds, names) in enumerate(_ref_jobs(mixed, apps)):
        out = tmp / f"ref{k}.pkl"
        refs[(kind, m, k)] = (out, subprocess.Popen(
            [sys.executable, __file__, "--ref", kind, str(m), str(out),
             ",".join(names)] + [str(s) for s in seeds], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    got = {}
    try:
        for w in worlds:
            out = tmp / f"world{w}"
            out.mkdir()
            t0 = time.perf_counter()
            run_ranks(pr.service_main, w, args=(str(out), SEEDS, APP_SEEDS),
                      backend="gloo", init_method=f"file://{out}/store",
                      timeout=60, join_timeout=SPAWN_LIMIT)
            got[w] = {"ranks": [pickle.loads((out / f"rank{r}.pkl")
                                             .read_bytes())
                                for r in range(w)],
                      "seconds": time.perf_counter() - t0}
        ref = {"mixed": {}, "apps": {}}
        for (kind, m, _), (out, proc) in refs.items():
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-4000:]
            for s, res in pickle.loads(out.read_bytes()).items():
                if kind == "apps":
                    ref[kind].setdefault((m, s), {}).update(res)
                else:
                    ref[kind][(m, s)] = res
    finally:
        for _, proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"world": got, "ref": ref}


def _ranks(runs, w):
    return runs["world"][w]["ranks"]


def _np(x):
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _match(what, got, want, *, exact=False):
    """Integers bit for bit (an int32 container read as the uint32 it
    holds), floats within FLOAT_TOL, or bit for bit with ``exact``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or exact:
        if got.dtype != want.dtype and \
                got.dtype.itemsize == want.dtype.itemsize:
            got = got.view(want.dtype)
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), \
            what
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), err_msg=what,
                                   **FLOAT_TOL)


def _same_window(what, got, want):
    """One mixed window's results: gathers bit for bit, RMWs and
    programs by ``_match``."""
    assert set(got) == set(want), what
    for key, value in want.items():
        if key[0] == "p":
            for part, (g, w) in enumerate(zip(got[key], value)):
                assert set(g) == set(w), (what, key)
                for name in w:
                    _match(f"{what} {key} part {part} {name}", g[name],
                           w[name])
        else:
            _match(f"{what} {key}", got[key], value, exact=key[0] == "g")


def test_worlds_finish_in_time(runs):
    for w, run in runs["world"].items():
        assert run["seconds"] < SPAWN_LIMIT, (w, run["seconds"])


# ---------------------------------------------------------------------------
# mixed windows through the Scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,seed", [
    _param(w, s, tier1=(w, s) in TIER1_MIXED)
    for w in (2, 4, 8) for s in SEEDS])
def test_mixed_window_equals_reference_mesh(runs, w, seed):
    """Every rank's window (gathers whole, RMW slices put back together)
    equals the reference's scheduler over a ShardedEngine mesh of the
    same size."""
    want = runs["ref"]["mixed"][(w, seed)]
    for r, rank in enumerate(_ranks(runs, w)):
        _same_window(f"world {w} rank {r} seed {seed} vs reference",
                     rank["mixed"][seed]["results"], want)


@pytest.mark.parametrize("w,seed", [_param(w, s) for w in (2, 4, 8)
                                    for s in SEEDS])
def test_mixed_window_equals_logical_mesh_and_numpy(runs, w, seed):
    """Every rank's window equals the port's logical mesh of the same
    size, and both hold the NumPy expectations."""
    from test_torch_scheduler import check_against_numpy, collect, \
        submit_mixed
    from repro.testing import fuzzer as rfuzzer
    case = rfuzzer.generate_mixed_case(seed)
    sched = Scheduler(engine=ShardedEngine(mesh=w, tile_size=pr.SERVICE_TILE,
                                           device="cpu"))
    entries = submit_mixed(sched, case, tile=pr.SERVICE_TILE)
    sched.flush()
    want = collect(sched, entries)
    check_against_numpy(case, want, entries, tile=pr.SERVICE_TILE)
    for r, rank in enumerate(_ranks(runs, w)):
        got = rank["mixed"][seed]["results"]
        _same_window(f"world {w} rank {r} seed {seed} vs logical mesh",
                     got, want)
        check_against_numpy(case, got, entries, tile=pr.SERVICE_TILE)


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_lowers_the_same_plan(runs, w):
    """explain() text and the lowering's skeleton are identical on every
    rank, the flush executed the explained plan with mesh-placed nodes,
    and each window took one agreement."""
    ranks = _ranks(runs, w)
    for seed in SEEDS:
        first = ranks[0]["mixed"][seed]
        assert first["sharded"] > 0 and first["same_plan"], seed
        for rank in ranks[1:]:
            mine = rank["mixed"][seed]
            assert mine["explain"] == first["explain"], (w, seed)
            assert mine["skeleton"] == first["skeleton"], (w, seed)
            assert mine["codes"] == first["codes"], (w, seed)
        assert all(r["mixed"][seed]["agreements"] == 1 for r in ranks)
    assert "sharded" in ranks[0]["mixed"][0]["explain"]


# ---------------------------------------------------------------------------
# the five apps through AccessService(mesh=ProcessMesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,name,seed", [
    _param(w, n, s, tier1=(w, s) in TIER1_APPS)
    for w in (2, 4, 8) for n in APPS for s in APP_SEEDS])
def test_app_equals_reference_mesh(runs, w, name, seed):
    """Every rank's run returns the reference app's result over a mesh of
    the same size, bit for bit."""
    want = runs["ref"]["apps"][(w, seed)][name]
    for r, rank in enumerate(_ranks(runs, w)):
        _match(f"world {w} rank {r} {name} seed {seed} vs reference",
               rank["apps"][(name, seed)], want, exact=True)


@pytest.mark.parametrize("w,name,seed", [
    _param(w, n, s) for w in (2, 4, 8) for n in APPS for s in APP_SEEDS])
def test_app_equals_oracle(runs, w, name, seed):
    """Every rank's run returns the NumPy oracle's result bit for bit."""
    want = APPS[name].demo_reference(seed)
    for r, rank in enumerate(_ranks(runs, w)):
        _match(f"world {w} rank {r} {name} seed {seed} vs oracle",
               rank["apps"][(name, seed)], want, exact=True)


@pytest.mark.parametrize("w", WORLDS)
def test_sequential_mode_over_a_process_mesh(runs, w):
    """The strictly-coupled baseline runs over the mesh too (its compute
    phases flush windows whose handles they drop): bfs and kv_serve bit
    for bit their oracles on every rank."""
    for rank in _ranks(runs, w):
        for name, got in rank["sequential"].items():
            _match(f"world {w} {name} sequential", got,
                   APPS[name].demo_reference(0), exact=True)


@pytest.mark.parametrize("w", WORLDS)
def test_harness_checks_on_a_process_mesh(runs, w):
    """check_mixed_flush_parity, check_app_parity, check_kv_parity and
    check_embedding_parity take mesh=ProcessMesh and passed on every
    rank (each raises on every rank when any rank diverges)."""
    for rank in _ranks(runs, w):
        h = rank["harness"]
        assert all(c > 0 for c in h["mixed"])
        assert h["apps"] == (len(APPS), [w])
        assert h["kv"] == 1 and h["embedding"] == 1


# ---------------------------------------------------------------------------
# the batch split, the refusals, the diverging stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
def test_batched_group_splits_across_ranks(runs, w):
    """A batched group of 5 programs: each rank runs only its block of
    ceil(5 / w) lanes, and every rank's results equal the group's
    single-device run_batch."""
    for rank in _ranks(runs, w):
        b = rank["batch"]
        assert b["same"] and b["vmapped"] == [True]
        assert b["lanes_run"] == [-(-5 // w)]


@pytest.mark.parametrize("w", WORLDS)
def test_refusals_on_every_rank(runs, w):
    """A forced bulk/eager path on a sliced table fails on every rank
    with the reason; a wrong slice on one rank is refused on every rank
    while the window's other submission runs; a controller on the wall
    clock is refused, one on a caller's clock runs."""
    table = np.arange(40, dtype=np.float32).reshape(20, 2)
    idx = np.array([0, 19, 7, 7, 12], np.int32)
    want_rmw = table.copy()
    np.add.at(want_rmw, idx, 1.0)
    for r, rank in enumerate(_ranks(runs, w)):
        ref = rank["refusals"]
        for knob in ("{'force_gather': 'bulk'}", "{'force_gather': 'eager'}",
                     "{'force_rmw': 'bulk'}"):
            assert "slice" in ref[knob] and "A14b" in ref[knob], (r, knob)
        assert "rank_rows" in ref["wrong_slice"], r
        if r != 1:
            assert "refused on rank 1" in ref["wrong_slice"], r
        lo, hi = _rows(20, w, r)
        _match(f"rank {r} window beside the refusal",
               ref["wrong_slice_other"], want_rmw[lo:hi], exact=True)
        assert "clock" in ref["wall_clock"] and "A14b" in ref["wall_clock"]
        _match(f"rank {r} service on a caller's clock",
               ref["virtual_clock"], table[idx], exact=True)


def _rows(n, w, r):
    from repro_torch.distributed import shard_row_ranges
    return shard_row_ranges(n, w)[r]


@pytest.mark.parametrize("w", WORLDS)
def test_diverging_stream_raises_on_every_rank(runs, w):
    """Rank 1 submits a longer stream: every rank raises PlanDivergence
    at once (no collective of the window was issued), naming the first
    leaf that differs; the window stays queued."""
    for rank in _ranks(runs, w):
        d = rank["diverge"]
        assert d["raised"] is not None and "rank(s) [1]" in d["raised"]
        assert "leaf 0" in d["raised"] and d["pending"] == 1
        assert d["seconds"] < 30


# ---------------------------------------------------------------------------
# the reference side (subprocesses with 8 forced host devices)
# ---------------------------------------------------------------------------

def _ref_main(kind, m, out_path, names, seeds):
    from repro import apps as rapps
    from repro.core import Scheduler as RefScheduler
    from repro.distributed import ShardedEngine as RefShardedEngine
    from repro.testing import fuzzer as rfuzzer
    from test_torch_scheduler import collect, submit_mixed
    out = {}
    for seed in seeds:
        if kind == "mixed":
            sched = RefScheduler(engine=RefShardedEngine(
                mesh=m, tile_size=pr.SERVICE_TILE))
            entries = submit_mixed(sched, rfuzzer.generate_mixed_case(seed),
                                   tile=pr.SERVICE_TILE, port=False)
            sched.flush()
            res = collect(sched, entries)
            out[seed] = {k: (tuple({n: np.asarray(x) for n, x in part.items()}
                                   for part in v) if k[0] == "p"
                             else np.asarray(v)) for k, v in res.items()}
        else:
            out[seed] = {name: np.asarray(rapps.APPS[name].demo(
                seed, mode="pipelined", mesh=m)) for name in names}
    Path(out_path).write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    assert sys.argv[1] == "--ref"
    _ref_main(sys.argv[2], int(sys.argv[3]), sys.argv[4],
              [n for n in sys.argv[5].split(",") if n],
              [int(a) for a in sys.argv[6:]])

"""The sharded engine over a process mesh (``distributed.ProcessMesh``: one
rank per process, each holding only its table slice, the exchange over
``torch.distributed``) on the CPU with gloo, at worlds 2 and 4 (8 with
``--runslow``).

Each world is spawned once for the module (``spawn.run_ranks``, a
``FileStore`` under the module's temp dir, so parallel workers never race
for a port); its ranks run every case (``process_mesh_ranks.rank_main``)
and write what they saw there. Held:

  * against the reference's ``ShardedEngine`` at the same mesh size, run
    in a subprocess on 8 forced host devices (``use_kernel=False``):
    ``default_sharded_cases(0)`` and ``_extra_cases`` of
    ``test_torch_distributed``, every codec x placement pin, start/finish,
    and ``ShardStats`` — gathers and integer RMWs bit for bit, float
    ADD/MUL within rtol 1e-5 / atol 1e-6 (DESIGN.md §3);
  * against the port's logical mesh at the same size (results and stats);
  * each rank's block and slice, the collectives, the owner-local exec's
    table (the rank's slice, never the whole table) and the harness's
    verdict, with a negative probe (one rank's exchange corrupted).
"""
import json
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
from repro_torch.core import Scheduler
from repro_torch.plan import CostModel
from repro_torch.distributed import (ProcessMesh, ShardedEngine,
                                     process_mesh, shard_row_ranges)
from repro_torch.distributed.spawn import RankFailure, run_ranks
from repro_torch.serve import AccessService
from repro_torch.testing import harness

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4, pytest.param(8, marks=pytest.mark.slow))
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
CORRUPT_RANK = 1
SPAWN_LIMIT = 120.0                # seconds for a world to finish


def cases():
    from test_torch_distributed import _extra_cases
    return harness.default_sharded_cases(0) + _extra_cases()


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, got.dtype, want.shape, want.dtype)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=what, **FLOAT_TOL)
    else:
        assert np.array_equal(got, want), what


def _gather_exact(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), what


# ---------------------------------------------------------------------------
# the runs: the reference in a subprocess, each world spawned once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    slow = request.config.getoption("--runslow")
    return once(tmp_path_factory, f"process_mesh-slow{int(slow)}",
                lambda: _spawn(slow, tmp_path_factory.mktemp("process_mesh")))


def _spawn(slow, tmp):
    """The reference at each mesh size and each gloo world, once."""
    sizes = [2, 4] + ([8] if slow else [])
    cases_path = tmp / "cases.pkl"
    cases_path.write_bytes(pickle.dumps(cases()))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    # the reference runs, one process per mesh size, while the worlds are
    # spawned
    refs = {m: subprocess.Popen(
        [sys.executable, __file__, "--ref", str(cases_path),
         str(tmp / f"ref{m}.pkl"), str(m)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for m in sizes}
    got = {}
    try:
        for w in sizes:
            out = tmp / f"world{w}"
            out.mkdir()
            t0 = time.perf_counter()
            run_ranks(pr.rank_main, w, args=(str(cases_path), str(out),
                                             CORRUPT_RANK),
                      backend="gloo", init_method=f"file://{out}/store",
                      timeout=60, join_timeout=SPAWN_LIMIT)
            got[w] = {"ranks": [pickle.loads((out / f"rank{r}.pkl")
                                             .read_bytes())
                                for r in range(w)],
                      "seconds": time.perf_counter() - t0}
        for m, proc in refs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    refs = {m: pickle.loads((tmp / f"ref{m}.pkl").read_bytes())[m]
            for m in sizes}
    return {"cases": cases(), "ref": refs, "world": got}


def _world(runs, w):
    return runs["world"][w]["ranks"]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
def test_cases_match_reference(runs, w):
    """Every case, assembled from the ranks, against the reference's
    8-device engine at mesh w."""
    ref = runs["ref"][w]["cases"]
    for k, (case, got, want) in enumerate(zip(
            runs["cases"], _world(runs, w)[0]["cases"], ref)):
        if case[0] == "gather":
            _gather_exact(got["whole"], want, f"case {k} gather")
        else:
            _close(got["whole"], want, f"case {k} rmw {case[4]}")


@pytest.mark.parametrize("w", WORLDS)
def test_shard_stats_match_reference(runs, w):
    ref = runs["ref"][w]["stats"]
    for rank in _world(runs, w):
        got = [c["stats"] for c in rank["cases"]]
        assert len(got) == len(ref)
        for k, (g, r) in enumerate(zip(got, ref)):
            assert g == r, (rank["rank"], k, g, r)


@pytest.mark.parametrize("w", WORLDS)
def test_pins_match_reference(runs, w):
    """Every placement x codec pin: results and stats."""
    table, idx, ti, vals = pr.pin_inputs()
    ref = runs["ref"][w]["pins"]
    assert len(ref) == len(pr.PINS) == 6
    for rank in _world(runs, w):
        for pin, got, want in zip(pr.PINS, rank["pins"], ref):
            _gather_exact(got["gather"], want["gather"], pin)
            _gather_exact(got["gather"], table[np.clip(idx, 0, 999)], pin)
            _gather_exact(got["rmw"], want["rmw"], pin)
            assert got["gather_stats"] == want["gather_stats"], pin
            assert got["rmw_stats"] == want["rmw_stats"], pin
            # owner placement puts the lanes back with one more exchange
            owner = got["gather_stats"]["placement"] == "owner"
            assert got["gather_collectives"] == 3 + owner, pin
    placements = {(g["gather_stats"]["placement"], g["gather_stats"]["codec"])
                  for g in ref}
    assert placements == set(pr.PINS)


@pytest.mark.parametrize("w", WORLDS)
def test_start_finish_matches_fused_and_reference(runs, w):
    table, idx, valid, ti, vals = pr.split_inputs()
    ref = runs["ref"][w]["split"]
    for rank in _world(runs, w):
        s = rank["split"]
        _gather_exact(s["gather"], s["gather_fused"], "gather split/fused")
        _gather_exact(s["gather"], ref["gather"], "gather vs reference")
        _gather_exact(s["gather"],
                      np.where(valid[:, None], table[idx], 0), "gather")
        _gather_exact(s["rmw"], s["rmw_fused"], "rmw split/fused")
        _gather_exact(s["rmw"], ref["rmw"], "rmw vs reference")
        _gather_exact(s["rmw"], harness._np_rmw(ti, idx, vals, "ADD",
                                                cond=valid), "rmw")
        assert all(o in (0.0, 1.0) for o in s["overlap"])
        assert s["empty"] == (0, 2) and s["empty_stats"] is None


# ---------------------------------------------------------------------------
# against the logical mesh, and the process mesh's own contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORLDS)
def test_process_mesh_equals_logical_mesh(runs, w):
    logical = ShardedEngine(mesh=w, device="cpu")
    for k, (case, got) in enumerate(zip(runs["cases"],
                                        _world(runs, w)[0]["cases"])):
        if case[0] == "gather":
            want = logical.sharded_gather(case[1], case[2])
        else:
            want = logical.sharded_rmw(case[1], case[2], case[3], op=case[4])
        want = pr._np(want, case[1])
        _close(got["whole"], want, f"case {k}")
        assert got["stats"] == pr.stats_record(logical.last_shard_stats), k


@pytest.mark.parametrize("w", WORLDS)
def test_blocks_slices_and_collectives(runs, w):
    """Rank r returns lanes ``rank_lanes`` of a gather and rows
    ``rank_rows`` of an RMW; ``gather_blocks`` gives every rank the
    whole; a gather makes 3 collectives (4 with owner placement), an RMW
    3, all over gloo on the CPU."""
    ranks = _world(runs, w)
    assert [r["rank"] for r in ranks] == list(range(w))
    for rank in ranks:
        assert rank["transport"] == "gloo" and rank["device"] == "cpu"
    for k, case in enumerate(runs["cases"]):
        whole = ranks[0]["cases"][k]["whole"]
        n = len(case[2]) if case[0] == "gather" else len(case[1])
        per = -(-n // w)
        for r, rank in enumerate(ranks):
            c = rank["cases"][k]
            _gather_exact(c["whole"], whole, f"case {k} rank {r} whole")
            lo, hi = min(r * per, n), min((r + 1) * per, n)
            _gather_exact(c["mine"], whole[lo:hi], f"case {k} rank {r}")
            assert c["slice"] == tuple(shard_row_ranges(len(case[1]),
                                                        w)[r])
            if c["stats"] is None:
                assert n == 0 and c["collectives"] is None
                continue
            assert c["transport"] == "gloo"
            owner = c["stats"]["placement"] == "owner"
            want = 3 + (owner and case[0] == "gather")
            assert c["collectives"] == want, (k, c["collectives"])


@pytest.mark.parametrize("w", WORLDS)
def test_owner_exec_sees_only_the_rank_slice(runs, w):
    """The owner-local exec is one bulk_gather (gather) or one bulk_rmw
    (RMW) per rank and call, on the rank's slice; no call hands a rank
    the whole table. A rank handed the whole table refuses it."""
    for rank in _world(runs, w):
        for k, (case, c) in enumerate(zip(runs["cases"], rank["cases"])):
            lo, hi = c["slice"]
            row = tuple(np.asarray(case[1]).shape[1:])
            n = len(case[2])
            kind = case[0]
            if n == 0:
                assert c["owner"] == [], k
                continue
            assert all(kind_ == kind for kind_, _ in c["owner"]), k
            assert len(c["owner"]) <= 1, (k, c["owner"])
            for _, shape in c["owner"]:
                assert shape == (hi - lo,) + row, (k, shape)
                assert hi - lo < len(case[1])
        assert "its slice of a 300-row table" in rank["whole_table"]


@pytest.mark.parametrize("w", WORLDS)
def test_kernel_path_equals_plain_path(runs, w):
    """``use_kernel=True`` (the kernels' plain versions on the CPU)."""
    for rank in _world(runs, w):
        for k, (got, plain) in enumerate(zip(rank["kernel_path"],
                                             rank["cases"])):
            _close(got, plain["whole"], f"case {k}")


@pytest.mark.parametrize("w", WORLDS)
def test_all_to_all_swaps_buckets(runs, w):
    for r, rank in enumerate(_world(runs, w)):
        s = rank["swaps"]
        want = [i * 100 + r for i in range(w) for _ in range(3)]
        assert s["even"] == want and s["flight"] == [float(v) for v in want]
        assert s["completed"]
        assert s["ragged"] == [i * 100 + r for i in range(w)
                               for _ in range(r + 1)]


@pytest.mark.parametrize("w", WORLDS)
def test_parity_harness_and_negative_probe(runs, w):
    """``check_sharded_parity(mesh=ProcessMesh)`` passes on every rank;
    with one bucket of one rank's exchange corrupted it fails on every
    rank (the verdict is all-reduced)."""
    n = len(harness.default_sharded_cases(0))
    for rank in _world(runs, w):
        assert rank["parity"] == (n, [w])
        assert rank["probe"] is not None, rank["rank"]
        assert f"process mesh of {w}" in rank["probe"]
        assert str(CORRUPT_RANK) in rank["probe"]


def test_worlds_finish_in_time(runs):
    for w, run in runs["world"].items():
        assert run["seconds"] < SPAWN_LIMIT, (w, run["seconds"])


# ---------------------------------------------------------------------------
# without a spawn
# ---------------------------------------------------------------------------

def test_process_mesh_needs_a_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        process_mesh(device="cpu")


def _unjoined_mesh(world=2):
    return ProcessMesh(group=None, rank=0, num_shards=world,
                       device=torch.device("cpu"), backend="gloo")


def test_scheduler_and_service_refuse_a_process_mesh():
    """A Scheduler and an AccessService build over a process mesh (its
    windows are agreed across ranks, ROADMAP A14b); what a process mesh
    still refuses is a local path forced on a rank's table slice, which
    the lowering turns into a failed node naming the slice."""
    eng = ShardedEngine(_unjoined_mesh(), device="cpu")
    assert eng.transport == "gloo" and eng.rank_rows(10) == (0, 5)
    assert eng.rank_lanes(7) == (0, 4)
    sched = Scheduler(engine=eng)
    assert sched.process and sched.engine is eng
    svc = AccessService(mesh=_unjoined_mesh(), device="cpu")
    assert svc.scheduler.process and svc.scheduler.engine.rank == 0
    forced = Scheduler(engine=eng, cost_model=CostModel(force_gather="bulk"))
    table = np.zeros((5, 2), np.float32)         # rank 0's rows of 10
    forced.submit_gather(table, np.arange(3), n_rows=10)
    (node,) = forced.explain().plan.roots
    assert isinstance(node.error, ValueError)
    assert "slice" in str(node.error) and node.sliced
    assert "slice" in str(CostModel(force_gather="eager")
                          .local_refusal(node))
    assert CostModel(force_rmw="bulk").local_refusal(node) is None
    with pytest.raises(ValueError, match="process mesh's device"):
        ShardedEngine(_unjoined_mesh(), device="meta")


def test_process_mesh_needs_n_rows():
    """A rank's slice alone does not say how large the table is: every
    entry point on a process mesh refuses a call without ``n_rows``."""
    eng = ShardedEngine(_unjoined_mesh(), device="cpu")
    table = np.zeros((5, 2), np.float32)
    idx, vals = np.arange(3), np.ones((3, 2), np.float32)
    for call in (lambda: eng.sharded_gather(table, idx),
                 lambda: eng.gather_start(table, idx),
                 lambda: eng.sharded_rmw(table, idx, vals),
                 lambda: eng.rmw_start(table, idx, vals)):
        with pytest.raises(ValueError, match=r"n_rows.*rank_rows"):
            call()


@pytest.mark.parametrize("how,says", [
    ("raise", "rank 1 raised"), ("die", r"rank\(s\) \[1\] died"),
    ("hang", r"rank\(s\) \[1\] hung past 10 s")],
    ids=["raise", "die", "hang"])
def test_a_failing_rank_fails_the_spawn(tmp_path, how, says):
    """A rank that raises, dies or hangs fails the spawn (within its join
    limit) instead of stalling the caller."""
    t0 = time.perf_counter()
    with pytest.raises(RankFailure, match=says):
        run_ranks(pr.fail_on_rank1, 2, args=(how,),
                  init_method=f"file://{tmp_path}/s", timeout=30,
                  join_timeout=10)
    assert time.perf_counter() - t0 < 40


# ---------------------------------------------------------------------------
# the reference side (subprocess with 8 forced host devices)
# ---------------------------------------------------------------------------

def _ref_main(cases_path, out_path, sizes):
    import jax.numpy as jnp
    from repro.distributed import ShardedEngine as RefShardedEngine
    from test_torch_distributed import _stats_record
    all_cases = pickle.loads(Path(cases_path).read_bytes())
    out = {}
    for m in sizes:
        eng = RefShardedEngine(mesh=m)
        res, stats = [], []
        for case in all_cases:
            if case[0] == "gather":
                got = eng.sharded_gather(case[1], case[2])
            else:
                got = eng.sharded_rmw(case[1], case[2], case[3], op=case[4])
            res.append(np.asarray(got))
            stats.append(_stats_record(eng.last_shard_stats))
        table, idx, ti, vals = pr.pin_inputs()
        pins = []
        for placement, codec in pr.PINS:
            g = eng.sharded_gather(table, idx, placement=placement,
                                   codec=codec)
            gst = _stats_record(eng.last_shard_stats)
            r = eng.sharded_rmw(ti, idx, vals, op="XOR",
                                placement=placement, codec=codec)
            pins.append({"gather": np.asarray(g), "gather_stats": gst,
                         "rmw": np.asarray(r),
                         "rmw_stats": _stats_record(eng.last_shard_stats)})
        table, idx, valid, ti, vals = pr.split_inputs()
        fl = eng.gather_start(table, idx, valid=jnp.asarray(valid))
        g = eng.gather_finish(table, fl)
        fl = eng.rmw_start(ti, idx, vals, op="ADD",
                           valid=jnp.asarray(valid))
        r = eng.rmw_finish(ti, fl)
        out[m] = {"cases": res, "stats": stats, "pins": pins,
                  "split": {"gather": np.asarray(g), "rmw": np.asarray(r)}}
    Path(out_path).write_bytes(pickle.dumps(out))
    print(json.dumps({"sizes": list(sizes)}))


if __name__ == "__main__":
    assert sys.argv[1] == "--ref"
    _ref_main(sys.argv[2], sys.argv[3], [int(a) for a in sys.argv[4:]])

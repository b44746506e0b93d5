"""Rank-side work of ``test_torch_process_mesh.py``.

Runs in the processes ``repro_torch.distributed.spawn.run_ranks`` spawns
(one per rank of a gloo group on the CPU), so it imports torch, NumPy and
``repro_torch`` only. Every rank runs every case over a ``ProcessMesh``
and writes what it saw to ``<out>/rank<r>.pkl``; the test module holds
those against the reference and the logical mesh.
"""
import pickle
from pathlib import Path

import numpy as np
import torch

#: every (placement, codec) pin
PINS = [(p, c) for p in ("block", "owner") for c in ("raw", "bitmap", "delta")]


def pin_inputs():
    """A gather table and stream, and an integer RMW, for the pins."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(1000, 3)).astype(np.float32)
    idx = rng.integers(-5, 1010, size=700).astype(np.int32)
    ti = rng.integers(0, 100, size=(1000,)).astype(np.int32)
    vals = rng.integers(0, 100, size=700).astype(np.int32)
    return table, idx, ti, vals


def split_inputs():
    """A masked gather and a masked ADD for the start/finish stages."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(300, 2)).astype(np.float32)
    idx = rng.integers(0, 300, size=250).astype(np.int32)
    valid = rng.random(250) < 0.7
    ti = np.zeros(300, np.int32)
    vals = rng.integers(0, 9, size=250).astype(np.int32)
    return table, idx, valid, ti, vals


def stats_record(st):
    """The fields of ``ShardStats`` the reference also has."""
    if st is None:
        return None
    return {"sent": st.sent.tolist(), "received": st.received.tolist(),
            "unique": st.unique.tolist(), "capacity": st.capacity,
            "codec": st.codec, "placement": st.placement,
            "idx_bytes": st.idx_bytes, "idx_bytes_raw": st.idx_bytes_raw,
            "bytes_on_wire": st.bytes_on_wire}


def _np(t, like):
    from repro_torch.core import interop
    return interop.to_numpy(t, np.asarray(like).dtype)


class OwnerCalls:
    """Records the table each owner-local bulk op is handed."""

    def __init__(self, bulk_ops):
        self.calls = []
        self._gather, self._rmw = bulk_ops.bulk_gather, bulk_ops.bulk_rmw

        def gather(table, *a, **k):
            self.calls.append(("gather", tuple(table.shape)))
            return self._gather(table, *a, **k)

        def rmw(table, *a, **k):
            self.calls.append(("rmw", tuple(table.shape)))
            return self._rmw(table, *a, **k)
        bulk_ops.bulk_gather, bulk_ops.bulk_rmw = gather, rmw

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def _run(eng, mesh, case, owner):
    """One case on this rank: its block or slice, the whole result
    (``gather_blocks``), the stats and the owner calls."""
    from repro_torch.distributed import gather_blocks
    table = np.asarray(case[1])
    n_rows = table.shape[0]
    lo, hi = eng.rank_rows(n_rows)
    if case[0] == "gather":
        mine = eng.sharded_gather(table[lo:hi], case[2], n_rows=n_rows)
    else:
        mine = eng.sharded_rmw(table[lo:hi], case[2], case[3], op=case[4],
                               n_rows=n_rows)
    st = eng.last_shard_stats
    return {"mine": _np(mine, table),
            "whole": _np(gather_blocks(mine, mesh), table),
            "stats": stats_record(st),
            "transport": None if st is None else st.transport,
            "collectives": None if st is None else st.collectives,
            "owner": owner.take(), "slice": (lo, hi)}


def _swaps(mesh, rank, world):
    """``all_to_all`` on even buckets (synchronous and in flight) and on
    ragged ones: bucket j of rank r holds r * 100 + j."""
    from repro_torch.distributed import all_to_all
    even = torch.tensor([rank * 100 + j for j in range(world)
                         for _ in range(3)], dtype=torch.int64)
    got = all_to_all(even, mesh)
    ex = all_to_all(even.to(torch.float32).reshape(-1, 1), mesh,
                    async_op=True)
    flight = ex.wait()
    # ragged: rank r sends j + 1 rows to rank j
    send = [j + 1 for j in range(world)]
    ragged = torch.cat([torch.full((j + 1,), rank * 100 + j)
                        for j in range(world)])
    got_r = all_to_all(ragged, mesh, send_counts=send,
                       recv_counts=[rank + 1] * world)
    return {"even": got.tolist(), "flight": flight.reshape(-1).tolist(),
            "completed": ex.is_completed(), "ragged": got_r.tolist()}


def rank_main(rank, world, cases_path, out_dir, corrupt_rank):
    from repro_torch.core import bulk_ops
    from repro_torch.distributed import (ShardedEngine, exchange,
                                         gather_blocks, process_mesh)
    from repro_torch.testing import harness
    mesh = process_mesh(device="cpu")
    owner = OwnerCalls(bulk_ops)
    cases = pickle.loads(Path(cases_path).read_bytes())
    eng = ShardedEngine(mesh, device="cpu")
    out = {"world": world, "rank": rank, "device": str(eng.device),
           "transport": eng.transport}
    out["cases"] = [_run(eng, mesh, c, owner) for c in cases]
    keng = ShardedEngine(mesh, use_kernel=True, device="cpu")
    out["kernel_path"] = [_run(keng, mesh, c, owner)["whole"]
                          for c in cases]
    table, idx, ti, vals = pin_inputs()
    out["pins"] = []
    for k, (placement, codec) in enumerate(PINS):
        lo, hi = eng.rank_rows(table.shape[0])
        g = eng.sharded_gather(table[lo:hi], idx, placement=placement,
                               codec=codec, n_rows=table.shape[0])
        gst = stats_record(eng.last_shard_stats)
        gcoll = eng.last_shard_stats.collectives
        r = eng.sharded_rmw(ti[lo:hi], idx, vals, op="XOR",
                            placement=placement, codec=codec,
                            n_rows=ti.shape[0])
        out["pins"].append({
            "gather": _np(gather_blocks(g, mesh), table), "gather_stats": gst,
            "gather_collectives": gcoll,
            "rmw": _np(gather_blocks(r, mesh), ti),
            "rmw_stats": stats_record(eng.last_shard_stats)})
    owner.take()
    table, idx, valid, ti, vals = split_inputs()
    n_rows = table.shape[0]
    lo, hi = eng.rank_rows(n_rows)
    fl = eng.gather_start(table[lo:hi], idx, valid=valid, n_rows=n_rows)
    g_split = eng.gather_finish(table[lo:hi], fl)
    g_overlap = eng.last_shard_stats.overlap_fraction
    g_fused = eng.sharded_gather(table[lo:hi], idx, valid=valid,
                                 n_rows=n_rows)
    fl = eng.rmw_start(ti[lo:hi], idx, vals, op="ADD", valid=valid,
                       n_rows=n_rows)
    r_split = eng.rmw_finish(ti[lo:hi], fl)
    r_overlap = eng.last_shard_stats.overlap_fraction
    r_fused = eng.sharded_rmw(ti[lo:hi], idx, vals, op="ADD", valid=valid,
                              n_rows=n_rows)
    empty = eng.sharded_gather(table[lo:hi], np.zeros(0, np.int32),
                               n_rows=n_rows)
    out["split"] = {
        "gather": _np(gather_blocks(g_split, mesh), table),
        "gather_fused": _np(gather_blocks(g_fused, mesh), table),
        "rmw": _np(gather_blocks(r_split, mesh), ti),
        "rmw_fused": _np(gather_blocks(r_fused, mesh), ti),
        "overlap": (g_overlap, r_overlap), "empty": tuple(empty.shape),
        "empty_stats": eng.last_shard_stats}
    out["swaps"] = _swaps(mesh, rank, world)
    try:
        eng.sharded_gather(table, idx, n_rows=table.shape[0])
        out["whole_table"] = "accepted"
    except ValueError as e:
        out["whole_table"] = str(e)
    out["parity"] = harness.check_sharded_parity(mesh=mesh)
    if rank == corrupt_rank:
        # the negative probe: one bucket of this rank's exchanges is off
        good = exchange.all_to_all

        def corrupt(t):
            t = t.clone()
            if t.numel():
                t.view(-1)[0] += 1
            return t

        def bad(x, m, **kw):
            got = good(x, m, **kw)
            return got.then(corrupt) if kw.get("async_op") else corrupt(got)
        exchange.all_to_all = bad
    try:
        harness.check_sharded_parity(mesh=mesh)
        out["probe"] = None
    except harness.ParityError as e:
        out["probe"] = str(e)
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    return True


def fail_on_rank1(rank, world, how):
    """Rank 1 raises, dies or hangs; rank 0 returns."""
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        if how == "die":
            import os
            os._exit(3)
        import time
        time.sleep(120)
    return rank


# ---------------------------------------------------------------------------
# test_torch_process_service.py: the Scheduler, AccessService and the apps
# over a process mesh
# ---------------------------------------------------------------------------

SERVICE_TILE = 256
TENANTS = ("a", "b", "c")


def _numpy(x):
    from repro_torch.core import interop
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def submit_mixed_slices(sched, case, tile=SERVICE_TILE):
    """A ``MixedFlushCase`` submitted as ``test_torch_scheduler
    .submit_mixed`` submits it (programs, gathers, RMWs, tenants
    rotating), every gather and RMW table as this rank's slice with
    ``n_rows`` (one slice object per table, so a table's submissions
    fuse). Returns the tickets and each table's whole row count."""
    from repro_torch.core import compile_pattern
    iota = np.arange(tile, dtype=np.int32)
    turn = iter(range(1, 1 << 30))

    def tenant():
        return TENANTS[next(turn) % len(TENANTS)]

    part = {}
    for name, t in case.tables.items():
        lo, hi = sched.engine.rank_rows(len(t))
        part[name] = (t[lo:hi], len(t))
    programs, gathers, rmws = [], [], {}
    for p, env, n in case.programs:
        prog, _ = compile_pattern(p, tile_size=tile)
        regs = {"tile_base": 0, "N": n, "tile_end": n}
        programs.append(sched.submit(prog, {**env, "__iota__": iota}, regs,
                                     tenant=tenant()))
    for name, idx in case.gathers:
        tab, n = part[name]
        gathers.append(sched.submit_gather(tab, idx, tenant=tenant(),
                                           n_rows=n))
    for name, idx, vals, cond in case.rmws:
        tab, n = part[name]
        rmws.setdefault(name, []).append(sched.submit_rmw(
            tab, idx, vals, op=case.table_ops[name], cond=cond,
            tenant=tenant(), n_rows=n))
    return (programs, gathers, rmws), {k: n for k, (_, n) in part.items()}


def collect_whole(sched, tickets, n_rows, mesh):
    """Every ticket's result as NumPy, keyed as ``test_torch_scheduler
    .collect`` keys them; an RMW's slice put back together whole."""
    from repro_torch.distributed import gather_blocks
    programs, gathers, rmws = tickets
    out = {("g", k): _numpy(sched.result(t)) for k, t in enumerate(gathers)}
    for name, ts in rmws.items():
        for k, t in enumerate(ts):
            out[("r", name, k)] = _numpy(gather_blocks(
                sched.result(t), mesh, n_rows[name]))
    for k, t in enumerate(programs):
        env, spd = sched.result(t)
        out[("p", k)] = ({n: _numpy(v) for n, v in env.items()},
                         {n: _numpy(v) for n, v in spd.items()})
    return out


def _mixed_window(mesh, seed):
    """One mixed window over the mesh: its results, explain() text and
    skeleton digest, and the harness's own verdict on it."""
    from repro_torch.core import Scheduler
    from repro_torch.core.scheduler import _digest
    from repro_torch.distributed import ShardedEngine
    from repro_torch.plan import skeleton_of
    from repro_torch.testing import fuzzer
    case = fuzzer.generate_mixed_case(seed)
    sched = Scheduler(engine=ShardedEngine(mesh, tile_size=SERVICE_TILE))
    tickets, n_rows = submit_mixed_slices(sched, case)
    ex = sched.explain()
    report = sched.flush()
    return {"results": collect_whole(sched, tickets, n_rows, mesh),
            "explain": ex.render(diagnostics=False),
            "codes": [d.code for d in ex.plan.diagnostics],
            "skeleton": _digest(skeleton_of(ex.plan)),
            "same_plan": report.plan is ex.plan,
            "sharded": sum(n.kind == "sharded" for n in report.plan.roots),
            "agreements": sched.stats["agreements"]}


def _batch_split(mesh, rank):
    """A batched group of 5 programs (a block per rank, the short last
    one padded) against the same group's ``run_batch`` on one device;
    each rank's ``run_lanes`` calls record how many lanes it ran."""
    from repro_torch.core import Engine, Scheduler, compile_pattern, interop
    from repro_torch.distributed import ShardedEngine
    from repro_torch.testing import fuzzer
    case = fuzzer.generate_mixed_case(1)
    p, env, n = case.programs[0]
    prog, _ = compile_pattern(p, tile_size=SERVICE_TILE)
    iota = np.arange(SERVICE_TILE, dtype=np.int32)
    rng = np.random.default_rng(3)
    envs = []
    for _ in range(5):
        e = {k: (rng.permutation(v) if v.ndim else v)
             for k, v in env.items()}
        envs.append({**e, "__iota__": iota})
    regs = {"tile_base": 0, "N": n, "tile_end": n}
    eng = ShardedEngine(mesh, tile_size=SERVICE_TILE)
    ran = []
    run_lanes = eng.run_lanes

    def counted(program, lane_envs, *a, **kw):
        ran.append(len(lane_envs))
        return run_lanes(program, lane_envs, *a, **kw)
    eng.run_lanes = counted
    sched = Scheduler(engine=eng)
    ts = [sched.submit(prog, e, regs, tenant=f"t{i}")
          for i, e in enumerate(envs)]
    report = sched.flush()
    got = [sched.result(t) for t in ts]
    one = Engine(tile_size=SERVICE_TILE, device="cpu")
    want = one.executable(prog, batch=5).run_batch(
        [{k: interop.to_tensor(v, device="cpu") for k, v in e.items()}
         for e in envs], [regs] * 5)
    same = all(
        set(g[0]) == set(w[0]) and all(
            np.array_equal(_numpy(g[0][k]), _numpy(w[0][k])) for k in w[0])
        and all(np.array_equal(_numpy(g[1][k]), _numpy(w[1][k]))
                for k in w[1]) for g, w in zip(got, want))
    return {"same": same, "lanes_run": ran,
            "vmapped": [g.vmapped for g in report.groups]}


def _refusals(mesh, rank):
    """What a process mesh refuses, on every rank alike: a forced local
    path on a slice, a wrong slice on one rank, a controller on the wall
    clock."""
    from repro_torch.core import Scheduler
    from repro_torch.distributed import ShardedEngine
    from repro_torch.plan import CostModel
    from repro_torch.serve import AccessService, FixedWindowController
    table = np.arange(40, dtype=np.float32).reshape(20, 2)
    idx = np.array([0, 19, 7, 7, 12], np.int32)
    out = {}
    eng = ShardedEngine(mesh)
    lo, hi = eng.rank_rows(20)
    for knob in (dict(force_gather="bulk"), dict(force_gather="eager"),
                 dict(force_rmw="bulk")):
        sched = Scheduler(engine=eng, cost_model=CostModel(**knob))
        if "force_rmw" in knob:
            t = sched.submit_rmw(table[lo:hi], idx, np.ones((5, 2),
                                 np.float32), n_rows=20)
        else:
            t = sched.submit_gather(table[lo:hi], idx, n_rows=20)
        sched.flush()
        try:
            sched.result(t)
            out[str(knob)] = "accepted"
        except ValueError as e:
            out[str(knob)] = str(e)
    # rank 1 hands in the whole table as if it were its slice: refused on
    # every rank, and the window's other submission still runs
    sched = Scheduler(engine=eng)
    mine = table if rank == 1 else table[lo:hi]
    bad = sched.submit_gather(mine, idx, n_rows=20)
    good = sched.submit_rmw(table[lo:hi].copy(), idx,
                            np.ones((5, 2), np.float32), n_rows=20)
    sched.flush()
    try:
        sched.result(bad)
        out["wrong_slice"] = "accepted"
    except ValueError as e:
        out["wrong_slice"] = str(e)
    out["wrong_slice_other"] = _numpy(sched.result(good))
    try:
        AccessService(mesh=mesh, controller=FixedWindowController(4))
        out["wall_clock"] = "accepted"
    except ValueError as e:
        out["wall_clock"] = str(e)
    svc = AccessService(mesh=mesh, controller=FixedWindowController(2),
                        clock=lambda: 0.0)
    t = svc.submit_gather(table[lo:hi], idx, n_rows=20)
    svc.submit_gather(table[lo:hi], idx[:2], n_rows=20)  # cuts at 2
    out["virtual_clock"] = _numpy(svc.wait(t))
    return out


def _diverge(mesh, rank):
    """Rank 1 submits a longer stream than the others: every rank raises
    ``PlanDivergence`` at the flush, none hangs."""
    import time
    from repro_torch.core import PlanDivergence, Scheduler
    from repro_torch.distributed import ShardedEngine
    eng = ShardedEngine(mesh)
    lo, hi = eng.rank_rows(30)
    table = np.arange(30, dtype=np.int32)
    sched = Scheduler(engine=eng)
    sched.submit_gather(table[lo:hi], np.arange(6 + (rank == 1),
                                                dtype=np.int32), n_rows=30)
    t0 = time.perf_counter()
    try:
        sched.flush()
        return {"raised": None, "seconds": time.perf_counter() - t0}
    except PlanDivergence as e:
        return {"raised": str(e), "seconds": time.perf_counter() - t0,
                "pending": sched.pending}


def service_main(rank, world, out_dir, mixed_seeds, app_seeds):
    """Rank side of ``test_torch_process_service.py``: mixed windows,
    the five apps, the harness's process-mesh checks, the batch split,
    the refusals and the diverging-stream probe (last)."""
    import time
    from repro_torch.apps import APPS
    from repro_torch.distributed import process_mesh
    from repro_torch.testing import fuzzer, harness
    mesh = process_mesh(device="cpu")
    t0 = time.perf_counter()
    out = {"rank": rank, "world": world}
    out["mixed"] = {s: _mixed_window(mesh, s) for s in mixed_seeds}
    out["apps"] = {(name, s): np.asarray(mod.demo(s, mode="pipelined",
                                                  mesh=mesh))
                   for name, mod in APPS.items() for s in app_seeds}
    # the strictly-coupled baseline drops the compute phase's handles
    out["sequential"] = {name: np.asarray(APPS[name].demo(
        0, mode="sequential", mesh=mesh)) for name in ("bfs", "kv_serve")}
    out["harness"] = {
        "mixed": [harness.check_mixed_flush_parity(
            fuzzer.generate_mixed_case(s), tile_size=SERVICE_TILE,
            mesh=mesh)[0] for s in (0, 7)],
        "apps": harness.check_app_parity(mesh=mesh, seeds=(0,)),
        "kv": harness.check_kv_parity(mesh=mesh, seeds=(0,)),
        "embedding": harness.check_embedding_parity(mesh=mesh, seeds=(0,))}
    out["batch"] = _batch_split(mesh, rank)
    out["refusals"] = _refusals(mesh, rank)
    out["diverge"] = _diverge(mesh, rank)
    out["seconds"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    return True


# ---------------------------------------------------------------------------
# test_torch_process_serving.py: replay_trace and KvPoolServer over a
# process mesh
# ---------------------------------------------------------------------------

SERVING_TILE = 256
#: the reference's mesh replay (tests/test_traffic.py:146)
MESH_TRACE = dict(seed=11, n_events=120, p_program=0.0)
#: tests/test_traffic.py:426's soak trace
LONG_TRACE = dict(seed=43, n_events=1000, n_tenants=2000, p_program=0.0)
#: tests/test_kv_embedding.py:66's widths
KV_WIDTHS = dict(page_size=4, d=4, init_pages=4, growth_pages=2)
KV_STEPS = 6
#: (n_old, n_new) re-cuts of a row-sharded table
REGROW_CASES = ((16, 24), (16, 16), (10, 40), (0, 12), (3, 5), (37, 38))


def service_time(depth, report):
    return 200.0 + 8.0 * depth


def replay_record(res, svc, rank_rows):
    """What every rank must agree on, and its tickets: the windows
    (start, order), admissions, rejections, makespan and telemetry; each
    gather ticket whole and each RMW ticket as the rank's slice (with the
    rows it covers)."""
    sched = svc.scheduler
    results = []
    for ev, t in res.tickets:
        got = _numpy(sched.result(t))
        if ev.kind in ("rmw", "kv_append"):
            results.append((got, rank_rows(res.trace.tables[ev.table]
                                           .shape[0])))
        else:
            results.append((got, None))
    return {"windows": [(s, rep.order) for s, rep in res.windows],
            "tickets": [t.tid for _, t in res.tickets],
            "rejected": [t.tid for _, t in res.rejected],
            "makespan": res.makespan_us,
            "telemetry": svc.telemetry.summary(),
            "results": results}


def mesh_service(mesh, controller, **kw):
    from repro_torch.serve import AccessService, VirtualClock
    return AccessService(mesh=mesh, tile_size=SERVING_TILE, auto_flush=0,
                         controller=controller, clock=VirtualClock(), **kw)


def corpus_controller(seed):
    """``test_torch_traffic.corpus_service``'s controller for a seed."""
    from repro_torch.serve import (AdaptiveFlushController,
                                   FixedWindowController)
    kind = seed % 4
    if kind == 0:
        return AdaptiveFlushController(overhead_us=200.0)
    if kind == 1:
        return FixedWindowController(2)
    if kind == 2:
        return FixedWindowController(16, drain_cap=6)
    return AdaptiveFlushController(overhead_us=200.0, drain_cap=8)


def corpus_service(mesh, seed, trace):
    """``test_torch_traffic.corpus_service`` over the process mesh, on a
    virtual clock."""
    svc = mesh_service(mesh, corpus_controller(seed))
    if seed % 4 == 3:
        counts = {}
        for e in trace.events:
            counts[e.tenant] = counts.get(e.tenant, 0) + 1
        hot = sorted(counts, key=counts.get, reverse=True)[:2]
        svc.connect(hot[0], weight=4.0, max_pending=4)
        if len(hot) > 1:
            svc.connect(hot[1], weight=0.5, max_pending=2)
    return svc


def kv_scenario(seed=3, seqs=4, prompt=3, prefix_pages=2):
    """The draws of ``test_torch_kvpool.servers``' scenario: a shared
    prefix, each sequence's prompt, and ``KV_STEPS`` decode batches over
    every sequence (the pool grows while decoding)."""
    rng = np.random.default_rng(seed)
    p, d = KV_WIDTHS["page_size"], KV_WIDTHS["d"]
    prefix = rng.integers(0, 4, size=(prefix_pages * p, 2 * d)).astype(
        np.float32)
    prompts = [rng.integers(0, 4, size=(prompt + i % 3, 2 * d)).astype(
        np.float32) for i in range(seqs)]
    steps = rng.integers(0, 4, size=(KV_STEPS, seqs, 2 * d)).astype(
        np.float32)
    return prefix, prompts, steps


def kv_run(srv, draws, on_step=None):
    """The scenario on ``srv`` (either package's server): each step's
    histories as NumPy; ``on_step(t)`` runs after each decode batch."""
    prefix, prompts, steps = draws
    srv.create_prefix("sys", prefix)
    for i, kv in enumerate(prompts):
        srv.admit(f"s{i}", f"tenant{i % 2}", kv, prefix="sys")
    out = []
    for t in range(steps.shape[0]):
        hists, _ = srv.decode_batch({f"s{i}": steps[t, i]
                                     for i in range(steps.shape[1])})
        out.append({k: _numpy(v) for k, v in hists.items()})
        if on_step is not None:
            on_step(t)
    return out


def _kv_pool(mesh):
    """The KV pool server over the mesh: every step's histories, the
    rank's slice and stats after each step, and each growth's rows."""
    from repro_torch.serve import AccessService, KvPoolServer
    srv = KvPoolServer(service=AccessService(mesh=mesh, auto_flush=0,
                                             tile_size=SERVING_TILE),
                       **KV_WIDTHS)
    steps = []

    def on_step(t):
        steps.append({"slice": _numpy(srv.pool), "stats": srv.stats()})
    hists = kv_run(srv, kv_scenario(), on_step)
    return {"hists": hists, "steps": steps,
            "pages": {k: list(s.pages) for k, s in srv.seqs.items()}}


def _regrow(eng):
    """``ShardedEngine.regrow`` on a table whose row r holds r + 1: each
    case's new slice, the rows moved and the collectives it took."""
    out = []
    for n_old, n_new in REGROW_CASES:
        whole = np.arange(1, n_old + 1, dtype=np.float32)[:, None] * \
            np.ones((1, 3), np.float32)
        lo, hi = eng.rank_rows(n_old)
        part = torch.from_numpy(whole[lo:hi].copy())
        before = part.clone()
        c0 = eng.collectives
        got, moved = eng.regrow(part, n_old, n_new)
        out.append({"slice": got.numpy(), "moved": moved,
                    "collectives": eng.collectives - c0,
                    "untouched": torch.equal(part, before),
                    "new_object": got.data_ptr() != part.data_ptr()
                    or got.numel() == 0})
    try:
        eng.regrow(torch.zeros((1, 3)), 40, 80)
        out.append("accepted")
    except ValueError as e:
        out.append(str(e))
    return out


def _serving_refusals(mesh, rank):
    """A controller without a clock over the mesh is still refused; a
    rank whose trace differs in one event raises ``PlanDivergence`` on
    every rank at that window's flush."""
    from repro_torch.core import PlanDivergence
    from repro_torch.serve import (AccessService, AdaptiveFlushController,
                                   TrafficConfig, generate_trace,
                                   replay_trace)
    out = {}
    try:
        AccessService(mesh=mesh, controller=AdaptiveFlushController())
        out["no_clock"] = "accepted"
    except ValueError as e:
        out["no_clock"] = str(e)
    trace = generate_trace(TrafficConfig(seed=5, n_events=40,
                                         p_program=0.0))
    if rank == 1:
        ev = next(e for e in trace.events if e.kind == "gather")
        ev.idx = np.concatenate([ev.idx, ev.idx[:1]])
    svc = mesh_service(mesh, AdaptiveFlushController(overhead_us=200.0))
    try:
        replay_trace(trace, svc, service_time=service_time)
        out["diverge"] = None
    except PlanDivergence as e:
        out["diverge"] = str(e)
    return out


def serving_main(rank, world, out_dir, corpus_seeds, ref_traces):
    """Rank side of ``test_torch_process_serving.py``: the reference's
    mesh replays (``ref_traces``: TrafficConfig kwargs), the traffic
    corpus through ``check_traffic_parity`` (each seed on its own
    service over the mesh, and corpus seed 0 once more on the service
    ``check_traffic_parity(mesh=...)`` builds), a replay with
    wall-measured flushes, the KV pool server, the re-cut helper and the
    refusals (last: the diverging trace)."""
    import time
    from repro_torch.distributed import ShardedEngine, process_mesh
    from repro_torch.serve import (AdaptiveFlushController, TrafficConfig,
                                   generate_trace, replay_trace)
    from repro_torch.testing import generate_traffic_case, harness
    mesh = process_mesh(device="cpu")
    t0 = time.perf_counter()
    out = {"rank": rank, "world": world, "ref": {}, "corpus": {}}
    for cfg in ref_traces:
        trace = generate_trace(TrafficConfig(**cfg))
        svc = mesh_service(mesh, AdaptiveFlushController(overhead_us=200.0))
        res = replay_trace(trace, svc, service_time=service_time)
        out["ref"][cfg["seed"]] = replay_record(
            res, svc, svc.scheduler.engine.rank_rows)
    for seed in corpus_seeds:
        trace = generate_traffic_case(seed)
        svc = corpus_service(mesh, seed, trace)
        checked, res = harness.check_traffic_parity(trace, svc)
        out["corpus"][seed] = {
            "checked": checked,
            "windows": [(s, rep.order) for s, rep in res.windows],
            "rejected": [t.tid for _, t in res.rejected],
            "telemetry": svc.telemetry.summary()}
    trace = generate_traffic_case(0)
    checked, res = harness.check_traffic_parity(trace, mesh=mesh)
    out["mesh_built"] = {
        "checked": checked,
        "windows": [(s, rep.order) for s, rep in res.windows],
        "rejected": [t.tid for _, t in res.rejected]}
    svc = mesh_service(mesh, AdaptiveFlushController())
    res = replay_trace(trace, svc)
    out["wall"] = {"windows": [(s, rep.order) for s, rep in res.windows],
                   "makespan": res.makespan_us,
                   "telemetry": svc.telemetry.summary(),
                   "controller": svc.controller.snapshot(),
                   "agreements": svc.scheduler.stats["agreements"]}
    out["kv"] = _kv_pool(mesh)
    out["regrow"] = _regrow(ShardedEngine(mesh, device="cpu"))
    out["refusals"] = _serving_refusals(mesh, rank)
    out["seconds"] = time.perf_counter() - t0
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    return True

"""Port scheduler vs the JAX reference scheduler and the NumPy oracles.

Each window is one of the reference's own: ``fuzzer.generate_mixed_case``
(programs + gathers + RMWs against shared tables, several tenants, one
flush) and the 12 Table-1 conformance patterns. The same NumPy inputs go
through the reference ``Scheduler(Engine(use_kernel=False))`` and through
the port's ``Scheduler`` on the CPU, submitted in the same order.

Tolerance (DESIGN.md §3 contract, as ``harness.check_mixed_flush_parity``):
gathers and integer results bit for bit; float results — float ADD RMW
reduced in another order — within rtol=1e-4, atol=1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import Scheduler as RefScheduler
from repro.core import compile_pattern as ref_compile
from repro.core.engine import Engine as RefEngine
from repro.testing import conformance, fuzzer, harness, oracle
from repro_torch.core import (BatchUnsupported, Engine, FailedResult,
                              Scheduler, compile_pattern, interop, isa)
from repro_torch.core.scheduler import QueueFull, QueueFullError
from repro_torch.testing import pattern_from

RTOL, ATOL = 1e-4, 1e-5
TILE = 256
TENANTS = ("a", "b", "c")


def as_np(x):
    """A result as NumPy: port tensors through interop (u32 stays in its
    int32 container), reference arrays as they are."""
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_match(what, got, want):
    """The harness contract: floats allclose, everything else exact (an
    int32 container is read as the uint32 it holds)."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    if want.dtype.kind in "biu":
        if got.dtype != want.dtype and \
                got.dtype.itemsize == want.dtype.itemsize:
            got = got.view(want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


def submit_mixed(sched, case, *, tile=TILE, port=True):
    """Submit a ``MixedFlushCase`` the way ``check_mixed_flush_parity``
    does (programs, then gathers, then RMWs, tenants rotating) to the
    port's scheduler (``port``) or the reference's. Returns the entries
    ``(programs, gathers, rmws)`` to check after the flush."""
    iota = np.arange(tile, dtype=np.int32)
    turn = iter(range(1, 1 << 30))

    def tenant():
        return TENANTS[next(turn) % len(TENANTS)]

    programs, gathers, rmws = [], [], {}
    for p, env, n in case.programs:
        ref_prog, _ = ref_compile(p, tile_size=tile)
        if port:
            prog, _ = compile_pattern(pattern_from(p), tile_size=tile)
            senv = {**env, "__iota__": iota}
        else:
            prog = ref_prog
            senv = {k: jnp.asarray(v) for k, v in env.items()}
            senv["__iota__"] = jnp.asarray(iota)
        regs = {"tile_base": 0, "N": n, "tile_end": n}
        t = sched.submit(prog, senv, regs, tenant=tenant())
        programs.append((t, ref_prog, env, regs))
    for name, idx in case.gathers:
        gathers.append((sched.submit_gather(case.tables[name], idx,
                                            tenant=tenant()), name, idx))
    for name, idx, vals, cond in case.rmws:
        t = sched.submit_rmw(case.tables[name], idx, vals,
                             op=case.table_ops[name], cond=cond,
                             tenant=tenant())
        rmws.setdefault(name, []).append(t)
    return programs, gathers, rmws


def collect(sched, entries):
    """Every ticket's result: {("g", k) | ("r", table, k) | ("p", k):
    tensor/array or (env, spd)}."""
    programs, gathers, rmws = entries
    out = {("g", k): sched.result(t) for k, (t, _, _) in enumerate(gathers)}
    for name, tickets in rmws.items():
        for k, t in enumerate(tickets):
            out[("r", name, k)] = sched.result(t)
    for k, (t, _, _, _) in enumerate(programs):
        out[("p", k)] = sched.result(t)
    return out


def check_against_numpy(case, got, entries, *, tile=TILE):
    """The expectations of ``harness.check_mixed_flush_parity``."""
    programs, gathers, rmws = entries
    for k, (_, name, idx) in enumerate(gathers):
        table = case.tables[name]
        want = table[np.clip(idx, 0, table.shape[0] - 1)]
        assert as_np(got[("g", k)]).dtype == want.dtype
        np.testing.assert_array_equal(as_np(got[("g", k)]), want,
                                      err_msg=f"gather {name}")
    for name, tickets in rmws.items():
        want = np.array(case.tables[name])
        for n2, idx, vals, cond in case.rmws:
            if n2 == name:
                want = harness._np_rmw(want, idx, vals,
                                       case.table_ops[name], cond=cond)
        for k in range(len(tickets)):
            assert_match(f"rmw {name}:{case.table_ops[name]}",
                         got[("r", name, k)], want)
    iota = np.arange(tile, dtype=np.int32)
    for k, (_, prog, env, regs) in enumerate(programs):
        oenv, ospd = oracle.OracleEngine(tile_size=tile).run(
            prog, {**{n: np.asarray(v) for n, v in env.items()},
                   "__iota__": iota}, regs)
        genv, gspd = got[("p", k)]
        for name in oenv:
            if name != "__iota__":
                assert_match(f"prog {prog.name} env[{name}]", genv[name],
                             oenv[name])
        for name in ospd:
            assert_match(f"prog {prog.name} spd[{name}]", gspd[name],
                         ospd[name])


def plan_identity(plan):
    """What explain() shows about each node: kind, id and backend."""
    return [(n.kind, n.nid, getattr(n, "backend", None),
             tuple(sorted(getattr(n, "shared", ()))))
            for n in plan.nodes()]


def run_mixed(case, *, use_kernel=False):
    """One mixed window through the port (CPU) and the reference; returns
    (port results, reference results, port plan, reference plan,
    entries)."""
    port = Scheduler(engine=Engine(tile_size=TILE, use_kernel=use_kernel,
                                   device="cpu"))
    entries = submit_mixed(port, case)
    port_plan = port.explain().plan
    report = port.flush()
    assert report.plan is port_plan
    got = collect(port, entries)
    ref = RefScheduler(engine=RefEngine(tile_size=TILE))
    rentries = submit_mixed(ref, case, port=False)
    ref_plan = ref.explain().plan
    ref.flush()
    want = collect(ref, rentries)
    return got, want, port_plan, ref_plan, entries


MIXED_SEEDS = tuple(range(16))


@pytest.mark.parametrize("seed", MIXED_SEEDS)
def test_mixed_window_parity(seed):
    """Port == NumPy expectations and == the reference scheduler, and the
    executed plan is the one explain() showed, node for node."""
    case = fuzzer.generate_mixed_case(seed)
    got, want, port_plan, ref_plan, entries = run_mixed(case)
    check_against_numpy(case, got, entries)
    assert set(got) == set(want)
    for key, value in want.items():
        if key[0] == "p":
            for part, (g, w) in enumerate(zip(got[key], value)):
                assert set(g) == set(w), key
                for name in w:
                    assert_match(f"{key} part {part} {name} vs reference",
                                 g[name], w[name])
        else:
            assert_match(f"{key} vs reference", got[key], value)
    assert plan_identity(port_plan) == plan_identity(ref_plan)
    assert [d.code for d in port_plan.diagnostics] == \
        [d.code for d in ref_plan.diagnostics]


@pytest.mark.parametrize("seed", (0, 5, 11))
def test_mixed_window_kernel_routing(seed):
    """use_kernel=True routes 2-D fused gathers and RMWs through the
    kernel wrappers (their plain versions on the CPU): same results as
    use_kernel=False, gathers bit for bit."""
    case = fuzzer.generate_mixed_case(seed)
    outs = []
    for use_kernel in (False, True):
        sched = Scheduler(engine=Engine(tile_size=TILE,
                                        use_kernel=use_kernel,
                                        device="cpu"))
        entries = submit_mixed(sched, case)
        sched.flush()
        outs.append(collect(sched, entries))
    for key, value in outs[0].items():
        if key[0] == "p":
            continue                          # programs: the engine's test
        assert_match(f"{key} kernel vs plain", outs[1][key], value)
        if key[0] == "g":
            assert torch.equal(outs[1][key], value), key


def test_conformance_patterns_one_flush():
    """The 12 Table-1 patterns in ONE flush (signature-compatible launches
    batch) against per-program OracleEngine runs, as
    ``harness.check_scheduler_parity``."""
    tile = 1024
    sched = Scheduler(engine=Engine(tile_size=tile, device="cpu"))
    iota = np.arange(tile, dtype=np.int32)
    entries = []
    for k, name in enumerate(conformance.all_names()):
        case = conformance.build(name)
        prog, _ = compile_pattern(pattern_from(case.pattern), tile_size=tile)
        ref_prog, _ = ref_compile(case.pattern, tile_size=tile)
        regs = {"tile_base": 0, "N": case.n, "tile_end": case.n}
        t = sched.submit(prog, {**case.env, "__iota__": iota}, regs,
                         tenant=TENANTS[k % 3])
        entries.append((t, ref_prog, case.env, regs))
    report = sched.flush()
    assert report.n_programs == len(entries)
    for t, prog, env, regs in entries:
        genv, gspd = sched.result(t)
        oenv, ospd = oracle.OracleEngine(tile_size=tile).run(
            prog, {**env, "__iota__": iota}, regs)
        for name in oenv:
            if name != "__iota__":
                assert_match(f"{prog.name} env[{name}]", genv[name],
                             oenv[name])
        for name in ospd:
            assert_match(f"{prog.name} spd[{name}]", gspd[name], ospd[name])


# ---------------------------------------------------------------------------
# batched groups: run_batch == per-lane runs
# ---------------------------------------------------------------------------

def _gather_program(tile, mod=None):
    """out[i] = A[B[i]] over one tile, plus an IRMW into a private
    histogram: ILD on a shared 2-D table, IRMW on a private region. Built
    with the port's pattern classes, or with ``mod``'s (the reference's
    ``repro.core``) — then returned as a Pattern, not compiled."""
    import repro_torch.core as port_core
    m = mod or port_core
    p = m.Pattern([
        m.Access("ST", "out", m.Var("i"),
                 value=m.Load("A", m.Load("B", m.Var("i"))), dtype="f32"),
        m.Access("RMW", "hist", m.Load("B", m.Var("i")),
                 value=m.Load("one", m.Var("i")), op="ADD", dtype="i32")],
        name="gather_hist")
    return p


@pytest.mark.parametrize("use_kernel", (False, True))
def test_run_batch_equals_lanes_with_oob_lane(use_kernel):
    """Lanes of one batched run give each lane's own results bit for bit —
    including a lane whose indices run past its rows and below 0: loads
    clamp and stores drop inside that lane, never in a neighbour's."""
    tile, k = 64, 4
    rng = np.random.default_rng(7)
    prog, _ = compile_pattern(_gather_program(tile), tile_size=tile)
    eng = Engine(tile_size=tile, use_kernel=use_kernel, device="cpu")
    A = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    envs, regs_list = [], []
    for lane in range(k):
        b = rng.integers(0, 50, size=tile).astype(np.int32)
        if lane == 2:                       # out-of-range both ways
            b[::3] = 50 + rng.integers(0, 40, size=b[::3].shape[0])
            b[1::5] = -1 - rng.integers(0, 9, size=b[1::5].shape[0])
        envs.append({
            "A": A, "B": torch.from_numpy(b),
            "out": torch.zeros(tile, 6),
            "hist": torch.from_numpy(rng.integers(0, 9, size=50)
                                     .astype(np.int32)),
            "one": torch.ones(tile, dtype=torch.int32),
            "__iota__": torch.arange(tile, dtype=torch.int32)})
        n = tile - 5 * lane
        regs_list.append({"tile_base": 0, "N": n, "tile_end": n})
    exe = eng.executable(prog, batch=k, shared=frozenset({"A", "one",
                                                          "__iota__"}))
    outs = exe.run_batch(envs, regs_list)
    single = eng.executable(prog)
    for lane, (env, regs) in enumerate(zip(envs, regs_list)):
        want_env, want_spd = single(env, regs)
        got_env, got_spd = outs[lane]
        for name in want_env:
            assert torch.equal(got_env[name], want_env[name]), (lane, name)
        for name in want_spd:
            assert torch.equal(got_spd[name], want_spd[name]), (lane, name)
    # the drops of lane 2 reached no other lane: every other histogram
    # changed by exactly its own in-range lanes
    for lane in (1, 3):
        b = envs[lane]["B"][:regs_list[lane]["N"]].long()
        want = envs[lane]["hist"].clone().index_add_(
            0, b, torch.ones_like(b, dtype=torch.int32))
        assert torch.equal(outs[lane][0]["hist"], want)


def test_run_batch_one_bulk_op_per_instruction(monkeypatch):
    """Each ILD/IRMW of a batched run is ONE bulk op for all lanes, and a
    shared table's rows are gathered through one coalesced fetch."""
    from repro_torch.core import bulk_ops
    tile, k = 32, 5
    prog, _ = compile_pattern(_gather_program(tile), tile_size=tile)
    calls = {"gather": 0, "rmw": 0}
    real_gather, real_rmw = bulk_ops.bulk_gather, bulk_ops.bulk_rmw

    def gather(*a, **kw):
        calls["gather"] += 1
        return real_gather(*a, **kw)

    def rmw(*a, **kw):
        calls["rmw"] += 1
        return real_rmw(*a, **kw)

    monkeypatch.setattr(bulk_ops, "bulk_gather", gather)
    monkeypatch.setattr(bulk_ops, "bulk_rmw", rmw)
    n_ild = sum(isinstance(i, isa.ILD) for i in prog.instrs)
    n_irmw = sum(isinstance(i, isa.IRMW) for i in prog.instrs)
    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.normal(size=(40, 4)).astype(np.float32))
    envs = [{"A": A, "B": torch.from_numpy(
        rng.integers(0, 40, size=tile).astype(np.int32)),
        "out": torch.zeros(tile, 4), "hist": torch.zeros(40,
                                                        dtype=torch.int32),
        "one": torch.ones(tile, dtype=torch.int32),
        "__iota__": torch.arange(tile, dtype=torch.int32)}
        for _ in range(k)]
    regs = [{"tile_base": 0, "N": tile, "tile_end": tile}] * k
    Engine(tile_size=tile, device="cpu").executable(
        prog, batch=k, shared=frozenset({"A"})).run_batch(envs, regs)
    assert calls == {"gather": n_ild, "rmw": n_irmw}


def _rng_program(tile):
    """Range-fuse [L[i], H[i]) with the capacity in register ``cap``."""
    return isa.AccessProgram((
        isa.SLD("i32", "L", "lo", rs1=0),
        isa.SLD("i32", "H", "hi", rs1=0),
        isa.RNG("outer", "inner", "lo", "hi", rs1="cap")),
        tile_size=tile, name="rng_cap")


def test_batch_unsupported_falls_back_other_errors_fail():
    """Lanes that cannot share a run (here: range-fuser capacities that
    differ) raise BatchUnsupported, which sends the scheduler to its
    per-member path; any other error fails the node's tickets."""
    tile = 16
    prog = _rng_program(tile)
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 5, size=tile).astype(np.int32)
    env = {"L": lo, "H": lo + rng.integers(0, 3, size=tile).astype(np.int32)}
    caps = (16, 8)
    eng = Engine(tile_size=tile, device="cpu")
    with pytest.raises(BatchUnsupported):
        eng.executable(prog, batch=2).run_batch(
            [interop.env_from_numpy(env, device="cpu")] * 2,
            [{"cap": c} for c in caps])
    assert issubclass(BatchUnsupported, NotImplementedError)

    sched = Scheduler(engine=eng)
    tickets = [sched.submit(prog, env, {"cap": c}) for c in caps]
    report = sched.flush()
    assert sched.stats["vmap_fallbacks"] == 1
    assert [(g.vmapped, g.fell_back) for g in report.groups] == \
        [(False, True)]
    for t, c in zip(tickets, caps):
        _, spd = sched.result(t)
        want = eng.run(prog, interop.env_from_numpy(env, device="cpu"),
                       {"cap": c})[1]
        for name in want:
            assert torch.equal(spd[name], want[name]), name
        assert spd["outer"].shape == (c,)

    # a broken launch (its capacity register missing: DX001) is not
    # "cannot batch": the group's tickets fail, the window survives
    sched2 = Scheduler(engine=Engine(tile_size=tile, device="cpu"))
    ok_t = sched2.submit_gather(np.arange(10, dtype=np.float32), [1, 2])
    progs = [sched2.submit(prog, env, {}) for _ in range(2)]
    sched2.flush()
    with pytest.raises(ValueError, match="DX001"):
        sched2.result(progs.pop())
    assert sched2.stats["vmap_fallbacks"] == 0
    assert sched2.stats["group_errors"] == 1
    np.testing.assert_array_equal(sched2.result(ok_t).numpy(), [1.0, 2.0])
    for t in progs:
        assert isinstance(sched2.poll(t), FailedResult)


def test_batched_group_matches_reference_vmap():
    """Eight launches of one program with a shared table batch into one
    group ("vmap", A shared) — the same group and shared set as the
    reference's — and give the reference's results bit for bit."""
    tile, k = 64, 8
    rng = np.random.default_rng(11)
    A = rng.normal(size=(100, 4)).astype(np.float32)
    import repro.core as ref_core
    prog, _ = compile_pattern(_gather_program(tile), tile_size=tile)
    rprog, _ = ref_compile(_gather_program(tile, ref_core), tile_size=tile)
    one = np.ones(tile, np.int32)
    iota = np.arange(tile, dtype=np.int32)
    shared_j = {"one": jnp.asarray(one), "__iota__": jnp.asarray(iota)}
    port = Scheduler(engine=Engine(tile_size=tile, device="cpu"))
    ref = RefScheduler(engine=RefEngine(tile_size=tile))
    lanes = []
    for b in range(k):
        env = {"A": A, "B": rng.integers(-3, 104, size=tile)
               .astype(np.int32), "out": np.zeros((tile, 4), np.float32),
               "hist": np.zeros(100, np.int32), "one": one,
               "__iota__": iota}
        regs = {"tile_base": 0, "N": tile - b, "tile_end": tile - b}
        # shared objects stay one object on both sides (the shared-region
        # test keys on the caller's array identity)
        renv = {n: v if n == "A" else jnp.asarray(v)
                for n, v in env.items()}
        renv.update(shared_j)
        lanes.append((port.submit(prog, env, regs, tenant=f"t{b}"),
                      ref.submit(rprog, renv, regs, tenant=f"t{b}")))
    pplan, rplan = port.explain().plan, ref.explain().plan
    assert plan_identity(pplan) == plan_identity(rplan)
    (group,) = pplan.fused("program_group")
    assert group.backend == "vmap"
    assert group.shared == frozenset({"A", "one", "__iota__"})
    port.flush()
    ref.flush()
    assert port.stats["vmap_groups"] == 1
    for pt, rt in lanes:
        genv, gspd = port.result(pt)
        wenv, wspd = ref.result(rt)
        for name in wenv:
            assert_match(name, genv[name], wenv[name])
            if as_np(wenv[name]).dtype.kind == "f" and name != "out":
                continue
            np.testing.assert_array_equal(as_np(genv[name]),
                                          as_np(wenv[name]))
        for name in wspd:
            np.testing.assert_array_equal(as_np(gspd[name]),
                                          as_np(wspd[name]))


# ---------------------------------------------------------------------------
# fairness, admission, error isolation, retrieval
# ---------------------------------------------------------------------------

def test_fair_order_matches_reference():
    """Weighted-fair drain order (weights, drain limit, rotation) is the
    reference's, window after window."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(64,)).astype(np.float32)
    port = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    ref = RefScheduler(engine=RefEngine(tile_size=TILE))
    for s in (port, ref):
        s.configure_tenant("b", weight=2.0)
    streams = [(f"t{int(rng.integers(0, 4))}" if i % 5 else "b",
                rng.integers(0, 64, size=8).astype(np.int32))
               for i in range(23)]
    for tenant, idx in streams:
        port.submit_gather(table, idx, tenant=tenant)
        ref.submit_gather(table, idx, tenant=tenant)
    for limit in (7, 5, None):
        assert port.flush(drain_limit=limit).order == \
            ref.flush(drain_limit=limit).order
    assert port.stats["deferrals"] == ref.stats["deferrals"]


def test_admission_control_rejects_past_cap():
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    sched.configure_tenant("x", max_pending=2)
    table = np.arange(8, dtype=np.int32)
    ts = [sched.submit_gather(table, [i], tenant="x") for i in range(3)]
    assert isinstance(sched.poll(ts[2]), QueueFull)
    with pytest.raises(QueueFullError):
        sched.result(ts[2])
    assert sched.result(ts[1]).tolist() == [1]
    assert sched.stats["rejects"] == 1
    with pytest.raises(ValueError):
        sched.configure_tenant("x", weight=0)


def test_bad_submission_fails_only_its_ticket():
    """A malformed RMW (values that cannot reshape to its stream) fails
    its own ticket at lowering; the rest of the window executes."""
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    t1 = np.zeros(8, np.int32)
    t2 = np.zeros(8, np.int32)
    bad = sched.submit_rmw(t1, [1, 2, 3], [1, 2], op="ADD", tenant="a")
    good = sched.submit_rmw(t2, [1, 1, 3], [1, 2, 3], op="ADD", tenant="b")
    g = sched.submit_gather(t2, [3], tenant="c")
    sched.flush()
    assert isinstance(sched.poll(bad), FailedResult)
    with pytest.raises(RuntimeError):
        sched.result(bad)
    assert sched.result(good).tolist() == [0, 3, 0, 3, 0, 0, 0, 0]
    assert sched.result(g).tolist() == [0]      # window-initial state
    assert sched.stats["group_errors"] == 1


def test_result_autoflushes_and_unknown_ticket_raises():
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    t = sched.submit_gather(np.arange(5, dtype=np.int32), [4, 9, -2])
    assert sched.poll(t) is None
    assert sched.result(t).tolist() == [4, 4, 0]    # loads clamp
    with pytest.raises(KeyError):
        sched.result(t)
    with pytest.raises(ValueError, match="RMW_OPS"):
        sched.submit_rmw(np.zeros(4, np.int32), [0], [1], op="SUB")


def test_u32_rmw_compares_unsigned():
    """A uint32 table's MAX compares unsigned (int32 container), as the
    reference's uint32 arrays do."""
    table = np.array([1, 2 ** 31 + 5, 7], np.uint32)
    vals = np.array([2 ** 31 + 9, 3, 2 ** 32 - 1], np.uint32)
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    t = sched.submit_rmw(table, [0, 1, 2], vals, op="MAX")
    got = as_np(sched.result(t)).view(np.uint32)
    np.testing.assert_array_equal(got, np.maximum(table, vals))
    # the same on int32 containers, the type named by the caller
    as_i32 = [torch.from_numpy(a.view(np.int32)) for a in (table, vals)]
    t = sched.submit_rmw(as_i32[0], [0, 1, 2], as_i32[1], op="MAX",
                         unsigned=True)
    np.testing.assert_array_equal(
        as_np(sched.result(t)).view(np.uint32), np.maximum(table, vals))


def test_u32_program_region_named_by_dtypes():
    """A u32 region passed as an int32 tensor reads as u32 when submit()
    names its type, as a uint32 NumPy region does by itself."""
    prog = isa.AccessProgram((
        isa.SLD("f32", "U", "x", rs1=0),), tile_size=4, name="u32_to_f32")
    u = np.array([1, 2 ** 31 + 3, 7, 2 ** 32 - 1], np.uint32)
    sched = Scheduler(engine=Engine(tile_size=4, device="cpu"))
    t_np = sched.submit(prog, {"U": u})
    t_named = sched.submit(prog, {"U": torch.from_numpy(u.view(np.int32))},
                           dtypes={"U": "u32"})
    t_plain = sched.submit(prog, {"U": torch.from_numpy(u.view(np.int32))})
    want = u.astype(np.float32)
    for t in (t_np, t_named):
        np.testing.assert_array_equal(sched.result(t)[1]["x"].numpy(), want)
    assert sched.result(t_plain)[1]["x"][1].item() < 0     # read as i32


def test_scheduler_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Scheduler() succeeds here")
    with pytest.raises(RuntimeError, match="cuda"):
        Scheduler()

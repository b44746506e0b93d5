"""Port plan IR (passes, cost model, explain, plan cache) and its hazard
scan and verifier, against the JAX reference on the CPU.

The same windows — the reference's ``generate_mixed_case`` corpus and its
``mutate_case`` hazards — go through the reference ``Scheduler`` and the
port's. Lowering is data-independent up to the cost model's measurement,
and on the CPU every stream is host-resident, so the port must decide
exactly as the reference: the rendered ``explain()`` of a window is the
reference's, line for line, and strict mode refuses the same windows with
the same DX codes.
"""
import numpy as np
import pytest
import torch

from repro.core import Scheduler as RefScheduler
from repro.core.engine import Engine as RefEngine
from repro.testing import fuzzer
from repro_torch import plan
from repro_torch.analysis import HazardError, VerificationError, check_pass
from repro_torch.core import Engine, Scheduler
from repro_torch.core.scheduler import Ticket
from repro_torch.plan import CostModel, LowerContext, nodes, passes
from test_torch_scheduler import plan_identity, submit_mixed

TILE = 256


def _gather_leaf(idx, rows=8, tid=0, table_id=1, host=False):
    table = torch.arange(float(rows))
    t = torch.as_tensor(np.asarray(idx, np.int32))
    return nodes.GatherNode(
        nid=-1, ticket=Ticket(tid, "a"), table=table, idx=t,
        table_id=table_id, table_ref=None, n_lanes=int(t.shape[0]),
        table_rows=rows,
        host_idx=np.asarray(idx, np.int32) if host else None)


def _ctx(**kw):
    kw.setdefault("cost", CostModel())
    return LowerContext(**kw)


def _both(case, *, strict=False):
    """The case's window submitted to a port and a reference scheduler."""
    port = Scheduler(engine=Engine(tile_size=TILE, device="cpu"),
                     strict=strict)
    ref = RefScheduler(engine=RefEngine(tile_size=TILE), strict=strict)
    submit_mixed(port, case)
    submit_mixed(ref, case, port=False)
    return port, ref


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def test_normalize_assigns_ids_and_clamps():
    leaf = _gather_leaf([-5, 3, 99], host=True)
    p = passes.normalize(nodes.Plan(leaves=(leaf,)), _ctx())
    (out,) = p.leaves
    assert out.nid == 0
    assert out.idx.tolist() == [0, 3, 7]
    assert out.host_idx.tolist() == [0, 3, 7]      # the host copy too
    assert p.trace[-1].name == "normalize"


def test_normalize_casts_rmw_values_and_isolates_bad_leaves():
    table = torch.zeros(4, 3, dtype=torch.int32)
    good = nodes.RmwNode(nid=-1, ticket=Ticket(0, "a"), table=table,
                         idx=torch.tensor([1, 2], dtype=torch.int32),
                         values=torch.ones(6, dtype=torch.float32),
                         n_lanes=2, table_rows=4)
    bad = nodes.RmwNode(nid=-1, ticket=Ticket(1, "a"), table=table,
                        idx=torch.tensor([1, 2], dtype=torch.int32),
                        values=torch.ones(5), n_lanes=2, table_rows=4)
    p = passes.normalize(nodes.Plan(leaves=(good, bad)), _ctx())
    assert p.leaves[0].values.shape == (2, 3)
    assert p.leaves[0].values.dtype == torch.int32
    assert p.leaves[0].error is None
    assert isinstance(p.leaves[1].error, RuntimeError)


def test_fuse_concatenates_per_table_and_op():
    table = torch.zeros(8, dtype=torch.int32)

    def rmw(tid, op, idx, cond=None):
        idx = torch.tensor(idx, dtype=torch.int32)
        return nodes.RmwNode(
            nid=tid, ticket=Ticket(tid, "a"), table=table, idx=idx,
            values=torch.ones(len(idx), dtype=torch.int32), op=op,
            cond=cond, table_id=7, n_lanes=len(idx), table_rows=8)

    leaves = (rmw(0, "ADD", [1, 2]),
              rmw(1, "ADD", [3], torch.tensor([False])),
              rmw(2, "MAX", [4]))
    p = passes.fuse(nodes.Plan(leaves=leaves), _ctx(_next_nid=3))
    add, mx = p.fused("rmw")
    assert (add.op, mx.op) == ("ADD", "MAX")
    assert add.idx.tolist() == [1, 2, 3]
    assert add.cond.tolist() == [True, True, False]
    assert mx.cond is None and add.n_lanes == 3


def test_coalesce_dedups_across_streams_with_host_count():
    a = _gather_leaf([5, 1, 5, 2], tid=0)
    b = _gather_leaf([2, 2, 7], tid=1)
    ctx = _ctx()
    p = passes.fuse(passes.normalize(nodes.Plan(leaves=(a, b)), ctx), ctx)
    p = passes.coalesce(p, ctx)
    (g,) = p.fused("gather")
    assert g.n_unique == 4 and isinstance(g.n_unique, int)
    assert g.unique_idx[:4].tolist() == [1, 2, 5, 7]
    assert g.pad_valid.tolist() == [True] * 4 + [False] * 3
    for m, inv in zip(g.members, g.inverses):
        assert torch.equal(g.unique_idx[inv], m.idx)


def test_cost_model_measures_only_host_resident_streams():
    """A lone duplicate-free stream goes eager when it can be measured on
    the host (a CPU tensor, or the NumPy the caller submitted); a stream
    that is not on the host (here on the meta device, standing in for
    the card) is not read: factor None, the "bulk" default."""
    cost, ctx = CostModel(), _ctx()
    cpu = _gather_leaf([0, 1, 2, 3])
    g = nodes.FusedGather(nid=0, members=(cpu,), streams=(cpu.idx,),
                          n_lanes=4, table_rows=8)
    assert cost.gather_path(g, ctx) == ("eager", 1.0)
    far = nodes.GatherNode(nid=1, ticket=Ticket(1, "a"),
                           idx=torch.empty(4, dtype=torch.int32,
                                           device="meta"),
                           n_lanes=4, table_rows=8)
    g_far = nodes.FusedGather(nid=2, members=(far,), streams=(far.idx,),
                              n_lanes=4, table_rows=8)
    assert cost.measure_factor(g_far) is None
    assert cost.gather_path(g_far, ctx) == ("coalesce", None)
    far_host = nodes.GatherNode(
        nid=3, ticket=Ticket(2, "a"), idx=far.idx, n_lanes=4,
        table_rows=8, host_idx=np.array([3, 3, 3, 1], np.int32))
    g_host = nodes.FusedGather(nid=4, members=(far_host,),
                               streams=(far.idx,), n_lanes=4, table_rows=8)
    assert cost.measure_factor(g_host) == 2.0
    with pytest.raises(ValueError):
        CostModel(force_gather="nope")


def test_batch_pass_waves_and_shared_regions():
    from test_torch_scheduler import _gather_program
    from repro_torch.core import compile_pattern
    prog, _ = compile_pattern(_gather_program(TILE), tile_size=TILE)
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"),
                      max_batch=3)
    A = np.zeros((16, 2), np.float32)
    one = np.ones(TILE, np.int32)
    for _ in range(7):
        sched.submit(prog, {"A": A, "B": np.zeros(TILE, np.int32),
                            "out": np.zeros((TILE, 2), np.float32),
                            "hist": np.zeros(16, np.int32), "one": one,
                            "__iota__": np.arange(TILE, dtype=np.int32)},
                     {"tile_base": 0, "N": TILE, "tile_end": TILE})
    groups = sched.explain().plan.fused("program_group")
    assert [(len(g.members), g.wave, g.backend) for g in groups] == \
        [(3, 0, "vmap"), (3, 1, "vmap"), (1, 2, "eager")]
    assert groups[0].shared == frozenset({"A", "one"})
    assert groups[2].shared == frozenset()


# ---------------------------------------------------------------------------
# explain(): the reference's plan, and the plan that runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 3, 7, 12))
def test_explain_renders_as_reference(seed):
    """Node kinds, ids, backends, shared sets, pass notes and
    diagnostics: the rendered explain() of a mixed window is the
    reference's, line for line; after the flush it is the executed,
    stripped plan."""
    port, ref = _both(fuzzer.generate_mixed_case(seed))
    pe, re_ = port.explain(), ref.explain()
    assert pe.render() == re_.render()
    assert plan_identity(pe.plan) == plan_identity(re_.plan)
    report = port.flush()
    assert report.plan is pe.plan and pe.plan.executed
    assert plan.explain(report).node_ids == pe.node_ids
    for n in pe.plan.nodes():                 # stripped: no tensors pinned
        for field in ("table", "idx", "values", "unique_idx", "env"):
            value = getattr(n, field, None)
            assert value is None or value == {}, (n.kind, field)


def test_explain_of_report_and_handle_and_errors():
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    sched.submit_rmw(np.zeros(4, np.int32), [0, 1], [1], op="ADD")
    handle = sched.flush_async()
    text = str(plan.explain(handle))
    assert "ERROR=RuntimeError" in text
    assert plan.explain(handle).plan is plan.explain(handle.report).plan
    with pytest.raises(TypeError):
        plan.explain(object())


# ---------------------------------------------------------------------------
# plan cache: window signatures and skeleton replay
# ---------------------------------------------------------------------------

def test_plan_cache_counters_match_reference():
    """Repeat windows hit, a new structure misses — the same hit/miss
    sequence as the reference on the same windows."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(64,)).astype(np.float32)
    other = rng.normal(size=(64,)).astype(np.float32)
    windows = [[(table, 32)], [(table, 32)], [(table, 16)],
               [(table, 32), (other, 32)], [(table, 32), (other, 32)],
               [(other, 32), (table, 32)], []]
    port = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    ref = RefScheduler(engine=RefEngine(tile_size=TILE))
    hits = {"port": [], "ref": []}
    for window in windows:
        streams = [(t, rng.integers(0, 64, size=n).astype(np.int32))
                   for t, n in window]
        for name, s in (("port", port), ("ref", ref)):
            for t, idx in streams:
                s.submit_gather(t, idx)
            hits[name].append(s.flush().plan is not None and
                              s.stats["plan_cache_hits"])
    assert hits["port"] == hits["ref"]
    for key in ("plan_cache_hits", "plan_cache_misses"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["plan_cache_misses"] == 3


def test_hit_replays_recorded_decisions():
    """A cache hit replays the skeleton's path even where a fresh
    measurement would pick another (decisions cached, data fresh)."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(64,)).astype(np.float32)
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    dup = np.full(32, 5, np.int32)
    t1 = sched.submit_gather(table, dup)
    assert sched.flush().plan.fused("gather")[0].backend == "bulk"
    fresh = rng.permutation(32).astype(np.int32)
    t2 = sched.submit_gather(table, fresh)
    r2 = sched.flush()
    assert r2.plan.cache_hit
    assert r2.plan.fused("gather")[0].backend == "bulk"
    np.testing.assert_array_equal(sched.result(t1).numpy(), table[dup])
    np.testing.assert_array_equal(sched.result(t2).numpy(), table[fresh])
    # without the cache the same stream goes eager (measured factor 1)
    sched2 = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
    sched2.submit_gather(table, fresh)
    assert sched2.flush().plan.fused("gather")[0].backend == "eager"


def test_window_signature_ignores_data_and_table_identity():
    """Same structure, other tables and data: one signature (table
    identity enters as equivalence classes); another shape: another."""
    def sig(tables, n):
        sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"))
        for t in tables:
            sched.submit_gather(t, np.zeros(n, np.int32))
        return sched.explain().plan.signature

    a, b = np.zeros(16, np.float32), np.ones(16, np.float32)
    assert sig([a, a], 8) == sig([b, b], 8)
    assert sig([a, b], 8) != sig([a, a], 8)
    assert sig([a, a], 8) != sig([a, a], 9)


# ---------------------------------------------------------------------------
# hazard scan, strict mode and the verifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1, 2, 3))
@pytest.mark.parametrize("kind", ("mixed_op", "gather_rmw_race"))
def test_strict_refuses_same_windows_as_reference(seed, kind):
    """mutate_case's order-dependent windows: the port's diagnostics are
    the reference's (codes, severities, tenants, tickets); strict mode
    raises on the same windows with the same ERROR codes and keeps the
    queues."""
    case = fuzzer.mutate_case(fuzzer.generate_mixed_case(seed), kind,
                              seed=seed)
    scheds = _both(case, strict=True)
    for s in scheds:
        if case.injected[0] == "gather":
            _, name, idx = case.injected
            s.submit_gather(case.tables[name], idx, tenant="evil")
        else:
            _, name, idx, vals, op = case.injected
            s.submit_rmw(case.tables[name], idx, vals, op=op, tenant="evil")
    port, ref = scheds
    pd = port.explain().diagnostics
    rd = ref.explain().diagnostics
    assert [(d.code, d.severity, d.tenants, d.tids, d.table)
            for d in pd] == [(d.code, d.severity, d.tenants, d.tids, d.table)
                             for d in rd]
    errors = sorted(d.code for d in rd if d.severity == "ERROR")
    for s in scheds:
        pending = s.pending
        if errors:
            with pytest.raises(Exception) as ei:
                s.flush()
            assert type(ei.value).__name__ == "HazardError"
            assert sorted(d.code for d in ei.value.diagnostics) == errors
            assert s.pending == pending
        else:
            s.flush()
    if errors:
        assert isinstance(HazardError(pd), RuntimeError)
        port.strict = False
        port.flush()
        assert port.stats["hazard_errors"] == len(errors)


def test_verifier_catches_broken_plans():
    """check_pass names the broken invariant (the pipeline runs it after
    every pass when DX100_PLAN_VERIFY is set, as in this suite)."""
    a, b = _gather_leaf([1], tid=0), _gather_leaf([2], tid=1)
    ctx = _ctx()
    p = passes.fuse(passes.normalize(nodes.Plan(
        leaves=(a, b), order=(("a", 0), ("a", 1))), ctx), ctx)
    check_pass(p, "fuse", None)
    dup = p.roots[0]
    broken = nodes.Plan(leaves=p.leaves, roots=(dup, dup), order=p.order)
    with pytest.raises(VerificationError, match="duplicate node ids"):
        check_pass(broken, "fuse", None)
    with pytest.raises(VerificationError, match="unknown pass"):
        check_pass(p, "sharpen", None)
    assert Scheduler(engine=Engine(tile_size=TILE, device="cpu")).verify

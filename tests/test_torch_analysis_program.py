"""The port's interval analyzer (repro_torch.analysis.program) against the
JAX package's, on the CPU.

  * ``binop`` / ``cast_to`` of the interval domain equal the reference's
    on a grid of intervals, ops and dtypes;
  * ``analyze_program`` of the port's compiled programs equals the
    reference's on theirs — every access record (index interval,
    classification, conditional flag, rows, OOB), every diagnostic and
    every tile state — for the 12 conformance patterns and fuzz seeds,
    per tile, with the regions each tile sees;
  * the reference's soundness check (``tests/test_analysis.py``), run on
    the port: every index the port's oracle touches lies in the inferred
    interval; plus its defect and classification checks;
  * ``coalescing_prior`` feeds the port's ``CostModel`` as it does the
    reference's.
"""
import itertools

import numpy as np
import pytest

from repro.analysis import program as rprog
from repro.core import compile_pattern as ref_compile
from repro.testing import conformance as rconf
from repro.testing import fuzzer as rfuzzer
from repro_torch.analysis import (ERROR, WARN, Interval, analyze_program,
                                  coalescing_prior)
from repro_torch.analysis import program as aprog
from repro_torch.core import (Access, Engine, Load, Pattern, Scheduler,
                              Var, compile_pattern, compiler, isa)
from repro_torch.plan import CostModel
from repro_torch.testing import fuzzer, oracle, pattern_from

TILE = 64
INTERVALS = [(0, 0), (1, 4), (-2, 3), (0, 1023), (-5, -1), (2 ** 31 - 10,
             2 ** 31 - 1), (0.25, 7.5), (-np.inf, np.inf), (3, 3)]
BINOPS = ("ADD", "SUB", "MUL", "MIN", "MAX", "AND", "OR", "XOR", "SHR",
          "SHL", "LT", "EQ")


def _iv(iv):
    return (iv.lo, iv.hi)


@pytest.mark.parametrize("op", BINOPS)
def test_binop_matches_reference(op):
    for (a, b), dts, out in itertools.product(
            itertools.product(INTERVALS, INTERVALS),
            [(), ("i32",), ("u32",), ("i32", "u32")],
            [None, "i32", "u32", "f32"]):
        want = rprog.binop(op, rprog.Interval(*a), rprog.Interval(*b), dts,
                           out)
        got = aprog.binop(op, Interval(*a), Interval(*b), dts, out)
        assert _iv(got) == _iv(want), (op, a, b, dts, out)


def test_cast_and_bounds_match_reference():
    for iv in INTERVALS:
        for dt in ("i32", "u32", "i64", "u64", "f32", None):
            assert _iv(aprog.cast_to(Interval(*iv), dt)) == \
                _iv(rprog.cast_to(rprog.Interval(*iv), dt))
            assert aprog.dtype_bounds(dt) == rprog.dtype_bounds(dt)


def _record(a):
    return (a.ip, a.kind, a.base, a.op, _iv(a.index), a.classification,
            a.conditional, a.rows, a.oob)


def _same_analysis(got, want):
    assert [_record(a) for a in got.accesses] == \
        [_record(a) for a in want.accesses]
    assert [(d.code, d.severity, d.message) for d in got.diagnostics] == \
        [(d.code, d.severity, d.message) for d in want.diagnostics]
    assert {k: (_iv(t.iv), t.prov, t.dtype, t.conditional)
            for k, t in got.tiles.items()} == \
        {k: (_iv(t.iv), t.prov, t.dtype, t.conditional)
         for k, t in want.tiles.items()}


def _compare_on(ref_pattern, env, n, tile=TILE):
    pprog, _ = compile_pattern(pattern_from(ref_pattern), tile_size=tile)
    rprog_, _ = ref_compile(ref_pattern, tile_size=tile)
    env = {k: np.asarray(v) for k, v in env.items()}
    env["__iota__"] = np.arange(compiler._round_up(n, tile), dtype=np.int32)
    _same_analysis(analyze_program(pprog), rprog.analyze_program(rprog_))
    for base in sorted({0, (n - 1) // tile * tile}):
        count = min(tile, n - base)
        regs = {"tile_base": base, "N": count, "tile_end": base + count}
        _same_analysis(
            analyze_program(pprog, env=env, regs=regs, externals=frozenset()),
            rprog.analyze_program(rprog_, env=env, regs=regs,
                                  externals=frozenset()))


@pytest.mark.parametrize("name", rconf.all_names())
def test_conformance_analysis_matches_reference(name):
    case = rconf.build(name)
    _compare_on(case.pattern, case.env, case.n)


@pytest.mark.parametrize("seed", range(48))
def test_fuzz_analysis_matches_reference(seed):
    case = rfuzzer.generate_case(seed)
    _compare_on(case.pattern, case.env, case.n)


def test_tensor_regions_are_not_read():
    """A tensor region's content is the hull of its width's integer kinds
    (it may live on the device, and may hold unsigned bits)."""
    import torch
    prog = isa.AccessProgram((
        isa.SLD("i32", "B", "%i", rs1="z", rs2="n", rs3=1),
        isa.ILD("f32", "A", "%o", "%i"),
    ), tile_size=TILE, name="t")
    env = {"A": torch.zeros(8), "B": torch.full((TILE,), 100,
                                                 dtype=torch.int32)}
    analysis = analyze_program(prog, env=env, regs={"z": 0, "n": TILE})
    ild = [a for a in analysis.accesses if a.kind == "ILD"][0]
    assert ild.rows == 8 and not ild.oob
    assert ild.index.contains(-(2 ** 31)) and ild.index.contains(2 ** 31 - 1)


# ---------------------------------------------------------------------------
# the reference's soundness and defect checks, on the port
# ---------------------------------------------------------------------------

def _assert_sound_on_case(case, tile_size=TILE):
    prog, _ = compiler.compile_pattern(case.pattern, tile_size=tile_size)
    eng = oracle.OracleEngine(tile_size=tile_size)
    env = {k: np.asarray(v) for k, v in case.env.items()}
    env["__iota__"] = np.arange(
        compiler._round_up(case.n, tile_size), dtype=np.int32)
    n_checked = 0
    for base in range(0, case.n, tile_size):
        count = min(tile_size, case.n - base)
        regs = {"tile_base": base, "N": count, "tile_end": base + count}
        analysis = analyze_program(prog, env=env, regs=regs,
                                   externals=frozenset())
        assert not analysis.errors(), analysis.errors()
        by_ip = analysis.by_ip
        eng.touched = {}
        env, _ = eng.run(prog, env, regs)
        for ip, batches in eng.touched.items():
            rec = by_ip[ip]
            touched = np.concatenate(batches)
            if touched.size == 0:
                continue
            lo, hi = touched.min(), touched.max()
            assert rec.index.contains(lo) and rec.index.contains(hi), (
                f"{case.name} ip{ip} {rec.kind} {rec.base}: oracle touched "
                f"[{lo}, {hi}] outside inferred {rec.index}")
            n_checked += len(batches)
    assert n_checked > 0


@pytest.mark.parametrize("seed", range(24))
def test_inferred_intervals_contain_oracle_indices(seed):
    _assert_sound_on_case(fuzzer.generate_case(seed))


def test_classification_defects_and_prior():
    prog, _ = compile_pattern(Pattern(
        [Access("LD", "A", Load("B", Var("i")), dtype="f32")], name="g"),
        tile_size=TILE)
    analysis = analyze_program(prog)
    ilds = [a for a in analysis.accesses if a.kind == "ILD"]
    assert [a.classification for a in ilds] == ["affine", "indirect"]
    assert all(a.classification == "strided" for a in analysis.accesses
               if a.kind == "SLD")
    assert [coalescing_prior(c) for c in ("affine", "strided", "indirect")] \
        == [1.0, 1.0, None]
    oob = isa.AccessProgram((
        isa.SLD("i32", "B", "%i", rs1="z", rs2="n", rs3=1),
        isa.ILD("f32", "A", "%o", "%i"),
    ), tile_size=TILE, name="oob")
    env = {"A": np.zeros(8, np.float32), "B": np.full(TILE, 100, np.int32)}
    a = analyze_program(oob, env=env, regs={"z": 0, "n": TILE})
    assert [x.base for x in a.accesses if x.oob] == ["A"]
    assert any(d.code == "DX003" and d.severity == WARN
               for d in a.diagnostics)
    dead = isa.AccessProgram((
        isa.SLD("i32", "__iota__", "%t", rs1="tile_base", rs2="N", rs3=1),
        isa.SLD("i32", "__iota__", "%t", rs1="tile_base", rs2="N", rs3=1),
        isa.IST("i32", "OUT", "%t", "%t"),
    ), tile_size=TILE, name="dead")
    assert any(d.code == "DX002" for d in analyze_program(dead).diagnostics)
    undef = isa.AccessProgram((isa.ILD("f32", "A", "%o", "%missing"),),
                              tile_size=TILE, name="undef")
    assert not analyze_program(undef).errors()
    assert any(d.code == "DX001" and d.severity == ERROR for d in
               analyze_program(undef, externals=frozenset()).errors())


@pytest.mark.parametrize("prior,backend", [(1.0, "eager"), (None, "bulk"),
                                           (4.0, "bulk")])
def test_prior_steers_the_cost_model(prior, backend):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(64,)).astype(np.float32)
    sched = Scheduler(engine=Engine(tile_size=TILE, device="cpu"),
                      cost_model=CostModel(measure_limit=4))
    if prior is not None:
        sched.cost.set_coalescing_prior(id(table), prior)
    t = sched.submit_gather(table, np.full(16, 3, np.int32))
    rep = sched.flush()
    assert rep.plan.fused("gather")[0].backend == backend
    np.testing.assert_array_equal(sched.result(t).numpy(),
                                  table[np.full(16, 3)])

"""Port engine + compiler vs the JAX reference engine and the NumPy oracle.

Every case is one of the reference's own generators: here the 12 Table-1
conformance patterns (the fuzz corpus is in test_torch_fuzz.py, which shares
the helpers below). The same NumPy
environment runs through the reference ``Engine(use_kernel=False)`` (eager
``harness.run_engine_tiled``), through the ISA-level ``OracleEngine``, and
through the port's ``run_tiled`` on the CPU.

Tolerance (DESIGN.md §3 contract): integers and every region/tile that no
float RMW writes must match bit for bit; a float region written by an RMW
may differ by reduction order, so it is held to rtol=1e-5, atol=1e-6.
"""
import numpy as np
import pytest
import torch

from repro.testing import conformance, harness, oracle
from repro_torch.core import Engine, compile_pattern, interop, run_tiled
from repro_torch.core.engine import structural_signature
from repro_torch.testing import pattern_from

RTOL, ATOL = 1e-5, 1e-6


def _float_rmw_regions(pattern):
    return {a.base for a in pattern.accesses
            if a.kind == "RMW" and a.dtype in ("f32", "f64", "bf16")}


def _assert_same(what, got, want, *, loose):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if loose:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def run_port(pattern, env, *, n, tile, use_kernel=False, optimize=True):
    """The port's run_tiled on the CPU, results back as NumPy with the
    reference's dtypes."""
    eng = Engine(tile_size=tile, use_kernel=use_kernel, optimize=optimize,
                 device="cpu")
    out_env, spd, info = run_tiled(
        eng, pattern_from(pattern), interop.env_from_numpy(env, device="cpu"),
        n=n, dtypes=interop.dtypes_of(env))
    return (interop.env_to_numpy(out_env, {k: v.dtype
                                           for k, v in env.items()}),
            spd, info)


def check_against_reference(pattern, env, *, n, tile, reference=True):
    """Port vs the ISA oracle (regions) and, with ``reference``, vs the
    reference engine (regions + last-tile scratchpad)."""
    penv, pspd, _ = run_port(pattern, env, n=n, tile=tile)
    loose = _float_rmw_regions(pattern)
    oenv, _, _ = oracle.oracle_run_tiled(pattern, env, n=n, tile_size=tile)
    for name in oenv:
        _assert_same(f"env[{name}] vs oracle", penv[name], oenv[name],
                     loose=name in loose)
    if not reference:
        return
    cfg = harness.EngineConfig(optimize=True, use_kernel=False, jit=False,
                               tile_size=tile)
    renv, rspd, _ = harness.run_engine_tiled(pattern, env, n=n, config=cfg)
    for name in renv:
        _assert_same(f"env[{name}] vs reference", penv[name], renv[name],
                     loose=name in loose)
    pspd = interop.env_to_numpy(pspd, {k: v.dtype for k, v in rspd.items()})
    assert set(pspd) == set(rspd)
    for name in rspd:
        _assert_same(f"spd[{name}] vs reference", pspd[name], rspd[name],
                     loose=False)


@pytest.mark.parametrize("name", conformance.all_names())
def test_conformance_pattern(name):
    case = conformance.build(name)
    check_against_reference(case.pattern, case.env, n=case.n, tile=1024)


def test_structural_signature_matches_reference():
    """Every conformance program compiles to the same instruction stream:
    the port's structural signature equals the reference's."""
    from repro.core import compile_pattern as ref_compile
    from repro.core.engine import structural_signature as ref_signature
    for name in conformance.all_names():
        p = conformance.build(name).pattern
        rprog, rinfo = ref_compile(p, tile_size=256)
        pprog, pinfo = compile_pattern(pattern_from(p), tile_size=256)
        assert structural_signature(pprog) == ref_signature(rprog), name
        assert pinfo == rinfo, name


def test_compile_cache_counters():
    p = conformance.build("histogram_is").pattern
    prog, _ = compile_pattern(pattern_from(p), tile_size=64)
    eng = Engine(tile_size=64, device="cpu")
    assert not eng.peek_cached(prog)
    exe = eng.jit_run(prog)
    assert eng.peek_cached(prog)
    assert eng.jit_run(prog) is exe
    assert eng.stats == {"trace_requests": 2, "trace_misses": 1}
    assert eng.cache_hits == 1
    env = {"key": torch.zeros(64, dtype=torch.int32),
           "one": torch.ones(64, dtype=torch.int32),
           "hist": torch.zeros(8, dtype=torch.int32),
           "__iota__": torch.arange(64, dtype=torch.int32)}
    regs = {"tile_base": 0, "N": 64, "tile_end": 64}
    out, _ = exe(env, regs)
    out, _ = exe(out, regs)
    assert exe.calls == 2 and exe.traces == 1
    assert int(out["hist"][0]) == 128
    assert int(env["hist"][0]) == 0          # inputs are not mutated
    exe({**env, "hist": torch.zeros(16, dtype=torch.int32)}, regs)
    assert exe.traces == 2                   # a new shape is a new trace
    # a batched handle is its own cache entry; its lanes give the per-lane
    # results bit for bit, the shared region read by both lanes
    shared = frozenset({"one"})
    bexe = eng.executable(prog, batch=2, shared=shared)
    assert bexe is not exe
    assert eng.executable(prog, batch=2, shared=shared) is bexe
    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 8, size=64).astype(np.int32))
    envs = [env, {**env, "key": keys}]
    regs_list = [regs, {"tile_base": 0, "N": 40, "tile_end": 40}]
    outs = bexe.run_batch(envs, regs_list)
    for lane_env, lane_regs, (got_env, got_spd) in zip(envs, regs_list,
                                                       outs):
        want_env, want_spd = exe(lane_env, lane_regs)
        assert set(got_env) == set(want_env)
        assert set(got_spd) == set(want_spd)
        for name in want_env:
            assert torch.equal(got_env[name], want_env[name]), name
        for name in want_spd:
            assert torch.equal(got_spd[name], want_spd[name]), name
    assert outs[1][0]["one"] is envs[1]["one"]   # shared: passed back
    with pytest.raises(TypeError):
        bexe(env, regs)


def test_missing_inputs_raise_dx001():
    p = conformance.build("histogram_is").pattern
    prog, _ = compile_pattern(pattern_from(p), tile_size=64)
    with pytest.raises(ValueError, match="DX001"):
        Engine(tile_size=64, device="cpu").run(prog, {}, {})


def test_engine_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Engine() succeeds here")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine()

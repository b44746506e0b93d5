"""The slice end to end: chip_smoke.py's two main-path patterns, small.

GATHER ``out[i] = A[B[i]]`` and RMW ``A[B[i]] += V[i]`` on a 2-D row table
(1300 rows x D=8 f32, two blocks of the engine's default 1024 rows, the
second partial), 600 lookups from a zipf(1.05) and a uniform stream with
out-of-range entries, at tile size 256 (three engine tiles, the last one
partial). The port runs ``run_tiled`` on ``Engine(use_kernel=True)`` —
on the CPU the kernels' plain versions — and is held against the
reference ``Engine(use_kernel=False)`` (the reference's Pallas kernels do
not run on the installed JAX) and the NumPy oracle.

Tolerance: the gather bit for bit; the RMW's float sums rtol=1e-5,
atol=1e-5 (duplicate lanes may be summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Engine as RefEngine
from repro.core import compile_pattern as ref_compile
from repro.core.compiler import Access, Load, Pattern, Var
from repro.testing import harness, oracle
from repro_torch.core import Engine, compile_pattern, interop, run_tiled
from repro_torch.kernels.gather import gather as gk
from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
from repro_torch.testing import pattern_from

ROWS, D, N, TILE = 1300, 8, 600, 256

GATHER = Pattern([Access("ST", "out", Var("i"),
                         value=Load("A", Load("B", Var("i"))), dtype="f32")],
                 name="gather")
RMW = Pattern([Access("RMW", "A", Load("B", Var("i")),
                      value=Load("V", Var("i")), op="ADD", dtype="f32")],
              name="rmw")


def _env(kind: str, pattern):
    rng = np.random.default_rng(0 if kind == "zipf" else 1)
    if kind == "zipf":
        b = rng.zipf(1.05, size=N) % ROWS
    else:
        b = rng.integers(0, ROWS, size=N)
    b[::50] = -3            # out of range: loads clamp, stores drop
    b[1::50] = ROWS + 7
    env = {"A": rng.normal(size=(ROWS, D)).astype(np.float32),
           "B": b.astype(np.int32)}
    if pattern is GATHER:
        env["out"] = np.zeros((N, D), np.float32)
    else:
        env["V"] = rng.normal(size=(N, D)).astype(np.float32)
    return env


@pytest.mark.parametrize("kind", ["zipf", "uniform"])
@pytest.mark.parametrize("pattern", [GATHER, RMW], ids=["gather", "rmw"])
def test_main_path_patterns(pattern, kind):
    env = _env(kind, pattern)
    cfg = harness.EngineConfig(optimize=True, use_kernel=False, jit=False,
                               tile_size=TILE)
    want, _, _ = harness.run_engine_tiled(pattern, env, n=N, config=cfg)
    oenv, _, _ = oracle.oracle_run_tiled(pattern, env, n=N, tile_size=TILE)
    before = (gk.launches, sk.launches)
    eng = Engine(tile_size=TILE, use_kernel=True, device="cpu")
    got, _, _ = run_tiled(eng, pattern_from(pattern),
                          interop.env_from_numpy(env, device="cpu"), n=N)
    assert (gk.launches, sk.launches) == before   # plain versions on CPU
    got = interop.env_to_numpy(got)
    name = "out" if pattern is GATHER else "A"
    for ref in (want[name], oenv[name]):
        if pattern is GATHER:
            np.testing.assert_array_equal(got[name], ref)
        else:
            np.testing.assert_allclose(got[name], ref, rtol=1e-5, atol=1e-5)
    if pattern is GATHER:
        idx = np.clip(env["B"], 0, ROWS - 1)
        np.testing.assert_array_equal(got["out"], env["A"][idx])


def test_compile_cache_counters_match_reference():
    """Tile by tile through the cached executable: one entry, one trace,
    one call per tile, on both sides."""
    env = _env("uniform", RMW)
    rprog, _ = ref_compile(RMW, tile_size=TILE)
    pprog, _ = compile_pattern(pattern_from(RMW), tile_size=TILE)
    reng = RefEngine(tile_size=TILE)
    peng = Engine(tile_size=TILE, use_kernel=True, device="cpu")
    renv = {k: jnp.asarray(v) for k, v in env.items()}
    penv = interop.env_from_numpy(env, device="cpu")
    renv["__iota__"] = jnp.arange(3 * TILE, dtype=jnp.int32)
    penv["__iota__"] = torch.arange(3 * TILE, dtype=torch.int32)
    for base in range(0, N, TILE):
        regs = {"tile_base": base, "N": min(TILE, N - base),
                "tile_end": min(base + TILE, N)}
        rexe, pexe = reng.jit_run(rprog), peng.jit_run(pprog)
        renv, _ = rexe(renv, regs)
        penv, _ = pexe(penv, regs)
    assert pexe is peng.jit_run(pprog)
    assert (pexe.calls, pexe.traces) == (rexe.calls, rexe.traces) == (3, 1)
    reng.jit_run(rprog)
    assert peng.stats == reng.stats
    assert peng.cache_hits == reng.cache_hits == 3
    np.testing.assert_allclose(penv["A"].numpy(), np.asarray(renv["A"]),
                               rtol=1e-5, atol=1e-5)

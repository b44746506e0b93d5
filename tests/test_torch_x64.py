"""The port's 64-bit mode (``JAX_ENABLE_X64=1``) against the reference's.

Both packages read ``JAX_ENABLE_X64`` once, at import, so the checks run in
subprocesses started with it set: this file run as a script executes
every case below (or, given ``k n``, every n-th from the k-th) and prints
one JSON object, case name -> "ok" or the failure; the module fixture
deals the cases to ``X64_PROCS`` such processes, and each pytest case
reads its entry. Inputs are made from a seed
with NumPy and fed to both packages, as in test_torch_isa.py (which holds
the x64-off mode):

  * widths: ``i64``/``u64``/``f64`` are 8 bytes in both, and
    ``env_from_numpy`` keeps them so;
  * the C1 probe: ``ADD`` of an i32 and a u32 tile promotes to i64;
  * ``alu_apply`` on the 64-bit kinds, every pair's promotion, every
    conversion and the RMW identities, bit for bit;
  * hand-written programs over 64-bit regions (mixed-kind ALUs, unsigned
    MIN/MAX RMWs, shifts, conversions) and fuzz seeds through the port's
    engine and the reference's ``Engine(use_kernel=False)``: integers and
    gathers bit for bit, float RMW regions to rtol 1e-5 / atol 1e-6.
"""
import json
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest

from spawn_once import once

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("i32", "u32", "f32", "bf16", "i64", "u64", "f64")
WIDE = ("i64", "u64", "f64")
ALU_OPS = ("ADD", "SUB", "MUL", "MIN", "MAX", "AND", "OR", "XOR", "SHR",
           "SHL", "LT", "LE", "GT", "GE", "EQ")
RMW_OPS = ("ADD", "MIN", "MAX", "AND", "OR", "XOR", "MUL")
PROGRAMS = ("mixed_alu", "wide_rmw", "shifts", "converts")
FUZZ_SEEDS = tuple(range(12))
N = 256
X64_PROCS = 3

CASES = (["widths", "probe"]
         + [f"alu:{op}:{k}" for op in ALU_OPS for k in WIDE]
         + [f"promote:{a}:{b}" for a in KINDS for b in KINDS]
         + [f"convert:{a}:{b}" for a in KINDS for b in KINDS]
         + [f"identity:{op}:{k}" for op in RMW_OPS for k in WIDE]
         + [f"program:{p}:{op}" for p in PROGRAMS for op in ("MIN", "MAX",
                                                             "ADD")]
         + [f"fuzz:{s}" for s in FUZZ_SEEDS])


# ---------------------------------------------------------------------------
# the checks, run inside the x64 subprocess
# ---------------------------------------------------------------------------

def _operands(kind, seed):
    rng = np.random.default_rng(seed)
    if kind in ("f32", "bf16", "f64"):
        x = rng.normal(scale=1e3, size=N)
        x[:9] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 3e38, 2e19]
        return x.astype(np.float64 if kind == "f64" else np.float32)
    x = rng.integers(-2 ** 63, 2 ** 63 - 1, size=N, dtype=np.int64)
    x[:7] = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 63 - 1, -2 ** 63]
    return _as_kind(x, kind)


def _as_kind(x, kind):
    """int64 values as ``kind``'s NumPy type (wrapping; unsigned kinds
    take the signed type's bits)."""
    x = x if kind in ("i64", "u64") else x.astype(np.int32)
    if kind[0] == "u":
        return x.view(np.uint64 if x.itemsize == 8 else np.uint32)
    return x


def _shift_amounts(kind, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(-80, 140, size=N).astype(np.int64)
    b[:8] = [0, 31, 32, 33, 63, 64, 65, -1]
    return _as_kind(b, kind)


def _checks(cases):
    import jax.numpy as jnp
    import torch

    from repro.core import isa as jisa
    from repro_torch.core import interop, isa

    def jx(a, kind):
        return jnp.asarray(a).astype(jisa.DTYPES[kind])

    def pt(a, kind):
        t = interop.to_tensor(a, device="cpu")
        return t.to(torch.bfloat16) if kind == "bf16" else t

    def same(got, want):
        want = np.asarray(want)
        got = interop.to_numpy(got, want.dtype)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        if want.dtype.name == "bfloat16":
            got, want = got.astype(np.float32), want.astype(np.float32)
        np.testing.assert_array_equal(got, want)

    def widths():
        assert isa.X64
        for name in WIDE:
            assert isa.DTYPES[name].itemsize == 8
            assert jnp.dtype(jisa.DTYPES[name]).itemsize == 8
        env = {"a": np.arange(4, dtype=np.int64) - 2 ** 40,
               "b": np.arange(4, dtype=np.uint64) + 2 ** 63,
               "c": np.linspace(0, 1, 4)}
        back = interop.env_to_numpy(interop.env_from_numpy(env, device="cpu"),
                                    {k: v.dtype for k, v in env.items()})
        for k, v in env.items():
            assert back[k].dtype == v.dtype and np.array_equal(back[k], v)

    def probe():
        a = np.array([2 ** 31 - 1, -5], np.int32)
        b = np.array([3, 7], np.uint32)
        want = jisa.alu_apply("ADD", jnp.asarray(a), jnp.asarray(b))
        pa, pb, kind = isa.promote(pt(a, "i32"), "i32", pt(b, "u32"), "u32")
        got = isa.alu_apply("ADD", pa, pb)
        assert kind == "i64" and got.dtype == torch.int64
        assert got.tolist() == [2147483650, 2] == np.asarray(want).tolist()

    def alu(op, kind):
        a = _operands(kind, 1)
        b = _shift_amounts(kind, 2) if op in ("SHR", "SHL") else \
            _operands(kind, 2)
        if kind == "f64" and op in ("AND", "OR", "XOR", "SHR", "SHL"):
            try:
                isa.alu_apply(op, pt(a, kind), pt(b, kind))
            except TypeError:
                return
            raise AssertionError("float bitwise op did not raise")
        want = jisa.alu_apply(op, jx(a, kind), jx(b, kind))
        got = isa.alu_apply(op, pt(a, kind), pt(b, kind),
                            unsigned=kind in isa.UNSIGNED_KINDS)
        same(got, want)

    def promote(ka, kb):
        a, b = _operands(ka, 4), _operands(kb, 5)
        want = jisa.alu_apply("MAX", jx(a, ka), jx(b, kb))
        pa, pb, kind = isa.promote(pt(a, ka), ka, pt(b, kb), kb)
        same(isa.alu_apply("MAX", pa, pb,
                           unsigned=kind in isa.UNSIGNED_KINDS), want)

    def convert(src, dst):
        a = _operands(src, 3)
        same(isa.convert(pt(a, src), src, dst),
             jx(a, src).astype(jisa.DTYPES[dst]))

    def identity(op, kind):
        if kind == "f64" and op in ("AND", "OR", "XOR"):
            return
        same(isa.rmw_identity(op, kind),
             jisa.rmw_identity(op, jisa.DTYPES[kind]))

    def program(name, op):
        from repro.core.engine import Engine as JEngine
        from repro_torch.core.engine import Engine
        rng = np.random.default_rng(len(name) * 7 + len(op))
        rows, ts = 64, 128
        env = {"I": rng.integers(-8, rows + 8, size=ts).astype(np.int64),
               "U": (rng.integers(0, 2 ** 63, size=rows, dtype=np.int64)
                     .view(np.uint64) * np.uint64(2)),
               "S": rng.integers(-2 ** 62, 2 ** 62, size=rows,
                                 dtype=np.int64),
               "F": rng.normal(size=rows) * 1e10,
               "W": rng.integers(0, 2 ** 31, size=rows).astype(np.uint32),
               "Q": rng.integers(-2 ** 31, 2 ** 31, size=rows,
                                 dtype=np.int64).astype(np.int32),
               "OU": rng.integers(0, 2 ** 40, size=rows).astype(np.uint64),
               "OS": rng.integers(-2 ** 40, 2 ** 40, size=rows),
               "OF": rng.normal(size=rows)}
        regs = {"k": 3, "big": 2 ** 40}

        def build(m):
            common = [m.SLD("i64", "I", "idx", rs1=0),
                      m.ILD("u64", "U", "u", "idx"),
                      m.ILD("i64", "S", "s", "idx"),
                      m.ILD("f64", "F", "f", "idx"),
                      m.ILD("u32", "W", "w", "idx"),
                      m.ILD("i32", "Q", "q", "idx")]
            body = {
                "mixed_alu": [m.ALUV("f64", "ADD", "t1", "u", "s"),
                              m.ALUV("i64", "MUL", "t2", "w", "q"),
                              m.ALUV("u64", "MAX", "t3", "u", "w"),
                              m.ALUV("f64", "SUB", "t4", "q", "f"),
                              m.ALUV("i64", "LT", "t5", "u", "s"),
                              m.IRMW("u64", "OU", op, "idx", "t3"),
                              m.IRMW("i64", "OS", op, "idx", "t2"),
                              m.IRMW("f64", "OF", op, "idx", "t1")],
                "wide_rmw": [m.ALUS("u64", "ADD", "t1", "u", rs="big"),
                             m.IRMW("u64", "OU", op, "idx", "t1"),
                             m.IRMW("i64", "OS", op, "idx", "s"),
                             m.IRMW("f64", "OF", op, "idx", "f")],
                "shifts": [m.ALUS("u64", "SHR", "t1", "u", rs="k"),
                           m.ALUS("i64", "SHR", "t2", "s", rs="k"),
                           m.ALUS("u64", "SHL", "t3", "u", rs="k"),
                           m.ALUV("u64", "SHR", "t4", "u", "w"),
                           m.IRMW("u64", "OU", op, "idx", "t1"),
                           m.IRMW("i64", "OS", op, "idx", "t2"),
                           m.SST("u64", "OU", "t3", rs1=0, rs2=8)],
                "converts": [m.ALUS("i32", "ADD", "t1", "u", rs=0),
                             m.ALUS("u32", "ADD", "t2", "f", rs=0.0),
                             m.ALUS("f32", "ADD", "t3", "u", rs=0),
                             m.ALUV("i64", "ADD", "t4", "t1", "t2"),
                             m.IRMW("i64", "OS", op, "idx", "t4"),
                             m.IRMW("f64", "OF", op, "idx", "t3"),
                             m.IRMW("u64", "OU", op, "idx", "t2")]}[name]
            return m.AccessProgram(tuple(common + body), tile_size=ts)

        renv, rspd = JEngine(tile_size=ts).run(
            build(jisa), {k: jnp.asarray(v) for k, v in env.items()}, regs)
        penv, pspd = Engine(tile_size=ts, device="cpu").run(
            build(isa), interop.env_from_numpy(env, device="cpu"), regs,
            dtypes=interop.dtypes_of(env))
        for k in renv:
            want = np.asarray(renv[k])
            got = interop.to_numpy(penv[k], want.dtype)
            if k == "OF" and op == "ADD":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            else:
                same(penv[k], want)
        for k in rspd:
            same(pspd[k], rspd[k])

    def fuzz(seed):
        from repro.testing import fuzzer, harness
        from test_torch_engine import _float_rmw_regions, run_port
        case = fuzzer.generate_case(seed)
        tile = (64, 1024)[seed % 2]
        penv, _, _ = run_port(case.pattern, case.env, n=case.n, tile=tile)
        cfg = harness.EngineConfig(optimize=True, use_kernel=False,
                                   jit=False, tile_size=tile)
        renv, _, _ = harness.run_engine_tiled(case.pattern, case.env,
                                              n=case.n, config=cfg)
        loose = _float_rmw_regions(case.pattern)
        for k in renv:
            if k in loose:
                np.testing.assert_allclose(penv[k], renv[k], rtol=1e-5,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(penv[k], renv[k])

    table = {"widths": widths, "probe": probe, "alu": alu,
             "promote": promote, "convert": convert, "identity": identity,
             "program": program, "fuzz": lambda s: fuzz(int(s))}
    results = {}
    for case in cases:
        kind, *args = case.split(":")
        try:
            table[kind](*args)
            results[case] = "ok"
        except Exception:
            results[case] = traceback.format_exc(limit=4)[-2000:]
    return results


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def x64_results(tmp_path_factory):
    return once(tmp_path_factory, "x64_results", _x64_subprocess)


def _x64_subprocess():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(k), str(X64_PROCS)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for k in range(X64_PROCS)]
    results = {}
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            results.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


@pytest.mark.parametrize("case", CASES)
def test_x64_matches_reference(case, x64_results):
    assert x64_results[case] == "ok", x64_results[case]


def test_x64_off_is_the_default():
    from repro_torch.core import isa
    if os.environ.get("JAX_ENABLE_X64", "0") in ("0", ""):
        assert not isa.X64
        assert isa.DTYPES["i64"].itemsize == 4


if __name__ == "__main__":
    k, n = map(int, sys.argv[1:3]) if len(sys.argv) > 2 else (0, 1)
    print(json.dumps(_checks(CASES[k::n])))

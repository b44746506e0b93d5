"""The port's NumPy oracle, conformance registry and case generators
against the JAX package's, on the CPU.

  * ``OracleEngine`` / ``oracle_run_tiled`` of the port (over the port's
    compiler and ISA) against the reference's on the 12 Table-1
    conformance patterns and fuzz seeds 0-199 at tiles {64, 1024, 16384}:
    every region and every last-tile scratchpad tile equal, bit for bit
    (both are NumPy; the same operations in the same order);
  * ``run_pattern`` (the source-level loop nest) and
    ``pattern_max_tile_fill`` likewise;
  * the conformance environments, ``generate_mixed_case`` and
    ``mutate_case`` byte for byte the reference's for the same seed;
  * ``NP_DTYPES`` keep the 64-bit names at 64 bits whatever the engine's
    mode.
"""
import numpy as np
import pytest

from repro.testing import conformance as rconf
from repro.testing import fuzzer as rfuzzer
from repro.testing import oracle as roracle
from repro_torch.testing import conformance, fuzzer, oracle, pattern_from

TILES = (64, 1024, 16384)
FUZZ_SEEDS = range(200)


def _same_arrays(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert g.tobytes() == w.tobytes(), (what, k)


def _check(port_pattern, ref_pattern, env, n):
    penv, pspd, pinfo = None, None, None
    for tile in TILES:
        penv, pspd, pinfo = oracle.oracle_run_tiled(port_pattern, env, n=n,
                                                    tile_size=tile)
        renv, rspd, rinfo = roracle.oracle_run_tiled(ref_pattern, env, n=n,
                                                     tile_size=tile)
        _same_arrays(penv, renv, f"env tile={tile}")
        _same_arrays(pspd, rspd, f"spd tile={tile}")
        assert pinfo == rinfo
        assert oracle.pattern_max_tile_fill(port_pattern, env, n, tile) == \
            roracle.pattern_max_tile_fill(ref_pattern, env, n, tile)
    penv, ploads = oracle.run_pattern(port_pattern, env, n=n)
    renv, rloads = roracle.run_pattern(ref_pattern, env, n=n)
    _same_arrays(penv, renv, "run_pattern env")
    _same_arrays(ploads, rloads, "run_pattern loads")


@pytest.mark.parametrize("name", rconf.all_names())
def test_conformance_case_and_oracle_match_reference(name):
    case, ref = conformance.build(name), rconf.build(name)
    assert case.n == ref.n and case.name == ref.name
    _same_arrays(case.env, ref.env, "conformance env")
    assert pattern_from(case.pattern) == pattern_from(ref.pattern)
    assert case.max_tile_fill(64) == ref.max_tile_fill(64)
    _check(case.pattern, ref.pattern, ref.env, ref.n)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_oracle_matches_reference(seed):
    case, ref = fuzzer.generate_case(seed), rfuzzer.generate_case(seed)
    assert pattern_from(case.pattern) == pattern_from(ref.pattern)
    for tile in TILES:
        assert case.max_tile_fill(tile) == ref.max_tile_fill(tile)
    _check(case.pattern, ref.pattern, ref.env, ref.n)


@pytest.mark.parametrize("seed", range(24))
def test_mixed_cases_and_mutants_match_reference(seed):
    case, ref = fuzzer.generate_mixed_case(seed), \
        rfuzzer.generate_mixed_case(seed)
    _same_arrays(case.tables, ref.tables, "tables")
    assert case.table_ops == ref.table_ops and case.name == ref.name
    for (pn, pi), (rn, ri) in zip(case.gathers, ref.gathers, strict=True):
        assert pn == rn and pi.tobytes() == ri.tobytes()
    for p, r in zip(case.rmws, ref.rmws, strict=True):
        assert p[0] == r[0]
        for a, b in zip(p[1:], r[1:]):
            assert (a is None and b is None) or a.tobytes() == b.tobytes()
    for (pp, pe, pn), (rp, re_, rn) in zip(case.programs, ref.programs,
                                           strict=True):
        assert pattern_from(pp) == pattern_from(rp) and pn == rn
        _same_arrays(pe, re_, "program env")
    for kind in ("mixed_op", "gather_rmw_race"):
        mp, mr = fuzzer.mutate_case(case, kind, seed), \
            rfuzzer.mutate_case(ref, kind, seed)
        assert mp.name == mr.name and mp.table_ops == mr.table_ops
        _same_arrays(mp.tables, mr.tables, "mutant tables")
        assert len(mp.injected) == len(mr.injected)
        for a, b in zip(mp.injected, mr.injected):
            if isinstance(b, np.ndarray):
                assert a.tobytes() == b.tobytes()
            else:
                assert a == b
    with pytest.raises(ValueError):
        fuzzer.mutate_case(case, "nonsense")


def test_np_dtypes_stay_64_bit():
    for name in ("i64", "u64", "f64"):
        assert oracle.NP_DTYPES[name].itemsize == 8
        assert oracle.NP_DTYPES[name] == roracle.NP_DTYPES[name]


def test_oracle_takes_tensors():
    """Tensors are turned into NumPy on the way in (the oracle computes in
    NumPy only)."""
    import torch
    case = conformance.build("histogram_is")
    env = {k: torch.from_numpy(v) for k, v in case.env.items()}
    got, _, _ = oracle.oracle_run_tiled(case.pattern, env, n=case.n,
                                        tile_size=64)
    want, _, _ = oracle.oracle_run_tiled(case.pattern, case.env, n=case.n,
                                         tile_size=64)
    _same_arrays(got, want, "tensor env")
    assert all(isinstance(v, np.ndarray) for v in got.values())

"""Port engine + compiler on a slice of the reference's seeded fuzz corpus.

Each ``fuzzer.generate_case(seed)`` runs through the port's ``run_tiled``
at tile sizes 64 and 1024 and is held against the NumPy ``OracleEngine`` at
both, and against the reference ``Engine(use_kernel=False)`` (eager JAX,
the slow part) at one of them, alternating with the seed. Tolerances as in
test_torch_engine.py: bit for bit except float RMW regions.
"""
import pytest

from repro.testing import fuzzer
from test_torch_engine import check_against_reference

FUZZ_SEEDS = tuple(range(24))
TILES = (64, 1024)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_case(seed):
    case = fuzzer.generate_case(seed)
    for tile in TILES:
        check_against_reference(case.pattern, case.env, n=case.n, tile=tile,
                                reference=tile == TILES[seed % 2])


def test_fuzz_slice_covers_u32_and_range_loops():
    """The slice exercises the u32 container and the range fuser."""
    cases = [fuzzer.generate_case(s) for s in FUZZ_SEEDS]
    assert any(c.pattern.range_loop is not None for c in cases)
    assert any(v.dtype.name == "uint32" for c in cases for v in c.env.values())

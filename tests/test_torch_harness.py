"""The port's parity harness (repro_torch.testing.harness) on the CPU.

Every ``check_*`` passes the port: the 12 conformance patterns over the
whole engine config matrix, the 200-seed fuzz corpus over rotating configs
(tiles {64, 1024, 16384}, optimize on/off, the row-table kernels' plain
versions on/off), batched programs, mixed flush windows, the sharded
engine at every mesh size {1, 2, 4, 8}, the five apps (and a 2-shard
mesh), the KV and embedding apps' own properties and traffic replays. The
negative probes patch one bulk op to corrupt one lane and require
``ParityError``: the harness is live, not vacuous. The harness's own
inputs (``default_sharded_cases``, the config matrix) are the reference's.
"""
import numpy as np
import pytest
import torch

from repro.testing import harness as rharness
from repro_torch.core import bulk_ops
from repro_torch.testing import (build_conformance, conformance_names,
                                 generate_case, generate_mixed_case,
                                 generate_traffic_case, harness)

CPU = "cpu"


@pytest.mark.parametrize("name", conformance_names())
def test_conformance_over_the_config_matrix(name):
    case = build_conformance(name)
    checked = harness.check_pattern_parity(
        case.pattern, case.env, n=case.n, configs=harness.CONFIG_MATRIX,
        max_tile_fill=case.max_tile_fill, device=CPU)
    assert checked >= len(harness.CONFIG_MATRIX)


@pytest.mark.parametrize("seed", range(200))
def test_fuzz_corpus_case_parity(seed):
    case = generate_case(seed)
    assert harness.check_case_parity(
        case, configs=harness.rotating_configs(seed), device=CPU) > 0


def test_config_matrix_and_rotation_are_the_reference():
    assert [c.label for c in harness.CONFIG_MATRIX] == \
        [c.label for c in rharness.CONFIG_MATRIX]
    for seed in range(16):
        assert [c.label for c in harness.rotating_configs(seed)] == \
            [c.label for c in rharness.rotating_configs(seed)]


def test_default_sharded_cases_are_the_reference():
    mine, ref = harness.default_sharded_cases(3), \
        rharness.default_sharded_cases(3)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert len(a) == len(b) and a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            else:
                assert x == y


def test_scheduler_parity():
    cases = [(c.pattern, c.env, min(c.n, 1024)) for c in
             (build_conformance(n) for n in ("histogram_is", "db_filter",
                                             "spatter_gather"))]
    cases += [(c.pattern, c.env, min(c.n, 1024)) for c in
              (generate_case(s) for s in range(6))]
    checked, report = harness.check_scheduler_parity(cases, device=CPU)
    assert checked > 0 and report.n_programs == len(cases)


@pytest.mark.parametrize("seed", range(16))
def test_mixed_flush_parity(seed):
    checked, report = harness.check_mixed_flush_parity(
        generate_mixed_case(seed), device=CPU)
    assert checked > 0 and not report.shard_stats


def test_sharded_parity_runs_every_mesh_size():
    checked, ran = harness.check_sharded_parity(
        mesh_sizes=(1, 2, 4, 8), device=CPU)
    assert ran == [1, 2, 4, 8]
    assert checked == 4 * len(harness.default_sharded_cases(0))


def test_app_parity_with_a_mesh():
    checked, ran = harness.check_app_parity(mesh_sizes=(2,), device=CPU)
    assert ran == [2] and checked == 15


def test_kv_and_embedding_parity():
    assert harness.check_kv_parity(seeds=(0,), mesh_sizes=(2,),
                                   device=CPU) == 5
    assert harness.check_embedding_parity(seeds=(0,), mesh_sizes=(4,),
                                          device=CPU) == 5


@pytest.mark.parametrize("seed", range(4))
def test_traffic_parity(seed):
    checked, res = harness.check_traffic_parity(generate_traffic_case(seed),
                                                device=CPU)
    assert checked == len(res.tickets)


# ---------------------------------------------------------------------------
# negative probes
# ---------------------------------------------------------------------------

def _corrupting(fn):
    """``fn`` with one lane of its result changed (the first)."""
    def bad(*args, **kw):
        out = fn(*args, **kw).clone()
        if out.numel():
            flat = out.view(-1)
            flat[0] = flat[0] + 1 if not out.dtype.is_floating_point \
                else flat[0] + 1.5
        return out
    return bad


def test_corrupted_gather_raises_parity_error(monkeypatch):
    case = build_conformance("spatter_gather")
    monkeypatch.setattr(bulk_ops, "bulk_gather",
                        _corrupting(bulk_ops.bulk_gather))
    with pytest.raises(harness.ParityError):
        harness.check_pattern_parity(case.pattern, case.env, n=case.n,
                                     configs=harness.EAGER_CONFIGS[:1],
                                     device=CPU)


def test_corrupted_rmw_raises_parity_error(monkeypatch):
    case = build_conformance("histogram_is")
    monkeypatch.setattr(bulk_ops, "bulk_rmw",
                        _corrupting(bulk_ops.bulk_rmw))
    with pytest.raises(harness.ParityError):
        harness.check_pattern_parity(case.pattern, case.env, n=case.n,
                                     configs=harness.EAGER_CONFIGS[:1],
                                     device=CPU)


def test_corrupted_owner_exec_raises_parity_error(monkeypatch):
    """The sharded engine's owner-local update: its first table row is
    corrupted (a row every RMW result is compared on)."""
    monkeypatch.setattr(bulk_ops, "bulk_rmw",
                        _corrupting(bulk_ops.bulk_rmw))
    with pytest.raises(harness.ParityError):
        harness.check_sharded_parity(mesh_sizes=(4,), device=CPU)


def test_harness_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.check_sharded_parity(mesh_sizes=(1,))

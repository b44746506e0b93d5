"""The port's five Table-1 apps against the JAX package's on the CPU.

Every app's seeded ``demo`` runs in each single-device mode through the
port (``device="cpu"``) and through the JAX package (its default
``use_kernel=False`` engine); both must equal the port's copied NumPy
oracle ``demo_reference`` (itself equal to the JAX package's), with no
tolerance: the apps keep every float sum an exact integer below 2^24.
Port-only checks: the integer SpMV, the KV pool's mid-flight growth and
cross-tenant gather, ``segment_combine`` against a naive duplicate
scatter, ``chip_smoke.py``'s vectorised oracles against the copied loop
oracles, and every app over a 2-shard mesh.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import apps as ref_apps
from repro_torch import apps
from repro_torch.apps import bfs, embedding_bag, hashjoin, kv_serve, spmv
from repro_torch.serve import AccessService

MODES = ("eager", "sequential", "pipelined")
CASES = [(name, 0) for name in apps.APPS] + \
    [("kv_serve", 1), ("embedding_bag", 1)]

# chip_smoke.py's vectorised host oracles (numpy and scipy only)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def assert_exact(got, want):
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,seed", CASES, ids=lambda x: str(x))
def test_app_matches_reference_and_oracle(name, seed, mode):
    port, ref = apps.APPS[name], ref_apps.APPS[name]
    want = port.demo_reference(seed)
    assert_exact(want, np.asarray(ref.demo_reference(seed)))
    got = port.demo(seed, mode=mode, device="cpu")
    assert_exact(got, want)
    assert_exact(got, np.asarray(ref.demo(seed, mode=mode)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype,d", [("i32", 1), ("i32", 4), ("f32", 4)])
def test_spmv_integer_and_block_variants(dtype, d, mode):
    prob = spmv.make_problem(3, n=300, d=d, dtype=dtype)
    got = spmv.run(prob, 6, mode=mode, device="cpu")
    want = spmv.reference(prob, 6)
    assert_exact(got, want)
    assert_exact(got, ref_apps.spmv.reference(
        ref_apps.spmv.make_problem(3, n=300, d=d, dtype=dtype), 6))


@pytest.mark.parametrize("mode", ["sequential", "pipelined"])
def test_kv_pool_grows_mid_flight_and_coalesces_across_tenants(mode):
    prob = kv_serve.make_problem(0)
    st = kv_serve._PageState(prob)
    kv_serve._prefill_streams(prob, st)
    decode_start = st.cap_pages + prob.init_slack_pages
    svc = AccessService(auto_flush=0, device="cpu")
    stats = {}
    got = kv_serve.run(prob, 6, mode=mode, service=svc, stats_out=stats)
    assert_exact(got, kv_serve.reference(prob, 6))
    assert stats["growths"] > st.growths            # grew during decode
    assert stats["final_pages"] > decode_start
    assert svc.stats()["plan_cache_misses"] > 2     # new extents re-plan
    # the last access window fused one gather across tenants
    spans = [len({m.ticket.tenant for m in g.members})
             for g in svc.last_report.plan.fused("gather")]
    assert max(spans) == len(set(prob.tenants)), spans
    gains = [g for g, _, _ in svc.last_report.gather_coalescing.values()]
    assert max(gains) > 1.0                         # shared prefix pages


@pytest.mark.parametrize("name", ["embedding_bag", "kv_serve"])
def test_shared_service_holds_no_results_after_a_run(name):
    """The apps redeem every ticket they submit: a long-lived service
    keeps no table (or pool) of a finished run alive."""
    svc = AccessService(auto_flush=0, device="cpu")
    for mode in ("sequential", "pipelined"):
        apps.APPS[name].demo(0, mode=mode, service=svc)
        assert svc.scheduler._results == {}


def _naive_push(idx, vals, rows):
    want = np.zeros((rows,) + vals.shape[1:], vals.dtype)
    for i, r in enumerate(idx):
        if 0 <= r < rows:
            want[r] += vals[i]
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_combine_matches_naive_duplicate_scatter(seed):
    rng = np.random.default_rng(0xD1_E3 + seed)
    rows, n, d = 16, 40, 5
    idx = rng.integers(-4, rows + 4, size=n)
    vals = rng.integers(0, 8, size=(n, d)).astype(np.float32)
    dest, summed = embedding_bag.segment_combine(idx, vals, num_rows=rows,
                                                 device="cpu")
    assert dest.dtype == torch.int32 and dest.shape == (n,)
    live = dest[dest < rows]
    assert live.unique().numel() == live.numel()    # one leader per row
    assert set(live.tolist()) == {int(r) for r in idx if 0 <= r < rows}
    got = torch.zeros((rows + 1, d)).index_add_(0, dest.long(), summed)
    np.testing.assert_array_equal(got[:rows].numpy(),
                                  _naive_push(idx, vals, rows))
    # the same pairs as the JAX package's, lane for lane
    ref_dest, ref_summed = ref_apps.embedding_bag.segment_combine(
        idx, vals, num_rows=rows)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(ref_dest))
    np.testing.assert_array_equal(summed.numpy(), np.asarray(ref_summed))


@pytest.mark.parametrize("idx", [np.zeros(0, np.int32),
                                 np.array([-1, 99, -7, 8])],
                         ids=["empty", "all_oob"])
def test_segment_combine_empty_and_all_oob(idx):
    vals = np.ones((idx.shape[0], 2), np.float32)
    dest, summed = embedding_bag.segment_combine(idx, vals, num_rows=8,
                                                 device="cpu")
    assert dest.shape == (idx.shape[0],) and summed.shape == vals.shape
    assert bool((dest == 8).all())                   # stores drop
    table = torch.zeros((9, 2)).index_add_(0, dest.long(), summed)
    assert not table[:8].any()


@pytest.mark.parametrize("seed,n,deg,levels", [
    (0, 3000, 5, 8), (1, 500, 1, 12), (2, 2000, 16, 3), (3, 64, 0, 4)])
def test_bfs_oracle_levels_match_loop_oracle(seed, n, deg, levels):
    g = bfs.make_graph(seed, n=n, avg_deg=deg)
    assert_exact(smoke.oracle_bfs(g, 0, levels),
                 bfs.reference(g, 0, levels=levels))


@pytest.mark.parametrize("seed", [0, 1])
def test_hashjoin_vector_oracle_matches_loop_oracle(seed):
    prob = hashjoin.make_problem(seed, n_build=2000, n_probe=6000,
                                 log2_buckets=12)
    out, count = smoke.oracle_hashjoin(prob)
    want_out, want_count = hashjoin.reference(prob)
    assert_exact(out, want_out)
    assert count == want_count


@pytest.mark.parametrize("dtype,d", [("f32", 1), ("f32", 16), ("i32", 1)])
def test_spmv_sparse_oracle_matches_loop_oracle(dtype, d):
    prob = spmv.make_problem(5, n=2000, avg_nnz=16, d=d, dtype=dtype)
    assert_exact(smoke.oracle_spmv(prob, 6), spmv.reference(prob, 6))


@pytest.mark.parametrize("name", sorted(apps.APPS))
def test_mesh_is_refused(name):
    """A mesh is no longer refused: the pipelined run over a 2-shard
    ``ShardedEngine`` equals the oracle bit for bit, and its fused
    gathers and RMWs went through the sharded backend (per-shard exchange
    stats)."""
    svc = AccessService(mesh=2, device="cpu", auto_flush=0,
                        tile_size=256 if name == "hashjoin" else 16384)
    reports = []
    flush = svc.flush_async

    def recording_flush(**kw):
        handle = flush(**kw)
        reports.append(handle.report)
        return handle

    svc.flush_async = recording_flush
    mod = apps.APPS[name]
    assert_exact(mod.demo(0, mesh=2, device="cpu"), mod.demo_reference(0))
    assert_exact(mod.demo(0, service=svc, device="cpu"),
                 mod.demo_reference(0))
    assert svc.scheduler.engine.num_shards == 2
    # the hash join submits programs only: no fused node to shard
    assert any(r.shard_stats for r in reports) == (name != "hashjoin")


def test_unknown_mode_is_refused():
    for name, mod in apps.APPS.items():
        with pytest.raises(ValueError, match="mode"):
            mod.demo(0, mode="warp", device="cpu")
    with pytest.raises(ValueError, match="max_steps"):
        kv_serve.run(kv_serve.make_problem(0), 99, device="cpu")

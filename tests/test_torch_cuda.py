"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False. The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the repository's root conftest imports JAX.)

Tolerance: gathers, integer RMWs and float MIN/MAX bit for bit; float
ADD/MUL rtol=1e-5/atol=1e-6 (f32) and rtol=1e-2/atol=1e-2 (bf16, one ulp),
since the plain version's ``index_add_`` may sum in another order. The
RMW kernel's aliasing plans (``chip_smoke.rmw_aliasing_cases``) are held bit
for bit, floats included, against a loop over the plan's lanes in order.
The sharded engine's owner-local work runs B1/B2 once per call, and the
parity harness holds the conformance patterns and every mesh size.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import bulk_gather, bulk_rmw, coalesce, \
    make_row_table_plan
from repro_torch.kernels.gather import gather as gk
from repro_torch.kernels.gather import ops as gops
from repro_torch.kernels.scatter_rmw import ops as sops
from repro_torch.kernels.scatter_rmw import ref as sref
from repro_torch.kernels.scatter_rmw import scatter_rmw as sk

N, BLOCK_ROWS, LANES = 777, 128, 32          # 777 rows: a partial last block

# chip_smoke.py's aliasing cases and lane-by-lane loop (numpy and torch only)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
ALIAS_CASES = list(smoke.rmw_aliasing_cases())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rmw_stream(rng, n, t):
    """Sorted, unique destinations framed by out-of-range ones (negative
    at the head, past the end at the tail), as bulk_rmw hands them on."""
    dest = np.unique(rng.integers(0, n, size=t))
    k = max(1, len(dest) // 16)
    return np.concatenate([-rng.integers(1, 5, size=k)[::-1] * 7, dest,
                           n + rng.integers(0, 5, size=k)]).astype(np.int32)


def _values(rng, shape, dtype, op):
    if dtype in (torch.int32, "u32"):
        return torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, size=shape,
                                            dtype=np.int64).astype(np.int32))
    x = rng.normal(size=shape).astype(np.float32)
    if op == "MUL":
        x = 1 + x / 64
    x[3, :2] = np.nan
    return torch.as_tensor(x).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_gather_kernel_on_card(cuda, dtype, d):
    rng = np.random.default_rng(d)
    table = (torch.as_tensor(rng.normal(size=(N, d)).astype(np.float32))
             * 100).to(dtype).to(cuda)
    idx = torch.as_tensor(rng.integers(0, N, size=300).astype(np.int32))
    idx[:3] = torch.tensor([N - 1, 0, N - 1])
    plan = make_row_table_plan(coalesce(idx.to(cuda))[0], n_rows=896,
                               block_rows=BLOCK_ROWS, lanes=LANES)
    before = gk.launches
    got = gops.row_table_gather(table, plan)
    torch.cuda.synchronize()
    assert gk.launches == before + 1
    assert torch.equal(got, gops.row_table_gather(table, plan, use_ref=True))


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", [
    *[(op, torch.int32) for op in ("ADD", "MIN", "MAX", "AND", "OR", "XOR",
                                   "MUL")],
    *[(op, dt) for dt in (torch.float32, torch.bfloat16)
      for op in ("ADD", "MIN", "MAX", "MUL")],
    ("MIN", "u32"), ("MAX", "u32")], ids=str)
def test_rmw_kernel_on_card(cuda, op, dtype):
    rng = np.random.default_rng(1)
    unsigned = dtype == "u32"
    d = 64
    table = _values(rng, (N, d), dtype, "ADD").to(cuda)
    dest = torch.as_tensor(_rmw_stream(rng, N, 300)).to(cuda)
    vals = _values(rng, (dest.shape[0], d), dtype, op).to(cuda)
    kw = dict(op=op, block_rows=BLOCK_ROWS, lanes=LANES, unsigned=unsigned)
    before = sk.launches
    keep = table.clone()
    got = sops.row_table_rmw(table, dest, vals, **kw)
    torch.cuda.synchronize()
    assert sk.launches == before + 1
    torch.testing.assert_close(table, keep, rtol=0.0, atol=0.0,
                               equal_nan=True)     # input not mutated
    want = sops.row_table_rmw(table, dest, vals, use_ref=True, **kw)
    if got.is_floating_point():
        tol = dict(rtol=0.0, atol=0.0)
        if op in ("ADD", "MUL"):
            tol = (dict(rtol=1e-5, atol=1e-6) if got.dtype == torch.float32
                   else dict(rtol=1e-2, atol=1e-2))
        torch.testing.assert_close(got, want, equal_nan=True, **tol)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ADD", "MUL", "XOR"])
def test_rmw_kernel_repeated_rows_on_card(cuda, op):
    """A plan of a sorted stream whose rows repeat (a run longer than a
    tile) with a real value on every lane, padded ones included: every
    update of a row lands. Integer ops: bit for bit."""
    rng = np.random.default_rng(6)
    n, d, br, lanes = 896, 16, 128, 32
    idx = np.sort(np.concatenate([rng.integers(0, n, size=500),
                                  np.full(70, 130)])).astype(np.int32)
    plan = make_row_table_plan(torch.as_tensor(idx, device=cuda), n_rows=n,
                               block_rows=br, lanes=lanes)
    table = _values(rng, (n, d), torch.int32, op).to(cuda)
    vals = _values(rng, (plan.num_tiles * lanes, d), torch.int32, op).to(cuda)
    args = (plan.tile_block, plan.tile_first.to(torch.int32), plan.offsets,
            vals)
    kw = dict(block_rows=br, lanes=lanes, op=op)
    got = sk.row_table_rmw_(table.clone(), *args, **kw)
    assert torch.equal(got, sref.row_table_rmw_ref_(table.clone(), *args,
                                                    **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ADD", "MAX"])
def test_bulk_ops_kernel_path_on_card(cuda, op):
    """bulk_gather / bulk_rmw with use_kernel=True (the kernels) against
    use_kernel=False (plain PyTorch) on a duplicate-heavy stream with
    out-of-range indices."""
    rng = np.random.default_rng(4)
    n, d = 3000, 16
    table = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                            device=cuda)
    idx = torch.as_tensor(
        (rng.zipf(1.2, size=5000) % (n + 40) - 20).astype(np.int32),
        device=cuda)
    vals = torch.as_tensor(rng.normal(size=(5000, d)).astype(np.float32),
                           device=cuda)
    g0, r0 = gk.launches, sk.launches
    got = bulk_gather(table, idx, use_kernel=True, block_rows=256, lanes=64,
                      device=cuda)
    assert torch.equal(got, bulk_gather(table, idx, device=cuda))
    got = bulk_rmw(table, idx, vals, op=op, use_kernel=True, block_rows=256,
                   lanes=64, device=cuda)
    want = bulk_rmw(table, idx, vals, op=op, device=cuda)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert (gk.launches - g0, sk.launches - r0) == (1, 1)


@pytest.mark.cuda
def test_wrappers_raise_on_card_instead_of_falling_back(cuda):
    table = torch.zeros((128, 4), dtype=torch.float64, device=cuda)
    plan = make_row_table_plan(torch.arange(0, 128, 5, dtype=torch.int32,
                                            device=cuda),
                               n_rows=128, block_rows=64, lanes=8)
    vals = torch.zeros((plan.num_tiles * 8, 4), dtype=torch.float64,
                       device=cuda)
    with pytest.raises(TypeError, match="unsupported table dtype"):
        sk.row_table_rmw_(table.clone(), plan.tile_block,
                          plan.tile_first.to(torch.int32), plan.offsets,
                          vals, block_rows=64, lanes=8)
    with pytest.raises(ValueError, match="contiguous"):
        gk.row_table_gather(table.float().t().contiguous().t(),
                            plan.tile_block, plan.offsets, block_rows=64,
                            lanes=8)


@pytest.mark.cuda
@pytest.mark.parametrize("op,dt", smoke.RMW_ALIAS_OPS, ids=str)
@pytest.mark.parametrize("case", ALIAS_CASES, ids=lambda c: c[0])
def test_rmw_kernel_aliasing_bitwise_on_card(cuda, case, op, dt):
    """Rows that more than one lane touches (offset 0 with padding, hot
    blocks over many CTAs, identity runs on rows 0 and n-1, 12-byte rows):
    the kernel against a loop over the plan's lanes in order, bit for bit
    (-0.0 and NaN included)."""
    (table, tile_block, tile_first, offsets, vals), kw = \
        smoke.rmw_aliasing_inputs(cuda, *case, op, dt)
    got = sk.row_table_rmw_(table.clone(), tile_block, tile_first, offsets,
                            vals, **kw)
    want = smoke.sequential_rmw(table.clone(), tile_block, offsets, vals,
                                block_rows=kw["block_rows"], op=op)
    assert torch.equal(smoke.bits(got), smoke.bits(want))


# ---------------------------------------------------------------------------
# the scheduler's fused window on the card
# ---------------------------------------------------------------------------

def _window(sched, A, G, streams, vals):
    """One window: a gather of A and an ADD into G from each stream."""
    gathers = [sched.submit_gather(A, s, tenant=f"t{k}")
               for k, s in enumerate(streams)]
    rmws = [sched.submit_rmw(G, s, v, op="ADD", tenant=f"t{k}")
            for k, (s, v) in enumerate(zip(streams, vals))]
    report = sched.flush()
    return report, [sched.result(t) for t in gathers], \
        [sched.result(t) for t in rmws]


@pytest.mark.cuda
def test_fused_window_kernels_match_plain_on_card(cuda):
    """A fused 2-D gather and RMW window through use_kernel=True equals
    the same window with use_kernel=False (gathers bit for bit, the float
    ADD within rtol=1e-4/atol=1e-3 of each other and of index_add_), and
    both kernels' launch counters rise on it."""
    from repro_torch.core import Engine, Scheduler
    gen = torch.Generator(device=cuda).manual_seed(0)
    A = torch.randn(5000, 32, generator=gen, device=cuda)
    G = torch.randn(5000, 32, generator=gen, device=cuda)
    rng = np.random.default_rng(0)
    streams = [torch.from_numpy((rng.zipf(1.2, size=3000) % 5100 - 50)
                                .astype(np.int32)).to(cuda)
               for _ in range(4)]
    vals = [torch.randn(3000, 32, generator=gen, device=cuda)
            for _ in range(4)]
    out = {}
    for use_kernel in (False, True):
        gk.launches = sk.launches = 0
        sched = Scheduler(engine=Engine(tile_size=4096,
                                        use_kernel=use_kernel, device=cuda))
        out[use_kernel] = _window(sched, A, G, streams, vals)
        launched = (gk.launches, sk.launches)
        assert (min(launched) > 0) == use_kernel, launched
    (_, g0, r0), (report, g1, r1) = out[False], out[True]
    assert report.plan.fused("gather")[0].backend == "bulk"
    for s, a, b in zip(streams, g0, g1):
        assert torch.equal(a, b)
        assert torch.equal(b, A[s.long().clamp(0, 4999)])
    idx = torch.cat(streams).long()
    ok = (idx >= 0) & (idx < 5000)
    want = G.clone().index_add_(0, idx[ok], torch.cat(vals)[ok])
    torch.testing.assert_close(r1[0], r0[0], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(r1[0], want, rtol=1e-4, atol=1e-3)
    assert all(r is r1[0] for r in r1)          # end-of-window state


@pytest.mark.cuda
def test_flush_handle_polls_without_blocking_on_card(cuda):
    """While the stream is held by a long sleep, poll() returns False at
    once; result() then waits and returns the report. The window is one
    duplicate-free gather submitted from NumPy, which the cost model
    measures on the host and sends down the direct ("eager") path: a
    coalesced window would wait for the stream inside flush_async, where
    ``torch.unique`` sizes the distinct rows on the host."""
    import time

    from repro_torch.core import Engine, Scheduler
    sched = Scheduler(engine=Engine(tile_size=1024, device=cuda))
    A = torch.randn(1000, 8, device=cuda)
    t = sched.submit_gather(A, np.arange(10, dtype=np.int32))
    assert sched.explain().plan.fused("gather")[0].backend == "eager"
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)           # ~1 s of spinning
    handle = sched.flush_async()
    t0 = time.perf_counter()
    assert handle.poll() is False
    assert not handle.done
    assert time.perf_counter() - t0 < 0.1     # poll did not wait
    with pytest.raises(RuntimeError, match="in flight"):
        sched.flush()
    report = handle.result()
    assert report is handle.report and handle.poll()
    assert torch.equal(sched.result(t), A[:10])


# ---------------------------------------------------------------------------
# the apps on the card
# ---------------------------------------------------------------------------

def _kernel_service(cuda, tile_size=16384):
    from repro_torch.core import Engine, Scheduler
    from repro_torch.serve import AccessService
    return AccessService(Scheduler(engine=Engine(
        tile_size=tile_size, use_kernel=True, device=cuda)), auto_flush=0)


# (app, kernels its pipelined run must launch), as chip_smoke phase 8
APP_KERNELS = [("spmv", ()), ("bfs", ()), ("hashjoin", ()),
               ("embedding_bag", ("gather", "rmw")),
               ("kv_serve", ("gather", "rmw"))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eager", "sequential", "pipelined"])
@pytest.mark.parametrize("app,kernels", APP_KERNELS, ids=lambda a: str(a))
def test_app_demo_on_card(cuda, app, kernels, mode):
    """Each app's seeded demo on the card, bit for bit its NumPy oracle:
    the scheduler modes on an AccessService over Engine(use_kernel=True),
    which must launch the kernels of the 2-D apps, and the eager mode on
    the plain path. The hash join's engine runs its programs' tile size
    (256 in the demo), as the app's own service does."""
    from repro_torch.apps import APPS
    mod = APPS[app]
    gk.launches = sk.launches = 0
    if mode == "eager":
        got = mod.demo(0, mode=mode, device=cuda)
    else:
        tile = 256 if app == "hashjoin" else 16384
        got = mod.demo(0, mode=mode, service=_kernel_service(cuda, tile))
    want = mod.demo_reference(0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    launched = {"gather": gk.launches, "rmw": sk.launches}
    for k in kernels if mode != "eager" else ():
        assert launched[k] >= 1, launched


@pytest.mark.cuda
def test_spmv_block_launches_gather_kernel_on_card(cuda):
    """The d > 1 SpMV gathers a 2-D row table: the gather kernel runs."""
    from repro_torch.apps import spmv
    prob = spmv.make_problem(1, n=700, d=4)
    gk.launches = 0
    got = spmv.run(prob, 6, service=_kernel_service(cuda))
    np.testing.assert_array_equal(got, spmv.reference(prob, 6))
    assert gk.launches == 6


@pytest.mark.cuda
def test_kv_serve_grows_and_coalesces_on_card(cuda):
    """The pool grows during decode, and the last access window fuses one
    gather across tenants (the shared prefix pages)."""
    from repro_torch.apps import kv_serve
    prob = kv_serve.make_problem(1)
    st = kv_serve._PageState(prob)
    kv_serve._prefill_streams(prob, st)
    svc = _kernel_service(cuda)
    stats = {}
    got = kv_serve.run(prob, 6, service=svc, stats_out=stats)
    np.testing.assert_array_equal(got, kv_serve.reference(prob, 6))
    assert stats["final_pages"] > st.cap_pages + prob.init_slack_pages
    assert any(len({m.ticket.tenant for m in g.members}) > 1
               for g in svc.last_report.plan.fused("gather"))


# ---------------------------------------------------------------------------
# the serving layer and the decoder on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kv_pool_server_step_launches_kernels_on_card(cuda):
    """A KvPoolServer on Engine(use_kernel=True) against the same server on
    the CPU's plain path, bit for bit (integer-valued K/V): the prefill
    window launches the RMW kernel, each decode window the gather kernel
    (the fused page histories) and the RMW kernel (the appends)."""
    from repro_torch.core import Engine, Scheduler
    from repro_torch.serve import AccessService, KvPoolServer
    rng = np.random.default_rng(4)
    cpu = AccessService(Scheduler(engine=Engine(device="cpu")),
                        auto_flush=0)
    gk.launches = sk.launches = 0
    srvs = [KvPoolServer(page_size=16, d=64, init_pages=4, growth_pages=2,
                         service=svc) for svc in (_kernel_service(cuda), cpu)]
    prefix = rng.integers(0, 8, size=(32, 128)).astype(np.float32)
    prompts = [rng.integers(0, 8, size=(n, 128)).astype(np.float32)
               for n in (5, 17, 40)]
    for srv in srvs:
        srv.create_prefix("sys", prefix)
        for i, kv in enumerate(prompts):
            srv.admit(f"s{i}", f"t{i % 2}", kv, prefix="sys")
    assert sk.launches >= 1 and gk.launches == 0
    for _ in range(3):
        new = {f"s{i}": rng.integers(0, 8, size=128).astype(np.float32)
               for i in range(3)}
        (hc, _), (hp, _) = srvs[0].decode_batch(new), \
            srvs[1].decode_batch(new)
        for name in new:
            assert torch.equal(hc[name].cpu(), hp[name])
    assert torch.equal(srvs[0].pool.cpu(), srvs[1].pool)
    assert srvs[0].stats() == srvs[1].stats()
    assert srvs[0].stats()["growths"] > 0
    assert gk.launches == 3 and sk.launches >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b"])
def test_decode_matches_forward_on_card(cuda, arch):
    """The reduced config (f32) on the card: prefill and each decode step
    against the full forward over the same tokens, within rtol=1e-4 /
    atol=1e-4 (cuBLAS picks other reduction orders per shape); no kernel
    of the port runs on this path. The MoE runs dropless (capacity for
    every token): with a capacity bound, the prefill's 24 tokens and the
    forward's 40 would overflow their experts differently."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = build_model(cfg, device=cuda)
    params = model.init(0)
    toks = torch.randint(0, 256, (2, 20), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    gk.launches = sk.launches = 0
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 32)
    got, cache = model.prefill(params, {"tokens": toks[:, :12]}, cache)
    torch.testing.assert_close(got[:, 0], full[:, 11], rtol=1e-4, atol=1e-4)
    for t in range(12, 20):
        got, cache = model.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                       cache)
        torch.testing.assert_close(got[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-4)
    assert gk.launches == sk.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
def test_sharded_gather_and_rmw_launch_kernels_on_card(cuda, m):
    """The sharded engine's owner-local take and update run B1 and B2 once
    per call on a 2-D table, and agree with the single-device engine bit
    for bit (integer-valued f32 ADD, i32 MIN)."""
    from repro_torch.distributed import ShardedEngine
    rng = np.random.default_rng(11 + m)
    table = torch.as_tensor(rng.integers(-64, 64, size=(4096, 32)).astype(
        np.float32)).to(cuda)
    itable = torch.as_tensor(rng.integers(0, 2 ** 20, size=(4096, 32))
                             .astype(np.int32)).to(cuda)
    idx = torch.as_tensor(
        (rng.zipf(1.05, size=20000) % 4096).astype(np.int32)).to(cuda)
    vals = torch.as_tensor(rng.integers(-8, 8, size=(20000, 32)).astype(
        np.float32)).to(cuda)
    want_g = bulk_gather(table, idx, use_kernel=True)
    want_add = bulk_rmw(table, idx, vals, op="ADD", use_kernel=True)
    eng = ShardedEngine(mesh=m, use_kernel=True)
    gk.launches = sk.launches = 0
    got = eng.sharded_gather(table, idx)
    assert (gk.launches, sk.launches) == (1, 0)
    new = eng.sharded_rmw(table, idx, vals, op="ADD")
    imin = eng.sharded_rmw(itable, idx, vals.to(torch.int32), op="MIN")
    assert (gk.launches, sk.launches) == (1, 2)
    assert torch.equal(got, want_g)
    assert torch.equal(new, want_add)
    assert torch.equal(new, table.index_add(0, idx.long(), vals))
    assert torch.equal(imin, itable.scatter_reduce(
        0, idx.long()[:, None].expand(-1, 32), vals.to(torch.int32),
        "amin"))
    st = eng.last_shard_stats
    assert int(st.sent.sum()) == int(st.received.sum())


@pytest.mark.cuda
def test_conformance_patterns_through_the_harness_on_card(cuda):
    from repro_torch.testing import (EngineConfig, build_conformance,
                                     conformance_names, harness)
    cfgs = [EngineConfig(optimize=True, use_kernel=True, jit=False,
                         tile_size=t) for t in (64, 16384)]
    for name in conformance_names():
        case = build_conformance(name)
        assert harness.check_pattern_parity(
            case.pattern, case.env, n=case.n, configs=cfgs,
            max_tile_fill=case.max_tile_fill) > 0
    checked, ran = harness.check_sharded_parity()
    assert ran == [1, 2, 4, 8] and checked > 0

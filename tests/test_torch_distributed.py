"""The port's sharded engine (repro_torch.distributed) against the JAX
package's on the CPU.

  * the exchange primitives and both index codecs against the reference's
    functions on the same seeded inputs, in-process (they need no
    collective), in the reference's one-shard form and batched over a
    leading shard axis;
  * ``ShardedEngine`` at m in {1, 2, 4, 8} logical shards against the
    NumPy oracle: gathers bit for bit (OOB, empty, boundary and owner-hot
    streams included), integer RMWs bit for bit for every ``RMW_OPS``,
    float ADD to rtol 1e-5 / atol 1e-6; with the kernels' plain versions
    (``use_kernel=True`` on the CPU) and over a two-device-entry mesh;
  * ``ShardStats`` equal to the reference's: the reference runs in a
    subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
    (mesh 8 in tier-1, {1, 2, 4} with ``--runslow``);
  * ``Scheduler(engine=ShardedEngine(mesh=1)).explain().render()`` equal to
    the reference's, line for line, and mixed windows over a mesh;
  * the exchange-plan cache: a stream tensor changed in place between two
    calls is measured anew.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Scheduler as RefScheduler
from repro.distributed import ShardedEngine as RefShardedEngine
from repro.distributed import exchange as rx
from repro.distributed import mesh as rmesh
from repro.testing import fuzzer as rfuzzer
from repro_torch.core import Scheduler, isa
from repro_torch.distributed import (Mesh, ShardedEngine, as_mesh,
                                     device_mesh, shard_row_ranges)
from repro_torch.distributed import exchange as px
from repro_torch.testing import fuzzer, harness
from spawn_once import once

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = (1, 2, 4, 8)
TILE = 256


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _equal(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool or got.dtype == bool:
        assert np.array_equal(got.astype(bool), want.astype(bool)), what
    else:
        assert np.array_equal(got.astype(np.int64) if got.dtype.kind in "iu"
                              else got, want.astype(np.int64)
                              if want.dtype.kind in "iu" else want), what


def _stream(seed, L, hi):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, size=L).astype(np.int32),
            rng.random(L) < 0.8)


# ---------------------------------------------------------------------------
# exchange primitives vs the reference
# ---------------------------------------------------------------------------

SHAPES = [(seed, L, ns, rows_per) for seed, (L, ns, rows_per) in enumerate(
    [(50, 4, 13), (64, 8, 33), (7, 2, 5), (200, 8, 4096), (33, 1, 64)])]


@pytest.mark.parametrize("seed,L,ns,rows_per", SHAPES)
def test_partition_dedup_and_counts_match_reference(seed, L, ns, rows_per):
    idx, valid = _stream(seed, L, ns * rows_per)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(valid)
    for cap in (None, 8, 16):
        want = rx.partition_by_owner(jnp.asarray(idx), jnp.asarray(valid),
                                     rows_per=rows_per, num_shards=ns,
                                     capacity=cap)
        got = px.partition_by_owner(ti, tv, rows_per=rows_per,
                                    num_shards=ns, capacity=cap)
        for g, w in zip(got, want):
            _equal(g, w, f"partition cap={cap}")
    for g, w in zip(px.dedup_stream(ti, tv),
                    rx.dedup_stream(jnp.asarray(idx), jnp.asarray(valid))):
        _equal(g, w, "dedup")
    _equal(px.masked_unique_count(ti, tv),
           rx.masked_unique_count(jnp.asarray(idx), jnp.asarray(valid)))
    assert px.bucket_capacity(L) == rx.bucket_capacity(L)


@pytest.mark.parametrize("op", isa.RMW_OPS)
@pytest.mark.parametrize("dtype", ["i32", "u32", "f32"])
def test_combine_duplicates_matches_reference(op, dtype):
    if dtype == "f32" and op in ("AND", "OR", "XOR"):
        return
    rng = np.random.default_rng(3)
    idx, valid = _stream(4, 60, 40)
    if dtype == "f32":
        vals = rng.integers(-8, 8, size=(60, 3)).astype(np.float32)
    else:
        vals = rng.integers(0, 2 ** 31, size=(60, 3)).astype(
            np.int32 if dtype == "i32" else np.uint32)
    want = rx.combine_duplicates(jnp.asarray(idx), jnp.asarray(vals),
                                 jnp.asarray(valid), op=op)
    got = px.combine_duplicates(
        torch.from_numpy(idx), torch.from_numpy(vals.view(
            np.int32) if dtype == "u32" else vals),
        torch.from_numpy(valid), op=op, unsigned=dtype == "u32")
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = _np(g).view(np.uint32) if w.dtype == np.uint32 else g
        _equal(g, w, f"combine {op} {dtype}")


@pytest.mark.parametrize("codec", ["bitmap", "delta"])
@pytest.mark.parametrize("seed,L,ns,rows_per", SHAPES)
def test_codecs_and_payload_match_reference(codec, seed, L, ns, rows_per):
    idx, valid = _stream(seed, L, ns * rows_per)
    u, uv, _, _ = rx.dedup_stream(jnp.asarray(idx), jnp.asarray(valid))
    cap = 16
    sidx, sval, order, slot, _ = rx.partition_by_owner(
        u, uv, rows_per=rows_per, num_shards=ns, capacity=cap)
    enc, dec, _ = rx.CODECS[codec]
    penc, pdec, _ = px.CODECS[codec]
    words = enc(sidx, sval, rows_per=rows_per, num_shards=ns)
    pwords = penc(torch.from_numpy(np.asarray(sidx)),
                  torch.from_numpy(np.asarray(sval)), rows_per=rows_per,
                  num_shards=ns)
    _equal(_np(pwords).view(np.asarray(words).dtype), words, "encode")
    for g, w in zip(pdec(pwords, rows_per=rows_per, num_shards=ns,
                         capacity=cap),
                    dec(words, rows_per=rows_per, num_shards=ns,
                        capacity=cap)):
        _equal(g, w, "decode")
    assert px.codec_wire_words(codec, rows_per=rows_per, capacity=cap) == \
        rx.codec_wire_words(codec, rows_per=rows_per, capacity=cap)
    vals = np.random.default_rng(seed).normal(size=(L, 2)).astype(
        np.float32)
    t_order, t_slot = (torch.from_numpy(np.asarray(order)),
                       torch.from_numpy(np.asarray(slot)))
    packed = px.pack_payload(torch.from_numpy(vals), t_order, t_slot,
                             num_shards=ns, capacity=cap)
    rpacked = rx.pack_payload(jnp.asarray(vals), order, slot, num_shards=ns,
                              capacity=cap)
    _equal(packed, rpacked, "pack")
    _equal(px.unpack_result(packed, t_order, t_slot,
                            torch.from_numpy(valid)),
           rx.unpack_result(rpacked, order, slot, jnp.asarray(valid)),
           "unpack")


def test_bitmap_codec_keeps_bit_31():
    """The bitmap's words are uint32 bits in int32 containers: a row at
    bit 31 of a word round-trips and matches the reference's word."""
    rows_per, ns = 64, 2
    idx = np.array([31, 63, 64 + 31], np.int32)
    valid = np.ones(3, bool)
    sidx, sval, *_ = rx.partition_by_owner(
        jnp.asarray(idx), jnp.asarray(valid), rows_per=rows_per,
        num_shards=ns, capacity=4)
    words = rx.encode_bitmap(sidx, sval, rows_per=rows_per, num_shards=ns)
    pw = px.encode_bitmap(torch.from_numpy(np.asarray(sidx)),
                          torch.from_numpy(np.asarray(sval)),
                          rows_per=rows_per, num_shards=ns)
    assert np.array_equal(_np(pw).view(np.uint32), np.asarray(words))
    assert (_np(pw) < 0).sum() == 3
    local, ok = px.decode_bitmap(pw, rows_per=rows_per, num_shards=ns,
                                 capacity=4)
    assert _np(local)[_np(ok)].tolist() == [31, 63, 31]


def test_batched_forms_equal_per_shard_forms():
    """The engine calls each primitive once over an ``(m, L)`` stream:
    every row equals the one-shard call on that row."""
    ns, rows_per, L = 4, 20, 30
    rows = [_stream(s, L, ns * rows_per) for s in range(ns)]
    idx = torch.from_numpy(np.stack([r[0] for r in rows]))
    valid = torch.from_numpy(np.stack([r[1] for r in rows]))
    vals = torch.arange(ns * L * 2, dtype=torch.float32).reshape(ns, L, 2)
    batched = [
        px.dedup_stream(idx, valid),
        px.partition_by_owner(idx, valid, rows_per=rows_per, num_shards=ns,
                              capacity=8),
        px.combine_duplicates(idx, vals, valid, op="ADD"),
        (px.masked_unique_count(idx, valid),)]
    for s in range(ns):
        single = [
            px.dedup_stream(idx[s], valid[s]),
            px.partition_by_owner(idx[s], valid[s], rows_per=rows_per,
                                  num_shards=ns, capacity=8),
            px.combine_duplicates(idx[s], vals[s], valid[s], op="ADD"),
            (px.masked_unique_count(idx[s], valid[s]),)]
        for b, one in zip(batched, single):
            for tb, t1 in zip(b, one):
                assert torch.equal(tb[s], t1)


def test_mesh_helpers():
    for n, m in ((257, 8), (10, 8), (64, 3), (5, 1)):
        assert shard_row_ranges(n, m) == rmesh.shard_row_ranges(n, m)
    mesh = as_mesh(8, device="cpu")
    assert mesh.num_shards == 8 and mesh.device == torch.device("cpu")
    assert as_mesh(None, device="cpu").num_shards == 1
    assert as_mesh(mesh) is mesh
    assert device_mesh(3, device="cpu").shape == {"shards": 3}
    with pytest.raises(ValueError):
        Mesh(0, torch.device("cpu"))
    with pytest.raises(TypeError):
        as_mesh("eight")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedEngine(mesh=2)


# ---------------------------------------------------------------------------
# the sharded engine vs the NumPy oracle
# ---------------------------------------------------------------------------

def _check_cases(eng, cases):
    for k, case in enumerate(cases):
        if case[0] == "gather":
            _, table, idx = case
            got = eng.sharded_gather(table, idx)
            want = table[np.clip(idx, 0, table.shape[0] - 1)]
            assert np.array_equal(_np(got), want), k
        else:
            _, table, idx, vals, op = case
            got = _np(eng.sharded_rmw(table, idx, vals, op=op))
            want = harness._np_rmw(table, idx, vals, op)
            if table.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert np.array_equal(got.view(want.dtype), want), (k, op)


def _extra_cases(seed=1):
    """Beyond ``default_sharded_cases``: u32 MIN/MAX, a 2-D integer RMW,
    a big sparse table (the delta codec) and a 2-D f32 ADD."""
    rng = np.random.default_rng(seed)
    tu = rng.integers(0, 2 ** 32, size=(300,), dtype=np.uint64).astype(
        np.uint32)
    t2i = rng.integers(0, 2 ** 20, size=(257, 4)).astype(np.int32)
    big = np.arange(65536, dtype=np.float32)
    t2f = rng.integers(-50, 50, size=(300, 8)).astype(np.float32)
    s = rng.integers(-20, 320, size=500).astype(np.int32)
    out = [("rmw", tu, s, rng.integers(0, 2 ** 32, size=500, dtype=np.uint64)
            .astype(np.uint32), op) for op in ("MIN", "MAX", "AND")]
    out.append(("rmw", t2i, rng.integers(0, 257, size=400).astype(np.int32),
                rng.integers(0, 9, size=(400, 4)).astype(np.int32), "ADD"))
    out.append(("gather", big, rng.integers(0, 65536, size=100).astype(
        np.int32)))
    out.append(("gather", t2f, s))
    out.append(("rmw", t2f, s, rng.integers(-4, 4, size=(500, 8)).astype(
        np.float32), "ADD"))
    return out


@pytest.mark.parametrize("m", MESHES)
def test_sharded_engine_matches_oracle(m):
    eng = ShardedEngine(mesh=m, device="cpu")
    _check_cases(eng, harness.default_sharded_cases(0) + _extra_cases())
    st = eng.last_shard_stats
    assert st.sent.shape == (m, m) and st.received.shape == (m,)


@pytest.mark.parametrize("m", MESHES)
def test_sharded_engine_kernel_path_and_device_entries(m):
    """``use_kernel=True`` (the kernels' plain versions on the CPU), by
    shard count and by an explicit one-device ``Mesh``."""
    cases = harness.default_sharded_cases(2) + _extra_cases(2)
    _check_cases(ShardedEngine(mesh=m, use_kernel=True, device="cpu"),
                 cases)
    one = Mesh(m, torch.device("cpu"))
    _check_cases(ShardedEngine(mesh=one, use_kernel=True, device="cpu"),
                 cases)


@pytest.mark.parametrize("m", MESHES)
def test_logical_mesh_holds_one_copy_of_the_table(m, monkeypatch):
    """A logical mesh lies on one device: every shard of
    ``device_mesh(m)`` is on it, and each call hands the owners' one
    bulk op the caller's table itself, never a copy per device."""
    from repro_torch.distributed import engine as dengine
    mesh = device_mesh(m, device="cpu")
    assert mesh.device == torch.device("cpu")
    assert not hasattr(mesh, "devices") and not hasattr(mesh, "device_of")
    eng = ShardedEngine(mesh=mesh, use_kernel=True, device="cpu")
    seen = []
    for name in ("bulk_gather", "bulk_rmw"):
        real = getattr(dengine.bulk_ops, name)

        def spy(table, *a, _real=real, _name=name, **k):
            seen.append((_name, table))
            return _real(table, *a, **k)
        monkeypatch.setattr(dengine.bulk_ops, name, spy)
    table = torch.arange(257 * 4, dtype=torch.float32).reshape(257, 4)
    idx = torch.from_numpy(np.random.default_rng(m).integers(
        0, 257, size=300).astype(np.int32))
    eng.sharded_gather(table, idx)
    eng.sharded_rmw(table, idx, torch.ones(300, 4), op="ADD")
    assert [n for n, _ in seen] == ["bulk_gather", "bulk_rmw"]
    assert all(t is table for _, t in seen)


@pytest.mark.parametrize("codec", ["raw", "bitmap", "delta"])
def test_logical_route_lands_in_the_start_stage(codec):
    """On a logical mesh the exchange is done at once, so the start stage
    also decodes and lands the indices, counts them and places each lane:
    the finish stage is left the owners' bulk op and the unpacking."""
    eng = ShardedEngine(mesh=4, device="cpu")
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(257, 2)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 257, 300).astype(np.int32))
    fl = eng.gather_start(table, idx, codec=codec)
    assert {"cat_idx", "n_recv", "n_uniq", "lane_pos"} <= set(fl.route)
    assert fl.wire[0].is_completed()
    assert torch.equal(eng.gather_finish(table, fl), table[idx.long()])
    fl = eng.rmw_start(table, idx, torch.ones(300, 2), op="ADD",
                       codec=codec)
    assert {"cat_idx", "n_recv", "n_uniq", "src"} <= set(fl.route)
    want = table.clone().index_add_(0, idx.long(), torch.ones(300, 2))
    torch.testing.assert_close(eng.rmw_finish(table, fl), want)


@pytest.mark.parametrize("placement,codec", [
    ("block", "raw"), ("owner", "raw"), ("block", "bitmap"),
    ("owner", "delta"), ("owner", "bitmap")])
def test_pinned_exchange_plans_agree(placement, codec):
    eng = ShardedEngine(mesh=4, device="cpu")
    rng = np.random.default_rng(9)
    table = rng.normal(size=(1000, 3)).astype(np.float32)
    idx = rng.integers(-5, 1010, size=700).astype(np.int32)
    got = eng.sharded_gather(table, idx, placement=placement, codec=codec)
    assert np.array_equal(_np(got), table[np.clip(idx, 0, 999)])
    st = eng.last_shard_stats
    assert (st.placement, st.codec) == (placement, codec)
    ti = rng.integers(0, 100, size=(1000,)).astype(np.int32)
    vals = rng.integers(0, 100, size=700).astype(np.int32)
    new = eng.sharded_rmw(ti, idx, vals, op="XOR", placement=placement,
                          codec=codec)
    assert np.array_equal(_np(new), harness._np_rmw(ti, idx, vals, "XOR"))


def test_split_route_exec_equals_fused():
    eng = ShardedEngine(mesh=4, device="cpu")
    rng = np.random.default_rng(5)
    table = rng.normal(size=(300, 2)).astype(np.float32)
    idx = rng.integers(0, 300, size=250).astype(np.int32)
    valid = rng.random(250) < 0.7
    fl = eng.gather_start(table, idx, valid=valid)
    got = eng.gather_finish(table, fl)
    want = np.where(valid[:, None], table[idx], 0)
    assert np.array_equal(_np(got), want)
    assert eng.last_shard_stats.overlap_fraction == 1.0
    ti = np.zeros(300, np.int32)
    vals = rng.integers(0, 9, size=250).astype(np.int32)
    fl = eng.rmw_start(ti, idx, vals, op="ADD", valid=valid)
    new = eng.rmw_finish(ti, fl)
    assert np.array_equal(_np(new), harness._np_rmw(ti, idx, vals, "ADD",
                                                    cond=valid))
    assert eng.sharded_gather(table, np.zeros(0, np.int32)).shape == (0, 2)
    assert eng.last_shard_stats is None


def test_exchange_cache_sees_in_place_mutation():
    """The plan cache is keyed on the tensor and its ``_version``: a
    stream changed in place is measured anew, so a capacity measured for
    its old contents never drops lanes of the new."""
    eng = ShardedEngine(mesh=4, device="cpu")
    table = torch.arange(400, dtype=torch.float32)
    # every shard's slice asks its own rows: nothing spills, capacity 8
    idx = torch.arange(200, dtype=torch.int32) * 2
    assert torch.equal(eng.sharded_gather(table, idx), table[idx.long()])
    assert eng.last_shard_stats.local_fraction == 1.0
    # reversed in place: every slice asks another shard for 50 rows, which
    # a replayed capacity of 8 (block placement) would drop
    idx[:] = 399 - torch.arange(200, dtype=torch.int32) * 2
    assert torch.equal(eng.sharded_gather(table, idx), table[idx.long()])
    st = eng.last_shard_stats
    assert int(st.received.sum()) == int(st.sent.sum()) == 200
    # an unchanged tensor replays its measurement
    eng.sharded_gather(table, idx)
    assert len(eng._xplan_cache) == 1


def test_shard_stats_stay_on_the_device_until_read():
    eng = ShardedEngine(mesh=2, device="cpu")
    eng.sharded_gather(np.arange(10.0), np.arange(10))
    st = eng.last_shard_stats
    assert st._device is not None and "<device>" in repr(st)
    assert st.local_fraction == 1.0 and st.num_shards == 2
    assert st._device is None and "<host>" in repr(st)


# ---------------------------------------------------------------------------
# ShardStats against the reference (subprocess with forced host devices)
# ---------------------------------------------------------------------------

def _stats_record(st):
    if st is None:
        return None
    return {"sent": st.sent.tolist(), "received": st.received.tolist(),
            "unique": st.unique.tolist(), "capacity": st.capacity,
            "codec": st.codec, "placement": st.placement,
            "idx_bytes": st.idx_bytes, "idx_bytes_raw": st.idx_bytes_raw,
            "bytes_on_wire": st.bytes_on_wire}


def _stats_run(eng):
    out = []
    for case in harness.default_sharded_cases(0) + _extra_cases():
        if case[0] == "gather":
            eng.sharded_gather(case[1], case[2])
        else:
            eng.sharded_rmw(case[1], case[2], case[3], op=case[4])
        out.append(_stats_record(eng.last_shard_stats))
    return out


@pytest.fixture(scope="module")
def ref_stats(request, tmp_path_factory):
    sizes = (1, 2, 4, 8) if request.config.getoption("--runslow") else (8,)
    return once(tmp_path_factory, f"ref_stats-{len(sizes)}",
                lambda: _ref_stats(sizes))


def _ref_stats(sizes):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--ref-stats"]
        + [str(m) for m in sizes], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _check_stats(m, ref_stats):
    got = _stats_run(ShardedEngine(mesh=m, device="cpu"))
    want = ref_stats[str(m)]
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, (k, g, w)


def test_shard_stats_match_reference_mesh8(ref_stats):
    _check_stats(8, ref_stats)


@pytest.mark.slow
@pytest.mark.parametrize("m", (1, 2, 4))
def test_shard_stats_match_reference(m, ref_stats):
    _check_stats(m, ref_stats)


# ---------------------------------------------------------------------------
# the "sharded" plan backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_explain_at_mesh1_renders_as_reference(seed):
    from test_torch_scheduler import submit_mixed
    case = rfuzzer.generate_mixed_case(seed)
    port = Scheduler(engine=ShardedEngine(mesh=1, tile_size=TILE,
                                          device="cpu"))
    ref = RefScheduler(engine=RefShardedEngine(mesh=1, tile_size=TILE))
    submit_mixed(port, case)
    submit_mixed(ref, case, port=False)
    pe, re_ = port.explain(), ref.explain()
    assert pe.render() == re_.render()
    assert any(n.kind == "sharded" for n in pe.plan.roots)
    report = port.flush()
    assert report.plan is pe.plan
    assert report.shard_stats and report.exchange_summary()["nodes"] == \
        len(report.shard_stats)


@pytest.mark.parametrize("m", (2, 4, 8))
@pytest.mark.parametrize("seed", range(6))
def test_mixed_windows_over_a_mesh(seed, m):
    sched = Scheduler(engine=ShardedEngine(mesh=m, tile_size=TILE,
                                           device="cpu"))
    checked, report = harness.check_mixed_flush_parity(
        fuzzer.generate_mixed_case(seed), tile_size=TILE, scheduler=sched,
        device="cpu")
    assert checked > 0 and report.shard_stats


if __name__ == "__main__":
    # the reference's ShardStats, for the module fixture above
    sizes = [int(a) for a in sys.argv[2:]]
    print(json.dumps({str(m): _stats_run(RefShardedEngine(mesh=m))
                      for m in sizes}))

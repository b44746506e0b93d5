"""Rank-side work of ``test_torch_process_mesh.py``.

Runs in the processes ``repro_torch.distributed.spawn.run_ranks`` spawns
(one per rank of a gloo group on the CPU), so it imports torch, NumPy and
``repro_torch`` only. Every rank runs every case over a ``ProcessMesh``
and writes what it saw to ``<out>/rank<r>.pkl``; the test module holds
those against the reference and the logical mesh.
"""
import pickle
from pathlib import Path

import numpy as np
import torch

#: every (placement, codec) pin
PINS = [(p, c) for p in ("block", "owner") for c in ("raw", "bitmap", "delta")]


def pin_inputs():
    """A gather table and stream, and an integer RMW, for the pins."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(1000, 3)).astype(np.float32)
    idx = rng.integers(-5, 1010, size=700).astype(np.int32)
    ti = rng.integers(0, 100, size=(1000,)).astype(np.int32)
    vals = rng.integers(0, 100, size=700).astype(np.int32)
    return table, idx, ti, vals


def split_inputs():
    """A masked gather and a masked ADD for the start/finish stages."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(300, 2)).astype(np.float32)
    idx = rng.integers(0, 300, size=250).astype(np.int32)
    valid = rng.random(250) < 0.7
    ti = np.zeros(300, np.int32)
    vals = rng.integers(0, 9, size=250).astype(np.int32)
    return table, idx, valid, ti, vals


def stats_record(st):
    """The fields of ``ShardStats`` the reference also has."""
    if st is None:
        return None
    return {"sent": st.sent.tolist(), "received": st.received.tolist(),
            "unique": st.unique.tolist(), "capacity": st.capacity,
            "codec": st.codec, "placement": st.placement,
            "idx_bytes": st.idx_bytes, "idx_bytes_raw": st.idx_bytes_raw,
            "bytes_on_wire": st.bytes_on_wire}


def _np(t, like):
    from repro_torch.core import interop
    return interop.to_numpy(t, np.asarray(like).dtype)


class OwnerCalls:
    """Records the table each owner-local bulk op is handed."""

    def __init__(self, bulk_ops):
        self.calls = []
        self._gather, self._rmw = bulk_ops.bulk_gather, bulk_ops.bulk_rmw

        def gather(table, *a, **k):
            self.calls.append(("gather", tuple(table.shape)))
            return self._gather(table, *a, **k)

        def rmw(table, *a, **k):
            self.calls.append(("rmw", tuple(table.shape)))
            return self._rmw(table, *a, **k)
        bulk_ops.bulk_gather, bulk_ops.bulk_rmw = gather, rmw

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def _run(eng, mesh, case, owner):
    """One case on this rank: its block or slice, the whole result
    (``gather_blocks``), the stats and the owner calls."""
    from repro_torch.distributed import gather_blocks
    table = np.asarray(case[1])
    n_rows = table.shape[0]
    lo, hi = eng.rank_rows(n_rows)
    if case[0] == "gather":
        mine = eng.sharded_gather(table[lo:hi], case[2], n_rows=n_rows)
    else:
        mine = eng.sharded_rmw(table[lo:hi], case[2], case[3], op=case[4],
                               n_rows=n_rows)
    st = eng.last_shard_stats
    return {"mine": _np(mine, table),
            "whole": _np(gather_blocks(mine, mesh), table),
            "stats": stats_record(st),
            "transport": None if st is None else st.transport,
            "collectives": None if st is None else st.collectives,
            "owner": owner.take(), "slice": (lo, hi)}


def _swaps(mesh, rank, world):
    """``all_to_all`` on even buckets (synchronous and in flight) and on
    ragged ones: bucket j of rank r holds r * 100 + j."""
    from repro_torch.distributed import all_to_all
    even = torch.tensor([rank * 100 + j for j in range(world)
                         for _ in range(3)], dtype=torch.int64)
    got = all_to_all(even, mesh)
    ex = all_to_all(even.to(torch.float32).reshape(-1, 1), mesh,
                    async_op=True)
    flight = ex.wait()
    # ragged: rank r sends j + 1 rows to rank j
    send = [j + 1 for j in range(world)]
    ragged = torch.cat([torch.full((j + 1,), rank * 100 + j)
                        for j in range(world)])
    got_r = all_to_all(ragged, mesh, send_counts=send,
                       recv_counts=[rank + 1] * world)
    return {"even": got.tolist(), "flight": flight.reshape(-1).tolist(),
            "completed": ex.is_completed(), "ragged": got_r.tolist()}


def rank_main(rank, world, cases_path, out_dir, corrupt_rank):
    from repro_torch.core import bulk_ops
    from repro_torch.distributed import (ShardedEngine, exchange,
                                         gather_blocks, process_mesh)
    from repro_torch.testing import harness
    mesh = process_mesh(device="cpu")
    owner = OwnerCalls(bulk_ops)
    cases = pickle.loads(Path(cases_path).read_bytes())
    eng = ShardedEngine(mesh, device="cpu")
    out = {"world": world, "rank": rank, "device": str(eng.device),
           "transport": eng.transport}
    out["cases"] = [_run(eng, mesh, c, owner) for c in cases]
    keng = ShardedEngine(mesh, use_kernel=True, device="cpu")
    out["kernel_path"] = [_run(keng, mesh, c, owner)["whole"]
                          for c in cases]
    table, idx, ti, vals = pin_inputs()
    out["pins"] = []
    for k, (placement, codec) in enumerate(PINS):
        lo, hi = eng.rank_rows(table.shape[0])
        g = eng.sharded_gather(table[lo:hi], idx, placement=placement,
                               codec=codec, n_rows=table.shape[0])
        gst = stats_record(eng.last_shard_stats)
        gcoll = eng.last_shard_stats.collectives
        r = eng.sharded_rmw(ti[lo:hi], idx, vals, op="XOR",
                            placement=placement, codec=codec,
                            n_rows=ti.shape[0])
        out["pins"].append({
            "gather": _np(gather_blocks(g, mesh), table), "gather_stats": gst,
            "gather_collectives": gcoll,
            "rmw": _np(gather_blocks(r, mesh), ti),
            "rmw_stats": stats_record(eng.last_shard_stats)})
    owner.take()
    table, idx, valid, ti, vals = split_inputs()
    n_rows = table.shape[0]
    lo, hi = eng.rank_rows(n_rows)
    fl = eng.gather_start(table[lo:hi], idx, valid=valid, n_rows=n_rows)
    g_split = eng.gather_finish(table[lo:hi], fl)
    g_overlap = eng.last_shard_stats.overlap_fraction
    g_fused = eng.sharded_gather(table[lo:hi], idx, valid=valid,
                                 n_rows=n_rows)
    fl = eng.rmw_start(ti[lo:hi], idx, vals, op="ADD", valid=valid,
                       n_rows=n_rows)
    r_split = eng.rmw_finish(ti[lo:hi], fl)
    r_overlap = eng.last_shard_stats.overlap_fraction
    r_fused = eng.sharded_rmw(ti[lo:hi], idx, vals, op="ADD", valid=valid,
                              n_rows=n_rows)
    empty = eng.sharded_gather(table[lo:hi], np.zeros(0, np.int32),
                               n_rows=n_rows)
    out["split"] = {
        "gather": _np(gather_blocks(g_split, mesh), table),
        "gather_fused": _np(gather_blocks(g_fused, mesh), table),
        "rmw": _np(gather_blocks(r_split, mesh), ti),
        "rmw_fused": _np(gather_blocks(r_fused, mesh), ti),
        "overlap": (g_overlap, r_overlap), "empty": tuple(empty.shape),
        "empty_stats": eng.last_shard_stats}
    out["swaps"] = _swaps(mesh, rank, world)
    try:
        eng.sharded_gather(table, idx, n_rows=table.shape[0])
        out["whole_table"] = "accepted"
    except ValueError as e:
        out["whole_table"] = str(e)
    out["parity"] = harness.check_sharded_parity(mesh=mesh)
    if rank == corrupt_rank:
        # the negative probe: one bucket of this rank's exchanges is off
        good = exchange.all_to_all

        def corrupt(t):
            t = t.clone()
            if t.numel():
                t.view(-1)[0] += 1
            return t

        def bad(x, m, **kw):
            got = good(x, m, **kw)
            return got.then(corrupt) if kw.get("async_op") else corrupt(got)
        exchange.all_to_all = bad
    try:
        harness.check_sharded_parity(mesh=mesh)
        out["probe"] = None
    except harness.ParityError as e:
        out["probe"] = str(e)
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    return True


def fail_on_rank1(rank, world, how):
    """Rank 1 raises, dies or hangs; rank 0 returns."""
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        if how == "die":
            import os
            os._exit(3)
        import time
        time.sleep(120)
    return rank

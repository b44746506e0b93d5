"""Port reorder stage (repro_torch.core.reorder) vs repro.core.reorder.

Streams are made from a seed with NumPy and fed to both. Everything here is
integer index arithmetic, so every array must match bit for bit: sort
permutations (the sort is stable on both sides), coalesce outputs, and all
six arrays of the row-table plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reorder as jr
from repro_torch.core import reorder


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _stream(kind: str, n: int, rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        s = rng.integers(0, rows, size=n)
    elif kind == "zipf":
        s = rng.zipf(1.3, size=n) % rows
    elif kind == "dups":
        s = rng.integers(0, max(rows // 16, 1), size=n)
    else:  # clustered: most blocks empty
        s = rng.integers(0, 8, size=n) + rows // 2
    return s.astype(np.int32)


@pytest.mark.parametrize("kind", ["uniform", "zipf", "dups"])
def test_sort_indices_stable(kind):
    s = _stream(kind, 300, 64)
    ws, wp = jr.sort_indices(jnp.asarray(s))
    gs, gp = reorder.sort_indices(_t(s))
    _eq(gs, ws)
    _eq(gp, wp)


@pytest.mark.parametrize("kind,size", [
    ("uniform", None), ("zipf", None), ("dups", None),
    ("dups", 400),        # padded past the stream length
    ("uniform", 64),      # overflow: more distinct values than size
])
def test_coalesce(kind, size):
    s = _stream(kind, 300, 256)
    if size is not None and size < len(np.unique(s)):
        with pytest.raises(ValueError, match="distinct values"):
            jr.coalesce(jnp.asarray(s), size=size)
        with pytest.raises(ValueError, match="distinct values"):
            reorder.coalesce(_t(s), size=size)
        return
    for got, want in zip(reorder.coalesce(_t(s), size=size),
                         jr.coalesce(jnp.asarray(s), size=size)):
        _eq(got, want)


def test_coalesce_empty_stream():
    for size in (None, 5):
        e = np.zeros((0,), np.int32)
        for got, want in zip(reorder.coalesce(_t(e), size=size),
                             jr.coalesce(jnp.asarray(e), size=size)):
            _eq(got, want)


def test_coalesce_streams_and_gain():
    streams = [_stream("uniform", n, 50, seed=n) for n in (40, 0, 77)]
    gu, ginv, gn = reorder.coalesce_streams([_t(s) for s in streams])
    wu, winv, wn = jr.coalesce_streams([jnp.asarray(s) for s in streams])
    _eq(gu, wu)
    _eq(gn, wn)
    for g, w in zip(ginv, winv):
        _eq(g, w)
    assert reorder.cross_stream_gain([_t(s) for s in streams]) == \
        jr.cross_stream_gain(streams)
    s0 = streams[0]
    assert float(reorder.coalescing_factor(_t(s0))) == \
        pytest.approx(len(s0) / len(np.unique(s0)))
    gu, ginv, gn = reorder.coalesce_streams([], size=3)
    wu, winv, wn = jr.coalesce_streams([], size=3)
    _eq(gu, wu)
    _eq(gn, wn)


PLAN_FIELDS = ("tile_block", "tile_first", "offsets", "src_pos", "valid",
               "n_tiles")

PLAN_CASES = [
    # (kind, T, n_rows, block_rows, lanes)
    ("uniform", 300, 256, 32, 8),
    ("zipf", 300, 256, 64, 16),
    ("dups", 200, 256, 32, 4),
    ("clustered", 100, 512, 32, 8),      # most blocks empty
    ("uniform", 50, 70, 32, 8),          # partial last block (n=70)
    ("uniform", 1, 70, 32, 8),           # T=1
    ("uniform", 64, 1024, 128, 64),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_row_table_plan(case):
    kind, T, n_rows, block_rows, lanes = case
    s = np.sort(_stream(kind, T, n_rows, seed=T))
    got = reorder.make_row_table_plan(_t(s), n_rows=n_rows,
                                      block_rows=block_rows, lanes=lanes)
    want = jr.make_row_table_plan(jnp.asarray(s), n_rows=n_rows,
                                  block_rows=block_rows, lanes=lanes)
    for f in PLAN_FIELDS:
        _eq(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == {"tile_first": torch.bool,
                                         "valid": torch.bool}.get(
                                             f, torch.int32), f
    assert (got.block_rows, got.lanes, got.num_blocks, got.num_tiles) == \
        (want.block_rows, want.lanes, want.num_blocks, want.num_tiles)


def test_row_table_plan_empty_stream():
    e = np.zeros((0,), np.int32)
    got = reorder.make_row_table_plan(_t(e), n_rows=64, block_rows=32,
                                      lanes=8)
    want = jr.make_row_table_plan(jnp.asarray(e), n_rows=64, block_rows=32,
                                  lanes=8)
    for f in PLAN_FIELDS:
        _eq(getattr(got, f), getattr(want, f))


def test_interleave_and_shard_helpers():
    s = np.sort(_stream("uniform", 200, 512))
    for nc in (2, 4):
        _eq(reorder.channel_of(_t(s), block_rows=32, num_channels=nc),
            jr.channel_of(jnp.asarray(s), block_rows=32, num_channels=nc))
        _eq(reorder.interleave_round_robin(_t(s), block_rows=32,
                                           num_channels=nc),
            jr.interleave_round_robin(jnp.asarray(s), block_rows=32,
                                      num_channels=nc))
    for got, want in zip(
            reorder.shard_bulk_indices(_t(s), num_shards=3, n_rows=512),
            jr.shard_bulk_indices(jnp.asarray(s), num_shards=3, n_rows=512)):
        _eq(got, want)


# --- the plan layout the RMW kernel relies on -------------------------------
# (kernels/csrc/row_table_rmw.cu applies a lane at once when no neighbour in
# its run shares its row and its offset is not 0; that is exact only if the
# plan keeps these guarantees)

LAYOUT_STREAMS = {
    # name: (table rows, stream maker)
    "out of range clamped": (200, lambda rng: np.concatenate([
        -rng.integers(1, 50, size=30), rng.integers(0, 200, size=150),
        200 + rng.integers(0, 50, size=40)])),
    "empty segments": (300, lambda rng: rng.integers(0, 40, size=400)),
    "partial last block": (250, lambda rng: rng.integers(0, 250, size=90)),
    "one lane per block": (640, lambda rng: np.arange(5, 640, 64)),
    "blocks over many tiles": (256, lambda rng: np.concatenate([
        64 + rng.integers(0, 64, size=100), rng.integers(0, 256, size=20)])),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(LAYOUT_STREAMS))
def test_rmw_plan_layout(name, seed):
    """Through bulk_rmw's own steps (stores drop, coalesce_updates,
    plan_updates): within each block's run the valid offsets do not
    decrease; every invalid lane sits at offset 0, holds the identity and
    comes after the run's valid lanes; tile_first opens each block exactly
    once; so a row with offset > 0 is touched by consecutive lanes only."""
    from repro_torch.core.bulk_ops import coalesce_updates
    from repro_torch.core.isa import rmw_identity
    from repro_torch.kernels.scatter_rmw.ops import plan_updates
    n, make = LAYOUT_STREAMS[name]
    rng = np.random.default_rng(seed)
    block_rows, lanes, op = 64, 16, "MIN"
    idx = torch.as_tensor(make(rng).astype(np.int32))
    vals = torch.as_tensor(rng.normal(size=(idx.shape[0], 2))
                           .astype(np.float32))
    idx = torch.where((idx >= 0) & (idx < n), idx, n)     # stores drop
    seg_dest, packed = coalesce_updates(idx, vals, n=n, op=op)
    plan, v = plan_updates(n, seg_dest, packed, op=op,
                           block_rows=block_rows, lanes=lanes)
    ident = float(rmw_identity(op, torch.float32))
    tile_block = plan.tile_block.numpy()
    first = plan.tile_first.numpy()
    offsets = plan.offsets.numpy()
    valid = plan.valid.numpy()
    v = v.numpy().reshape(plan.num_tiles, lanes, -1)
    assert first[0] and all(first[1:] == (tile_block[1:] != tile_block[:-1]))
    opened = tile_block[first]
    assert len(set(opened.tolist())) == len(opened), "a block opened twice"
    starts = np.flatnonzero(first).tolist() + [plan.num_tiles]
    for t0, t1 in zip(starts[:-1], starts[1:]):
        off = offsets[t0:t1].reshape(-1)
        ok = valid[t0:t1].reshape(-1)
        if not ok.all():
            k = int(np.argmin(ok))               # first invalid lane
            assert not ok[k:].any(), "a valid lane after an invalid one"
        assert np.all(np.diff(off[ok]) >= 0), "valid offsets decrease"
        assert np.all(off[~ok] == 0)
        assert np.all(v[t0:t1].reshape(-1, v.shape[-1])[~ok] == ident)
        for o in np.unique(off[off > 0]):
            where = np.flatnonzero(off == o)
            assert where[-1] - where[0] == len(where) - 1, \
                f"offset {o} not on consecutive lanes"

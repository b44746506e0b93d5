"""Reorder / coalesce / interleave — the paper's three bandwidth mechanisms.

A DRAM *row* becomes a contiguous block of table rows; the Row Table becomes
a run-length plan over sorted block ids that drives the row-table kernels
(``repro_torch.kernels``); the Word Table becomes within-block offsets plus
the inverse permutation; coalescing is sort-based dedup; interleaving is
recovered by block-sequential access and by sharding the index space.

Shapes follow the JAX package's static-shape rules (padded outputs, fixed
plan budgets) so the two agree array for array. PyTorch runs eagerly, so
inputs are always concrete: data-dependent checks (coalesce overflow) always
run, and ``torch.unique``/``bincount`` synchronise with the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ---------------------------------------------------------------------------
# sorting & coalescing
# ---------------------------------------------------------------------------

def sort_indices(idx: torch.Tensor):
    """Reorder stage: sort bulk indices ascending, stably.

    Returns (sorted_idx, perm) with ``sorted_idx = idx[perm]``. Sorting by
    address groups same-block ("same DRAM row") accesses together, which is
    the paper's Row-Table insertion order made explicit. The sort is stable
    (as ``jnp.argsort``): tie order fixes ``bulk_rmw``'s float sums.
    """
    perm = torch.argsort(idx, stable=True)
    return idx[perm], perm


def coalesce(idx: torch.Tensor, *, size: int | None = None):
    """Coalescing stage: deduplicate bulk indices (Word-Table linked list).

    Returns ``(unique_idx, inverse, n_unique)`` where
    ``unique_idx[inverse] == idx`` and ``unique_idx`` is sorted ascending and
    padded (with its max value, so it stays sorted) to a static ``size``
    (default: len(idx)). A stream with more than ``size`` distinct values
    raises ``ValueError``.
    """
    size = int(size if size is not None else idx.shape[0])
    dev = idx.device
    if idx.shape[0] == 0:
        return (torch.zeros((size,), dtype=idx.dtype, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    unique_idx, inverse = torch.unique(idx, sorted=True, return_inverse=True)
    true_n = int(unique_idx.shape[0])
    if true_n > size:
        raise ValueError(
            f"coalesce: {true_n} distinct values do not fit the static "
            f"size={size}; raise size (or pass size=None for the safe "
            f"default of len(idx))")
    if true_n < size:
        unique_idx = torch.cat(
            [unique_idx, unique_idx[-1:].expand(size - true_n)])
    return (unique_idx, inverse.to(torch.int32),
            torch.tensor(true_n, dtype=torch.int32, device=dev))


def coalescing_factor(idx: torch.Tensor) -> torch.Tensor:
    """#accesses / #unique accesses — the paper's coalescing metric."""
    _, _, n_unique = coalesce(idx)
    return idx.shape[0] / torch.clamp(n_unique, min=1)


def coalesce_streams(streams, *, size: int | None = None):
    """Cross-stream coalescing: one Word-Table pass over many request
    streams (the shared-accelerator case, §2.3/§6.1).

    ``streams``: sequence of 1-D index tensors against one memory region.
    Returns ``(unique_idx, inverses, n_unique)`` where ``inverses`` is a
    tuple with ``unique_idx[inverses[k]] == streams[k]``.
    """
    streams = [torch.as_tensor(s).reshape(-1) for s in streams]
    lens = [int(s.shape[0]) for s in streams]
    dev = streams[0].device if streams else torch.device("cpu")
    if not streams or sum(lens) == 0:
        empty = torch.zeros((0,), dtype=torch.int32, device=dev)
        return (torch.zeros((int(size or 0),), dtype=torch.int32, device=dev),
                tuple(empty for _ in streams),
                torch.zeros((), dtype=torch.int32, device=dev))
    cat = torch.cat(streams)
    unique_idx, inverse, n_unique = coalesce(cat, size=size)
    bounds = np.cumsum([0] + lens)
    inverses = tuple(inverse[bounds[k]:bounds[k + 1]]
                     for k in range(len(streams)))
    return unique_idx, inverses, n_unique


def cross_stream_gain(streams) -> tuple:
    """Cross-request coalescing gain: (sum of per-stream unique counts) /
    (unique count of the fused stream). Returns ``(gain,
    per_stream_unique_total, fused_unique)``. Pure NumPy on the host: this
    is measurement, not execution."""
    streams = [np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s)
               .reshape(-1) for s in streams]
    streams = [s for s in streams if s.shape[0]]
    if not streams:
        return 1.0, 0, 0
    per = sum(np.unique(s).shape[0] for s in streams)
    fused = np.unique(np.concatenate(streams)).shape[0]
    return per / max(fused, 1), int(per), int(fused)


# ---------------------------------------------------------------------------
# row-table plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RowTablePlan:
    """Row-Table analogue: a static-shape schedule of block-granular accesses.

    Each of ``num_tiles`` plan tiles serves up to ``lanes`` words from ONE
    table block (= one "DRAM row"). Padded lanes read offset 0 of their
    block (harmless for gathers; scatter callers neutralise them with the
    RMW identity using ``valid``).

    Fields (tensors unless noted):
      tile_block   (num_tiles,) int32  block id served by each tile
      tile_first   (num_tiles,) bool   True on a tile that *opens* its block
      offsets      (num_tiles, lanes) int32  word offsets within the block
      src_pos      (num_tiles, lanes) int32  position into the *sorted* index
                                             stream each lane serves
      valid        (num_tiles, lanes) bool
      n_tiles      ()        int32    number of tiles actually used
      block_rows   (python int)
      lanes        (python int)
      num_blocks   (python int)
    """
    tile_block: torch.Tensor
    tile_first: torch.Tensor
    offsets: torch.Tensor
    src_pos: torch.Tensor
    valid: torch.Tensor
    n_tiles: torch.Tensor
    block_rows: int
    lanes: int
    num_blocks: int

    @property
    def num_tiles(self) -> int:
        return int(self.tile_block.shape[0])


def _ceil_div(a, b):
    return (a + b - 1) // b


def make_row_table_plan(sorted_idx: torch.Tensor, *, n_rows: int,
                        block_rows: int, lanes: int) -> RowTablePlan:
    """Build the Row-Table plan from *sorted* indices.

    ``sorted_idx`` : (T,) ascending row indices into a table with ``n_rows``
    rows, grouped into blocks of ``block_rows``. Duplicates are allowed
    (coalesce first if you want them fused).

    Static tile budget: ceil(T / lanes) + min(num_blocks, T) — the most any
    stream of length T can need. Tiles beyond ``n_tiles`` have
    ``valid == False`` and repeat the block of the last valid tile, so
    ``tile_first`` (a block-change flag) never opens a block for them.
    """
    T = int(sorted_idx.shape[0])
    dev = sorted_idx.device
    num_blocks = _ceil_div(n_rows, block_rows)
    i32 = torch.int32
    if T == 0:
        z = torch.zeros((0, lanes), dtype=i32, device=dev)
        return RowTablePlan(
            tile_block=torch.zeros((0,), dtype=i32, device=dev),
            tile_first=torch.zeros((0,), dtype=torch.bool, device=dev),
            offsets=z, src_pos=z.clone(),
            valid=torch.zeros((0, lanes), dtype=torch.bool, device=dev),
            n_tiles=torch.zeros((), dtype=i32, device=dev),
            block_rows=block_rows, lanes=lanes, num_blocks=num_blocks)
    max_tiles = _ceil_div(T, lanes) + min(num_blocks, T)

    idx = sorted_idx.to(torch.int64)
    blk = torch.div(idx, block_rows, rounding_mode="floor")
    # segment_sum drops out-of-range segment ids: send them to a spare bin
    binned = torch.where((blk >= 0) & (blk < num_blocks), blk, num_blocks)
    counts = torch.bincount(binned, minlength=num_blocks + 1)[:num_blocks]
    tiles_per_block = _ceil_div(counts, lanes)                    # (nb,)
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    tile_start = torch.cat([zero, torch.cumsum(tiles_per_block, 0)[:-1]])
    n_tiles = tiles_per_block.sum()
    pos_start = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])   # (nb,)

    t = torch.arange(max_tiles, dtype=torch.int64, device=dev)
    # block owning tile t: the last block with tile_start <= t (empty blocks
    # share their successor's tile_start, so right-side search skips them)
    owner = torch.searchsorted(tile_start, t, right=True) - 1
    owner = owner.clamp(0, num_blocks - 1)
    k = t - tile_start[owner]                                     # tile # in block
    lane = torch.arange(lanes, dtype=torch.int64, device=dev)
    pos = pos_start[owner][:, None] + k[:, None] * lanes + lane[None, :]
    in_block = pos < (pos_start[owner] + counts[owner])[:, None]
    valid = in_block & (t < n_tiles)[:, None]
    pos_c = pos.clamp(0, T - 1)
    offsets = idx[pos_c] - owner[:, None] * block_rows
    offsets = torch.where(valid, offsets, 0).clamp(0, block_rows - 1)
    # invalid trailing tiles point at the block of the last VALID tile, so
    # a kernel walking a block's run never opens a fresh block for them;
    # tile_first is then a block-change flag, (k == 0) on the valid prefix
    last_owner = owner[(n_tiles - 1).clamp(0, max_tiles - 1)]
    tile_block = torch.where(t < n_tiles, owner, last_owner)
    tile_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                            tile_block[1:] != tile_block[:-1]])
    return RowTablePlan(
        tile_block=tile_block.to(i32),
        tile_first=tile_first,
        offsets=offsets.to(i32),
        src_pos=torch.where(valid, pos_c, 0).to(i32),
        valid=valid,
        n_tiles=n_tiles.to(i32),
        block_rows=block_rows,
        lanes=lanes,
        num_blocks=num_blocks,
    )


# ---------------------------------------------------------------------------
# interleaving helpers (benchmark + sharding utilities)
# ---------------------------------------------------------------------------

def channel_of(idx: torch.Tensor, *, block_rows: int, num_channels: int):
    """Channel id under a block-cyclic layout (paper Fig 1a analogue)."""
    return (idx // block_rows) % num_channels


def interleave_round_robin(sorted_idx: torch.Tensor, *, block_rows: int,
                           num_channels: int):
    """Request-Generator analogue: emit sorted accesses round-robin across
    channels. Returns a permutation of positions into sorted_idx."""
    ch = channel_of(sorted_idx, block_rows=block_rows,
                    num_channels=num_channels)
    # stable sort by (round, channel): round = per-channel running count
    chans = torch.arange(num_channels, device=ch.device)
    eq = (ch[:, None] == chans[None, :]).to(torch.int64)
    run = torch.cumsum(eq, 0) - 1
    rnd = torch.take_along_dim(run, ch[:, None].to(torch.int64), 1)[:, 0]
    key = rnd * num_channels + ch
    return torch.argsort(key, stable=True)


def shard_bulk_indices(idx: torch.Tensor, *, num_shards: int, n_rows: int):
    """Address-range partitioning (§6.6 option 1): owner shard per index
    under an equal row-range split. Returns (owner, local_idx)."""
    rows_per = _ceil_div(n_rows, num_shards)
    owner = (idx // rows_per).to(torch.int32)
    return owner, (idx - owner * rows_per).to(torch.int32)

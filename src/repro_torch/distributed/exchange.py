"""Owner partitioning + the ragged-to-static exchange discipline.

The port's copy of the JAX package's ``distributed.exchange``, on the same
semantics. The multi-accelerator deployment of paper §6.6 splits the
address range across units; every bulk index stream must then be routed to
the shard that owns each row. The per-owner sub-streams are *ragged*; each
shard packs its requests into a static ``(num_shards, C)`` bucket buffer
plus validity, and the exchange swaps bucket ``j`` of shard ``i`` with
bucket ``i`` of shard ``j``: on a logical mesh a transpose of the
``(m, m, C)`` view (``distributed.engine``), on a process mesh
``all_to_all`` below, one ``torch.distributed.all_to_all_single`` over the
group.

The protocol (DESIGN.md §5), in order: dedup before the fabric
(``dedup_stream``; RMW streams ``combine_duplicates``), owner-local lanes
never enter it, a measured power-of-two capacity per bucket
(``bucket_capacity``), and the sorted unique spill shipped raw, as an
occupancy bitmap or as packed 16-bit deltas (``CODECS``; both round-trip
exactly, with set semantics).

Every function works on a stream's last axis and takes any leading batch
axes: the engine calls them once for all shards with a leading shard axis
(``(m, L)`` streams), tests with the reference's one-shard ``(L,)`` form.
Payloads carry row axes after the lane axis. No function synchronises
with the device: every shape is static.

The collectives (``all_to_all``, ``all_gather``) move bytes: any dtype
travels as its uint8 view, which every backend carries. The reductions
(``all_reduce``, ``reduce_scatter``: the train step's tensor- and
data-parallel sums) cannot: they travel in the tensor's own dtype. On an
"nccl" group CUDA tensors go directly; on a "gloo" group CPU tensors go
directly and CUDA tensors through pinned host buffers (``transport``).
The group's backend decides, once; nothing switches backend on a
failure.
"""
from __future__ import annotations

import torch

from repro_torch.core import bulk_ops, isa

_INT32_MAX = 2 ** 31 - 1


def bucket_capacity(n: int, *, floor: int = 8) -> int:
    """Power-of-two bucket for a measured per-owner spill count (the
    reference bounds its shard_map traces with it; the port keeps it so
    capacities, and ``ShardStats``, agree)."""
    n = int(n)
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


def _flat(x: torch.Tensor, lanes_dim: int):
    """``x`` with its leading batch axes merged into one: ``(B, L, ...)``
    for a stream whose lane axis is ``lanes_dim`` from the end of its
    batch axes; returns the tensor and the batch shape."""
    batch = tuple(x.shape[:x.ndim - lanes_dim])
    return x.reshape((-1,) + tuple(x.shape[len(batch):])), batch


def _take(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``x[b, pos[b, k]]``: x ``(B, M, *row)``, pos ``(B, L)``."""
    idx = pos.to(torch.int64).view(tuple(pos.shape) + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(tuple(pos.shape) +
                                         tuple(x.shape[2:])))


def _put(size: int, pos: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out[b, pos[b, k]] = src[b, k]`` into zeros ``(B, size, *row)``;
    lanes at ``pos == size`` are dropped."""
    out = src.new_zeros((src.shape[0], size + 1) + tuple(src.shape[2:]))
    idx = pos.to(torch.int64).view(tuple(pos.shape) + (1,) * (src.ndim - 2))
    return out.scatter_(1, idx.expand_as(src), src)[:, :size]


def _lane(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def partition_by_owner(idx: torch.Tensor, valid: torch.Tensor, *,
                       rows_per: int, num_shards: int,
                       capacity: int | None = None):
    """Pack a request stream into static per-owner buckets.

    ``idx`` ``(..., L)`` global rows (anything on invalid lanes), ``valid``
    its mask; ``capacity`` the per-owner bucket size ``C`` (default ``L``,
    which cannot overflow; lanes past a smaller capacity are dropped).

    Returns ``(send_idx, send_valid, order, slot, sent_counts)``:
    ``send_idx``/``send_valid`` ``(..., num_shards*C)`` with bucket ``o``
    holding the lanes owned by shard ``o`` in stream order (zero-padded);
    ``order`` ``(..., L)`` the stable owner-sort permutation; ``slot``
    ``(..., L)`` the bucket position of the k-th sorted lane
    (``num_shards*C`` = dropped); ``sent_counts`` ``(..., num_shards)``.
    """
    idx, batch = _flat(idx.to(torch.int32), 1)
    valid, _ = _flat(valid, 1)
    ns = int(num_shards)
    L = int(idx.shape[1])
    C = L if capacity is None else int(capacity)
    owner = (idx // rows_per).clamp(0, ns - 1)   # garbage on invalid lanes
    key = torch.where(valid, owner, ns)
    order = torch.argsort(key, dim=1, stable=True)
    s_key = torch.gather(key, 1, order)
    counts = torch.zeros((idx.shape[0], ns + 1), dtype=torch.int32,
                         device=idx.device).scatter_add_(
        1, key.to(torch.int64), torch.ones_like(key))[:, :ns]
    start = torch.cumsum(counts, 1, dtype=torch.int32) - counts
    rank = _lane(L, idx.device) - torch.gather(
        start, 1, s_key.clamp(max=ns - 1).to(torch.int64))
    slot = torch.where((s_key < ns) & (rank < C), s_key * C + rank,
                       ns * C).to(torch.int32)
    send_idx = _put(ns * C, slot, torch.gather(idx, 1, order))
    send_valid = _put(ns * C, slot, torch.gather(valid, 1, order))
    out = (send_idx, send_valid, order.to(torch.int32), slot, counts)
    return tuple(t.reshape(batch + tuple(t.shape[1:])) for t in out)


def pack_payload(payload: torch.Tensor, order: torch.Tensor,
                 slot: torch.Tensor, *, num_shards: int,
                 capacity: int | None = None) -> torch.Tensor:
    """Scatter a per-lane payload ``(..., L, *row)`` into the bucket layout
    ``partition_by_owner`` produced for its indices."""
    order, batch = _flat(order, 1)
    slot, _ = _flat(slot, 1)
    payload = payload.reshape((order.shape[0],) +
                              tuple(payload.shape[len(batch):]))
    L = int(order.shape[1])
    C = L if capacity is None else int(capacity)
    out = _put(int(num_shards) * C, slot, _take(payload, order))
    return out.reshape(batch + tuple(out.shape[1:]))


def unpack_result(bucket_vals: torch.Tensor, order: torch.Tensor,
                  slot: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-lane results ``(..., L, *row)`` read back out of a returned
    bucket buffer ``(..., M, *row)``, in stream order; invalid lanes 0."""
    order, batch = _flat(order, 1)
    slot, _ = _flat(slot, 1)
    valid, _ = _flat(valid, 1)
    vals = bucket_vals.reshape((order.shape[0],) +
                               tuple(bucket_vals.shape[len(batch):]))
    picked = _take(vals, slot.clamp(0, vals.shape[1] - 1))
    out = _put(int(order.shape[1]), order, picked)
    mask = valid.view(tuple(valid.shape) + (1,) * (out.ndim - 2))
    out = torch.where(mask, out, torch.zeros_like(out))
    return out.reshape(batch + tuple(out.shape[1:]))


def _sorted_firsts(idx: torch.Tensor, valid: torch.Tensor):
    """Valid lanes sorted ascending (invalid ones last, as int32-max
    sentinels): ``(sorted, order, first)`` with ``first`` marking each
    value's first lane."""
    keyed = torch.where(valid, idx.to(torch.int32), _INT32_MAX)
    s, order = torch.sort(keyed, dim=-1, stable=True)
    first = torch.ones_like(valid)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    return s, order, first


def masked_unique_count(idx: torch.Tensor, valid: torch.Tensor
                        ) -> torch.Tensor:
    """Number of distinct values among the valid lanes, per stream
    ``(...)`` int32 (a shard's owner-local coalescing statistic)."""
    s, _, first = _sorted_firsts(idx, valid)
    nv = valid.sum(-1, keepdim=True)
    k = _lane(s.shape[-1], s.device)
    return ((k < nv) & first).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# pre-exchange dedup / combine (the unique-set pass before the fabric)
# ---------------------------------------------------------------------------

def dedup_stream(idx: torch.Tensor, valid: torch.Tensor):
    """Unique-set pass over a stream's valid lanes, before any lane is
    considered for the fabric. Returns ``(u_idx, u_valid, inv, n_u)``:
    ``u_idx`` ``(..., L)`` holds the distinct valid values ascending in
    its first ``n_u`` lanes (zero elsewhere), ``u_valid`` marks them, and
    ``inv`` maps every original lane to its value's position
    (``u_idx[inv]`` restores the stream on valid lanes)."""
    idx, batch = _flat(idx, 1)
    valid, _ = _flat(valid, 1)
    L = int(idx.shape[1])
    s, order, first = _sorted_firsts(idx, valid)
    uid = torch.cumsum(first, 1, dtype=torch.int32) - 1
    k = _lane(L, idx.device)
    lane_valid = k < valid.sum(1, keepdim=True)
    u_idx = _put(L, torch.where(lane_valid, uid, L), s)
    n_u = (first & lane_valid).sum(1, dtype=torch.int32)
    u_valid = k < n_u[:, None]
    inv = _put(L, order, uid)
    out = (u_idx, u_valid, inv, n_u)
    return tuple(t.reshape(batch + tuple(t.shape[1:])) for t in out)


def combine_duplicates(idx: torch.Tensor, values: torch.Tensor,
                       valid: torch.Tensor, *, op: str,
                       unsigned: bool = False):
    """RMW variant of ``dedup_stream``: duplicate destinations merge with
    ``op`` (an ``isa.RMW_OPS`` member) before the exchange, so one
    combined update ships per distinct row. Invalid lanes contribute the
    op identity. ``unsigned`` marks u32/u64 containers. Returns
    ``(u_idx, u_vals, u_valid, n_u)``."""
    u_idx, u_valid, inv, n_u = dedup_stream(idx, valid)
    inv, batch = _flat(inv, 1)
    B, L = inv.shape
    row = tuple(values.shape[len(batch) + 1:])
    vals = values.reshape((B, L) + row)
    mask = valid.reshape((B, L) + (1,) * len(row))
    ident = isa.rmw_identity(op, vals.dtype, unsigned=unsigned).to(
        vals.device)
    vals = torch.where(mask, vals, ident)
    seg = inv.clamp(0, L - 1) + (_lane(B, inv.device) * L)[:, None]
    u_vals = bulk_ops.segment_combine(
        vals.reshape((B * L,) + row), seg.reshape(-1), num_segments=B * L,
        op=op, unsigned=unsigned)
    return u_idx, u_vals.reshape(batch + (L,) + row), u_valid, n_u


# ---------------------------------------------------------------------------
# index codecs (dense-run compression of the remote spill)
# ---------------------------------------------------------------------------
#
# Both codecs assume the layout ``partition_by_owner`` produces from a
# deduped, sorted stream: each bucket is a strictly ascending run of
# distinct local rows in [0, rows_per). Decoding recovers that sorted set.
# Words are int32 containers (the bitmap's hold uint32 bits).

def bitmap_words(rows_per: int) -> int:
    """int32 words per bucket for the occupancy-bitmap codec."""
    return -(-int(rows_per) // 32)


def delta_words(capacity: int) -> int:
    """int32 words per bucket for the packed-delta codec: one count word,
    one base word, then two 16-bit deltas per word."""
    return 2 + (max(int(capacity) - 1, 0) + 1) // 2


def _bucket_local(send_idx, ns: int, rows_per: int):
    """Each lane's bucket and its row local to the bucket's owner."""
    C = int(send_idx.shape[1]) // ns
    bucket = _lane(ns * C, send_idx.device) // C
    local = (send_idx.to(torch.int32) - bucket * rows_per).clamp(
        0, rows_per - 1)
    return bucket, local, C


def encode_bitmap(send_idx: torch.Tensor, send_valid: torch.Tensor, *,
                  rows_per: int, num_shards: int) -> torch.Tensor:
    """Occupancy bitmap of a bucket buffer: bit ``r`` of bucket ``o``'s
    ``bitmap_words(rows_per)`` words is set iff local row ``r`` of owner
    ``o`` is requested (each at most once: the dedup precondition). The
    words are summed in int64 and kept modulo 2**32, bit 31 included, as
    the reference's uint32 scatter-add keeps them."""
    send_idx, batch = _flat(send_idx, 1)
    send_valid, _ = _flat(send_valid, 1)
    ns, W = int(num_shards), bitmap_words(rows_per)
    bucket, local, _ = _bucket_local(send_idx, ns, rows_per)
    word = (bucket * W + local // 32).expand_as(send_idx)
    contrib = torch.where(send_valid, 1 << (local % 32).to(torch.int64), 0)
    words = torch.zeros((send_idx.shape[0], ns * W), dtype=torch.int64,
                        device=send_idx.device).scatter_add_(
        1, word.to(torch.int64), contrib)
    return isa.wrap32(words).reshape(batch + (ns * W,))


def decode_bitmap(bitmap: torch.Tensor, *, rows_per: int, num_shards: int,
                  capacity: int):
    """Inverse of ``encode_bitmap``: per bucket, the sorted local rows of
    the set bits, padded to ``capacity`` lanes. Returns
    ``(local_rows, valid)`` ``(..., num_shards*capacity)``."""
    bitmap, batch = _flat(bitmap, 1)
    ns, W, C = int(num_shards), bitmap_words(rows_per), int(capacity)
    B = bitmap.shape[0]
    bits = torch.arange(32, dtype=torch.int64, device=bitmap.device)
    occ = ((isa.to_u64(bitmap)[..., None] >> bits) & 1).bool()
    occ = occ.reshape(B, ns, W * 32)
    row = _lane(W * 32, bitmap.device)
    keyed = torch.where(occ & (row < rows_per), row, _INT32_MAX)
    top = torch.sort(keyed, dim=2).values[:, :, :C]
    if top.shape[2] < C:        # more lanes than the bitmap has rows
        top = torch.cat([top, top.new_full(
            (B, ns, C - top.shape[2]), _INT32_MAX)], 2)
    valid = top < rows_per
    local = torch.where(valid, top, 0)
    return (local.reshape(batch + (ns * C,)),
            valid.reshape(batch + (ns * C,)))


def encode_delta(send_idx: torch.Tensor, send_valid: torch.Tensor, *,
                 rows_per: int, num_shards: int) -> torch.Tensor:
    """Packed-delta codec: per bucket, word 0 the valid-lane count, word 1
    the first local row, then two 16-bit successive deltas per word.
    Exact for ascending runs with ``rows_per <= 1 << 16``."""
    if rows_per > (1 << 16):
        raise ValueError(f"delta codec needs rows_per <= 65536, got "
                         f"{rows_per} (16-bit packed deltas)")
    send_idx, batch = _flat(send_idx, 1)
    send_valid, _ = _flat(send_valid, 1)
    ns = int(num_shards)
    B = send_idx.shape[0]
    _, local, C = _bucket_local(send_idx, ns, rows_per)
    local = torch.where(send_valid, local, 0)
    b = local.reshape(B, ns, C)
    delta = b[:, :, 1:] - b[:, :, :-1]          # (B, ns, C-1), < 2^16
    npairs = C // 2
    dpad = torch.zeros((B, ns, 2 * npairs), dtype=torch.int32,
                       device=b.device)
    dpad[:, :, :C - 1] = delta
    pairs = dpad.reshape(B, ns, npairs, 2)
    packed = pairs[..., 0] | (pairs[..., 1] << 16)
    count = send_valid.reshape(B, ns, C).sum(2, keepdim=True,
                                             dtype=torch.int32)
    words = torch.cat([count, b[:, :, :1], packed], 2)
    return words.reshape(batch + (ns * delta_words(C),))


def decode_delta(words: torch.Tensor, *, rows_per: int, num_shards: int,
                 capacity: int):
    """Inverse of ``encode_delta``: cumulative-sum the packed deltas back
    into each bucket's ascending run. Returns ``(local_rows, valid)``
    ``(..., num_shards*capacity)``."""
    words, batch = _flat(words, 1)
    ns, C = int(num_shards), int(capacity)
    w = words.reshape(words.shape[0], ns, delta_words(C))
    count, base, packed = w[:, :, 0], w[:, :, 1], w[:, :, 2:]
    lo = packed & 0xFFFF
    hi = (packed >> 16) & 0xFFFF
    deltas = torch.stack([lo, hi], 3).reshape(
        words.shape[0], ns, -1)[:, :, :max(C - 1, 0)]
    runs = torch.cat([base[:, :, None], deltas], 2)[:, :, :C]
    local = torch.cumsum(runs, 2, dtype=torch.int32)
    valid = _lane(C, words.device) < count[:, :, None]
    local = torch.where(valid, local, 0)
    return (local.reshape(batch + (ns * C,)),
            valid.reshape(batch + (ns * C,)))


#: codec name -> (encode, decode, words-per-bucket fn(rows_per, capacity))
CODECS = {
    "bitmap": (encode_bitmap, decode_bitmap,
               lambda rows_per, cap: bitmap_words(rows_per)),
    "delta": (encode_delta, decode_delta,
              lambda rows_per, cap: delta_words(cap)),
}


def codec_wire_words(codec: str, *, rows_per: int, capacity: int) -> int:
    """int32 words one bucket costs on the wire under ``codec`` ("raw"
    ships ``capacity`` index lanes)."""
    if codec == "raw":
        return int(capacity)
    return int(CODECS[codec][2](rows_per, capacity))


# ---------------------------------------------------------------------------
# collectives over a process mesh (``distributed.mesh.ProcessMesh``)
# ---------------------------------------------------------------------------

def transport(mesh, device) -> str:
    """How ``mesh``'s group moves tensors that live on ``device``: "nccl"
    (CUDA tensors, directly), "gloo" (CPU tensors, directly) or
    "gloo+host" (CUDA tensors through pinned host buffers). The group's
    backend decides; there is no fallback from one to another."""
    dev = torch.device(device)
    if mesh.backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"an nccl group exchanges CUDA tensors, got "
                             f"{dev}")
        return "nccl"
    if mesh.backend == "gloo":
        return "gloo+host" if dev.type == "cuda" else "gloo"
    raise ValueError(f"unsupported process-group backend {mesh.backend!r}")


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``(rows, row_bytes)`` uint8: every backend carries bytes,
    and splits along the first axis stay whole rows."""
    rows = int(x.shape[0])
    width = 1
    for d in x.shape[1:]:
        width *= int(d)
    return x.contiguous().reshape(rows, width).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, rows: int):
    shape = (rows,) + tuple(like.shape[1:])
    if b.numel() == 0:
        return torch.empty(shape, dtype=like.dtype, device=b.device)
    return b.view(like.dtype).reshape(shape)


class Exchange:
    """A collective in flight: ``wait()`` returns what arrived (on the
    tensor's own device), ``is_completed()`` polls without blocking."""

    def __init__(self, work, out: torch.Tensor, finish):
        self._work = work
        self._out = out
        self._finish = finish

    def is_completed(self) -> bool:
        return self._work is None or bool(self._work.is_completed())

    def then(self, fn) -> "Exchange":
        """This exchange, with ``fn`` applied to what arrives: at once
        when nothing is in flight."""
        if self._work is None:
            self._out = fn(self.wait())
            return self
        prev = self._finish
        self._finish = fn if prev is None else (lambda o: fn(prev(o)))
        return self

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._finish is not None:
            self._out, self._finish = self._finish(self._out), None
        return self._out


def _staged(x_bytes: torch.Tensor, out_shape) -> tuple:
    """Pinned host copies for a gloo collective of CUDA bytes: the input
    (copied before the collective reads it) and the output buffer."""
    h_in = torch.empty(tuple(x_bytes.shape), dtype=torch.uint8,
                       pin_memory=True)
    h_in.copy_(x_bytes)
    h_out = torch.empty(tuple(out_shape), dtype=torch.uint8,
                        pin_memory=True)
    return h_in, h_out


def _collective(mesh, x: torch.Tensor, out_rows: int, issue, async_op):
    """Run ``issue(out_bytes, in_bytes)`` over ``x``'s bytes on the
    mesh's transport; the result has ``out_rows`` rows of ``x``'s row
    shape and dtype, on ``x``'s device."""
    way = transport(mesh, x.device)
    b = _as_bytes(x)
    out_shape = (int(out_rows), int(b.shape[1]))
    if way == "gloo+host":
        src, dst = _staged(b, out_shape)
        dev = x.device

        def finish(o):
            return _from_bytes(o.to(dev, non_blocking=True), x, out_rows)
    else:
        src = b
        dst = torch.empty(out_shape, dtype=torch.uint8, device=x.device)

        def finish(o):
            return _from_bytes(o, x, out_rows)
    work = issue(dst, src)
    ex = Exchange(work, dst, finish)
    return ex if async_op else ex.wait()


def all_to_all(x: torch.Tensor, mesh, *, async_op: bool = False,
               send_counts=None, recv_counts=None):
    """Bucket ``j`` of this rank's ``(m*C, ...)`` buffer goes to rank
    ``j``; what arrives holds rank ``i``'s bucket for this rank at bucket
    ``i`` (the reference's ``all_to_all(..., 0, 0, tiled=True)``). With
    ``send_counts``/``recv_counts`` (rows per rank) the buckets are
    ragged. Returns the received tensor, or an ``Exchange`` with
    ``async_op=True``."""
    import torch.distributed as dist
    m = int(mesh.num_shards)
    if send_counts is None:
        if int(x.shape[0]) % m:
            raise ValueError(f"{x.shape[0]} rows do not split into {m} "
                             "equal buckets")
        out_rows, splits = int(x.shape[0]), None
    else:
        send_counts = [int(c) for c in send_counts]
        recv_counts = [int(c) for c in recv_counts]
        if sum(send_counts) != int(x.shape[0]):
            raise ValueError(f"send_counts {send_counts} do not sum to "
                             f"{x.shape[0]} rows")
        out_rows, splits = sum(recv_counts), (recv_counts, send_counts)

    def issue(dst, src):
        return dist.all_to_all_single(
            dst, src, output_split_sizes=None if splits is None
            else splits[0], input_split_sizes=None if splits is None
            else splits[1], group=mesh.group, async_op=True)
    return _collective(mesh, x, out_rows, issue, async_op)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` (same shape on all), stacked in rank order:
    ``(m,) + x.shape``."""
    import torch.distributed as dist
    m = int(mesh.num_shards)
    flat = x.reshape((1,) + tuple(x.shape))

    def issue(dst, src):
        return dist.all_gather(list(dst.chunk(m)), src, group=mesh.group,
                               async_op=True)
    return _collective(mesh, flat, m, issue, False)


def all_gather_object(obj, mesh) -> list:
    """Every rank's picklable ``obj``, in rank order: the plan agreement's
    transport (a window's signature digest, decisions and capacities).
    Two collectives: the pickled sizes, then the bytes padded to the
    largest. A gloo group carries them in CPU tensors, an nccl group on
    the mesh's card."""
    import pickle
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    size = torch.tensor([int(data.shape[0])], dtype=torch.int64, device=dev)
    sizes = all_gather(size, mesh).reshape(-1).tolist()
    pad = torch.zeros((max(sizes),), dtype=torch.uint8, device=dev)
    pad[:data.shape[0]] = data.to(dev)
    got = all_gather(pad, mesh).cpu()
    return [pickle.loads(got[r, :s].numpy().tobytes())
            for r, s in enumerate(sizes)]


_REDUCE_OPS = {"sum": "SUM", "max": "MAX"}


def _reduction(mesh, x: torch.Tensor, out_shape, issue) -> torch.Tensor:
    """Run ``issue(out, in)`` over ``x`` in its own dtype on the mesh's
    transport; the result (``out_shape``, ``x``'s dtype) is on ``x``'s
    device and ``x`` is left as it was."""
    way = transport(mesh, x.device)
    if way == "gloo+host":
        src = torch.empty(tuple(x.shape), dtype=x.dtype, pin_memory=True)
        src.copy_(x)
    else:
        src = x.contiguous().clone()
    dst = src if out_shape is None else torch.empty(
        tuple(out_shape), dtype=x.dtype, device=src.device,
        pin_memory=way == "gloo+host")
    issue(dst, src).wait()
    return dst.to(x.device, non_blocking=True) if way == "gloo+host" \
        else dst


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") of every rank's ``x`` (same
    shape on all), on every rank."""
    import torch.distributed as dist
    red = getattr(dist.ReduceOp, _REDUCE_OPS[op])

    def issue(dst, src):
        return dist.all_reduce(dst, op=red, group=mesh.group, async_op=True)
    return _reduction(mesh, x, None, issue)


def reduce_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of ``x`` (``(m * n, ...)``, same shape on all),
    of which this rank keeps rows ``[rank * n, (rank + 1) * n)``."""
    import torch.distributed as dist
    m = int(mesh.num_shards)
    if int(x.shape[0]) % m:
        raise ValueError(f"{x.shape[0]} rows do not split into {m} equal "
                         "blocks")
    out_shape = (int(x.shape[0]) // m,) + tuple(x.shape[1:])

    # reduce_scatter_single is reduce_scatter_tensor's newer name
    rs = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor

    def issue(dst, src):
        return rs(dst, src, op=dist.ReduceOp.SUM, group=mesh.group,
                  async_op=True)
    return _reduction(mesh, x, out_shape, issue)

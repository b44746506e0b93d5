"""ShardedEngine: the bulk-access engine over a mesh of shards.

The port of the JAX package's ``distributed.engine``. Paper §6.6, option 1:
multiple DX100 units partition the address range, and each bulk request
stream is split by owner unit so that the reorder / coalesce / interleave
pipeline runs *next to the memory that holds the rows*. Per call
(DESIGN.md §5):

  1. **dedup before the fabric** — each shard's slice is deduped
     (``exchange.dedup_stream``; RMWs ``combine_duplicates``) before any
     lane is considered for routing;
  2. **owner-local lanes never enter the fabric** — the deduped slice
     splits into the rows its own shard owns and the remote spill; only
     the spill is packed into static per-owner buckets whose capacity is
     the *measured* worst per-(source, owner) spill;
  3. **compressed wire** — the cost model (``CostModel.exchange_plan``)
     picks "raw" lanes, a "bitmap" or packed "delta" words per node;
  4. the owners serve the landed rows and gather values return through
     the inverse exchange; RMWs are one-way.

Two meshes (``distributed.mesh``):

  * a logical ``Mesh``: the reference's ``shard_map`` over m devices
    becomes tensors with a leading shard axis. Every shard's stream slice
    is one row of an ``(m, per)`` tensor, each exchange step runs once for
    all shards, and ``all_to_all`` is the transpose of the ``(m, m, C)``
    bucket view. The whole table lies on the one device, so shard ``o``'s
    local row ``r`` is global row ``o * rows_per + r``: the owners' takes
    are ONE ``bulk_gather`` and their updates ONE ``bulk_rmw`` over the
    table, and the exchange moves lane positions, not rows.
  * a ``ProcessMesh``: the reference's ``shard_map`` bodies run as each
    rank's own code (a leading shard axis of 1), and every ``all_to_all``
    is ``exchange.all_to_all`` over the group. SPMD contract, as the
    reference's global arrays: every rank passes its own table slice
    (rows ``rank_rows(n_rows)``) and the *same* global stream (values and
    ``valid`` included); every rank computes the same exchange plan from
    it. A gather returns the rank's block of lanes ``rank_lanes(n)`` in
    the stream's order (with "owner" placement one more, ragged exchange
    puts the lanes back); an RMW returns the rank's updated slice;
    ``gather_blocks`` puts blocks or slices back together.
    ``ShardedEngine.slice_of`` cuts a table to the rank's slice, and
    ``ShardedEngine.regrow`` grows a slice, moving only the rows whose
    owner changes.

Owner-local execution runs with ``use_kernel`` as the engine's: on a 2-D
table through the row-table kernels B1/B2, once per call on a logical mesh
and once per rank on a process mesh. Results equal the single-device
engine's, gathers and integer RMWs bit for bit.

Lane *placement* is a plan decision: the host-side planner
(``_measure_exchange``) compares the natural "block" slicing with an
owner-major permutation and applies it when the measured local-fraction
gain clears the cost model's cutoff. Only streams already on the host are
measured (never a device read); the rest run at the worst-case capacity,
the slice length. Measurements are cached per stream *tensor*, keyed on
its identity and its ``_version`` (torch tensors change in place, and a
stale capacity would drop lanes); NumPy streams are measured every call.

The route (exchange) and exec (owner-local compute) stages run fused in
``sharded_gather``/``sharded_rmw`` or split (``gather_start``/``_finish``,
``rmw_start``/``_finish``): the start issues the index exchange (on a
process mesh as an asynchronous collective) so the emit stage can put
every sharded node's exchange in flight before any node's exec. Importing
this module registers the **"sharded" plan backend**
(``repro_torch.plan.emit``). Over a process mesh each rank's scheduler
lowers the same window, agreed once per window (``agree``, see
``core.scheduler``); a gather node's result is put back together whole
on every rank, an RMW node's is the rank's updated slice, and a batched
program group runs its block of lanes on each rank, the results
all-gathered (``_constrain_batch``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch import plan
from repro_torch.core import bulk_ops, interop, isa
from repro_torch.core.device import resolve_device
from repro_torch.core.engine import BatchUnsupported, Engine
from repro_torch.distributed import exchange
from repro_torch.distributed.mesh import (ProcessMesh, as_mesh,
                                          shard_row_ranges)
from repro_torch.plan.cost import CostModel, ExchangePlan

class ShardStats:
    """Per-stream record of one sharded bulk access.

    Counts are **post-dedup**: ``sent[i, j]`` is the number of distinct
    rows in shard ``i``'s slice owned by shard ``j`` (the diagonal never
    enters the fabric); ``received[j]`` / ``unique[j]`` are each owner's
    landed lane count (own + received spill) and distinct-row count.

    Wire accounting is static per call geometry: ``idx_bytes`` is what the
    chosen codec shipped for the off-diagonal index spill,
    ``idx_bytes_raw`` what raw int32 lanes would have cost, and
    ``bytes_on_wire`` adds the value payload. ``overlap_fraction`` is 1.0
    when the exchange had completed before the exec stage dispatched
    (split path), 0.0 when not, None for fused calls. ``transport`` says
    how the exchange moved ("logical": within one device; on a process
    mesh "nccl", "gloo" or "gloo+host", ``exchange.transport``) and
    ``collectives`` how many collectives the call made on every rank (the
    one gathering these counts included).

    The counts stay on the device until a property reads them (so
    back-to-back sharded calls keep dispatching); the first read copies
    all of them to NumPy and drops the device tensors. On a process mesh
    every rank holds every shard's counts, gathered within the call.
    """

    def __init__(self, sent, received, unique, *, placement: str = "block",
                 codec: str = "raw", capacity: int = 0, idx_bytes: int = 0,
                 idx_bytes_raw: int = 0, bytes_on_wire: int = 0,
                 overlap: Optional[float] = None,
                 transport: str = "logical", collectives: int = 0):
        self._device: Optional[tuple] = (sent, received, unique)
        self._host: Optional[tuple] = None
        self.placement = placement
        self.codec = codec
        self.capacity = int(capacity)
        self.idx_bytes = int(idx_bytes)
        self.idx_bytes_raw = int(idx_bytes_raw)
        self.bytes_on_wire = int(bytes_on_wire)
        self.transport = transport
        self.collectives = int(collectives)
        self._overlap = overlap

    def _materialize(self) -> tuple:
        if self._host is None:
            dev, self._device = self._device, None
            self._host = tuple(x.cpu().numpy() for x in dev)
        return self._host

    @property
    def sent(self) -> np.ndarray:
        return self._materialize()[0]

    @property
    def received(self) -> np.ndarray:
        return self._materialize()[1]

    @property
    def unique(self) -> np.ndarray:
        return self._materialize()[2]

    @property
    def num_shards(self) -> int:
        return int(self.received.shape[0])

    @property
    def coalescing_gain(self) -> np.ndarray:
        """Owner-local dedup factor per shard (#landed / #distinct)."""
        return self.received / np.maximum(self.unique, 1)

    @property
    def local_fraction(self) -> float:
        """Fraction of post-dedup requests already resident on their
        source shard (no fabric traffic)."""
        s = self.sent
        return float(np.trace(s) / max(s.sum(), 1))

    @property
    def compression_ratio(self) -> float:
        """Raw-vs-shipped index wire ratio (1.0 = uncompressed)."""
        if not self.idx_bytes:
            return 1.0
        return self.idx_bytes_raw / self.idx_bytes

    @property
    def overlap_fraction(self) -> Optional[float]:
        return self._overlap

    def set_overlap(self, f: float) -> None:
        self._overlap = float(f)

    def __repr__(self) -> str:
        # does not materialize: a repr must not wait for the device
        state = "host" if self._host is not None else "device"
        return (f"ShardStats(<{state}> place={self.placement} "
                f"codec={self.codec})")


@dataclasses.dataclass
class ExchangeInflight:
    """Handle for a dispatched route stage awaiting its exec stage
    (``gather_start``/``rmw_start`` -> ``*_finish``)."""
    kind: str
    route: dict = dataclasses.field(default_factory=dict)
    wire: tuple = ()             # exchanges in flight (index, payload)
    perm: object = None          # owner placement: device permutation
    perm_host: object = None     # ... and its host copy (process mesh)
    n: int = 0
    xplan: ExchangePlan = None
    cap: int = 0
    codec: str = "raw"
    rows_per: int = 0
    value_nbytes: int = 0
    op: str = "ADD"
    unsigned: bool = False
    collectives: int = 0
    done: object = None          # CUDA event recorded after the route


def _host(x) -> Optional[np.ndarray]:
    """``x`` as NumPy when it is already on the host (an array, a list, a
    CPU tensor), else None: a device tensor is never read."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.device.type == "cpu" else None
    return np.asarray(x)


def gather_blocks(out, mesh, n: Optional[int] = None) -> torch.Tensor:
    """Put the per-rank results of a process mesh back together, on every
    rank: gather blocks (``rank_lanes``) into the whole ``(n, ...)``
    result, or RMW slices (``rank_rows``) into the whole table. Both are
    the ceil-div split, so one function serves both. ``n``, the whole
    extent when the caller knows it, saves the collective that exchanges
    the sizes. On a logical mesh (or an int) ``out`` is already whole and
    comes back as it is."""
    if not isinstance(mesh, ProcessMesh):
        return out
    out = out if isinstance(out, torch.Tensor) else torch.as_tensor(out)
    out = out.to(mesh.device)
    if n is None:
        k = torch.tensor([int(out.shape[0])], dtype=torch.int64,
                         device=mesh.device)
        sizes = exchange.all_gather(k, mesh).reshape(-1).tolist()
    else:
        sizes = [hi - lo for lo, hi in
                 shard_row_ranges(n, mesh.num_shards)]
    per = max(sizes)
    pad = out.new_zeros((per,) + tuple(out.shape[1:]))
    pad[:out.shape[0]] = out
    blocks = exchange.all_gather(pad, mesh)
    return torch.cat([blocks[r, :s] for r, s in enumerate(sizes)])


class ShardedEngine(Engine):
    """Drop-in ``Engine`` whose bulk streams span a mesh of shards.

    ``mesh``: None (one logical shard per visible device), an int shard
    count (logical shards, all on the engine's device), a logical
    ``distributed.Mesh``, or a ``distributed.ProcessMesh`` (one shard per
    rank; the engine runs on the mesh's device). ``device`` as for
    ``Engine`` (None = CUDA; for a process mesh, the mesh's device).
    Everything else matches ``Engine``; a 1-shard mesh gives single-device
    results.
    """

    plan_backend = "sharded"     # registered below at import time
    #: streams longer than this never get a host-side exchange measurement
    #: (the fallback plan — block placement, raw wire, worst-case capacity
    #: — is always correct, just not minimal)
    measure_limit = 1 << 16

    def __init__(self, mesh=None, *, tile_size: int = 16384,
                 optimize: bool = True, use_kernel: bool = False,
                 cost_model: Optional[CostModel] = None, device=None):
        if isinstance(mesh, ProcessMesh):
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the process "
                                 f"mesh's device {mesh.device}")
            device = mesh.device
        super().__init__(tile_size=tile_size, optimize=optimize,
                         use_kernel=use_kernel, device=device)
        self.mesh = as_mesh(mesh, device=self.device)
        self.axis = self.mesh.axis
        self.num_shards = int(self.mesh.num_shards)
        self.process = isinstance(self.mesh, ProcessMesh)
        if self.process:
            self.rank = self.mesh.rank
            self.transport = exchange.transport(self.mesh, self.device)
            self._shards = torch.tensor([self.rank], device=self.device)
        else:
            self.rank = None
            self.transport = "logical"
            self._shards = torch.arange(self.num_shards, device=self.device)
        # (id(idx), id(valid), n_rows, kind, ns) -> (idx, valid, versions,
        # meas, perm): strong refs keep the ids stable
        self._xplan_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.exchange_cost = cost_model or CostModel()
        self.last_shard_stats: Optional[ShardStats] = None
        # collectives this engine issued (process mesh), every kind
        self.collectives = 0

    # -- what this process holds ----------------------------------------------

    def rank_rows(self, n_rows: int) -> tuple:
        """The half-open global rows whose table slice this process passes:
        its own shard's on a process mesh, all of them on a logical one."""
        if not self.process:
            return 0, int(n_rows)
        return tuple(shard_row_ranges(n_rows, self.num_shards)[self.rank])

    def rank_lanes(self, n: int) -> tuple:
        """The half-open lanes of an ``n``-lane stream whose gather results
        this process returns (the reference's lane-sharded output): its
        block on a process mesh, all of them on a logical one."""
        n = int(n)
        if not self.process:
            return 0, n
        per = -(-n // self.num_shards)
        return min(self.rank * per, n), min((self.rank + 1) * per, n)

    def _n_rows(self, table: torch.Tensor, n_rows: Optional[int]) -> int:
        """The global table's row count. On a process mesh the caller
        gives it (``n_rows``), and the rank's slice must be exactly its
        ``rank_rows``."""
        local = int(table.shape[0])
        if not self.process:
            if n_rows is not None and int(n_rows) != local:
                raise ValueError(f"n_rows={n_rows} but the table has "
                                 f"{local} rows (a logical mesh takes the "
                                 "whole table)")
            return local
        if n_rows is None:
            raise ValueError(
                "a process mesh needs n_rows, the whole table's row count: "
                "each rank passes its slice rank_rows(n_rows)")
        lo, hi = self.rank_rows(n_rows)
        if local != hi - lo:
            raise ValueError(
                f"rank {self.rank} passed {local} table rows; its slice of "
                f"a {n_rows}-row table is rows [{lo}, {hi}): pass each rank "
                "its own slice (rank_rows)")
        return int(n_rows)

    # -- SPMD agreement and the batch split (process mesh) --------------------

    def agree(self, obj) -> list:
        """Every rank's picklable ``obj`` in rank order (one all-gather of
        a small host object over the mesh's group): the scheduler's
        per-window agreement."""
        if not self.process:
            return [obj]
        self.collectives += 2
        return exchange.all_gather_object(obj, self.mesh)

    def whole(self, out: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's ceil-div block of an ``n``-row result put back
        together whole on every rank (one all-gather)."""
        self.collectives += 1
        return gather_blocks(out, self.mesh, n)

    def slice_of(self, table):
        """``(table to submit, submit kwargs)`` for a row-sharded table:
        over a process mesh this rank's rows ``rank_rows`` on its device
        (a NumPy table is cut before it is copied there, and a u32/u64
        one is marked ``unsigned``, which the tensor no longer says) with
        the whole table's ``n_rows``; on a logical mesh the table itself
        and no kwargs."""
        if not self.process:
            return table, {}
        n = int(table.shape[0])
        lo, hi = self.rank_rows(n)
        if isinstance(table, torch.Tensor):
            return table[lo:hi].to(self.device), {"n_rows": n}
        table = np.asarray(table)
        part = interop.to_tensor(np.ascontiguousarray(table[lo:hi]),
                                 device=self.device)
        return part, {"n_rows": n, "unsigned":
                      table.dtype.name in ("uint32", "uint64")}

    def regrow(self, part: torch.Tensor, n_old: int, n_new: int):
        """This rank's slice of an ``n_old``-row table sharded over a
        process mesh, grown to ``n_new >= n_old`` rows: the old rows
        followed by zero rows. Returns ``(slice, moved)``: the rank's
        slice ``rank_rows(n_new)`` as a new tensor (``part`` is never
        written, so a gather already submitted on it still reads it) and
        ``(sent, received)``, the rows this rank sent and received.

        The ceil-div split moves its boundaries when the table grows, so
        rows change owner: only those move, in one ragged ``all_to_all``
        (none when no row changes owner), and each zero row is allocated
        on its new owner. No rank holds more than its old and new slices
        and the rows in flight."""
        if not self.process:
            raise ValueError("regrow re-cuts a table sharded over a process "
                             "mesh; a logical mesh holds tables whole")
        n_old, n_new = int(n_old), int(n_new)
        if n_new < n_old:
            raise ValueError(f"regrow shrinks {n_old} rows to {n_new}")
        lo, hi = self.rank_rows(n_old)
        if int(part.shape[0]) != hi - lo:
            raise ValueError(
                f"rank {self.rank} passed {part.shape[0]} table rows; its "
                f"slice of a {n_old}-row table is rows [{lo}, {hi})")
        nlo, nhi = self.rank_rows(n_new)
        out = part.new_zeros((nhi - nlo,) + tuple(part.shape[1:]))
        old = shard_row_ranges(n_old, self.num_shards)
        new = shard_row_ranges(n_new, self.num_shards)

        def overlap(a, b):
            return max(a[0], b[0]), min(a[1], b[1])

        # rows [a, b) of rank s's old slice that rank r now owns
        cuts = [[overlap(old[s], new[r]) for r in range(self.num_shards)]
                for s in range(self.num_shards)]
        count = [[max(b - a, 0) if s != r else 0 for r, (a, b) in
                  enumerate(row)] for s, row in enumerate(cuts)]
        a, b = cuts[self.rank][self.rank]
        if b > a:
            out[a - nlo:b - nlo] = part[a - lo:b - lo]
        sent = sum(count[self.rank])
        received = sum(count[s][self.rank] for s in range(self.num_shards))
        if not any(map(any, count)):
            return out, (0, 0)
        send = torch.cat([part[a - lo:b - lo] for r, (a, b) in
                          enumerate(cuts[self.rank]) if count[self.rank][r]]
                         or [part[:0]])
        got = exchange.all_to_all(
            send, self.mesh, send_counts=count[self.rank],
            recv_counts=[count[s][self.rank]
                         for s in range(self.num_shards)])
        self.collectives += 1
        k = 0
        for s in range(self.num_shards):
            c = count[s][self.rank]
            if c:
                a = cuts[s][self.rank][0]
                out[a - nlo:a - nlo + c] = got[k:k + c]
                k += c
        return out, (sent, received)

    @staticmethod
    def _batch_precheck(program, envs, regs_list, shared) -> None:
        """``run_lanes``'s ``BatchUnsupported`` tests over *every* lane,
        so that all ranks decide alike before each runs its block."""
        for name, value in envs[0].items():
            if name in shared:
                continue
            if any(not isinstance(e.get(name), torch.Tensor)
                   or e[name].shape != value.shape
                   or e[name].dtype != value.dtype for e in envs):
                raise BatchUnsupported(
                    f"region {name!r} differs in type or shape across lanes")
        for ins in program.instrs:
            if isinstance(ins, isa.RNG):
                caps = set()
                for regs in regs_list:
                    c = Engine._reg(regs, ins.rs1)
                    caps.add(-1 if isinstance(c, int) and c < 0 else int(c))
                if len(caps) > 1:
                    raise BatchUnsupported(
                        f"range-fuser capacities differ across lanes: "
                        f"{sorted(caps)}")

    def _constrain_batch(self, program, envs, regs_list, spd=None, *,
                         shared=frozenset(), dtypes=None) -> list:
        """A batched group over a process mesh: rank ``r`` runs its block
        of the ``k`` lanes (``rank_lanes`` over the batch axis; a short
        last block repeats the group's last lane), against the whole
        program environments every rank holds; then one all-gather puts
        the lanes' written regions and tiles back on every rank. The
        result is the single-device ``run_lanes``'s. A rank whose block
        fails fails the group on every rank (its status is all-gathered
        first)."""
        if not self.process or self.num_shards == 1:
            return super()._constrain_batch(program, envs, regs_list, spd,
                                            shared=shared, dtypes=dtypes)
        k, m = len(envs), self.num_shards
        self._batch_precheck(program, envs, regs_list, shared)
        per = -(-k // m)
        lanes = [min(self.rank * per + j, k - 1) for j in range(per)]
        try:
            outs, err = self.run_lanes(
                program, [envs[i] for i in lanes],
                [regs_list[i] for i in lanes], spd, shared=shared,
                dtypes=dtypes), None
        except Exception as e:
            outs, err = None, e
        code = 0 if err is None else (
            2 if isinstance(err, BatchUnsupported) else 1)
        status = exchange.all_gather(torch.tensor(
            [code], dtype=torch.int32, device=self.device),
            self.mesh).reshape(-1).tolist()
        self.collectives += 1
        if any(status):
            if err is not None:
                raise err
            bad = [r for r, c in enumerate(status) if c]
            if 2 in status:
                raise BatchUnsupported(f"rank(s) {bad}: the lanes cannot "
                                       "share one batched run")
            raise RuntimeError(f"rank(s) {bad} failed their block of the "
                               "batched group")
        written = sorted({ins.base for ins in program.instrs
                          if isinstance(ins, (isa.IST, isa.IRMW, isa.SST))})
        tiles = list(outs[0][1])
        parts = [[env[n] for n in written] + [sp[n] for n in tiles]
                 for env, sp in outs]
        flat = torch.stack([torch.cat([exchange._as_bytes(
            t.reshape(1, -1)).reshape(-1) for t in lane]) for lane in parts])
        got = exchange.all_gather(flat, self.mesh)
        self.collectives += 1
        got = got.reshape((m * per, -1))[:k]
        result = []
        for b in range(k):
            pieces, off = [], 0
            for t in parts[0]:
                nb = t.numel() * t.element_size()
                pieces.append(got[b, off:off + nb].clone().view(
                    t.dtype).reshape(t.shape))
                off += nb
            env = dict(envs[b])
            env.update(zip(written, pieces[:len(written)]))
            result.append(({n: env[n] for n in envs[b]},
                           dict(zip(tiles, pieces[len(written):]))))
        return result

    # -- host-side exchange planning ----------------------------------------

    def _measure_exchange(self, idx, valid, *, n_rows: int, kind: str):
        """Measure the post-dedup exchange of one stream on the host,
        replicating the device pipeline's clamp/drop, pad, slice and
        per-slice unique exactly (the capacity sizes a lossy buffer).
        Returns ``(meas, perm)``, or ``(None, None)`` when the stream is
        on the device or over budget."""
        h = _host(idx)
        if h is None:
            return None, None
        n = int(h.reshape(-1).shape[0])
        if n == 0 or n > self.measure_limit:
            return None, None
        h = h.reshape(-1).astype(np.int64)
        if valid is None:
            hv = np.ones(n, bool)
        else:
            hv = _host(valid)
            if hv is None:
                return None, None
            hv = hv.reshape(-1).astype(bool)
        if kind == "gather":
            h = np.clip(h, 0, n_rows - 1)          # loads clamp
        else:
            hv = hv & (h >= 0) & (h < n_rows)      # stores drop
        return self._measure_padded(h, hv, n_rows=n_rows)

    def _measure_padded(self, h: np.ndarray, hv: np.ndarray, *,
                        n_rows: int):
        """Evaluate both placements (block slices vs the owner-major
        permutation) of the canonical host stream: measured diagonal
        fraction, exact worst per-(source, owner) spill (power-of-two
        bucketed) and per-codec wire words."""
        ns = self.num_shards
        rows_per = -(-n_rows // ns)
        n = int(h.shape[0])
        per = -(-n // ns)
        L = per * ns
        hp = np.zeros(L, np.int64)
        hp[:n] = h
        vp = np.zeros(L, bool)
        vp[:n] = hv
        owner = np.clip(hp // rows_per, 0, ns - 1)
        key = np.where(vp, owner, ns)
        perm = np.argsort(key, kind="stable").astype(np.int32)
        meas = {}
        for placement, p in (("block", None), ("owner", perm)):
            sp = hp if p is None else hp[p]
            vv = vp if p is None else vp[p]
            diag = total = spill = 0
            for s in range(ns):
                sl = sp[s * per:(s + 1) * per]
                u = np.unique(sl[vv[s * per:(s + 1) * per]])
                cnt = np.bincount(np.clip(u // rows_per, 0, ns - 1),
                                  minlength=ns)
                total += int(cnt.sum())
                diag += int(cnt[s])
                cnt[s] = 0
                spill = max(spill, int(cnt.max()))
            cap = min(exchange.bucket_capacity(spill), per)
            meas[f"local_{placement}"] = diag / max(total, 1)
            meas[f"cap_{placement}"] = cap
            if spill == 0:
                # nothing crosses the fabric: only raw is legal
                wire = {"raw": cap, "bitmap": None, "delta": None}
            else:
                wire = {"raw": cap,
                        "bitmap": exchange.bitmap_words(rows_per),
                        "delta": (exchange.delta_words(cap)
                                  if rows_per <= (1 << 16) else None)}
            meas[f"wire_{placement}"] = wire
        return meas, perm

    @staticmethod
    def _versions(*ts) -> tuple:
        return tuple(None if t is None else t._version for t in ts)

    def _seed_cache(self, key, idx, valid, meas, perm) -> None:
        self._xplan_cache[key] = (idx, valid, self._versions(idx, valid),
                                  meas, perm)
        self._xplan_cache.move_to_end(key)
        while len(self._xplan_cache) > 64:
            self._xplan_cache.popitem(last=False)

    def _cached(self, key, idx, valid):
        hit = self._xplan_cache.get(key)
        if hit is None or hit[0] is not idx or hit[1] is not valid or \
                hit[2] != self._versions(idx, valid):
            return None
        self._xplan_cache.move_to_end(key)
        return hit[3], hit[4]

    def _plan_exchange(self, idx, valid, *, n_rows: int, kind: str,
                       placement: Optional[str] = None,
                       codec: Optional[str] = None,
                       capacity: Optional[int] = None):
        """Measure (or replay the cached measurement of the same, unchanged
        stream tensor) and let the cost model decide. ``placement``/
        ``codec`` pin the policy (the plan-IR annotation); the capacity
        comes from the measurement, or is ``capacity`` when the caller
        agreed it across the ranks of a process mesh (0: the worst case,
        the slice length)."""
        key = (id(idx), id(valid), n_rows, kind, self.num_shards)
        tensors = isinstance(idx, torch.Tensor) and (
            valid is None or isinstance(valid, torch.Tensor))
        hit = self._cached(key, idx, valid) if tensors else None
        if hit is not None:
            meas, perm = hit
        else:
            meas, perm = self._measure_exchange(idx, valid, n_rows=n_rows,
                                                kind=kind)
            if meas is not None and tensors:
                self._seed_cache(key, idx, valid, meas, perm)
        cm = self.exchange_cost
        if placement is not None or codec is not None:
            cm = dataclasses.replace(
                cm, force_placement=placement or cm.force_placement,
                force_codec=codec or cm.force_codec)
        xplan = cm.exchange_plan(meas)
        if xplan.placement == "owner" and perm is None:
            # a pinned "owner" placement without a measurable stream has
            # no permutation to apply — fall back to block, never guess
            xplan = dataclasses.replace(xplan, placement="block")
        if capacity is not None:
            xplan = dataclasses.replace(xplan, capacity=int(capacity))
        return xplan, (perm if xplan.placement == "owner" else None)

    def plan_node_exchange(self, node, cost) -> ExchangePlan:
        """Shard-pass hook: measure a mesh-placed fused node's exchange
        from its member streams (host-resident only) replicating the
        device dedup/pad layout, let ``cost`` pick (placement, codec,
        capacity), and seed the plan cache so emission reuses the
        measurement."""
        ns = self.num_shards
        try:
            if node.kind == "gather":
                if node.unique_idx is None or node.n_lanes == 0 or \
                        node.n_lanes > self.measure_limit:
                    return cost.exchange_plan(None)
                streams = [_host(s) for s in node.streams]
                if any(s is None for s in streams):
                    return cost.exchange_plan(None)
                cat = np.concatenate([s.reshape(-1) for s in streams])
                u = np.unique(np.clip(cat.astype(np.int64), 0,
                                      node.table_rows - 1))
                # the coalesce pass's padded layout: sorted unique values
                # first, pad (pad_valid False) after
                L_pad = int(node.unique_idx.shape[0])
                h = np.zeros(L_pad, np.int64)
                h[:u.shape[0]] = u
                hv = np.zeros(L_pad, bool)
                hv[:u.shape[0]] = True
                meas, perm = self._measure_padded(
                    h, hv, n_rows=node.table_rows)
                key = (id(node.unique_idx), id(node.pad_valid),
                       node.table_rows, "gather", ns)
                self._seed_cache(key, node.unique_idx, node.pad_valid,
                                 meas, perm)
            else:
                if node.idx is None or node.n_lanes == 0 or \
                        node.n_lanes > self.measure_limit:
                    return cost.exchange_plan(None)
                arrs = [_host(m.idx) for m in node.members]
                conds = [None if m.cond is None else _host(m.cond)
                         for m in node.members]
                if any(a is None for a in arrs) or any(
                        c is None and m.cond is not None
                        for c, m in zip(conds, node.members)):
                    return cost.exchange_plan(None)
                h = np.concatenate([a.reshape(-1)
                                    for a in arrs]).astype(np.int64)
                hv = np.concatenate(
                    [np.ones(m.n_lanes, bool) if c is None
                     else c.reshape(-1).astype(bool)
                     for m, c in zip(node.members, conds)])
                hv = hv & (h >= 0) & (h < node.table_rows)
                meas, perm = self._measure_padded(
                    h, hv, n_rows=node.table_rows)
                key = (id(node.idx), id(node.cond), node.table_rows,
                       "rmw", ns)
                self._seed_cache(key, node.idx, node.cond, meas, perm)
        except (ValueError, TypeError, RuntimeError):
            return cost.exchange_plan(None)
        xplan = cost.exchange_plan(meas)
        if xplan.placement == "owner" and perm is None:
            xplan = dataclasses.replace(xplan, placement="block")
        return xplan

    def _concretize(self, xplan: ExchangePlan, perm, per: int):
        """The static call geometry: effective capacity (the slice length
        when unmeasured), effective codec (compression needs a measured
        bound) and the placement permutation (None for block)."""
        cap = int(xplan.capacity) if xplan.capacity else per
        codec = xplan.codec if xplan.capacity else "raw"
        perm_t = None
        if perm is not None and xplan.placement == "owner":
            perm_t = torch.as_tensor(perm, device=self.device).to(
                torch.int64)
        return cap, codec, perm_t

    # -- inputs ---------------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return interop.to_tensor(np.asarray(x), device=self.device)

    def _pad_stream(self, idx: torch.Tensor, valid=None):
        """The stream padded to ``per * num_shards`` lanes and its mask."""
        n = int(idx.shape[0])
        per = -(-n // self.num_shards)
        L = per * self.num_shards
        pad = L - n
        mask = torch.arange(L, device=self.device) < n
        if pad:
            idx = torch.cat([idx, idx.new_zeros((pad,))])
        if valid is not None:
            valid = self._tensor(valid).reshape(-1).to(torch.bool)
            mask[:n] &= valid
        return idx, mask, per

    def _shard_view(self, x: torch.Tensor, perm, per: int):
        """The lanes of a stream this process computes, in their
        placement: ``(m, per, ...)`` on a logical mesh, the rank's own
        ``(1, per, ...)`` on a process mesh. ``x`` is padded to
        ``per * m`` lanes (a process mesh also takes it unpadded: its
        pad lanes are masked)."""
        if self.process:
            lo = self.rank * per
            pos = perm[lo:lo + per] if perm is not None else \
                torch.arange(lo, lo + per, device=self.device)
            return x[pos.clamp(max=x.shape[0] - 1)][None]
        if perm is not None:
            x = x[perm]
        return x.reshape((self.num_shards, per) + tuple(x.shape[1:]))

    @staticmethod
    def _unsigned(table, unsigned) -> bool:
        if unsigned is not None:
            return bool(unsigned)
        return not isinstance(table, torch.Tensor) and \
            np.asarray(table).dtype.kind == "u"

    @staticmethod
    def _row_nbytes(table: torch.Tensor) -> int:
        nb = table.element_size()
        for d in table.shape[1:]:
            nb *= int(d)
        return nb

    # -- the exchange ---------------------------------------------------------

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Bucket ``j`` of shard ``i`` -> bucket ``i`` of shard ``j``:
        ``x`` ``(m, m*C, ...)`` viewed as ``(m, m, C, ...)`` and
        transposed on its two shard axes."""
        ns = self.num_shards
        v = x.reshape((ns, ns, -1) + tuple(x.shape[2:]))
        return v.transpose(0, 1).reshape(x.shape)

    def _swap(self, x: torch.Tensor, fl: ExchangeInflight
              ) -> exchange.Exchange:
        """Swap the bucket buffers ``(S, m*C, ...)`` of the shards this
        process computes: the transpose on a logical mesh (done at once),
        one asynchronous collective over the group on a process mesh
        (counted on ``fl``)."""
        if not self.process:
            return exchange.Exchange(None, self._all_to_all(x), None)
        fl.collectives += 1
        return exchange.all_to_all(x[0], self.mesh, async_op=True).then(
            lambda got: got[None])

    def _split_by_owner(self, u_idx, u_valid, rows_per: int):
        """Own/remote split of the deduped slices plus the full (diagonal
        included) post-dedup routing counts ``sent`` ``(S, m)``."""
        ns = self.num_shards
        owner = (u_idx // rows_per).clamp(0, ns - 1)
        local_row = u_idx - owner * rows_per
        me = self._shards[:, None]
        is_local = u_valid & (owner == me)
        is_remote = u_valid & (owner != me)
        okey = torch.where(u_valid, owner, ns).to(torch.int64)
        sent = torch.zeros((okey.shape[0], ns + 1), dtype=torch.int32,
                           device=self.device).scatter_add_(
            1, okey, torch.ones_like(okey, dtype=torch.int32))[:, :ns]
        return local_row, is_local, is_remote, sent

    def _send_indices(self, send_idx, send_valid, fl: ExchangeInflight):
        """Ship the remote index spill (raw lanes with a -1 sentinel, or
        the codec's words); the exchange's ``wait()`` gives the owners'
        ``(local_rows, valid)`` ``(S, m*C)``."""
        rows_per, ns = fl.rows_per, self.num_shards
        if fl.codec == "raw":
            def land(recv):
                ok = recv >= 0
                r = recv.clamp(min=0)
                return torch.where(ok, r - (r // rows_per) * rows_per, 0), ok
            return self._swap(torch.where(send_valid, send_idx, -1),
                              fl).then(land)
        enc_fn, dec_fn, _ = exchange.CODECS[fl.codec]
        words = enc_fn(send_idx, send_valid, rows_per=rows_per,
                       num_shards=ns)
        return self._swap(words, fl).then(lambda w: dec_fn(
            w, rows_per=rows_per, num_shards=ns, capacity=fl.cap))

    def _landed(self, is_local, local_row, r_local, recv_valid):
        """Each owner's landed stream ``(S, W)``: its own rows, then the
        received buckets (source ``s``'s bucket at ``per + s*C``)."""
        cat_idx = torch.cat([torch.where(is_local, local_row, 0), r_local],
                            1)
        return cat_idx, torch.cat([is_local, recv_valid], 1)

    def _land(self, fl: ExchangeInflight) -> dict:
        """The owners' landed streams (``cat_idx``, ``cat_valid``), their
        counts and, on a logical mesh, where each deduped lane landed.
        A logical mesh's exchange is done at once, so its route stage
        calls this; a process mesh's exec stage calls it once the index
        exchange has arrived."""
        r = fl.route
        if "cat_idx" in r:
            return r
        r_local, recv_valid = fl.wire[0].wait()
        cat_idx, cat_valid = self._landed(r["is_local"], r["local_row"],
                                          r_local, recv_valid)
        r.update(cat_idx=cat_idx, cat_valid=cat_valid,
                 n_recv=cat_valid.sum(1, dtype=torch.int32),
                 n_uniq=exchange.masked_unique_count(cat_idx, cat_valid))
        if self.process:
            return r
        lane_pos = self._lane_positions(r["is_local"], r["order"],
                                        r["slot"], fl.cap)
        if fl.kind == "gather":
            r["lane_pos"] = lane_pos
        else:
            # the combined payload travels as its lanes' landed positions:
            # src[p] is the deduped lane whose update landed at position p
            drop = cat_idx.numel()
            r["src"] = torch.full((drop + 1,), -1, dtype=torch.int64,
                                  device=self.device).scatter_(
                0, torch.where(lane_pos >= 0, lane_pos, drop).reshape(-1),
                torch.arange(lane_pos.numel(), device=self.device))[:drop]
        return r

    def _lane_positions(self, is_local, order, slot, cap: int):
        """Where each deduped lane ``(s, j)`` of every shard landed, as a
        flat index into the owners' ``(m, W)`` landed streams: an own lane
        at ``s*W + j``, a remote one where its bucket slot ``o*C + r``
        lands on owner ``o`` (``o*W + per + s*C + r``); -1 for lanes that
        landed nowhere. On one device the exchange moves these positions,
        not the rows: values are read or written once, at the owners."""
        ns, per = is_local.shape
        W = per + ns * cap
        s = torch.arange(ns, device=self.device)[:, None]
        q = slot.to(torch.int64)
        o = q // cap
        sorted_pos = torch.where(q < ns * cap,
                                 o * W + per + s * cap + (q - o * cap), -1)
        pos = torch.full((ns, per), -1, dtype=torch.int64,
                         device=self.device).scatter_(
            1, order.to(torch.int64), sorted_pos)
        own = s * W + torch.arange(per, device=self.device)
        return torch.where(is_local, own, pos)

    @staticmethod
    def _kept(cat_valid):
        """Flat indices of the landed lanes that are valid: one host sync,
        which sizes the owners' bulk op to the lanes that landed."""
        return cat_valid.reshape(-1).nonzero().squeeze(1)

    def _overlap(self, fl: ExchangeInflight) -> float:
        """1.0 when the route's exchanges had completed at the exec stage
        (a non-blocking query: the collectives' ``is_completed()`` on a
        process mesh, the route's CUDA event on a logical one)."""
        if self.process:
            return 1.0 if all(w.is_completed() for w in fl.wire) else 0.0
        return 1.0 if fl.done is None or fl.done.query() else 0.0

    def _mark_route(self, fl: ExchangeInflight) -> ExchangeInflight:
        if not self.process and fl.wire and self.device.type == "cuda":
            fl.done = torch.cuda.Event()
            fl.done.record()
        return fl

    # -- owner-local execution ------------------------------------------------

    def _owner_gather(self, table: torch.Tensor, rows: torch.Tensor):
        """``table[rows]`` on the table this process holds (B1 on a 2-D
        table with ``use_kernel``)."""
        return bulk_ops.bulk_gather(
            table, rows, sort=self.optimize, dedup=self.optimize,
            use_kernel=self.use_kernel and table.ndim == 2,
            device=self.device)

    def _owner_rmw(self, table, rows, vals, *, op: str, unsigned: bool):
        """Landed updates applied to the table this process holds (B2 on a
        2-D table with ``use_kernel``)."""
        return bulk_ops.bulk_rmw(
            table, rows, vals, op=op, optimize=True,
            use_kernel=self.use_kernel and table.ndim == 2,
            unsigned=unsigned, device=self.device)

    # -- gather ---------------------------------------------------------------

    def gather_start(self, table, idx, *, valid=None,
                     placement: Optional[str] = None,
                     codec: Optional[str] = None,
                     n_rows: Optional[int] = None,
                     capacity: Optional[int] = None) -> ExchangeInflight:
        """Dispatch the route stage (dedup -> split -> pack -> index
        exchange) of a sharded gather; only the table's shape is read.
        Finish with ``gather_finish``."""
        return self._mark_route(self._gather_route(
            table, idx, valid, placement, codec, n_rows, capacity))

    def _gather_route(self, table, idx, valid, placement, codec, n_rows,
                      capacity=None):
        table = self._tensor(table)
        n_rows = self._n_rows(table, n_rows)
        idx_t = bulk_ops._as_index(self._tensor(idx)).reshape(-1)
        n = int(idx_t.shape[0])
        if n == 0:
            return ExchangeInflight(kind="gather:empty")
        xplan, perm = self._plan_exchange(idx, valid, n_rows=n_rows,
                                          kind="gather",
                                          placement=placement, codec=codec,
                                          capacity=capacity)
        # loads clamp (policy), as bulk_gather: any mesh size agrees with
        # the single-device engine on out-of-range streams
        idx_p, mask, per = self._pad_stream(idx_t.clamp(0, n_rows - 1),
                                            valid)
        cap, codec_eff, perm_t = self._concretize(xplan, perm, per)
        fl = ExchangeInflight(
            kind="gather", perm=perm_t, perm_host=perm, n=n, xplan=xplan,
            cap=cap, codec=codec_eff,
            rows_per=-(-n_rows // self.num_shards),
            value_nbytes=self._row_nbytes(table))
        idx_l = self._shard_view(idx_p, perm_t, per)
        mask_l = self._shard_view(mask, perm_t, per)
        u_idx, u_valid, inv, _ = exchange.dedup_stream(idx_l, mask_l)
        local_row, is_local, is_remote, sent = self._split_by_owner(
            u_idx, u_valid, fl.rows_per)
        send_idx, send_valid, order, slot, _ = exchange.partition_by_owner(
            u_idx, is_remote, rows_per=fl.rows_per,
            num_shards=self.num_shards, capacity=cap)
        fl.wire = (self._send_indices(send_idx, send_valid, fl),)
        fl.route = dict(inv=inv, is_local=is_local, local_row=local_row,
                        order=order, slot=slot, sent=sent, mask_l=mask_l)
        if not self.process:
            self._land(fl)
        return fl

    def gather_finish(self, table, fl: ExchangeInflight):
        """Exec stage of ``gather_start``: owner-local takes, the inverse
        value exchange and lane unpacking. Records on
        ``last_shard_stats`` whether the route had completed (a
        non-blocking query)."""
        overlap = self._overlap(fl) if fl.kind == "gather" else None
        return self._gather_exec(table, fl, overlap)

    def _gather_exec(self, table, fl: ExchangeInflight, overlap):
        table = self._tensor(table)
        if fl.kind == "gather:empty":
            self.last_shard_stats = None
            return table[torch.zeros((0,), dtype=torch.int64,
                                     device=self.device)]
        r = self._land(fl)
        cat_idx, cat_valid = r["cat_idx"], r["cat_valid"]
        if self.process:
            out = self._gather_owned(table, fl, cat_idx, cat_valid)
        else:
            out = self._gather_logical(table, fl, cat_idx, cat_valid)
        self._record_stats(r["sent"], r["n_recv"], r["n_uniq"], fl, overlap)
        return out

    def _gather_logical(self, table, fl, cat_idx, cat_valid):
        """Every owner's take at once over the whole table; each lane then
        reads the row its deduped lane landed on."""
        r = fl.route
        ns, W = cat_idx.shape
        base = (torch.arange(ns, device=self.device) * fl.rows_per)[:, None]
        keep = self._kept(cat_valid)
        vals = self._owner_gather(table, (cat_idx + base).reshape(-1)[keep])
        lane_pos = r["lane_pos"]
        at = torch.cumsum(cat_valid.reshape(-1), 0) - 1
        src = at[torch.gather(lane_pos, 1, r["inv"]).clamp(min=0)].clamp(
            min=0)
        if keep.numel():
            out = vals[src.reshape(-1)]
        else:
            out = table.new_zeros((src.numel(),) + tuple(table.shape[1:]))
        out.masked_fill_(~r["mask_l"].reshape((-1,) + (1,) * (out.ndim - 1)),
                         0)
        if fl.perm is not None:
            # undo the placement permutation (every lane written once)
            out = torch.zeros_like(out).index_copy_(0, fl.perm, out)
        return out[:fl.n]

    def _gather_owned(self, table, fl, cat_idx, cat_valid):
        """This rank's take from its slice (own lanes and the received
        buckets), the received buckets' rows back to their sources, and
        the rank's block of lanes."""
        r = fl.route
        per = int(r["is_local"].shape[1])
        row = tuple(table.shape[1:])
        keep = self._kept(cat_valid)
        landed = table.new_zeros((int(cat_idx.shape[1]),) + row)
        if keep.numel():
            landed[keep] = self._owner_gather(table,
                                              cat_idx.reshape(-1)[keep])
        back = self._swap(landed[None, per:], fl).wait()
        remote = exchange.unpack_result(back, r["order"], r["slot"],
                                        ~r["is_local"])
        lane = (1, per) + (1,) * len(row)
        u_vals = torch.where(r["is_local"].reshape(lane), landed[None, :per],
                             remote)
        out = u_vals[0][r["inv"][0].to(torch.int64)]
        out.masked_fill_(~r["mask_l"][0].reshape((per,) + lane[2:]), 0)
        if fl.perm_host is not None:
            out = self._unpermute(out, fl)
        lo, hi = self.rank_lanes(fl.n)
        return out[:hi - lo]

    def _unpermute(self, out: torch.Tensor, fl: ExchangeInflight):
        """Owner placement on a process mesh: this rank computed the lanes
        ``perm[rank*per:(rank+1)*per]``; one ragged exchange sends each to
        the rank whose block holds it. Every rank derives both sides'
        counts from the replicated permutation."""
        perm = np.asarray(fl.perm_host, np.int64)
        per, m, me = int(out.shape[0]), self.num_shards, self.rank
        mine = perm[me * per:(me + 1) * per]
        dest = mine // per
        order = np.argsort(dest, kind="stable")
        to_me = np.nonzero(perm // per == me)[0]
        got = exchange.all_to_all(
            out[torch.as_tensor(order, device=self.device)], self.mesh,
            send_counts=np.bincount(dest, minlength=m),
            recv_counts=np.bincount(to_me // per, minlength=m))
        fl.collectives += 1
        pos = torch.as_tensor(perm[to_me] - me * per, device=self.device)
        return torch.zeros_like(out).index_copy_(0, pos, got)

    def sharded_gather(self, table, idx, *, valid=None,
                       placement: Optional[str] = None,
                       codec: Optional[str] = None,
                       n_rows: Optional[int] = None,
                       capacity: Optional[int] = None) -> torch.Tensor:
        """``C = table[idx]`` with dedup and the reorder->coalesce pipeline
        running owner-locally for every shard; sets ``last_shard_stats``.

        ``valid``: optional ``(len(idx),)`` bool mask — False lanes never
        enter the exchange and read 0 (the scheduler's coalesce padding).
        ``placement``/``codec`` pin the exchange plan, ``capacity`` the
        bucket size (else measured). On a process mesh
        ``table`` is this rank's slice, ``n_rows`` the whole table's rows
        (required) and the result this rank's block of
        lanes (``rank_lanes``)."""
        fl = self._gather_route(table, idx, valid, placement, codec, n_rows,
                                capacity)
        return self._gather_exec(table, fl, None)

    # -- RMW ------------------------------------------------------------------

    def rmw_start(self, table, idx, values, *, op: str = "ADD",
                  valid=None, placement: Optional[str] = None,
                  codec: Optional[str] = None,
                  unsigned: Optional[bool] = None,
                  n_rows: Optional[int] = None,
                  capacity: Optional[int] = None) -> ExchangeInflight:
        """Route stage of a sharded RMW: pre-combine, split, and ship the
        index spill and the combined payload; only the table's shape is
        read. ``rmw_finish`` applies the landed updates."""
        return self._mark_route(self._rmw_route(
            table, idx, values, op, valid, placement, codec, unsigned,
            n_rows, capacity))

    def _rmw_route(self, table, idx, values, op, valid, placement, codec,
                   unsigned, n_rows, capacity=None):
        if op not in isa.RMW_OPS:
            raise ValueError(f"op {op!r} not in RMW_OPS {isa.RMW_OPS} "
                             "(sharded RMW needs reorder-safe combines)")
        unsigned = self._unsigned(table, unsigned)
        table = self._tensor(table)
        n_rows = self._n_rows(table, n_rows)
        idx_t = bulk_ops._as_index(self._tensor(idx)).reshape(-1)
        n = int(idx_t.shape[0])
        if n == 0:
            return ExchangeInflight(kind="rmw:empty")
        row = tuple(table.shape[1:])
        vals = self._tensor(values).reshape((n,) + row)
        if vals.dtype != table.dtype:
            vals = vals.to(table.dtype)
        xplan, perm = self._plan_exchange(idx, valid, n_rows=n_rows,
                                          kind="rmw", placement=placement,
                                          codec=codec, capacity=capacity)
        # stores drop (policy): out-of-range destinations never enter the
        # exchange, as bulk_rmw routes them out
        in_range = (idx_t >= 0) & (idx_t < n_rows)
        if valid is not None:
            in_range &= self._tensor(valid).reshape(-1).to(torch.bool)
        idx_p, mask, per = self._pad_stream(idx_t, in_range)
        pad = per * self.num_shards - n
        if pad and not self.process:
            vals = torch.cat([vals, vals.new_zeros((pad,) + row)])
        cap, codec_eff, perm_t = self._concretize(xplan, perm, per)
        fl = ExchangeInflight(
            kind="rmw", n=n, xplan=xplan, cap=cap, codec=codec_eff,
            rows_per=-(-n_rows // self.num_shards),
            value_nbytes=self._row_nbytes(table), op=op, unsigned=unsigned)
        ns = self.num_shards
        u_idx, u_vals, u_valid, _ = exchange.combine_duplicates(
            self._shard_view(idx_p, perm_t, per),
            self._shard_view(vals, perm_t, per),
            self._shard_view(mask, perm_t, per), op=op, unsigned=unsigned)
        local_row, is_local, is_remote, sent = self._split_by_owner(
            u_idx, u_valid, fl.rows_per)
        send_idx, send_valid, order, slot, _ = exchange.partition_by_owner(
            u_idx, is_remote, rows_per=fl.rows_per, num_shards=ns,
            capacity=cap)
        fl.wire = (self._send_indices(send_idx, send_valid, fl),)
        fl.route = dict(is_local=is_local, local_row=local_row, order=order,
                        slot=slot, sent=sent, u_vals=u_vals)
        if self.process:
            # the combined payload crosses the fabric with its indices
            fl.wire += (self._swap(exchange.pack_payload(
                u_vals, order, slot, num_shards=ns, capacity=cap), fl),)
        else:
            self._land(fl)
        return fl

    def rmw_finish(self, table, fl: ExchangeInflight):
        """Exec stage of ``rmw_start``: one owner-local segment-combine +
        unique scatter over the landed (own + received) updates."""
        overlap = self._overlap(fl) if fl.kind == "rmw" else None
        return self._rmw_exec(table, fl, overlap)

    def _rmw_exec(self, table, fl: ExchangeInflight, overlap):
        table = self._tensor(table)
        if fl.kind == "rmw:empty":
            self.last_shard_stats = None
            return table
        r = self._land(fl)
        cat_idx, cat_valid = r["cat_idx"], r["cat_valid"]
        row = tuple(table.shape[1:])
        keep = self._kept(cat_valid)
        if self.process:
            landed = torch.cat([r["u_vals"], fl.wire[1].wait()], 1)
            rows = cat_idx.reshape(-1)[keep]
            vals = landed.reshape((-1,) + row)[keep]
        else:
            base = (torch.arange(self.num_shards, device=self.device)
                    * fl.rows_per)[:, None]
            rows = (cat_idx + base).reshape(-1)[keep]
            vals = r["u_vals"].reshape((-1,) + row)[r["src"][keep]]
        if keep.numel() or not self.process:
            new = self._owner_rmw(table, rows, vals, op=fl.op,
                                  unsigned=fl.unsigned)
        else:
            new = table.clone()
        self._record_stats(r["sent"], r["n_recv"], r["n_uniq"], fl, overlap)
        return new

    def sharded_rmw(self, table, idx, values, *, op: str = "ADD",
                    valid=None, placement: Optional[str] = None,
                    codec: Optional[str] = None,
                    unsigned: Optional[bool] = None,
                    n_rows: Optional[int] = None,
                    capacity: Optional[int] = None) -> torch.Tensor:
        """``table[idx] op= values`` across the mesh, **one-way**:
        duplicate destinations merge with ``op`` on the source shard, one
        combined update per distinct row crosses the fabric, and the
        owners apply own + received updates. ``op`` in ``isa.RMW_OPS``;
        ``valid`` masks lanes out entirely; ``unsigned`` marks u32/u64
        containers (default: whether ``table`` is an unsigned NumPy
        array). Returns the new table — on a process mesh this rank's
        updated slice (``table`` is the slice, ``n_rows`` as for
        ``sharded_gather``)."""
        fl = self._rmw_route(table, idx, values, op, valid, placement,
                             codec, unsigned, n_rows, capacity)
        return self._rmw_exec(table, fl, None)

    def _record_stats(self, sent, recv, uniq, fl: ExchangeInflight,
                      overlap: Optional[float]) -> ShardStats:
        ns = self.num_shards
        if self.process:
            # every rank's counts, gathered within the call (never on a
            # later property read, which only some ranks might make)
            allc = exchange.all_gather(torch.cat(
                [sent.reshape(-1), recv.reshape(-1), uniq.reshape(-1)]).to(
                    torch.int32), self.mesh)
            fl.collectives += 1
            self.collectives += fl.collectives
            sent, recv, uniq = allc[:, :ns], allc[:, ns], allc[:, ns + 1]
        # no host transfer here: the counts stay on the device
        offd = ns * (ns - 1)
        idx_bytes = 4 * offd * exchange.codec_wire_words(
            fl.codec, rows_per=fl.rows_per, capacity=fl.cap)
        st = ShardStats(
            sent, recv, uniq, placement=fl.xplan.placement, codec=fl.codec,
            capacity=fl.cap, idx_bytes=idx_bytes,
            idx_bytes_raw=4 * offd * fl.cap,
            bytes_on_wire=idx_bytes + offd * fl.cap * fl.value_nbytes,
            overlap=overlap, transport=self.transport,
            collectives=fl.collectives)
        self.last_shard_stats = st
        return st


# ---------------------------------------------------------------------------
# "sharded" plan backend: shard-placement pass + owner-local emitters,
# registered at import (base: the scheduler's "local" backend)
# ---------------------------------------------------------------------------

def _shard_place(p: "plan.Plan", ctx: "plan.LowerContext") -> "plan.Plan":
    """The mesh variant of the pipeline's ``shard`` slot: per fused node
    the cost model (or the replayed skeleton) picks "bulk" vs "sharded";
    mesh-placed nodes are wrapped in ``ShardedNode`` carrying the exchange
    plan (the policy may be replayed; the capacity is always measured
    anew, a replayed data-dependent bound could drop lanes)."""
    roots, notes, gi, ri, xi = [], [], 0, 0, 0
    replay = ctx.replay
    for node in p.roots:
        if getattr(node, "error", None) is not None:
            roots.append(node)         # error nodes never place
            continue
        if isinstance(node, plan.FusedGather):
            if node.backend == "eager":
                backend = "eager"
            elif replay is not None and gi < len(replay.gather_backends):
                backend = replay.gather_backends[gi]
            else:
                backend = ctx.cost.gather_backend(node, ctx)
            gi += 1
        elif isinstance(node, plan.FusedRmw):
            if replay is not None and ri < len(replay.rmw_backends):
                backend = replay.rmw_backends[ri]
            else:
                backend = ctx.cost.rmw_backend(node, ctx)
            ri += 1
        else:
            roots.append(node)
            continue
        if backend != node.backend:
            node = dataclasses.replace(node, backend=backend)
        if backend == "sharded":
            cost = ctx.cost
            if replay is not None and xi < len(replay.exchange_plans):
                pl_, cd_ = replay.exchange_plans[xi]
                cost = dataclasses.replace(ctx.cost, force_placement=pl_,
                                           force_codec=cd_)
            xi += 1
            if hasattr(ctx.engine, "plan_node_exchange"):
                xp = ctx.engine.plan_node_exchange(node, cost)
            else:
                xp = cost.exchange_plan(None)
            node = plan.ShardedNode(
                nid=ctx.nid(), inner=node, num_shards=ctx.num_shards,
                placement=xp.placement, codec=xp.codec,
                capacity=xp.capacity,
                est_local_fraction=xp.est_local_fraction)
            notes.append(f"{node.inner.kind}#{node.inner.nid} -> sharded "
                         f"(mesh={ctx.num_shards}, "
                         f"rows={node.inner.table_rows}) {xp.describe()}")
        else:
            notes.append(f"{node.kind}#{node.nid} -> {backend} "
                         f"(rows={node.table_rows} < mesh or forced)")
        roots.append(node)
    p = dataclasses.replace(p, roots=tuple(roots))
    d = plan.PassDelta("shard", len(p.leaves) + len(roots),
                       len(p.leaves) + len(roots), tuple(notes))
    return dataclasses.replace(p, trace=p.trace + (d,))


def _call_args(node, ctx) -> dict:
    """A sharded node's engine call: the plan's policy (placement, codec)
    and, over a process mesh, the whole table's rows (the node's table is
    the rank's slice) and the capacity agreed across the ranks."""
    kw = dict(placement=node.placement, codec=node.codec)
    if ctx.engine.process:
        kw.update(n_rows=plan.unwrap(node).table_rows,
                  capacity=node.capacity)
    return kw


def _prefetch_gather_sharded(node, ctx: "plan.EmitContext"):
    """Route-stage prefetch: issue this gather's exchange before any
    node's exec dispatches."""
    g = plan.unwrap(node)
    if g.unique_idx is None or int(g.unique_idx.shape[0]) == 0:
        return
    ctx.exchange_inflight[node.nid] = ctx.engine.gather_start(
        g.table, g.unique_idx, valid=g.pad_valid, **_call_args(node, ctx))


def _emit_gather_sharded(node, ctx: "plan.EmitContext"):
    """Owner-local fused fetch across the mesh. Coalesce padding is
    masked out via ``pad_valid``, as in the reference (pad lanes would
    skew the exchange toward the max row's owner). Over a process mesh
    the rank's block of the distinct rows is put back together whole on
    every rank, so each ticket resolves to its whole result."""
    g = plan.unwrap(node)
    fl = ctx.exchange_inflight.pop(node.nid, None)
    if fl is not None:
        packed = ctx.engine.gather_finish(g.table, fl)
    else:
        packed = ctx.engine.sharded_gather(
            g.table, g.unique_idx, valid=g.pad_valid,
            **_call_args(node, ctx))
    st = ctx.engine.last_shard_stats
    if ctx.engine.process:
        packed = ctx.engine.whole(packed, int(g.unique_idx.shape[0]))
    if st is not None:
        st.collectives += ctx.engine.process
        ctx.shard_stats[g.table_id] = st
    for m, inv in zip(g.members, g.inverses):
        ctx.results[m.ticket.tid] = packed[inv]


def _prefetch_rmw_sharded(node, ctx: "plan.EmitContext"):
    """Route-stage prefetch for a sharded RMW: the one-way exchange needs
    only the table's shape, so it can fly before earlier updates to the
    same table land."""
    r = plan.unwrap(node)
    if r.idx is None or r.n_lanes == 0:
        return
    ctx.exchange_inflight[node.nid] = ctx.engine.rmw_start(
        r.table, r.idx, r.values, op=r.op, valid=r.cond,
        unsigned=r.unsigned, **_call_args(node, ctx))


def _emit_rmw_sharded(node, ctx: "plan.EmitContext"):
    """Owner-local fused RMW across the mesh; ``cond`` lanes stay out of
    the exchange. Over a process mesh the table is the rank's slice, and
    so is the new state its tickets resolve to."""
    r = plan.unwrap(node)
    table = ctx.tables.get(r.table_id, r.table)
    fl = ctx.exchange_inflight.pop(node.nid, None)
    if fl is not None:
        new = ctx.engine.rmw_finish(table, fl)
    else:
        new = ctx.engine.sharded_rmw(table, r.idx, r.values, op=r.op,
                                     valid=r.cond, unsigned=r.unsigned,
                                     **_call_args(node, ctx))
    if ctx.engine.last_shard_stats is not None:
        ctx.shard_stats[("rmw", r.table_id, r.op)] = \
            ctx.engine.last_shard_stats
    ctx.tables[r.table_id] = new
    ctx.rmw_members.setdefault(r.table_id, []).extend(r.members)


plan.register_backend(
    "sharded", base="local", sharded=True,
    passes_override={"shard": _shard_place},
    emitters={
        ("gather", "sharded"): _emit_gather_sharded,
        ("rmw", "sharded"): _emit_rmw_sharded,
    },
    prefetchers={
        ("gather", "sharded"): _prefetch_gather_sharded,
        ("rmw", "sharded"): _prefetch_rmw_sharded,
    })

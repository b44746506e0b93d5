"""ShardedEngine: the bulk-access engine over a mesh of logical shards.

The port of the JAX package's ``distributed.engine``. Paper §6.6, option 1:
multiple DX100 units partition the address range, and each bulk request
stream is split by owner unit so that the reorder / coalesce / interleave
pipeline runs *next to the memory that holds the rows*. The reference's
``shard_map`` over m devices becomes tensors with a leading shard axis:
every shard's stream slice is one row of an ``(m, per)`` tensor, each
exchange step runs once for all shards in batched tensor ops, and its
``all_to_all`` is the transpose of the ``(m, m, C)`` bucket view. Per call
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

Owner-local execution: with every shard on one device, shard ``o``'s
local row ``r`` is global row ``o * rows_per + r``, so all owners' takes
are ONE ``bulk_gather`` and all owners' updates ONE ``bulk_rmw`` over the
table, with ``use_kernel`` as the engine's: on a 2-D table they run
through the row-table kernels B1/B2 (the reference takes and
``bulk_rmw``s each shard's slice). Where shards sit on several devices,
each device's owners are served there (``.to(device)``) and the results
come back. Results equal the single-device engine's, gathers and integer
RMWs bit for bit.

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
``rmw_start``/``_finish``) so the emit stage can issue every sharded
node's exchange before any node's exec. Importing this module registers
the **"sharded" plan backend** (``repro_torch.plan.emit``).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch import plan
from repro_torch.core import bulk_ops, interop, isa
from repro_torch.core.engine import Engine
from repro_torch.distributed import exchange
from repro_torch.distributed.mesh import as_mesh
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
    (split path), 0.0 when not, None for fused calls.

    The counts stay on the device until a property reads them (so
    back-to-back sharded calls keep dispatching); the first read copies
    all of them to NumPy and drops the device tensors.
    """

    def __init__(self, sent, received, unique, *, placement: str = "block",
                 codec: str = "raw", capacity: int = 0, idx_bytes: int = 0,
                 idx_bytes_raw: int = 0, bytes_on_wire: int = 0,
                 overlap: Optional[float] = None):
        self._device: Optional[tuple] = (sent, received, unique)
        self._host: Optional[tuple] = None
        self.placement = placement
        self.codec = codec
        self.capacity = int(capacity)
        self.idx_bytes = int(idx_bytes)
        self.idx_bytes_raw = int(idx_bytes_raw)
        self.bytes_on_wire = int(bytes_on_wire)
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
    route: tuple = ()
    perm: object = None
    n: int = 0
    xplan: ExchangePlan = None
    cap: int = 0
    codec: str = "raw"
    rows_per: int = 0
    value_nbytes: int = 0
    op: str = "ADD"
    unsigned: bool = False
    done: object = None          # CUDA event recorded after the route


def _host(x) -> Optional[np.ndarray]:
    """``x`` as NumPy when it is already on the host (an array, a list, a
    CPU tensor), else None: a device tensor is never read."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.device.type == "cpu" else None
    return np.asarray(x)


class ShardedEngine(Engine):
    """Drop-in ``Engine`` whose bulk streams span a mesh of shards.

    ``mesh``: None (one shard per visible card), an int shard count
    (all shards round-robin on the visible cards: one card holds them
    all), or a ``distributed.mesh.Mesh``. ``device`` as for ``Engine``
    (None = CUDA); for a CPU engine the mesh lies on the CPU. Everything
    else matches ``Engine``; a 1-shard mesh gives single-device results.
    """

    plan_backend = "sharded"     # registered below at import time
    #: streams longer than this never get a host-side exchange measurement
    #: (the fallback plan — block placement, raw wire, worst-case capacity
    #: — is always correct, just not minimal)
    measure_limit = 1 << 16

    def __init__(self, mesh=None, *, tile_size: int = 16384,
                 optimize: bool = True, use_kernel: bool = False,
                 cost_model: Optional[CostModel] = None, device=None):
        super().__init__(tile_size=tile_size, optimize=optimize,
                         use_kernel=use_kernel, device=device)
        self.mesh = as_mesh(mesh, device=self.device)
        self.axis = self.mesh.axis
        self.num_shards = int(self.mesh.num_shards)
        # (id(idx), id(valid), n_rows, kind, ns) -> (idx, valid, versions,
        # meas, perm): strong refs keep the ids stable
        self._xplan_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.exchange_cost = cost_model or CostModel()
        self.last_shard_stats: Optional[ShardStats] = None

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
                       codec: Optional[str] = None):
        """Measure (or replay the cached measurement of the same, unchanged
        stream tensor) and let the cost model decide. ``placement``/
        ``codec`` pin the policy (the plan-IR annotation); the capacity
        always comes from the measurement."""
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
        """A padded lane stream in its placement, as ``(m, per, ...)``."""
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

    # -- the exchange, for all shards at once ---------------------------------

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Bucket ``j`` of shard ``i`` -> bucket ``i`` of shard ``j``:
        ``x`` ``(m, m*C, ...)`` viewed as ``(m, m, C, ...)`` and
        transposed on its two shard axes."""
        ns = self.num_shards
        v = x.reshape((ns, ns, -1) + tuple(x.shape[2:]))
        return v.transpose(0, 1).reshape(x.shape)

    def _split_by_owner(self, u_idx, u_valid, rows_per: int):
        """Own/remote split of the deduped slices plus the full (diagonal
        included) post-dedup routing counts ``sent`` ``(m, m)``."""
        ns = self.num_shards
        owner = (u_idx // rows_per).clamp(0, ns - 1)
        local_row = u_idx - owner * rows_per
        me = torch.arange(ns, device=self.device)[:, None]
        is_local = u_valid & (owner == me)
        is_remote = u_valid & (owner != me)
        okey = torch.where(u_valid, owner, ns).to(torch.int64)
        sent = torch.zeros((ns, ns + 1), dtype=torch.int32,
                           device=self.device).scatter_add_(
            1, okey, torch.ones_like(okey, dtype=torch.int32))[:, :ns]
        return local_row, is_local, is_remote, sent

    def _wire_indices(self, send_idx, send_valid, *, rows_per: int,
                      cap: int, codec: str):
        """Ship the remote index spill (raw lanes with a -1 sentinel, or
        the codec's words); returns the owners' ``(local_rows, valid)``
        ``(m, m*C)``."""
        if codec == "raw":
            recv = self._all_to_all(torch.where(send_valid, send_idx, -1))
            recv_valid = recv >= 0
            r = recv.clamp(min=0)
            local = r - (r // rows_per) * rows_per
            return torch.where(recv_valid, local, 0), recv_valid
        enc_fn, dec_fn, _ = exchange.CODECS[codec]
        words = enc_fn(send_idx, send_valid, rows_per=rows_per,
                       num_shards=self.num_shards)
        return dec_fn(self._all_to_all(words), rows_per=rows_per,
                      num_shards=self.num_shards, capacity=cap)

    def _landed(self, is_local, local_row, r_local, recv_valid):
        """Each owner's landed stream ``(m, W)``: its own rows, then the
        received buckets (source ``s``'s bucket at ``per + s*C``)."""
        cat_idx = torch.cat([torch.where(is_local, local_row, 0), r_local],
                            1)
        return cat_idx, torch.cat([is_local, recv_valid], 1)

    def _lane_positions(self, is_local, order, slot, cap: int):
        """Where each deduped lane ``(s, j)`` of every shard landed, as a
        flat index into the owners' ``(m, W)`` landed streams: an own lane
        at ``s*W + j``, a remote one where its bucket slot ``o*C + r``
        lands on owner ``o`` (``o*W + per + s*C + r``); -1 for lanes that
        landed nowhere. On one card the exchange moves these positions,
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

    # -- owner-local execution ------------------------------------------------

    def _owner_gather(self, table: torch.Tensor, rows: torch.Tensor,
                      owners: torch.Tensor):
        """``table[rows]`` for landed lanes owned by ``owners`` (global
        rows): one ``bulk_gather`` per device holding owners (B1 on a 2-D
        table with ``use_kernel``)."""
        def take(dev, r):
            return bulk_ops.bulk_gather(
                table.to(dev), r, sort=self.optimize, dedup=self.optimize,
                use_kernel=self.use_kernel and table.ndim == 2, device=dev)
        if len(self.mesh.devices) == 1:
            return take(self.device, rows)
        out = table.new_zeros((rows.shape[0],) + tuple(table.shape[1:]))
        entry = owners % len(self.mesh.devices)
        for j, dev in enumerate(self.mesh.devices):
            sel = (entry == j).nonzero().squeeze(1)
            out[sel] = take(dev, rows[sel].to(dev)).to(self.device)
        return out

    def _owner_rmw(self, table, rows, vals, owners, *, op: str,
                   unsigned: bool, rows_per: int):
        """Landed updates applied to their (global) rows: one
        ``bulk_rmw`` per device holding owners (B2 on a 2-D table with
        ``use_kernel``)."""
        def apply(dev, r, v):
            return bulk_ops.bulk_rmw(
                table.to(dev), r, v, op=op, optimize=True,
                use_kernel=self.use_kernel and table.ndim == 2,
                unsigned=unsigned, device=dev)
        if len(self.mesh.devices) == 1:
            return apply(self.device, rows, vals)
        nd = len(self.mesh.devices)
        new = table.clone()
        for j, dev in enumerate(self.mesh.devices):
            sel = ((owners % nd) == j).nonzero().squeeze(1)
            res = apply(dev, rows[sel].to(dev), vals[sel].to(dev)).to(
                self.device)
            for o in range(j, self.num_shards, nd):
                lo = min(o * rows_per, table.shape[0])
                hi = min((o + 1) * rows_per, table.shape[0])
                new[lo:hi] = res[lo:hi]
        return new

    # -- gather ---------------------------------------------------------------

    def gather_start(self, table, idx, *, valid=None,
                     placement: Optional[str] = None,
                     codec: Optional[str] = None) -> ExchangeInflight:
        """Dispatch the route stage (dedup -> split -> pack -> index
        exchange) of a sharded gather; only the table's shape is read.
        Finish with ``gather_finish``."""
        fl = self._gather_route(table, idx, valid, placement, codec)
        if fl.kind == "gather" and self.device.type == "cuda":
            fl.done = torch.cuda.Event()
            fl.done.record()
        return fl

    def _gather_route(self, table, idx, valid, placement, codec):
        table = self._tensor(table)
        n_rows = int(table.shape[0])
        idx_t = bulk_ops._as_index(self._tensor(idx)).reshape(-1)
        n = int(idx_t.shape[0])
        if n == 0:
            return ExchangeInflight(kind="gather:empty")
        xplan, perm = self._plan_exchange(idx, valid, n_rows=n_rows,
                                          kind="gather",
                                          placement=placement, codec=codec)
        # loads clamp (policy), as bulk_gather: any mesh size agrees with
        # the single-device engine on out-of-range streams
        idx_p, mask, per = self._pad_stream(idx_t.clamp(0, n_rows - 1),
                                            valid)
        cap, codec_eff, perm_t = self._concretize(xplan, perm, per)
        rows_per = -(-n_rows // self.num_shards)
        ns = self.num_shards
        idx_l = self._shard_view(idx_p, perm_t, per)
        mask_l = self._shard_view(mask, perm_t, per)
        u_idx, u_valid, inv, _ = exchange.dedup_stream(idx_l, mask_l)
        local_row, is_local, is_remote, sent = self._split_by_owner(
            u_idx, u_valid, rows_per)
        send_idx, send_valid, order, slot, _ = exchange.partition_by_owner(
            u_idx, is_remote, rows_per=rows_per, num_shards=ns,
            capacity=cap)
        r_local, recv_valid = self._wire_indices(
            send_idx, send_valid, rows_per=rows_per, cap=cap,
            codec=codec_eff)
        cat_idx, cat_valid = self._landed(is_local, local_row, r_local,
                                          recv_valid)
        n_recv = cat_valid.sum(1, dtype=torch.int32)
        n_uniq = exchange.masked_unique_count(cat_idx, cat_valid)
        lane_pos = self._lane_positions(is_local, order, slot, cap)
        return ExchangeInflight(
            kind="gather",
            route=(inv, cat_idx, cat_valid, lane_pos, sent, n_recv, n_uniq,
                   mask_l),
            perm=perm_t, n=n, xplan=xplan, cap=cap, codec=codec_eff,
            rows_per=rows_per, value_nbytes=self._row_nbytes(table))

    def gather_finish(self, table, fl: ExchangeInflight):
        """Exec stage of ``gather_start``: owner-local takes, the inverse
        value exchange and lane unpacking. Records on
        ``last_shard_stats`` whether the route had completed (a
        non-blocking event query)."""
        overlap = None
        if fl.kind == "gather":
            overlap = 1.0 if fl.done is None or fl.done.query() else 0.0
        return self._gather_exec(table, fl, overlap)

    def _gather_exec(self, table, fl: ExchangeInflight, overlap):
        table = self._tensor(table)
        if fl.kind == "gather:empty":
            self.last_shard_stats = None
            return table[torch.zeros((0,), dtype=torch.int64,
                                     device=self.device)]
        (inv, cat_idx, cat_valid, lane_pos, sent, n_recv, n_uniq,
         mask_l) = fl.route
        ns, W = cat_idx.shape
        base = (torch.arange(ns, device=self.device) * fl.rows_per)[:, None]
        # the owners take every landed row (own, then received) at once
        keep = self._kept(cat_valid)
        vals = self._owner_gather(table, (cat_idx + base).reshape(-1)[keep],
                                  keep // W)
        # each lane reads the row its deduped lane landed on
        at = torch.cumsum(cat_valid.reshape(-1), 0) - 1
        src = at[torch.gather(lane_pos, 1, inv).clamp(min=0)].clamp(min=0)
        if keep.numel():
            out = vals[src.reshape(-1)]
        else:
            out = table.new_zeros((src.numel(),) + tuple(table.shape[1:]))
        out.masked_fill_(~mask_l.reshape((-1,) + (1,) * (out.ndim - 1)), 0)
        if fl.perm is not None:
            # undo the placement permutation (every lane written once)
            out = torch.zeros_like(out).index_copy_(0, fl.perm, out)
        self._record_stats(sent, n_recv, n_uniq, fl, overlap)
        return out[:fl.n]

    def sharded_gather(self, table, idx, *, valid=None,
                       placement: Optional[str] = None,
                       codec: Optional[str] = None) -> torch.Tensor:
        """``C = table[idx]`` with dedup and the reorder->coalesce pipeline
        running owner-locally for every shard; sets ``last_shard_stats``.

        ``valid``: optional ``(len(idx),)`` bool mask — False lanes never
        enter the exchange and read 0 (the scheduler's coalesce padding).
        ``placement``/``codec`` pin the exchange plan."""
        fl = self._gather_route(table, idx, valid, placement, codec)
        return self._gather_exec(table, fl, None)

    # -- RMW ------------------------------------------------------------------

    def rmw_start(self, table, idx, values, *, op: str = "ADD",
                  valid=None, placement: Optional[str] = None,
                  codec: Optional[str] = None,
                  unsigned: Optional[bool] = None) -> ExchangeInflight:
        """Route stage of a sharded RMW: pre-combine, split, and ship the
        index spill and the combined payload; only the table's shape is
        read. ``rmw_finish`` applies the landed updates."""
        fl = self._rmw_route(table, idx, values, op, valid, placement,
                             codec, unsigned)
        if fl.kind == "rmw" and self.device.type == "cuda":
            fl.done = torch.cuda.Event()
            fl.done.record()
        return fl

    def _rmw_route(self, table, idx, values, op, valid, placement, codec,
                   unsigned):
        if op not in isa.RMW_OPS:
            raise ValueError(f"op {op!r} not in RMW_OPS {isa.RMW_OPS} "
                             "(sharded RMW needs reorder-safe combines)")
        unsigned = self._unsigned(table, unsigned)
        table = self._tensor(table)
        idx_t = bulk_ops._as_index(self._tensor(idx)).reshape(-1)
        n = int(idx_t.shape[0])
        if n == 0:
            return ExchangeInflight(kind="rmw:empty")
        n_rows = int(table.shape[0])
        row = tuple(table.shape[1:])
        vals = self._tensor(values).reshape((n,) + row)
        if vals.dtype != table.dtype:
            vals = vals.to(table.dtype)
        xplan, perm = self._plan_exchange(idx, valid, n_rows=n_rows,
                                          kind="rmw", placement=placement,
                                          codec=codec)
        # stores drop (policy): out-of-range destinations never enter the
        # exchange, as bulk_rmw routes them out
        in_range = (idx_t >= 0) & (idx_t < n_rows)
        if valid is not None:
            in_range &= self._tensor(valid).reshape(-1).to(torch.bool)
        idx_p, mask, per = self._pad_stream(idx_t, in_range)
        pad = per * self.num_shards - n
        if pad:
            vals = torch.cat([vals, vals.new_zeros((pad,) + row)])
        cap, codec_eff, perm_t = self._concretize(xplan, perm, per)
        rows_per = -(-n_rows // self.num_shards)
        ns = self.num_shards
        u_idx, u_vals, u_valid, _ = exchange.combine_duplicates(
            self._shard_view(idx_p, perm_t, per),
            self._shard_view(vals, perm_t, per),
            self._shard_view(mask, perm_t, per), op=op, unsigned=unsigned)
        local_row, is_local, is_remote, sent = self._split_by_owner(
            u_idx, u_valid, rows_per)
        send_idx, send_valid, order, slot, _ = exchange.partition_by_owner(
            u_idx, is_remote, rows_per=rows_per, num_shards=ns,
            capacity=cap)
        r_local, recv_valid = self._wire_indices(
            send_idx, send_valid, rows_per=rows_per, cap=cap,
            codec=codec_eff)
        cat_idx, cat_valid = self._landed(is_local, local_row, r_local,
                                          recv_valid)
        n_recv = cat_valid.sum(1, dtype=torch.int32)
        n_uniq = exchange.masked_unique_count(cat_idx, cat_valid)
        # the combined payload travels as its lanes' landed positions:
        # src[p] is the deduped lane whose update landed at position p
        lane_pos = self._lane_positions(is_local, order, slot, cap)
        drop = cat_idx.numel()
        src = torch.full((drop + 1,), -1, dtype=torch.int64,
                         device=self.device).scatter_(
            0, torch.where(lane_pos >= 0, lane_pos, drop).reshape(-1),
            torch.arange(lane_pos.numel(), device=self.device))[:drop]
        return ExchangeInflight(
            kind="rmw", route=(cat_idx, cat_valid, src, u_vals, sent,
                               n_recv, n_uniq),
            n=n, xplan=xplan, cap=cap, codec=codec_eff, rows_per=rows_per,
            value_nbytes=self._row_nbytes(table), op=op, unsigned=unsigned)

    def rmw_finish(self, table, fl: ExchangeInflight):
        """Exec stage of ``rmw_start``: one owner-local segment-combine +
        unique scatter over the landed (own + received) updates."""
        overlap = None
        if fl.kind == "rmw":
            overlap = 1.0 if fl.done is None or fl.done.query() else 0.0
        return self._rmw_exec(table, fl, overlap)

    def _rmw_exec(self, table, fl: ExchangeInflight, overlap):
        table = self._tensor(table)
        if fl.kind == "rmw:empty":
            self.last_shard_stats = None
            return table
        cat_idx, cat_valid, src, u_vals, sent, n_recv, n_uniq = fl.route
        ns, W = cat_idx.shape
        base = (torch.arange(ns, device=self.device) * fl.rows_per)[:, None]
        keep = self._kept(cat_valid)
        vals = u_vals.reshape((-1,) + tuple(u_vals.shape[2:]))[src[keep]]
        new = self._owner_rmw(table, (cat_idx + base).reshape(-1)[keep],
                              vals, keep // W, op=fl.op,
                              unsigned=fl.unsigned, rows_per=fl.rows_per)
        self._record_stats(sent, n_recv, n_uniq, fl, overlap)
        return new

    def sharded_rmw(self, table, idx, values, *, op: str = "ADD",
                    valid=None, placement: Optional[str] = None,
                    codec: Optional[str] = None,
                    unsigned: Optional[bool] = None) -> torch.Tensor:
        """``table[idx] op= values`` across the mesh, **one-way**:
        duplicate destinations merge with ``op`` on the source shard, one
        combined update per distinct row crosses the fabric, and the
        owners apply own + received updates. ``op`` in ``isa.RMW_OPS``;
        ``valid`` masks lanes out entirely; ``unsigned`` marks u32/u64
        containers (default: whether ``table`` is an unsigned NumPy
        array). Returns the new table."""
        fl = self._rmw_route(table, idx, values, op, valid, placement,
                             codec, unsigned)
        return self._rmw_exec(table, fl, None)

    def _record_stats(self, sent, recv, uniq, fl: ExchangeInflight,
                      overlap: Optional[float]) -> ShardStats:
        # no host transfer here: the counts stay on the device
        ns = self.num_shards
        offd = ns * (ns - 1)
        idx_bytes = 4 * offd * exchange.codec_wire_words(
            fl.codec, rows_per=fl.rows_per, capacity=fl.cap)
        st = ShardStats(
            sent, recv, uniq, placement=fl.xplan.placement, codec=fl.codec,
            capacity=fl.cap, idx_bytes=idx_bytes,
            idx_bytes_raw=4 * offd * fl.cap,
            bytes_on_wire=idx_bytes + offd * fl.cap * fl.value_nbytes,
            overlap=overlap)
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


def _prefetch_gather_sharded(node, ctx: "plan.EmitContext"):
    """Route-stage prefetch: issue this gather's exchange before any
    node's exec dispatches."""
    g = plan.unwrap(node)
    if g.unique_idx is None or int(g.unique_idx.shape[0]) == 0:
        return
    ctx.exchange_inflight[node.nid] = ctx.engine.gather_start(
        g.table, g.unique_idx, valid=g.pad_valid,
        placement=node.placement, codec=node.codec)


def _emit_gather_sharded(node, ctx: "plan.EmitContext"):
    """Owner-local fused fetch across the mesh. Coalesce padding is
    masked out via ``pad_valid``, as in the reference (pad lanes would
    skew the exchange toward the max row's owner)."""
    g = plan.unwrap(node)
    fl = ctx.exchange_inflight.pop(node.nid, None)
    if fl is not None:
        packed = ctx.engine.gather_finish(g.table, fl)
    else:
        packed = ctx.engine.sharded_gather(
            g.table, g.unique_idx, valid=g.pad_valid,
            placement=node.placement, codec=node.codec)
    if ctx.engine.last_shard_stats is not None:
        ctx.shard_stats[g.table_id] = ctx.engine.last_shard_stats
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
        placement=node.placement, codec=node.codec, unsigned=r.unsigned)


def _emit_rmw_sharded(node, ctx: "plan.EmitContext"):
    """Owner-local fused RMW across the mesh; ``cond`` lanes stay out of
    the exchange."""
    r = plan.unwrap(node)
    table = ctx.tables.get(r.table_id, r.table)
    fl = ctx.exchange_inflight.pop(node.nid, None)
    if fl is not None:
        new = ctx.engine.rmw_finish(table, fl)
    else:
        new = ctx.engine.sharded_rmw(table, r.idx, r.values, op=r.op,
                                     valid=r.cond,
                                     placement=node.placement,
                                     codec=node.codec, unsigned=r.unsigned)
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

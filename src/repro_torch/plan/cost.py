"""Cost model: per-node backend selection during lowering.

Inputs, per the plan-IR contract (DESIGN.md §9): stream sizes, *measured*
coalescing factors (host-side, only for streams that are already on the
host — never a device read), mesh width and table extent, and the
engine's compile-cache state (``structural_signature`` keyed — surfaced
through the batch pass's ``cache_hit`` annotation).

Decisions:

  program groups   "vmap" (one lane-batched engine run) for n > 1,
                   "eager" singletons
  fused gathers    "eager" (direct clamped read — skips the sort+unique)
                   only for a lone stream whose measurement positively
                   shows no duplication; "bulk" (coalesced fetch) for
                   everything else — multi-stream windows AND unmeasured
                   streams (on the device / over budget) keep the engine's
                   always-coalesce default; "sharded" when the engine
                   spans a mesh and the table is wide enough to partition
  fused RMWs       "bulk" or "sharded" (an unordered eager scatter would
                   change float reduction order, so writes always go
                   through the segment-combining bulk path)

``force_*`` pins a choice — the differential tests run every legal
backend against the cost model's pick and assert bit-equality. Every
cutoff is the JAX package's, so on the CPU (where every stream is
host-resident) the port decides exactly as the reference does, the mesh
exchange policy (placement, codec, capacity: ``exchange_plan``) included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

GATHER_BACKENDS = ("eager", "bulk", "sharded")
RMW_BACKENDS = ("bulk", "sharded")
PROGRAM_BACKENDS = ("eager", "vmap")
EXCHANGE_PLACEMENTS = ("block", "owner")
EXCHANGE_CODECS = ("raw", "bitmap", "delta")


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Per-node exchange decision for a mesh-placed fused node.

    ``placement``: how request lanes map to source shards — "block"
    (natural contiguous slices) or "owner" (owner-major permutation, so
    lanes start on the shard that owns their row and the fabric only
    carries the residual spill). ``codec``: wire encoding of the remote
    index spill — "raw" int32 lanes, "bitmap" occupancy words, or
    "delta" packed 16-bit run deltas (``distributed.exchange.CODECS``).
    ``capacity``: measured power-of-two per-(source, owner) spill bound
    (0 = unmeasured worst case, the slice length). Estimates ride along
    for ``explain()``; the engine re-measures capacity per call, because
    a replayed skeleton's *data-dependent* numbers must never size a
    lossy buffer.
    """
    placement: str = "block"
    codec: str = "raw"
    capacity: int = 0
    est_local_fraction: Optional[float] = None
    est_compression: Optional[float] = None
    measured: bool = False

    def describe(self) -> str:
        lf = ("?" if self.est_local_fraction is None
              else f"{self.est_local_fraction:.2f}")
        cx = ("?" if self.est_compression is None
              else f"{self.est_compression:.1f}x")
        cap = "worst" if not self.capacity else str(self.capacity)
        return (f"place={self.placement} codec={self.codec} cap={cap} "
                f"local~{lf} wire~{cx}")


def host_stream(member) -> Optional[np.ndarray]:
    """A gather leaf's (clamped) index stream as NumPy when it is already
    on the host — a CPU tensor, or the NumPy array the caller submitted —
    else None. Never copies from the device."""
    if isinstance(member.idx, torch.Tensor) and \
            member.idx.device.type == "cpu":
        return member.idx.numpy()
    return member.host_idx


@dataclasses.dataclass
class CostModel:
    force_gather: Optional[str] = None
    force_rmw: Optional[str] = None
    force_program: Optional[str] = None
    # streams longer than this are never measured (host dedup is
    # O(n log n); past this point the answer wouldn't change the pick)
    measure_limit: int = 1 << 16
    # measured coalescing factor below which a lone stream skips the
    # coalesce machinery entirely
    eager_factor_cutoff: float = 1.05
    # static coalescing priors by table id (e.g. 1.0 for affine/strided
    # accesses): consulted only for a lone stream the measurement could
    # not cover
    priors: dict = dataclasses.field(default_factory=dict)
    # exchange pins (None = decide from measurement; see exchange_plan)
    force_placement: Optional[str] = None
    force_codec: Optional[str] = None
    # minimum measured local-fraction gain before the owner-major
    # permutation (one extra device gather + scatter) is worth taking
    placement_gain_cutoff: float = 0.05

    def set_coalescing_prior(self, table_id: int, factor: float) -> None:
        """Record a statically-inferred coalescing factor for a table's
        index streams. Priors only ever steer path selection for
        unmeasured lone streams; gathers are bit-exact on either path, so
        a wrong prior costs performance, never correctness."""
        self.priors[table_id] = float(factor)

    def __post_init__(self):
        for v, legal in ((self.force_gather, GATHER_BACKENDS),
                         (self.force_rmw, RMW_BACKENDS),
                         (self.force_program, PROGRAM_BACKENDS),
                         (self.force_placement, EXCHANGE_PLACEMENTS),
                         (self.force_codec, EXCHANGE_CODECS)):
            if v is not None and v not in legal:
                raise ValueError(f"forced backend {v!r} not in {legal}")

    # -- exchange (mesh-placed nodes) ----------------------------------------

    def exchange_plan(self, meas: Optional[dict] = None) -> ExchangePlan:
        """Pick placement + codec + capacity for one mesh-placed node.

        ``meas`` is the engine's host-side exchange measurement (computed
        only when the stream is already on the host — the
        ``measure_factor`` discipline: never a device read), with keys
        ``local_block``/``local_owner`` (measured diagonal fraction of
        the post-dedup exchange matrix under each placement),
        ``cap_block``/``cap_owner`` (power-of-two bucketed worst
        per-(source, owner) remote spill) and ``wire_block``/
        ``wire_owner`` (codec name -> off-diagonal int32 words, None
        where a codec is statically illegal). ``meas=None`` — the stream
        was on the device or over budget — returns the safe fallback: block
        placement, raw wire, worst-case capacity (capacity 0), which can
        never drop a lane.
        """
        if meas is None:
            return ExchangePlan(placement=self.force_placement or "block",
                                codec=self.force_codec or "raw", capacity=0)
        placement = self.force_placement
        if placement is None:
            gain = meas["local_owner"] - meas["local_block"]
            placement = "owner" if gain > self.placement_gain_cutoff \
                else "block"
        wire = meas[f"wire_{placement}"]
        legal = {c: w for c, w in wire.items() if w is not None}
        codec = self.force_codec
        if codec is None or codec not in legal:
            # ties break toward raw: identical wire cost with no decode
            codec = min(legal, key=lambda c: (legal[c], c != "raw"))
        raw_w = max(wire.get("raw") or 1, 1)
        return ExchangePlan(
            placement=placement, codec=codec,
            capacity=int(meas[f"cap_{placement}"]),
            est_local_fraction=float(meas[f"local_{placement}"]),
            est_compression=raw_w / max(legal[codec], 1),
            measured=True)

    # -- gathers -------------------------------------------------------------

    def _sharded_eligible(self, node, ctx) -> bool:
        """Mesh placement on the table's *whole* extent. Over a process
        mesh exactly the row-sharded tables (a rank's slice) go to the
        mesh; a table every rank holds whole stays local."""
        if getattr(ctx, "process", False):
            return ctx.sharded_capable and node.sliced
        return ctx.sharded_capable and node.table_rows >= ctx.num_shards

    def local_refusal(self, node) -> Optional[ValueError]:
        """Why a local path forced by ``force_gather``/``force_rmw`` cannot
        serve ``node``: its table is a rank's slice, and a local path
        would read the slice as if it were the whole table. None when the
        node is not a slice or no local path is forced. The fuse pass
        fails such a node, on every rank alike."""
        knob = "force_rmw" if node.kind == "rmw" else "force_gather"
        path = getattr(self, knob)
        if not getattr(node, "sliced", False) or path not in ("eager",
                                                              "bulk"):
            return None
        return ValueError(
            f"{node.kind}#{node.nid}: CostModel.{knob}={path!r} forces a "
            f"local path, but the table is this rank's slice of "
            f"{node.table_rows} rows; a local path would read the slice as "
            f"the whole table. Over a process mesh a row-sharded table is "
            f"always 'sharded' (ROADMAP A14b)")

    def gather_path(self, node, ctx) -> tuple:
        """("eager" | "coalesce", measured factor or None) for one
        ``FusedGather``. Coalescing is mandatory whenever the node may
        go to the mesh (the exchange ships the deduped set) or more than
        one stream fused (cross-request reuse is the whole point)."""
        if self.force_gather == "eager":
            return "eager", self.measure_factor(node)
        if self.force_gather in ("bulk", "sharded"):
            return "coalesce", None
        if self._sharded_eligible(node, ctx):
            return "coalesce", None
        if len(node.streams) > 1:
            return "coalesce", None
        factor = self.measure_factor(node)
        if factor is not None and factor <= self.eager_factor_cutoff:
            # measurement POSITIVELY shows a duplication-free lone stream:
            # dedup cannot pay for its sort+unique. An unmeasurable stream
            # (on the device, or past the measurement budget) keeps the
            # always-coalesce default.
            return "eager", factor
        if factor is None and len(node.streams) <= 1:
            prior = self.priors.get(node.table_id)
            if prior is not None and prior <= self.eager_factor_cutoff:
                return "eager", None
        return "coalesce", factor

    def gather_backend(self, node, ctx) -> str:
        """"bulk" | "sharded" for an already-coalesced FusedGather."""
        if self.force_gather == "bulk":
            return "bulk"
        return "sharded" if self._sharded_eligible(node, ctx) else "bulk"

    def measure_factor(self, node) -> Optional[float]:
        """Host-side coalescing factor (#lanes / #distinct rows) of the
        fused stream — only when every stream is already on the host
        (``host_stream``). A stream on the card counts as not resident:
        reading it would be a device-to-host copy and a sync, and would
        make the plan depend on timing."""
        if node.n_lanes == 0 or node.n_lanes > self.measure_limit:
            return None
        streams = [host_stream(m) for m in node.members]
        if any(s is None for s in streams):
            return None
        cat = np.concatenate([s.reshape(-1) for s in streams])
        return float(cat.shape[0] / max(np.unique(cat).shape[0], 1))

    # -- RMWs ----------------------------------------------------------------

    def rmw_backend(self, node, ctx) -> str:
        if self.force_rmw == "bulk":
            return "bulk"
        return "sharded" if self._sharded_eligible(node, ctx) else "bulk"

    # -- program groups ------------------------------------------------------

    def program_backend(self, members, ctx) -> str:
        if self.force_program is not None:
            return self.force_program
        return "vmap" if len(members) > 1 else "eager"

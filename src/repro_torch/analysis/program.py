"""Abstract interpretation of ``AccessProgram``s over interval domains.

``analyze_program`` walks an instruction list once, carrying an interval
``[lo, hi]`` plus a provenance tag for every scratchpad tile, and records
for each memory access (ILD/IST/IRMW/SLD/SST) a sound over-approximation
of the indices it can touch. Soundness contract (checked property-based
against the NumPy oracle in tests/test_analysis.py): every index the
oracle actually executes lies inside the inferred interval. The analyzer
may over-approximate, never under-approximate.

The port's copy of the JAX package's ``analysis.program``, over the port's
``core.isa``: NumPy only, run at lint time, on no execution path. The
transfer functions mirror ``repro_torch.testing.oracle.OracleEngine._exec``
— the repo's ground truth — including its quirks:

  * SLD reads all ``tile_size`` lanes regardless of the count register.
  * ILD applies ``where(cond, idx, 0)`` *before* clipping, so a
    conditional gather's index interval is hulled with 0.
  * IST/IRMW skip condition-masked lanes entirely (no hull with 0) and
    drop out-of-range addresses.
  * Index arithmetic happens in int32: any ALU hull that can exceed an
    involved integer dtype widens to the full output-dtype range (wrap).
  * Float results get a small relative epsilon widening — exact Python
    arithmetic on the corners can otherwise miss f32-rounded values.

Per-access classification (``affine`` / ``strided`` / ``indirect`` plus
an orthogonal ``conditional`` flag) follows the index chain's
provenance: a closed form of the lane index is affine, anything loaded
from memory is data-dependent. ``coalescing_prior`` turns that into a
prior for ``plan.cost.CostModel.set_coalescing_prior`` — affine/strided
streams cannot gain
from dedup-coalescing, so the cost model may pick the eager path without
spending a measurement.

Region contents are snapshotted at analysis time: a region written by
IST/SST/IRMW is never read again within one program (``validate()``
enforces that), so content intervals stay valid for the whole walk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

import torch

from repro_torch.analysis import diagnostics as diag
from repro_torch.core import isa

INF = float("inf")

#: integer dtype ranges; floats (and unknown dtypes) are unbounded
_INT_BOUNDS = {
    "u32": (0, 2**32 - 1),
    "i32": (-(2**31), 2**31 - 1),
    "u64": (0, 2**64 - 1),
    "i64": (-(2**63), 2**63 - 1),
}

# relative/absolute slack applied to float-valued hulls: corner
# arithmetic is exact in Python but the engine rounds to f32/bf16
_F_REL = 1e-3
_F_ABS = 1e-6


def dtype_bounds(dtype: Optional[str]) -> Tuple[float, float]:
    if dtype in _INT_BOUNDS:
        return _INT_BOUNDS[dtype]
    return (-INF, INF)


# ---------------------------------------------------------------------------
# interval domain
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval [lo, hi]; ±inf encodes unbounded sides."""
    lo: float
    hi: float

    def __post_init__(self):
        if self.lo > self.hi:  # pragma: no cover - internal invariant
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @property
    def is_point(self) -> bool:
        return self.lo == self.hi and math.isfinite(self.lo)

    @property
    def finite(self) -> bool:
        return math.isfinite(self.lo) and math.isfinite(self.hi)

    def contains(self, x) -> bool:
        return self.lo <= x <= self.hi

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def __repr__(self):
        return f"[{self.lo}, {self.hi}]"


TOP = Interval(-INF, INF)


def point(v) -> Interval:
    return Interval(v, v)


def from_dtype(dtype: Optional[str]) -> Interval:
    lo, hi = dtype_bounds(dtype)
    return Interval(lo, hi)


def cast_to(iv: Interval, dtype: Optional[str]) -> Interval:
    """Abstract ``astype``: in-range values pass through (truncated
    toward zero for integer targets — trunc is monotone, so the corner
    image bounds the whole image); anything that can overflow widens to
    the full target range (C-style wrap)."""
    lo, hi = dtype_bounds(dtype)
    if not iv.finite or iv.lo < lo or iv.hi > hi:
        return Interval(lo, hi)
    if dtype in _INT_BOUNDS:
        return Interval(math.trunc(iv.lo), math.trunc(iv.hi))
    return iv


def _widen_float(iv: Interval) -> Interval:
    if not iv.finite:
        return iv
    slack_lo = _F_REL * abs(iv.lo) + _F_ABS
    slack_hi = _F_REL * abs(iv.hi) + _F_ABS
    return Interval(iv.lo - slack_lo, iv.hi + slack_hi)


def _corner_hull(f, a: Interval, b: Interval) -> Interval:
    vals = [f(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(vals), max(vals))


def binop(op: str, a: Interval, b: Interval,
          involved_dtypes=(), out_dtype: Optional[str] = None) -> Interval:
    """Abstract ALU op. ``involved_dtypes`` lists the operand tile dtypes
    — the concrete engine computes in those (then casts to
    ``out_dtype``), so a hull escaping any involved *integer* range may
    wrap and must widen to the full output range."""
    if op == "ADD":
        raw = Interval(a.lo + b.lo, a.hi + b.hi)
    elif op == "SUB":
        raw = Interval(a.lo - b.hi, a.hi - b.lo)
    elif op == "MUL":
        if not (a.finite and b.finite):
            return from_dtype(out_dtype)
        raw = _corner_hull(lambda x, y: x * y, a, b)
    elif op == "MIN":
        raw = Interval(min(a.lo, b.lo), min(a.hi, b.hi))
    elif op == "MAX":
        raw = Interval(max(a.lo, b.lo), max(a.hi, b.hi))
    elif op == "AND":
        if a.lo >= 0 and b.lo >= 0:
            raw = Interval(0, min(a.hi, b.hi))
        else:
            return from_dtype(out_dtype)
    elif op in ("OR", "XOR"):
        if a.lo >= 0 and b.lo >= 0 and a.finite and b.finite:
            bits = max(int(a.hi).bit_length(), int(b.hi).bit_length())
            raw = Interval(0, (1 << bits) - 1)
        else:
            return from_dtype(out_dtype)
    elif op == "SHR":
        if not (a.finite and b.finite) or b.lo < 0 or b.hi > 64:
            return from_dtype(out_dtype)
        raw = _corner_hull(lambda x, y: int(x) >> int(y), a, b)
    elif op == "SHL":
        if not (a.finite and b.finite) or b.lo < 0 or b.hi > 64:
            return from_dtype(out_dtype)
        raw = _corner_hull(lambda x, y: int(x) << int(y), a, b)
    elif op in ("LT", "LE", "GT", "GE", "EQ"):
        raw = Interval(0, 1)
    else:  # pragma: no cover - ISA op list is closed
        return from_dtype(out_dtype)
    for dt in involved_dtypes:
        if dt in _INT_BOUNDS:
            lo, hi = _INT_BOUNDS[dt]
            if not raw.finite or raw.lo < lo or raw.hi > hi:
                return from_dtype(out_dtype)
    if out_dtype is not None and out_dtype not in _INT_BOUNDS:
        raw = _widen_float(raw)
    return cast_to(raw, out_dtype)


# ---------------------------------------------------------------------------
# tile states and access records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileState:
    """Abstract state of one scratchpad tile.

    ``prov`` is the provenance lattice: "affine" means the tile is a
    closed form of the lane index (iota load, RNG outer counter, ALU of
    affines); "data" means it was loaded from memory or joins one that
    was. ``conditional`` marks values influenced by a condition tile."""
    iv: Interval = TOP
    prov: str = "data"
    dtype: Optional[str] = None
    conditional: bool = False


_EXTERNAL = TileState(TOP, "data", None, False)


def _join_prov(*provs: str) -> str:
    return "affine" if all(p == "affine" for p in provs) else "data"


@dataclasses.dataclass(frozen=True)
class AccessRecord:
    """One memory access: instruction position, inferred index interval,
    and its static classification."""
    ip: int
    kind: str                  # ILD | IST | IRMW | SLD | SST
    base: str                  # region name
    op: Optional[str]          # RMW op, if any
    index: Interval            # sound over-approx of touched indices
    classification: str        # affine | strided | indirect
    conditional: bool
    rows: Optional[int]        # region length when known
    oob: bool                  # guaranteed entirely out of bounds


@dataclasses.dataclass(frozen=True)
class ProgramAnalysis:
    program: isa.AccessProgram
    accesses: Tuple[AccessRecord, ...]
    diagnostics: Tuple[diag.Diagnostic, ...]
    tiles: Mapping[str, TileState]

    @property
    def by_ip(self) -> Dict[int, AccessRecord]:
        return {a.ip: a for a in self.accesses}

    def errors(self):
        return diag.errors(self.diagnostics)

    def warnings(self):
        return diag.warnings(self.diagnostics)


def coalescing_prior(classification: str) -> Optional[float]:
    """Static prior for ``CostModel``: affine/strided index streams have
    no duplicate structure worth dedup-coalescing, so their expected
    coalescing factor is 1.0; indirect streams yield no prior (None)."""
    if classification in ("affine", "strided"):
        return 1.0
    return None


# ---------------------------------------------------------------------------
# region environment
# ---------------------------------------------------------------------------

_CONTENT_SCAN_LIMIT = 1 << 16


def _region_info(env: Optional[Mapping], base: str):
    """-> (rows or None, content Interval). Small NumPy arrays get exact
    min/max content ranges; big ones fall back to dtype bounds. A tensor
    is never read (it may live on the device, and its signed container
    may hold unsigned values): its content is the hull of both integer
    kinds of its width."""
    if env is None or base not in env:
        return None, TOP
    v = env[base]
    if isinstance(v, int):
        return int(v), TOP
    if isinstance(v, torch.Tensor):
        rows = int(v.shape[0]) if v.ndim else None
        if v.is_floating_point() or v.dtype == torch.bool:
            return rows, TOP
        wide = v.element_size() == 8
        lo, _ = dtype_bounds("i64" if wide else "i32")
        _, hi = dtype_bounds("u64" if wide else "u32")
        return rows, Interval(lo, hi)
    rows = int(v.shape[0]) if getattr(v, "shape", None) else None
    if isinstance(v, np.ndarray) and v.size and v.size <= _CONTENT_SCAN_LIMIT:
        try:
            return rows, Interval(float(v.min()), float(v.max()))
        except (TypeError, ValueError):  # non-numeric payloads
            return rows, TOP
    dt = getattr(v, "dtype", None)
    if dt is not None:
        name = np.dtype(dt).name if np.dtype(dt).kind in "iu" else None
        short = {"uint32": "u32", "int32": "i32",
                 "uint64": "u64", "int64": "i64"}.get(name)
        return rows, from_dtype(short)
    return rows, TOP


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------

class _Analyzer:
    def __init__(self, program, env, regs, externals):
        self.program = program
        self.ts = int(program.tile_size)
        self.env = env
        self.regs = regs
        self.externals = set(externals) if externals is not None else None
        self.tiles: Dict[str, TileState] = {}
        self.accesses: list = []
        self.diags: list = []
        self.last_def: Dict[str, int] = {}
        self.read_since: Dict[str, bool] = {}
        self.ip = 0

    # -- plumbing -----------------------------------------------------------

    def _emit(self, code, msg, *, table=None):
        self.diags.append(diag.make(code, msg, table=table, ip=self.ip))

    def tile(self, name: str) -> TileState:
        st = self.tiles.get(name)
        if st is not None:
            self.read_since[name] = True
            return st
        if self.externals is not None and name not in self.externals:
            self._emit("DX001",
                       f"tile {name!r} read before any definition and not "
                       f"declared external")
        return _EXTERNAL

    def reg(self, r) -> Interval:
        if isinstance(r, bool):
            return point(int(r))
        if isinstance(r, (int, float)):
            return point(r)
        if self.regs is None:
            return TOP
        if r in self.regs:
            v = self.regs[r]
            if isinstance(v, Interval):
                return v
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return point(v)
            return TOP
        self._emit("DX001", f"register {r!r} referenced but not provided")
        return TOP

    def define(self, name: str, st: TileState, *, implicit=False):
        if (not implicit and name in self.last_def
                and not self.read_since.get(name, False)):
            self._emit(
                "DX002",
                f"tile {name!r} written at ip{self.last_def[name]} is "
                f"overwritten before any read")
        self.tiles[name] = st
        self.last_def[name] = self.ip
        self.read_since[name] = False

    def record(self, kind, base, op, index: Interval, classification,
               conditional):
        rows, _content = _region_info(self.env, base)
        oob = False
        if rows is not None and (index.hi < 0 or index.lo >= rows):
            oob = True
            verb = "clamp" if kind in ("ILD", "SLD") else "drop"
            self._emit(
                "DX003",
                f"{kind} on region {base!r}: inferred index range {index} "
                f"lies entirely outside [0, {rows}) — every lane will "
                f"{verb}", table=base)
        self.accesses.append(AccessRecord(
            ip=self.ip, kind=kind, base=base, op=op, index=index,
            classification=classification, conditional=conditional,
            rows=rows, oob=oob))

    def _cond(self, tc: Optional[str]) -> bool:
        if tc is None:
            return False
        self.tile(tc)
        return True

    def _index_state(self, ts1: str):
        st = self.tile(ts1)
        cls = "affine" if st.prov == "affine" else "indirect"
        return st, cls

    # -- transfer functions (one per instruction kind) ----------------------

    def exec(self, ins: isa.Instr):
        if isinstance(ins, isa.SLD):
            has_cond = self._cond(ins.tc)
            lane = Interval(0, self.ts - 1)
            # oracle reads all tile_size lanes regardless of rs2
            step = binop("MUL", lane, self.reg(ins.rs3),
                         ("i32",), "i32")
            addr = binop("ADD", self.reg(ins.rs1), step, ("i32",), "i32")
            self.record("SLD", ins.base, None, addr, "strided", has_cond)
            rows, content = _region_info(self.env, ins.base)
            val = cast_to(content, ins.dtype)
            prov = "affine" if ins.base == "__iota__" else "data"
            if has_cond:
                val = val.hull(point(0))
            self.define(ins.td, TileState(val, prov, ins.dtype, has_cond))
        elif isinstance(ins, isa.SST):
            self.tile(ins.ts)
            has_cond = self._cond(ins.tc)
            cnt = self.reg(ins.rs2)
            if cnt.is_point:
                c = int(cnt.lo)
                count = self.ts if c < 0 else min(c, self.ts)
            else:
                count = self.ts
            if count <= 0:
                return
            lane = Interval(0, count - 1)
            step = binop("MUL", lane, self.reg(ins.rs3), ("i32",), "i32")
            addr = binop("ADD", self.reg(ins.rs1), step, ("i32",), "i32")
            self.record("SST", ins.base, None, addr, "strided", has_cond)
        elif isinstance(ins, isa.ILD):
            has_cond = self._cond(ins.tc)
            st, cls = self._index_state(ins.ts1)
            idx = cast_to(st.iv, "i32")
            if has_cond:
                # oracle: where(cond, idx, 0) happens before the clip
                idx = idx.hull(point(0))
            conditional = has_cond or st.conditional
            self.record("ILD", ins.base, None, idx, cls, conditional)
            rows, content = _region_info(self.env, ins.base)
            val = cast_to(content, ins.dtype)
            if has_cond:
                val = val.hull(point(0))
            self.define(ins.td, TileState(val, "data", ins.dtype, conditional))
        elif isinstance(ins, (isa.IST, isa.IRMW)):
            has_cond = self._cond(ins.tc)
            st, cls = self._index_state(ins.ts1)
            self.tile(ins.ts2)
            # masked lanes are skipped outright: no hull with 0
            idx = cast_to(st.iv, "i32")
            kind = "IRMW" if isinstance(ins, isa.IRMW) else "IST"
            op = ins.op if isinstance(ins, isa.IRMW) else None
            self.record(kind, ins.base, op, idx, cls,
                        has_cond or st.conditional)
        elif isinstance(ins, isa.ALUV):
            a = self.tile(ins.ts1)
            b = self.tile(ins.ts2)
            has_cond = self._cond(ins.tc)
            iv = binop(ins.op, a.iv, b.iv,
                       (a.dtype, b.dtype, ins.dtype), ins.dtype)
            if has_cond:
                iv = iv.hull(point(0))
            self.define(ins.td, TileState(
                iv, _join_prov(a.prov, b.prov), ins.dtype,
                has_cond or a.conditional or b.conditional))
        elif isinstance(ins, isa.ALUS):
            a = self.tile(ins.ts)
            has_cond = self._cond(ins.tc)
            iv = binop(ins.op, a.iv, self.reg(ins.rs),
                       (a.dtype, ins.dtype), ins.dtype)
            if has_cond:
                iv = iv.hull(point(0))
            self.define(ins.td, TileState(
                iv, a.prov, ins.dtype, has_cond or a.conditional))
        elif isinstance(ins, isa.RNG):
            lo = self.tile(ins.ts1)
            hi = self.tile(ins.ts2)
            has_cond = self._cond(ins.tc)
            cap = self.reg(ins.rs1)
            cap_hi = (self.ts if not cap.is_point or cap.lo < 0
                      else min(int(cap.lo), self.ts))
            conditional = has_cond or lo.conditional or hi.conditional
            # outer counters are lane numbers; unfilled slots stay 0
            self.define(ins.td1, TileState(
                Interval(0, max(self.ts - 1, 0)), "affine", "i32",
                conditional))
            inner = binop("SUB", cast_to(hi.iv, "i32"), point(1),
                          ("i32",), "i32")
            inner = cast_to(lo.iv, "i32").hull(inner).hull(point(0))
            self.define(ins.td2, TileState(
                inner, _join_prov(lo.prov, hi.prov), "i32", conditional),
                implicit=False)
            self.define("_rng_total",
                        TileState(Interval(0, max(cap_hi, 0)), "affine",
                                  "i32", conditional), implicit=True)
            self.define(ins.td1 + "__mask",
                        TileState(Interval(0, 1), "affine", "i32",
                                  conditional), implicit=True)
        else:  # pragma: no cover - ISA instruction list is closed
            raise TypeError(f"unknown instruction {ins!r}")

    def run(self) -> ProgramAnalysis:
        for ip, ins in enumerate(self.program.instrs):
            self.ip = ip
            self.exec(ins)
        return ProgramAnalysis(
            program=self.program,
            accesses=tuple(self.accesses),
            diagnostics=tuple(self.diags),
            tiles=dict(self.tiles))


def analyze_program(program: isa.AccessProgram,
                    env: Optional[Mapping] = None,
                    regs: Optional[Mapping] = None,
                    externals=None) -> ProgramAnalysis:
    """Analyze one program launch.

    ``env`` maps region names to arrays (or row counts) — supplies table
    lengths for OOB checks and content ranges for loaded-index bounds.
    ``regs`` maps register names to values or ``Interval``s; when None,
    register reads are unbounded and never flagged. ``externals`` is the
    set of tiles legally live before the program runs (e.g. a warm
    scratchpad); when None, undefined-tile reads are assumed external
    and not flagged (DX001 requires an explicit contract)."""
    return _Analyzer(program, env, regs, externals).run()

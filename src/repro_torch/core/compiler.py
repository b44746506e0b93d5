"""Compiler passes (paper §4.2) — pattern IR -> tiled AccessProgram.

The paper lowers C/C++ through Polygeist to MLIR affine/scf, tiles loops,
DFS-walks use-def chains from loop induction variables to find indirect
accesses, hoists loads / sinks stores into ``packed_*`` ops, checks legality
via alias analysis, and emits DX100 API calls.

Here the "legacy code" is a small declarative access IR covering every
pattern in Table 1 (single loops, direct/indirect range loops, 1-3 levels of
indirection, masked accesses, hash-style address calculation). The three
passes map 1:1:

  Pass 1 (tile)    : split the iteration space into TILE-sized chunks
  Pass 2 (hoist)   : classify each statement's access chain via DFS over the
                     index-expression tree; hoist loads, sink stores/RMWs;
                     legality = single-writer alias check + no loop-carried
                     dependences (paper §4.2 Legality)
  Pass 3 (codegen) : emit ISA instructions (SLD/ILD chains, ALUS/ALUV for
                     address math & conditions, RNG for range loops,
                     IST/IRMW sinks)

``compile_pattern`` returns an AccessProgram; run it with ``Engine``.
The passes are the JAX package's, unchanged: the IR is pure Python.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core import isa

# ---------------------------------------------------------------------------
# access-pattern IR ("legacy code")
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Var:
    """A loop induction variable ('i' of the tiled loop, 'j' of a fused
    range loop)."""
    name: str = "i"


@dataclasses.dataclass(frozen=True)
class Load:
    """BASE[expr] — one level of indirection per nesting level.

    dtype=None means "infer from use": i32 when used as an index/address,
    the access dtype when used as a stored value, f32 in conditions.
    """
    base: str
    index: "Expr"
    dtype: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BinOp:
    """Address calculation, e.g. (C[i] & F) >> G for hash-join."""
    op: str           # isa.ALU_OPS
    lhs: "Expr"
    rhs: "Expr"       # Expr or scalar register name / immediate


Expr = Union[Var, Load, BinOp, str, int]


@dataclasses.dataclass(frozen=True)
class Compare:
    """Loop condition, e.g. D[E[j]] < F (Table 1)."""
    op: str           # LT LE GT GE EQ
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class RangeLoop:
    """j = LO to HI where LO/HI are exprs of the outer var i.

    direct   : j = H[i]    .. H[i+1]     (lo=Load('H', Var()), ...)
    indirect : j = H[K[i]] .. H[K[i]+1]
    """
    var: str
    lo: Expr
    hi: Expr


@dataclasses.dataclass(frozen=True)
class Access:
    """One offloadable statement: LD / ST / RMW at an indirect address."""
    kind: str                 # "LD" | "ST" | "RMW"
    base: str
    index: Expr
    value: Optional[Expr] = None   # for ST/RMW: expr producing stored values
    op: str = "ADD"                # for RMW
    dtype: str = "f32"
    cond: Optional[Compare] = None


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A loop nest: `for i in [0,N): [for j in range: ] accesses`."""
    accesses: Sequence[Access]
    range_loop: Optional[RangeLoop] = None
    name: str = "pattern"


class LegalityError(ValueError):
    pass


# ---------------------------------------------------------------------------
# pass 2 helpers: DFS over index expressions
# ---------------------------------------------------------------------------

def _regions_read(e: Expr, acc=None):
    acc = set() if acc is None else acc
    if isinstance(e, Load):
        acc.add(e.base)
        _regions_read(e.index, acc)
    elif isinstance(e, BinOp):
        _regions_read(e.lhs, acc)
        _regions_read(e.rhs, acc)
    elif isinstance(e, Compare):
        _regions_read(e.lhs, acc)
        _regions_read(e.rhs, acc)
    return acc


def check_legality(p: Pattern):
    """Paper §4.2: (1) no core/DX100 store aliases a region DX100 loads
    within the loop (Gauss-Seidel is rejected); (2) RMW ops must be
    reorder-safe; (3) loop-carried deps: a region both loaded and written
    in the same pattern is illegal unless the write is the *only* access.
    """
    reads, writes = set(), set()
    for a in p.accesses:
        r = _regions_read(a.index)
        if a.cond is not None:
            r |= _regions_read(a.cond)
        if a.value is not None:
            r |= _regions_read(a.value)
        if a.kind == "LD":
            r.add(a.base)
            reads |= r
        else:
            writes.add(a.base)
            reads |= r
        if a.kind == "RMW" and a.op not in isa.RMW_OPS:
            raise LegalityError(f"RMW op {a.op} not reorder-safe")
    if p.range_loop is not None:
        reads |= _regions_read(p.range_loop.lo)
        reads |= _regions_read(p.range_loop.hi)
    overlap = reads & writes
    if overlap:
        raise LegalityError(
            f"aliasing hazard: regions {sorted(overlap)} are both read and "
            "indirectly written inside the loop (paper §4.2 rejects this, "
            "e.g. Gauss-Seidel)")


# ---------------------------------------------------------------------------
# pass 3: codegen
# ---------------------------------------------------------------------------

class _Emitter:
    def __init__(self, tile_size: int):
        self.instrs = []
        self.tile_size = tile_size
        self._n = itertools.count()
        self.iter_tile = {}      # var name -> tile holding its values

    def fresh(self, hint="t"):
        return f"%{hint}{next(self._n)}"

    def emit(self, ins):
        self.instrs.append(ins)

    def lower_expr(self, e: Expr, cond_tile=None, want: str = "i32") -> str:
        """DFS lowering of an index/value expression to a tile name.

        ``want`` is the inferred dtype for Loads/ALU ops that don't pin one
        (indices want i32; stored values want the access dtype).
        """
        if isinstance(e, Var):
            try:
                return self.iter_tile[e.name]
            except KeyError:
                raise LegalityError(
                    f"unknown loop variable {e.name!r}: not an induction "
                    f"variable of this pattern (known: "
                    f"{sorted(self.iter_tile)}) [DX001]") from None
        if isinstance(e, Load):
            idx_t = self.lower_expr(e.index, cond_tile, "i32")
            td = self.fresh("ld")
            self.emit(isa.ILD(e.dtype or want, e.base, td, idx_t,
                              tc=cond_tile))
            return td
        if isinstance(e, BinOp):
            lhs_t = self.lower_expr(e.lhs, cond_tile, want)
            if isinstance(e.rhs, (str, int, float)):
                td = self.fresh("alu")
                self.emit(isa.ALUS(want, e.op, td, lhs_t, rs=e.rhs,
                                   tc=cond_tile))
                return td
            rhs_t = self.lower_expr(e.rhs, cond_tile, want)
            td = self.fresh("alu")
            self.emit(isa.ALUV(want, e.op, td, lhs_t, rhs_t, tc=cond_tile))
            return td
        if isinstance(e, (str, int)):
            # scalar broadcast: materialize via ALUS ADD on a zero tile
            raise LegalityError(
                "bare scalars must appear as BinOp rhs (register operand)")
        raise TypeError(f"cannot lower {e!r}")

    def lower_compare(self, c: Compare) -> str:
        lhs_t = self.lower_expr(c.lhs, want="f32")
        td = self.fresh("cmp")
        if isinstance(c.rhs, (str, int, float)):
            self.emit(isa.ALUS("i32", c.op, td, lhs_t, rs=c.rhs))
        else:
            rhs_t = self.lower_expr(c.rhs, want="f32")
            self.emit(isa.ALUV("i32", c.op, td, lhs_t, rhs_t))
        return td


def compile_pattern(p: Pattern, *, tile_size: int = 16384,
                    n_register: str = "N") -> Tuple[isa.AccessProgram, dict]:
    """Compile a Pattern to an AccessProgram over one tile of the outer loop.

    The caller launches the program once per tile (the paper's
    `for base in range(0, N, TILE)` outer loop); `regs` must carry
    {n_register: remaining count, "tile_base": tile start}.

    Returns (program, info) where info names the scratchpad tiles holding
    each LD result (the packed_load queues of Fig. 7c).
    """
    check_legality(p)
    em = _Emitter(tile_size)
    info = {"loads": {}, "iteration_tile": None}

    # Pass 1 (tile): materialize the outer induction-variable tile
    # i = tile_base + [0, TILE)
    i_tile = em.fresh("i")
    em.emit(isa.SLD("i32", "__iota__", i_tile, rs1="tile_base",
                    rs2=n_register, rs3=1))
    em.iter_tile["i"] = i_tile
    # loop-bound guard: lanes past the trip count must not store/RMW
    # (the hardware's per-element finish bits; here an explicit mask tile)
    guard = em.fresh("guard")
    em.emit(isa.ALUS("i32", "LT", guard, i_tile, rs="tile_end"))

    # Range loop (RNG): fuse short inner ranges into bulk streams
    if p.range_loop is not None:
        rl = p.range_loop
        lo_t = em.lower_expr(rl.lo)
        hi_t = em.lower_expr(rl.hi)
        outer_t, inner_t = em.fresh("outer"), em.fresh("inner")
        em.emit(isa.RNG(outer_t, inner_t, lo_t, hi_t, rs1=-1, tc=guard))
        em.iter_tile[rl.var] = inner_t
        info["iteration_tile"] = (outer_t, inner_t)
        guard = outer_t + "__mask"       # fused-stream validity mask
        # RNG emits tile-local outer lane numbers; downstream `i` references
        # need the global induction value, so rebase by the tile offset.
        i_fused = em.fresh("ifused")
        em.emit(isa.ALUS("i32", "ADD", i_fused, outer_t, rs="tile_base",
                         tc=guard))
        em.iter_tile["i"] = i_fused

    # Pass 2+3: per access — condition tile, hoist/sink
    for a in p.accesses:
        tc = guard
        if a.cond is not None:
            user_tc = em.lower_compare(a.cond)
            tc = em.fresh("tc")
            em.emit(isa.ALUV("i32", "AND", tc, guard, user_tc))
        idx_t = em.lower_expr(a.index, tc, "i32")
        if a.kind == "LD":
            td = em.fresh("out")
            em.emit(isa.ILD(a.dtype, a.base, td, idx_t, tc=tc))
            info["loads"][a.base] = td
        elif a.kind == "ST":
            val_t = em.lower_expr(a.value, tc, a.dtype)
            em.emit(isa.IST(a.dtype, a.base, idx_t, val_t, tc=tc))
        elif a.kind == "RMW":
            val_t = em.lower_expr(a.value, tc, a.dtype)
            em.emit(isa.IRMW(a.dtype, a.base, a.op, idx_t, val_t, tc=tc))
        else:
            raise ValueError(a.kind)

    prog = isa.AccessProgram(tuple(em.instrs), tile_size=tile_size,
                             name=p.name)
    return prog, info


def run_tiled(engine, p: Pattern, env, *, n: int, extra_regs=None,
              dtypes=None):
    """Reference driver: compile once, launch per tile (paper Fig. 7d).

    ``env`` holds tensors on the engine's device; ``dtypes`` is passed to
    ``Engine.run`` (ISA dtype names of u32 regions, see there)."""
    import torch
    prog, info = compile_pattern(p, tile_size=engine.tile_size)
    env = dict(env)
    env["__iota__"] = torch.arange(  # iota region backing the SLD of `i`
        _round_up(n, engine.tile_size), dtype=torch.int32,
        device=engine.device)
    spd_last = None
    for base in range(0, n, engine.tile_size):
        count = min(engine.tile_size, n - base)
        regs = {"tile_base": base, "N": count, "tile_end": base + count}
        regs.update(extra_regs or {})
        env, spd_last = engine.run(prog, env, regs, dtypes=dtypes)
    env.pop("__iota__")
    return env, spd_last, info


def _round_up(a, b):
    return (a + b - 1) // b * b

"""DX100 instruction set (Table 2 of the paper), as a PyTorch IR.

An ``AccessProgram`` is a list of instruction dataclasses operating on named
scratchpad *tiles* and a scalar *register file*; ``repro_torch.core.engine``
executes it eagerly on tensors. Tiles are 1-D tensors of ``tile_size``
elements (the paper's 16K default), with a validity count per tile standing
in for the hardware size/ready bits.

Supported, mirroring the paper:
  * access types  : ILD (indirect load), IST (indirect store), IRMW
  * stream types  : SLD, SST  (strided loads/stores)
  * compute       : ALUV (tile op tile), ALUS (tile op scalar)
  * loop fusion   : RNG (range fuser)
  * DTYPE         : u32,i32,f32,u64,i64,f64 (+bf16)
  * OP            : ADD SUB MUL MIN MAX AND OR XOR SHR SHL LT LE GT GE EQ
  * conditions    : every instruction takes an optional condition tile TC
  * IRMW restriction: only associative+commutative ops (ADD MIN MAX AND OR
    XOR MUL) — the engine reorders accesses, exactly as in §3.1.

Widths follow the JAX package as it runs with 64-bit types off: ``i64``,
``u64`` and ``f64`` are 32 bits wide. Unsigned values live in an int32
*container* holding the same bits (torch has almost no ``uint32``
arithmetic): ADD, SUB, MUL, AND, OR, XOR and SHL are bit-identical there,
while MIN, MAX, the comparisons, SHR and conversion to float take
``unsigned=True`` and treat the bits as unsigned. ``KINDS`` names the
logical type of each ISA dtype; the engine tracks it beside every tile and
region.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import torch

# ---------------------------------------------------------------------------
# dtypes and ops
# ---------------------------------------------------------------------------

# tensor dtype (the container) of each ISA dtype
DTYPES = {
    "u32": torch.int32,
    "i32": torch.int32,
    "f32": torch.float32,
    "u64": torch.int32,
    "i64": torch.int32,
    "f64": torch.float32,
    "bf16": torch.bfloat16,
}

# logical type each ISA dtype computes in (64-bit names run at 32 bits)
KINDS = {
    "u32": "u32", "u64": "u32",
    "i32": "i32", "i64": "i32",
    "f32": "f32", "f64": "f32",
    "bf16": "bf16",
}

ALU_OPS = (
    "ADD", "SUB", "MUL", "MIN", "MAX",
    "AND", "OR", "XOR", "SHR", "SHL",
    "LT", "LE", "GT", "GE", "EQ",
)

# §3.1: IRMW supports only a reorder-safe (associative & commutative) subset.
RMW_OPS = ("ADD", "MIN", "MAX", "AND", "OR", "XOR", "MUL")

COMPARE_OPS = ("LT", "LE", "GT", "GE", "EQ")

_INT_KINDS = ("i32", "u32")
_SIGN_BIT = -(2 ** 31)
_MASK32 = 0xFFFFFFFF


def kind_of(t: torch.Tensor) -> str:
    """Logical kind of a tensor whose ISA type is not recorded elsewhere:
    int32 containers read as signed."""
    if t.dtype == torch.bool:
        return "bool"
    if t.dtype == torch.bfloat16:
        return "bf16"
    if t.is_floating_point():
        return "f32"
    return "i32"


def to_u64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 container, widened to int64."""
    return x.to(torch.int64) & _MASK32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32 (two's complement bits)."""
    return (((x & _MASK32) ^ 2 ** 31) - 2 ** 31).to(torch.int32)


def flip_sign(x: torch.Tensor) -> torch.Tensor:
    """Map unsigned order onto signed order (and back): toggle bit 31."""
    return x ^ _SIGN_BIT


def convert(x: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """``astype`` between logical kinds (i32, u32, f32, bf16, bool).

    Float -> int saturates and sends NaN to 0, as XLA's convert does;
    i32 <-> u32 keeps the bits; u32 -> float converts the unsigned value.
    """
    if src == dst:
        return x
    if dst == "bool":
        return x != 0
    if src == "bool":
        return x.to(DTYPES[dst])
    if dst in _INT_KINDS:
        if src in _INT_KINDS:
            return x
        xf = x.to(torch.float64)
        xf = torch.where(torch.isnan(xf), 0.0, xf).trunc()
        if dst == "u32":
            return wrap32(xf.clamp(0, _MASK32).to(torch.int64))
        return xf.clamp(-(2 ** 31), 2 ** 31 - 1).to(torch.int32)
    if src == "u32":
        return to_u64(x).to(DTYPES[dst])
    return x.to(DTYPES[dst])


def scalar(value, kind: str, device) -> torch.Tensor:
    """A register value as a 0-d tensor of ``kind`` (``jnp.asarray(v,
    dtype)``: floats truncate into ints; an int outside the unsigned
    range raises for u32, as JAX does)."""
    if isinstance(value, torch.Tensor):
        return convert(value.to(device), kind_of(value), kind)
    if kind == "u32":
        v = int(value)
        if not 0 <= v <= _MASK32:
            raise OverflowError(f"Python integer {v} out of bounds for u32")
        return torch.tensor(v - 2 ** 32 if v >= 2 ** 31 else v,
                            dtype=torch.int32, device=device)
    if kind == "i32":
        return torch.tensor(int(value), dtype=torch.int32, device=device)
    return torch.tensor(value, dtype=DTYPES[kind], device=device)


def promote(a: torch.Tensor, ka: str, b: torch.Tensor, kb: str):
    """JAX's promotion of two operand kinds (64-bit off): mixed signedness
    computes as i32, int with float as the float, bf16 with f32 as f32.
    Returns ``(a, b, kind)``."""
    if ka == kb:
        return a, b, ka
    if ka == "bool" or kb == "bool":
        kind = kb if ka == "bool" else ka
    elif ka in _INT_KINDS and kb in _INT_KINDS:
        return a, b, "i32"
    elif "f32" in (ka, kb):
        kind = "f32"
    else:
        kind = "bf16"
    return convert(a, ka, kind), convert(b, kb, kind), kind


def _shift_amount(b: torch.Tensor) -> torch.Tensor:
    # XLA reads the amount as unsigned: negative amounts are huge shifts
    return to_u64(b)


def _shr(a, b, unsigned: bool):
    amt = _shift_amount(b)
    if unsigned:
        r = to_u64(a) >> amt.clamp(max=31)
        return wrap32(torch.where(amt >= 32, 0, r))
    # arithmetic: shifts past the width fill with the sign bit
    return a >> amt.clamp(max=31).to(a.dtype)


def _shl(a, b):
    amt = _shift_amount(b)
    r = (to_u64(a) << amt.clamp(max=31)) & _MASK32
    return wrap32(torch.where(amt >= 32, 0, r))


def alu_apply(op: str, a, b, *, unsigned: bool = False):
    """Semantics of the OP field, shared by ALU unit and Word Modifier.

    ``unsigned`` says the int32 operands are u32 containers.
    """
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    if op in ("AND", "OR", "XOR", "SHR", "SHL") and (
            a.is_floating_point() or b.is_floating_point()):
        raise TypeError(f"ALU op {op} requires integer operands, "
                        f"got {a.dtype} and {b.dtype}")
    if unsigned and op in ("MIN", "MAX", "LT", "LE", "GT", "GE"):
        a, b = flip_sign(a), flip_sign(b)
        if op in ("MIN", "MAX"):
            return flip_sign(alu_apply(op, a, b))
        return alu_apply(op, a, b)
    if op == "ADD":
        return a + b
    if op == "SUB":
        return a - b
    if op == "MUL":
        return a * b
    if op == "MIN":
        return torch.minimum(a, b)
    if op == "MAX":
        return torch.maximum(a, b)
    if op == "AND":
        return a & b
    if op == "OR":
        return a | b
    if op == "XOR":
        return a ^ b
    if op == "SHR":
        return _shr(a, b, unsigned)
    if op == "SHL":
        return _shl(a, b)
    if op == "LT":
        return a < b
    if op == "LE":
        return a <= b
    if op == "GT":
        return a > b
    if op == "GE":
        return a >= b
    if op == "EQ":
        return a == b
    raise ValueError(f"unknown ALU op {op!r}")


def rmw_identity(op: str, dtype, *, unsigned: bool = False) -> torch.Tensor:
    """Identity element used to mask inactive lanes of a reordered RMW.

    ``dtype`` is a torch dtype (with ``unsigned`` for u32 containers) or an
    ISA dtype name. Returns a 0-d CPU tensor, which torch broadcasts as a
    scalar against tensors on any device.
    """
    if isinstance(dtype, str):
        unsigned = KINDS[dtype] == "u32"
        dtype = DTYPES[dtype]
    floating = dtype.is_floating_point
    if op in ("ADD", "OR", "XOR"):
        v = 0
    elif op == "MUL":
        v = 1
    elif op == "MIN":
        v = float("inf") if floating else (-1 if unsigned
                                           else torch.iinfo(dtype).max)
    elif op == "MAX":
        v = float("-inf") if floating else (0 if unsigned
                                            else torch.iinfo(dtype).min)
    elif op == "AND":
        v = -1
    else:
        raise ValueError(
            f"op {op!r} is not a legal IRMW op (must be one of {RMW_OPS})")
    return torch.tensor(v, dtype=dtype)


# ---------------------------------------------------------------------------
# instructions
# ---------------------------------------------------------------------------

Reg = Union[str, int, float]  # register name, or an immediate


@dataclasses.dataclass(frozen=True)
class Instr:
    """Base class; ``defs``/``uses`` drive the scoreboard hazard check."""

    def defs(self) -> Sequence[str]:  # tiles written
        return ()

    def uses(self) -> Sequence[str]:  # tiles read
        return ()


@dataclasses.dataclass(frozen=True)
class ILD(Instr):
    """SPD[td][i] = BASE[SPD[ts1][i]]  (if SPD[tc][i])."""
    dtype: str
    base: str          # name of the memory region (tensor) in the environment
    td: str
    ts1: str
    tc: Optional[str] = None

    def defs(self):
        return (self.td,)

    def uses(self):
        return (self.ts1,) + ((self.tc,) if self.tc else ())


@dataclasses.dataclass(frozen=True)
class IST(Instr):
    """BASE[SPD[ts1][i]] = SPD[ts2][i]  (if SPD[tc][i])."""
    dtype: str
    base: str
    ts1: str
    ts2: str
    tc: Optional[str] = None

    def defs(self):
        return ()

    def uses(self):
        return (self.ts1, self.ts2) + ((self.tc,) if self.tc else ())


@dataclasses.dataclass(frozen=True)
class IRMW(Instr):
    """BASE[SPD[ts1][i]] = OP(BASE[SPD[ts1][i]], SPD[ts2][i])."""
    dtype: str
    base: str
    op: str
    ts1: str
    ts2: str
    tc: Optional[str] = None

    def __post_init__(self):
        if self.op not in RMW_OPS:
            raise ValueError(
                f"IRMW op {self.op!r} not associative+commutative; "
                f"legal: {RMW_OPS}")

    def defs(self):
        return ()

    def uses(self):
        return (self.ts1, self.ts2) + ((self.tc,) if self.tc else ())


@dataclasses.dataclass(frozen=True)
class SLD(Instr):
    """SPD[td][i] = BASE[rs1 + i*rs3] for i < rs2  (if SPD[tc][i])."""
    dtype: str
    base: str
    td: str
    rs1: Reg = 0      # start
    rs2: Reg = -1     # count (-1 = full tile)
    rs3: Reg = 1      # stride
    tc: Optional[str] = None

    def defs(self):
        return (self.td,)

    def uses(self):
        return (self.tc,) if self.tc else ()


@dataclasses.dataclass(frozen=True)
class SST(Instr):
    """BASE[rs1 + i*rs3] = SPD[ts][i] for i < rs2  (if SPD[tc][i])."""
    dtype: str
    base: str
    ts: str
    rs1: Reg = 0
    rs2: Reg = -1
    rs3: Reg = 1
    tc: Optional[str] = None

    def defs(self):
        return ()

    def uses(self):
        return (self.ts,) + ((self.tc,) if self.tc else ())


@dataclasses.dataclass(frozen=True)
class ALUV(Instr):
    """SPD[td][i] = OP(SPD[ts1][i], SPD[ts2][i])."""
    dtype: str
    op: str
    td: str
    ts1: str
    ts2: str
    tc: Optional[str] = None

    def __post_init__(self):
        if self.op not in ALU_OPS:
            raise ValueError(f"unknown ALU op {self.op!r}")

    def defs(self):
        return (self.td,)

    def uses(self):
        return (self.ts1, self.ts2) + ((self.tc,) if self.tc else ())


@dataclasses.dataclass(frozen=True)
class ALUS(Instr):
    """SPD[td][i] = OP(SPD[ts][i], RF[rs])."""
    dtype: str
    op: str
    td: str
    ts: str
    rs: Reg = 0
    tc: Optional[str] = None

    def __post_init__(self):
        if self.op not in ALU_OPS:
            raise ValueError(f"unknown ALU op {self.op!r}")

    def defs(self):
        return (self.td,)

    def uses(self):
        return (self.ts,) + ((self.tc,) if self.tc else ())


@dataclasses.dataclass(frozen=True)
class RNG(Instr):
    """Range fuser (Fig. 5): flatten `for i: for j in [TS1[i], TS2[i])`.

    Writes outer iteration numbers to td1 and inner induction values to td2,
    compacted; rs1 holds the output-capacity register (defaults to tile).
    """
    td1: str
    td2: str
    ts1: str
    ts2: str
    rs1: Reg = -1
    tc: Optional[str] = None

    def defs(self):
        return (self.td1, self.td2)

    def uses(self):
        return (self.ts1, self.ts2) + ((self.tc,) if self.tc else ())


@dataclasses.dataclass(frozen=True)
class AccessProgram:
    """A sequence of DX100 instructions plus static metadata.

    ``tile_size`` is the paper's TILE (16K default). ``inputs`` names the
    memory regions (tensors) the program reads; ``outputs`` names regions it
    writes (IST/IRMW targets) and scratchpad tiles the host will read back.
    """
    instrs: tuple
    tile_size: int = 16384
    name: str = "dx100_program"

    def __post_init__(self):
        object.__setattr__(self, "instrs", tuple(self.instrs))
        self.validate()

    def validate(self):
        """Scoreboard-style static hazard & legality checks (§3.5, §4.2).

        A region written by IST/IRMW/SST must not be read by ILD/SLD later
        in the same program (the single-writer exclusivity rule), RNG must
        not write both streams to one tile, and RMW ops must be
        reorder-safe (checked in IRMW.__post_init__).
        """
        written_regions = set()
        for ins in self.instrs:
            if isinstance(ins, (ILD, SLD)):
                if ins.base in written_regions:
                    raise ValueError(
                        f"illegal program: region {ins.base!r} read after "
                        "indirect write within one program (aliasing hazard, "
                        "paper §4.2 Legality)")
            if isinstance(ins, (IST, IRMW, SST)):
                written_regions.add(ins.base)
            if isinstance(ins, RNG) and ins.td1 == ins.td2:
                raise ValueError(
                    f"illegal program: RNG writes both outer and inner "
                    f"streams to one tile {ins.td1!r} (duplicate "
                    "destination — the second write clobbers the first)")

    def scratch_tiles(self):
        tiles = []
        for ins in self.instrs:
            for t in tuple(ins.defs()) + tuple(ins.uses()):
                if t is not None and t not in tiles:
                    tiles.append(t)
        return tiles

    def external_tiles(self):
        """Tiles read before any instruction defines them — the warm
        scratchpad state a launch must supply via ``spd``. Accounts for
        RNG's implicit definitions (``td1 + "__mask"``, ``_rng_total``)."""
        defined, external = set(), []
        for ins in self.instrs:
            for t in ins.uses():
                if t is not None and t not in defined \
                        and t not in external:
                    external.append(t)
            for t in ins.defs():
                defined.add(t)
            if isinstance(ins, RNG):
                defined.add(ins.td1 + "__mask")
                defined.add("_rng_total")
        return tuple(external)

    def regions(self):
        """Memory region names the program touches, in first-use order."""
        out = []
        for ins in self.instrs:
            base = getattr(ins, "base", None)
            if base is not None and base not in out:
                out.append(base)
        return tuple(out)

    def register_names(self):
        """Scalar register names (string-valued Reg fields) the program
        reads, in first-use order."""
        out = []
        for ins in self.instrs:
            for field in ("rs", "rs1", "rs2", "rs3"):
                r = getattr(ins, field, None)
                if isinstance(r, str) and r not in out:
                    out.append(r)
        return tuple(out)

    def check_inputs(self, env: Mapping, regs: Mapping,
                     spd: Mapping) -> None:
        """Validate a launch's inputs upfront with a clear diagnostic
        (DX001): a missing region, register or warm tile would otherwise
        die deep inside the engine's instruction loop as a ``KeyError``."""
        missing = [r for r in self.regions() if r not in env]
        if missing:
            raise ValueError(
                f"program {self.name!r}: memory region(s) {missing} not "
                f"in env (known: {sorted(env)}) [DX001]")
        missing = [r for r in self.register_names() if r not in regs]
        if missing:
            raise ValueError(
                f"program {self.name!r}: scalar register(s) {missing} "
                f"not in regs (known: {sorted(regs)}) [DX001]")
        missing = [t for t in self.external_tiles() if t not in spd]
        if missing:
            raise ValueError(
                f"program {self.name!r}: tile(s) {missing} read before "
                f"any definition and not supplied via spd (known: "
                f"{sorted(spd)}) [DX001]")

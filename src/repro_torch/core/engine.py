"""DX100 engine: executes an AccessProgram against memory regions.

The paper's Controller dispatches instructions to four functional units with
scoreboard hazard tracking; here each instruction runs eagerly, in program
order, as PyTorch ops on the engine's device — dataflow replaces the
scoreboard, and the scratchpad is a dict of named tile tensors.

Usage:
    eng = Engine(tile_size=16384)                 # device=None -> "cuda"
    out_env, spd = eng.run(program, env={"A": a, "B": b}, regs={"N": n})
`env` holds the memory regions (the paper's main-memory arrays) as tensors
on the engine's device; regions written by IST/IRMW come back updated in
`out_env` (the tensors passed in are not modified). `spd` is the final
scratchpad (packed tiles the "cores" read back).

Types: u32 values travel in int32 containers (``core.isa``), so the engine
records each tile's and region's logical type beside it: a tile takes the
type its instruction names, a region the type named for it in ``dtypes``,
else the type of the instructions that write it (IST/IRMW/SST name their
region's type), else its tensor's (int32 reads as i32).

Compile cache: PyTorch runs eagerly, so there is nothing to trace; the
cache keeps the reference's bookkeeping. ``Engine.executable(program)``
returns a ``TracedExecutable`` cached per *structural signature*
(instruction stream modulo the display name); ``Engine.stats`` counts cache
traffic and ``TracedExecutable.traces`` the distinct input structures a
handle has seen — what ``jax.jit`` would have retraced on.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional

import torch

from repro_torch.core import bulk_ops, isa, range_fuser
from repro_torch.core.device import resolve_device


@functools.lru_cache(maxsize=1024)
def structural_signature(program: isa.AccessProgram) -> tuple:
    """Hashable structural identity of a program.

    Covers every instruction's opcode and fields (operand/tile/region names,
    immediates) and the tile size, but not the display ``name``. Programs
    with equal signatures execute identically (given equal env/reg
    structure), so they share one compile-cache entry.
    """
    return (program.tile_size,) + tuple(
        (type(ins).__name__,)
        + tuple((f.name, getattr(ins, f.name))
                for f in dataclasses.fields(ins))
        for ins in program.instrs)


def _structure(value):
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), value.dtype, value.device.type)
    return type(value).__name__


def _input_structure(env, regs, spd) -> tuple:
    return tuple(tuple(sorted((k, _structure(v)) for k, v in d.items()))
                 for d in (env, regs, spd))


class TracedExecutable:
    """A compile-cached handle for one program structure.

    ``calls`` counts calls; ``traces`` counts the distinct input structures
    (region/tile shapes and dtypes, register types) seen so far — it stays
    at 1 across any number of same-structure calls, which is the counter
    the compile-cache tests assert on.
    """

    def __init__(self, engine: "Engine", program: isa.AccessProgram,
                 key: tuple):
        self.engine = engine
        self.program = program
        self.key = key
        self.calls = 0
        self.traces = 0
        self._seen: set = set()

    def __call__(self, env, regs=None, spd=None, *, dtypes=None):
        self.calls += 1
        env, regs, spd = dict(env), dict(regs or {}), dict(spd or {})
        structure = _input_structure(env, regs, spd)
        if structure not in self._seen:
            self._seen.add(structure)
            self.traces += 1
        return self.engine.run(self.program, env, regs, spd, dtypes=dtypes)


class Engine:
    def __init__(self, tile_size: int = 16384, *, optimize: bool = True,
                 use_kernel: bool = False, device=None):
        self.tile_size = int(tile_size)
        self.optimize = optimize
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self._cache: Dict[tuple, TracedExecutable] = {}
        self.stats = {"trace_requests": 0, "trace_misses": 0}

    # -- compile cache -------------------------------------------------------
    @property
    def cache_hits(self) -> int:
        return self.stats["trace_requests"] - self.stats["trace_misses"]

    def executable(self, program: isa.AccessProgram, *,
                   batch: Optional[int] = None,
                   shared: frozenset = frozenset()) -> TracedExecutable:
        """Fetch (or build) the cached executable for ``program``.

        The cache key is the structural signature plus every engine knob
        that changes execution (tile size, optimize, kernel routing). Two
        programs differing only in ``name`` share an entry. Batched
        executables (``batch=k``) are not ported yet.
        """
        if batch is not None or shared:
            raise NotImplementedError(
                "batched executables (batch=, shared=) are not ported yet")
        key = self._cache_key(program, batch, shared)
        self.stats["trace_requests"] += 1
        exe = self._cache.get(key)
        if exe is None:
            self.stats["trace_misses"] += 1
            exe = TracedExecutable(self, program, key)
            self._cache[key] = exe
        return exe

    def _cache_key(self, program: isa.AccessProgram,
                   batch: Optional[int], shared) -> tuple:
        # single source of truth: executable() and peek_cached() must
        # never drift apart on what identifies a cached entry
        return (structural_signature(program), self.tile_size,
                self.optimize, self.use_kernel, batch, frozenset(shared))

    def peek_cached(self, program: isa.AccessProgram, *,
                    batch: Optional[int] = None,
                    shared: frozenset = frozenset()) -> bool:
        """True if the compile cache already holds this executable —
        read-only (never instantiates or counts)."""
        return self._cache_key(program, batch, shared) in self._cache

    # -- scalar operand resolution (register file) -------------------------
    @staticmethod
    def _reg(regs: Mapping, r):
        if isinstance(r, str):
            return regs[r]
        return r

    @staticmethod
    def _cond(spd, tc):
        if tc is None:
            return None
        return spd[tc] != 0

    def _i32(self, value) -> torch.Tensor:
        return isa.scalar(value, "i32", self.device)

    # -- instruction semantics ---------------------------------------------
    def _exec(self, ins: isa.Instr, env: Dict, spd: Dict, regs: Mapping,
              kinds: Dict):
        """One instruction. ``kinds`` maps ("env"|"spd", name) to the
        logical type of each region and tile."""
        ts = self.tile_size
        dev = self.device

        def tile(name):
            return spd[name], kinds[("spd", name)]

        def put(name, value, kind):
            spd[name] = value
            kinds[("spd", name)] = kind

        def region_kind(name):
            return kinds[("env", name)]

        if isinstance(ins, isa.SLD):
            # Lanes beyond the trip count (rs2) continue the stride
            # progression (clipped reads) rather than being zeroed;
            # downstream guards rely on the address progression staying
            # monotone. Lanes failing TC read 0.
            start = self._i32(self._reg(regs, ins.rs1))
            stride = self._i32(self._reg(regs, ins.rs3))
            base = env[ins.base]
            i = torch.arange(ts, dtype=torch.int32, device=dev)
            addr = start + i * stride
            vals = base[addr.clamp(0, base.shape[0] - 1)]
            kind = isa.KINDS[ins.dtype]
            vals = isa.convert(vals, region_kind(ins.base), kind)
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                vals = torch.where(cond, vals, torch.zeros_like(vals))
            put(ins.td, vals, kind)
        elif isinstance(ins, isa.SST):
            start = self._i32(self._reg(regs, ins.rs1))
            count = self._i32(self._reg(regs, ins.rs2))
            stride = self._i32(self._reg(regs, ins.rs3))
            base = env[ins.base]
            n = base.shape[0]
            i = torch.arange(ts, dtype=torch.int32, device=dev)
            count = torch.where(count < 0, ts, count)
            addr = start + i * stride
            # stores drop (policy): negative addresses route out with the
            # invalid lanes instead of wrapping; >= n drops too
            valid = (i < count) & (addr >= 0)
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                valid = valid & cond
            addr = torch.where(valid & (addr < n), addr, n)
            vals, vkind = tile(ins.ts)
            out = bulk_ops._with_spare_row(base)
            out[addr] = isa.convert(vals, vkind, region_kind(ins.base))
            env[ins.base] = out[:n]
        elif isinstance(ins, isa.ILD):
            cond = self._cond(spd, ins.tc)
            idx = isa.convert(*tile(ins.ts1), "i32")
            if cond is not None:
                idx = torch.where(cond, idx, 0)
            base = env[ins.base]
            out = bulk_ops.bulk_gather(
                base, idx, sort=self.optimize, dedup=self.optimize,
                use_kernel=self.use_kernel and base.ndim == 2, device=dev)
            if cond is not None:
                zshape = (-1,) + (1,) * (out.ndim - 1)
                out = torch.where(cond.view(zshape), out,
                                  torch.zeros_like(out))
            kind = isa.KINDS[ins.dtype]
            put(ins.td, isa.convert(out, region_kind(ins.base), kind), kind)
        elif isinstance(ins, isa.IST):
            rkind = region_kind(ins.base)
            env[ins.base] = bulk_ops.bulk_scatter(
                env[ins.base], isa.convert(*tile(ins.ts1), "i32"),
                isa.convert(*tile(ins.ts2), rkind),
                cond=self._cond(spd, ins.tc), optimize=self.optimize,
                device=dev)
        elif isinstance(ins, isa.IRMW):
            rkind = region_kind(ins.base)
            base = env[ins.base]
            env[ins.base] = bulk_ops.bulk_rmw(
                base, isa.convert(*tile(ins.ts1), "i32"),
                isa.convert(*tile(ins.ts2), rkind), op=ins.op,
                cond=self._cond(spd, ins.tc), optimize=self.optimize,
                use_kernel=self.use_kernel and base.ndim == 2,
                unsigned=rkind == "u32", device=dev)
        elif isinstance(ins, (isa.ALUV, isa.ALUS)):
            if isinstance(ins, isa.ALUV):
                a, b, kind = isa.promote(*tile(ins.ts1), *tile(ins.ts2))
            else:
                a, kind = tile(ins.ts)
                b = isa.scalar(self._reg(regs, ins.rs), kind, dev)
            out = isa.alu_apply(ins.op, a, b, unsigned=kind == "u32")
            out_kind = "bool" if ins.op in isa.COMPARE_OPS else kind
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                out = torch.where(cond, out, torch.zeros_like(out))
            kind = isa.KINDS[ins.dtype]
            put(ins.td, isa.convert(out, out_kind, kind), kind)
        elif isinstance(ins, isa.RNG):
            cap = self._reg(regs, ins.rs1)
            cap = self.tile_size if (isinstance(cap, int) and cap < 0) \
                else int(cap)
            outer, inner, total = range_fuser.fuse_ranges(
                isa.convert(*tile(ins.ts1), "i32"),
                isa.convert(*tile(ins.ts2), "i32"), capacity=cap,
                cond=self._cond(spd, ins.tc))
            put(ins.td1, outer, "i32")
            put(ins.td2, inner, "i32")
            put("_rng_total", total, "i32")
            # validity mask of the fused stream (the hardware's finish bits):
            # downstream stores/RMWs must be guarded by it.
            put(ins.td1 + "__mask",
                (torch.arange(cap, dtype=torch.int32, device=dev)
                 < total).to(torch.int32), "i32")
        else:
            raise TypeError(f"unknown instruction {ins!r}")

    def _kinds(self, program: isa.AccessProgram, env: Mapping,
               spd: Mapping, dtypes: Optional[Mapping]) -> Dict:
        dtypes = dict(dtypes or {})
        written = {ins.base: ins.dtype for ins in program.instrs
                   if isinstance(ins, (isa.IST, isa.IRMW, isa.SST))}
        kinds = {}
        for space, values in (("env", env), ("spd", spd)):
            for name, value in values.items():
                named = dtypes.get(name) or (
                    written.get(name) if space == "env" else None)
                kinds[(space, name)] = (isa.KINDS[named] if named
                                        else isa.kind_of(value))
        return kinds

    # -- program execution ---------------------------------------------------
    def run(self, program: isa.AccessProgram, env: Mapping,
            regs: Mapping | None = None, spd: Mapping | None = None, *,
            dtypes: Mapping | None = None):
        """Execute the program; returns (env, spd) after retirement.

        ``env`` and ``spd`` hold tensors on the engine's device. ``dtypes``
        optionally names the ISA dtype of regions or warm tiles (needed for
        a u32 region that no instruction writes, e.g. one read into f32).
        """
        env = dict(env)
        spd = dict(spd or {})
        regs = dict(regs or {})
        # fail fast with a named culprit instead of a KeyError deep in
        # the instruction loop
        program.check_inputs(env, regs, spd)
        for space, values in (("env", env), ("spd", spd)):
            for name, value in values.items():
                if isinstance(value, torch.Tensor) and \
                        value.device.type != self.device.type:
                    raise ValueError(
                        f"{space}[{name!r}] is on {value.device}, the "
                        f"engine on {self.device}")
        kinds = self._kinds(program, env, spd, dtypes)
        for ins in program.instrs:
            self._exec(ins, env, spd, regs, kinds)
        return env, spd

    def jit_run(self, program: isa.AccessProgram):
        """Fetch (or build) the cached executable — repeat calls with a
        structurally identical program return the same
        ``TracedExecutable``."""
        return self.executable(program)

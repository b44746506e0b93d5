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

Lanes: every instruction runs over a leading *lane* axis. ``run`` is one
lane; ``TracedExecutable.run_batch`` runs ``k`` launches of one program
(the JAX package ``jax.vmap``s them) as ``k`` lanes, so each ILD/IST/IRMW
issues ONE bulk op for all of them: private regions are stacked and lane
``b``'s indices, clamped or dropped against its own rows first, are offset
by ``b * rows`` into the flattened stack; shared read-only regions are one
copy that every lane indexes directly, so the lanes' reads of a shared
table coalesce in one sort and dedup.

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
from typing import Dict, Mapping, Optional, Sequence

import torch

from repro_torch.core import bulk_ops, isa, range_fuser
from repro_torch.core.device import resolve_device


class BatchUnsupported(NotImplementedError):
    """``run_batch`` cannot run these launches as one batch (lanes whose
    region shapes or range-fuser capacities differ). The scheduler runs
    the group's members one by one on this error and on no other."""


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

    ``batch=None`` runs one launch via ``__call__``; ``batch=k`` runs ``k``
    launches at once via ``run_batch`` as the lanes of one engine run.
    Regions named in ``shared`` are not stacked: the one copy is read by
    every lane (the multi-tenant case of many programs reading one table).
    Shared regions must be read-only in the program.
    """

    def __init__(self, engine: "Engine", program: isa.AccessProgram,
                 key: tuple, *, batch: Optional[int] = None,
                 shared: frozenset = frozenset()):
        self.engine = engine
        self.program = program
        self.key = key
        self.batch = batch
        self.shared = frozenset(shared)
        self.calls = 0
        self.traces = 0
        self._seen: set = set()

    def _count(self, env, regs, spd):
        self.calls += 1
        structure = _input_structure(env, regs, spd)
        if structure not in self._seen:
            self._seen.add(structure)
            self.traces += 1

    def __call__(self, env, regs=None, spd=None, *, dtypes=None):
        if self.batch is not None:
            raise TypeError("batched executable: use run_batch(envs, regs)")
        env, regs, spd = dict(env), dict(regs or {}), dict(spd or {})
        self._count(env, regs, spd)
        return self.engine.run(self.program, env, regs, spd, dtypes=dtypes)

    def run_batch(self, envs: Sequence[Mapping],
                  regs_list: Sequence[Mapping], spd=None, *, dtypes=None):
        """Run ``batch`` launches: ``envs[i]``/``regs_list[i]`` belong to
        lane i (shared regions may appear in every env — the first copy
        is used). Returns a list of per-lane ``(env, spd)`` results, each
        that of running its lane alone (integers and gathers bit for bit),
        with shared regions passed back untouched. Raises
        ``BatchUnsupported`` where the lanes cannot share one run."""
        if self.batch is None or len(envs) != self.batch or \
                len(regs_list) != self.batch:
            raise TypeError(
                f"executable compiled for batch={self.batch}, "
                f"got {len(envs)} envs and {len(regs_list)} register sets")
        spd = dict(spd or {})
        self._count(dict(envs[0]), dict(regs_list[0]), spd)
        return self.engine.run_lanes(self.program, envs, regs_list, spd,
                                     shared=self.shared, dtypes=dtypes)


@dataclasses.dataclass
class _Lanes:
    """State of one engine run over ``k`` lanes: regions (private ones
    stacked as ``(k, rows, ...)``, shared ones as they are), tiles as
    ``(k, ...)``, each lane's registers and every logical type."""
    k: int
    env: Dict
    spd: Dict
    regs: Sequence[Mapping]
    kinds: Dict
    shared: frozenset


class Engine:
    # Name of the registered plan backend (``repro_torch.plan.emit``) the
    # scheduler lowers through for this engine.
    plan_backend = "local"

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
        that changes execution (tile size, optimize, kernel routing), the
        batch width and the shared-region set. Two programs differing only
        in ``name`` share an entry.
        """
        key = self._cache_key(program, batch, shared)
        self.stats["trace_requests"] += 1
        exe = self._cache.get(key)
        if exe is None:
            self.stats["trace_misses"] += 1
            exe = TracedExecutable(self, program, key, batch=batch,
                                   shared=shared)
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

    # -- operands ------------------------------------------------------------
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

    def _scalar(self, st: _Lanes, r, kind: str, ndim: int) -> torch.Tensor:
        """Register or immediate ``r`` as ``kind``: a 0-d tensor when every
        lane holds the same Python value, else one value per lane shaped
        ``(k, 1, ...)`` to broadcast against an ``ndim``-dim lane tensor."""
        values = [self._reg(regs, r) for regs in st.regs]
        first = values[0]
        if st.k == 1 or not isinstance(first, torch.Tensor) and all(
                type(v) is type(first) and v == first for v in values[1:]):
            return isa.scalar(first, kind, self.device)
        per_lane = torch.stack([isa.scalar(v, kind, self.device)
                                for v in values])
        return per_lane.view((st.k,) + (1,) * (ndim - 1))

    def _rows(self, st: _Lanes, name: str):
        """A region as one table for all lanes: ``(table, rows, offset)``.
        A private region is its stack flattened to ``k * rows`` rows, with
        lane b's row offset ``b * rows`` as a ``(k, 1)`` tensor (None for
        one lane); a shared region is itself, with no offset."""
        base = st.env[name]
        if name in st.shared:
            return base, base.shape[0], None
        n = base.shape[1]
        flat = base.reshape((st.k * n,) + tuple(base.shape[2:]))
        if st.k == 1:
            return flat, n, None
        offset = torch.arange(st.k, dtype=torch.int32,
                              device=self.device).view(st.k, 1) * n
        return flat, n, offset

    # -- instruction semantics ---------------------------------------------
    def _exec(self, ins: isa.Instr, st: _Lanes):
        """One instruction over every lane. ``st.kinds`` maps
        ("env"|"spd", name) to the logical type of each region and tile."""
        ts = self.tile_size
        dev = self.device
        k = st.k
        spd, env, kinds = st.spd, st.env, st.kinds

        def tile(name):
            return spd[name], kinds[("spd", name)]

        def put(name, value, kind):
            spd[name] = value
            kinds[("spd", name)] = kind

        def region_kind(name):
            return kinds[("env", name)]

        def lanes(x):
            # lane-less operands (uniform registers) broadcast to (k, ts)
            return x.expand((k,) + tuple(x.shape[-1:]))

        if isinstance(ins, isa.SLD):
            # Lanes beyond the trip count (rs2) continue the stride
            # progression (clipped reads) rather than being zeroed;
            # downstream guards rely on the address progression staying
            # monotone. Lanes failing TC read 0.
            start = self._scalar(st, ins.rs1, "i32", 2)
            stride = self._scalar(st, ins.rs3, "i32", 2)
            table, n, offset = self._rows(st, ins.base)
            i = torch.arange(ts, dtype=torch.int32, device=dev)
            addr = lanes(start + i * stride).clamp(0, n - 1)
            vals = table[addr if offset is None else addr + offset]
            kind = isa.KINDS[ins.dtype]
            vals = isa.convert(vals, region_kind(ins.base), kind)
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                vals = torch.where(cond, vals, torch.zeros_like(vals))
            put(ins.td, vals, kind)
        elif isinstance(ins, isa.SST):
            start = self._scalar(st, ins.rs1, "i32", 2)
            count = self._scalar(st, ins.rs2, "i32", 2)
            stride = self._scalar(st, ins.rs3, "i32", 2)
            base = env[ins.base]
            n = base.shape[1]
            i = torch.arange(ts, dtype=torch.int32, device=dev)
            count = torch.where(count < 0, ts, count)
            addr = lanes(start + i * stride)
            # stores drop (policy): negative addresses route out with the
            # invalid lanes instead of wrapping; >= n drops too. Each lane
            # drops onto its own spare row n.
            valid = (i < count) & (addr >= 0)
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                valid = valid & cond
            addr = torch.where(valid & (addr < n), addr, n)
            if k > 1:
                addr = addr + torch.arange(
                    k, dtype=torch.int32, device=dev).view(k, 1) * (n + 1)
            vals, vkind = tile(ins.ts)
            row_shape = tuple(base.shape[2:])
            out = torch.cat([base, base.new_zeros((k, 1) + row_shape)], 1)
            out.view((k * (n + 1),) + row_shape)[addr.reshape(-1)] = \
                isa.convert(vals, vkind, region_kind(ins.base)).reshape(
                    (-1,) + row_shape)
            env[ins.base] = out[:, :n]
        elif isinstance(ins, isa.ILD):
            cond = self._cond(spd, ins.tc)
            idx = isa.convert(*tile(ins.ts1), "i32")
            if cond is not None:
                idx = torch.where(cond, idx, 0)
            table, n, offset = self._rows(st, ins.base)
            if k > 1:
                # loads clamp per lane before the offset: no lane reaches
                # another lane's rows
                idx = idx.clamp(0, n - 1)
                if offset is not None:
                    idx = idx + offset
            out = bulk_ops.bulk_gather(
                table, idx.reshape(-1), sort=self.optimize,
                dedup=self.optimize,
                use_kernel=self.use_kernel and table.ndim == 2, device=dev)
            out = out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))
            if cond is not None:
                zshape = tuple(cond.shape) + (1,) * (out.ndim - 2)
                out = torch.where(cond.view(zshape), out,
                                  torch.zeros_like(out))
            kind = isa.KINDS[ins.dtype]
            put(ins.td, isa.convert(out, region_kind(ins.base), kind), kind)
        elif isinstance(ins, (isa.IST, isa.IRMW)):
            rkind = region_kind(ins.base)
            base = env[ins.base]
            table, n, offset = self._rows(st, ins.base)
            idx = isa.convert(*tile(ins.ts1), "i32")
            vals = isa.convert(*tile(ins.ts2), rkind).reshape(
                (-1,) + tuple(table.shape[1:]))
            cond = self._cond(spd, ins.tc)
            if offset is not None:
                # stores drop per lane before the offset: an out-of-range
                # lane goes past the end of the stack, never into a
                # neighbour (one lane: the bulk op drops it itself)
                idx = torch.where((idx >= 0) & (idx < n), idx + offset,
                                  table.shape[0])
            idx = idx.reshape(-1)
            if cond is not None:
                cond = cond.reshape(-1)
            if isinstance(ins, isa.IST):
                new = bulk_ops.bulk_scatter(table, idx, vals, cond=cond,
                                            optimize=self.optimize,
                                            device=dev)
            else:
                new = bulk_ops.bulk_rmw(
                    table, idx, vals, op=ins.op, cond=cond,
                    optimize=self.optimize,
                    use_kernel=self.use_kernel and table.ndim == 2,
                    unsigned=rkind == "u32", device=dev)
            env[ins.base] = new.reshape(base.shape)
        elif isinstance(ins, (isa.ALUV, isa.ALUS)):
            if isinstance(ins, isa.ALUV):
                a, b, kind = isa.promote(*tile(ins.ts1), *tile(ins.ts2))
            else:
                a, kind = tile(ins.ts)
                b = self._scalar(st, ins.rs, kind, a.ndim)
            out = isa.alu_apply(ins.op, a, b, unsigned=kind == "u32")
            out_kind = "bool" if ins.op in isa.COMPARE_OPS else kind
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                out = torch.where(cond, out, torch.zeros_like(out))
            kind = isa.KINDS[ins.dtype]
            put(ins.td, isa.convert(out, out_kind, kind), kind)
        elif isinstance(ins, isa.RNG):
            caps = {self.tile_size if (isinstance(c, int) and c < 0)
                    else int(c)
                    for c in (self._reg(regs, ins.rs1) for regs in st.regs)}
            if len(caps) > 1:
                raise BatchUnsupported(
                    f"range-fuser capacities differ across lanes: "
                    f"{sorted(caps)}")
            cap = caps.pop()
            lo = isa.convert(*tile(ins.ts1), "i32")
            hi = isa.convert(*tile(ins.ts2), "i32")
            cond = self._cond(spd, ins.tc)
            fused = [range_fuser.fuse_ranges(
                lo[b], hi[b], capacity=cap,
                cond=None if cond is None else cond[b]) for b in range(k)]
            outer, inner, total = (torch.stack(t) for t in zip(*fused))
            put(ins.td1, outer, "i32")
            put(ins.td2, inner, "i32")
            put("_rng_total", total, "i32")
            # validity mask of the fused stream (the hardware's finish bits):
            # downstream stores/RMWs must be guarded by it.
            put(ins.td1 + "__mask",
                (torch.arange(cap, dtype=torch.int32, device=dev)
                 < total.view(k, 1)).to(torch.int32), "i32")
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

    def _check_device(self, space: str, values: Mapping):
        for name, value in values.items():
            if isinstance(value, torch.Tensor) and \
                    value.device.type != self.device.type:
                raise ValueError(
                    f"{space}[{name!r}] is on {value.device}, the "
                    f"engine on {self.device}")

    # -- program execution ---------------------------------------------------
    def run(self, program: isa.AccessProgram, env: Mapping,
            regs: Mapping | None = None, spd: Mapping | None = None, *,
            dtypes: Mapping | None = None):
        """Execute the program; returns (env, spd) after retirement.

        ``env`` and ``spd`` hold tensors on the engine's device. ``dtypes``
        optionally names the ISA dtype of regions or warm tiles (needed for
        a u32 region that no instruction writes, e.g. one read into f32).
        """
        return self.run_lanes(program, [env], [regs or {}], spd,
                              dtypes=dtypes)[0]

    def run_lanes(self, program: isa.AccessProgram, envs: Sequence[Mapping],
                  regs_list: Sequence[Mapping], spd: Mapping | None = None,
                  *, shared: frozenset = frozenset(),
                  dtypes: Mapping | None = None) -> list:
        """Execute ``len(envs)`` launches of ``program`` as the lanes of one
        run (see the module docstring); returns each lane's (env, spd).
        ``spd`` (warm tiles) is common to every lane; regions in
        ``shared`` are read from ``envs[0]`` and must be read-only."""
        envs = [dict(e) for e in envs]
        regs_list = [dict(r or {}) for r in regs_list]
        spd = dict(spd or {})
        k = len(envs)
        # fail fast with a named culprit instead of a KeyError deep in
        # the instruction loop
        for env, regs in zip(envs, regs_list):
            program.check_inputs(env, regs, spd)
            self._check_device("env", env)
        self._check_device("spd", spd)
        shared = frozenset(shared)
        written = {ins.base for ins in program.instrs
                   if isinstance(ins, (isa.IST, isa.IRMW, isa.SST))}
        if shared & written:
            raise ValueError(f"shared regions {sorted(shared & written)} "
                             "are written by the program")
        stacked = {}
        for name, value in envs[0].items():
            if name in shared:
                stacked[name] = value
                continue
            if k == 1:
                stacked[name] = value.unsqueeze(0)
                continue
            values = [e.get(name) for e in envs]
            if any(not isinstance(v, torch.Tensor) or v.shape != value.shape
                   or v.dtype != value.dtype for v in values):
                raise BatchUnsupported(
                    f"region {name!r} differs in type or shape across lanes")
            stacked[name] = torch.stack(values)
        st = _Lanes(
            k=k, env=dict(stacked), regs=regs_list, shared=shared,
            spd={name: t.unsqueeze(0).expand((k,) + tuple(t.shape))
                 for name, t in spd.items()},
            kinds=self._kinds(program, envs[0], spd, dtypes))
        for ins in program.instrs:
            self._exec(ins, st)
        out = []
        for b, env in enumerate(envs):
            out_env = {name: (env[name] if value is stacked[name]
                              or name in shared else value[b])
                       for name, value in st.env.items()}
            out.append((out_env, {name: t[b] for name, t in st.spd.items()}))
        return out

    def jit_run(self, program: isa.AccessProgram):
        """Fetch (or build) the cached executable — repeat calls with a
        structurally identical program return the same
        ``TracedExecutable``."""
        return self.executable(program)

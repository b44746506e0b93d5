"""Pure-NumPy oracle for the DX100 ISA and the compiler's Pattern IR.

Two independent ground truths back the differential-testing subsystem:

  * ``OracleEngine`` — an ISA-level interpreter. It executes an
    ``AccessProgram`` with naive loop semantics: stores and RMWs are applied
    one lane at a time in program order, with no sorting, no deduplication
    and no segment tricks. Every optimized ``Engine`` configuration
    (optimize on/off, row-table kernels on/off, cached executable or
    eager, any tile size) must agree with it — bit-exactly for integers,
    to float tolerance for reordered float reductions (§3.1 of the
    paper).

  * ``run_pattern`` — a source-level loop-nest evaluator for the compiler's
    ``Pattern`` IR. It evaluates `for i: [for j in range:] accesses` the way
    the original "legacy code" would, so a compiler bug that lowers the
    nest incorrectly is caught even when engine and ISA oracle agree on the
    (mis)compiled instruction stream.

Both are deliberately simple and torch-free (tensors are turned into NumPy
on the way in) so they cannot share a bug with the engine's PyTorch paths.
The port's copy of the JAX package's ``testing.oracle``: ``NP_DTYPES``
keep ``i64``/``u64``/``f64`` at 64 bits whatever the engine's mode
(``core.isa.X64``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from repro_torch.core import compiler, interop, isa

import torch

try:  # bf16 as a NumPy dtype comes from ml_dtypes, where installed
    import ml_dtypes
    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BF16 = np.dtype(np.float32)

NP_DTYPES = {
    "u32": np.dtype(np.uint32),
    "i32": np.dtype(np.int32),
    "f32": np.dtype(np.float32),
    "u64": np.dtype(np.uint64),
    "i64": np.dtype(np.int64),
    "f64": np.dtype(np.float64),
    "bf16": _BF16,
}


def np_alu(op: str, a, b):
    """NumPy mirror of ``isa.alu_apply`` (the OP field semantics)."""
    if op == "ADD":
        return a + b
    if op == "SUB":
        return a - b
    if op == "MUL":
        return a * b
    if op == "MIN":
        return np.minimum(a, b)
    if op == "MAX":
        return np.maximum(a, b)
    if op == "AND":
        return a & b
    if op == "OR":
        return a | b
    if op == "XOR":
        return a ^ b
    if op == "SHR":
        return a >> b
    if op == "SHL":
        return a << b
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


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x).copy()
    return np.array(np.asarray(x))  # copy


# ---------------------------------------------------------------------------
# ISA-level oracle interpreter
# ---------------------------------------------------------------------------

class OracleEngine:
    """Naive loop-semantics executor for ``AccessProgram``s.

    Mirrors ``repro_torch.core.engine.Engine``'s *defined* behaviour (including
    its conventions for out-of-trip-count SLD lanes and condition-masked
    reads) while implementing every store with an explicit per-lane Python
    loop — ground truth, not fast.
    """

    def __init__(self, tile_size: int = 16384):
        self.tile_size = int(tile_size)
        # index recorder for the analyzer soundness property
        # (tests/test_analysis.py): set to {} before run() to collect,
        # per instruction position, every index/address the oracle
        # executes (pre-clip / pre-OOB-drop) — exactly the values the
        # interval analyzer must bound.
        self.touched: Optional[Dict[int, list]] = None
        self._ip = -1

    def _touch(self, vals) -> None:
        if self.touched is not None:
            self.touched.setdefault(self._ip, []).append(
                np.asarray(vals, dtype=np.int64).reshape(-1))

    @staticmethod
    def _reg(regs: Mapping, r):
        if isinstance(r, str):
            return regs[r]
        return r

    @staticmethod
    def _cond(spd: Dict, tc: Optional[str]):
        if tc is None:
            return None
        return spd[tc].astype(bool)

    def _exec(self, ins: isa.Instr, env: Dict, spd: Dict, regs: Mapping):
        ts = self.tile_size
        if isinstance(ins, isa.SLD):
            start = int(self._reg(regs, ins.rs1))
            stride = int(self._reg(regs, ins.rs3))
            base = env[ins.base]
            i = np.arange(ts, dtype=np.int32)
            addr = np.int32(start) + i * np.int32(stride)
            self._touch(addr)
            vals = base[np.clip(addr, 0, base.shape[0] - 1)]
            vals = vals.astype(NP_DTYPES[ins.dtype])
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                vals = np.where(cond, vals, np.zeros_like(vals))
            spd[ins.td] = vals
        elif isinstance(ins, isa.SST):
            start = int(self._reg(regs, ins.rs1))
            count = int(self._reg(regs, ins.rs2))
            stride = int(self._reg(regs, ins.rs3))
            base = env[ins.base]
            count = ts if count < 0 else count
            vals = spd[ins.ts].astype(base.dtype)
            cond = self._cond(spd, ins.tc)
            n = base.shape[0]
            for i in range(min(count, ts)):
                if cond is not None and not cond[i]:
                    continue
                a = start + i * stride
                self._touch([a])
                if 0 <= a < n:
                    base[a] = vals[i]
        elif isinstance(ins, isa.ILD):
            cond = self._cond(spd, ins.tc)
            idx = spd[ins.ts1].astype(np.int32)
            if cond is not None:
                idx = np.where(cond, idx, 0)
            self._touch(idx)           # post-mask, pre-clip
            base = env[ins.base]
            out = base[np.clip(idx, 0, base.shape[0] - 1)]
            if cond is not None:
                zshape = (-1,) + (1,) * (out.ndim - 1)
                out = np.where(cond.reshape(zshape), out,
                               np.zeros_like(out))
            spd[ins.td] = out.astype(NP_DTYPES[ins.dtype])
        elif isinstance(ins, isa.IST):
            base = env[ins.base]
            idx = spd[ins.ts1].astype(np.int32)
            vals = spd[ins.ts2].astype(base.dtype)
            cond = self._cond(spd, ins.tc)
            n = base.shape[0]
            lanes = (np.flatnonzero(cond) if cond is not None
                     else range(idx.shape[0]))
            self._touch(idx[lanes] if cond is not None else idx)
            for i in lanes:                 # sequential: last write wins
                a = int(idx[i])
                if 0 <= a < n:
                    base[a] = vals[i]
        elif isinstance(ins, isa.IRMW):
            base = env[ins.base]
            idx = spd[ins.ts1].astype(np.int32)
            vals = spd[ins.ts2].astype(base.dtype)
            cond = self._cond(spd, ins.tc)
            n = base.shape[0]
            lanes = (np.flatnonzero(cond) if cond is not None
                     else range(idx.shape[0]))
            self._touch(idx[lanes] if cond is not None else idx)
            for i in lanes:
                a = int(idx[i])
                if 0 <= a < n:
                    # slice form keeps array (wrapping) integer semantics
                    base[a:a + 1] = np_alu(ins.op, base[a:a + 1],
                                           vals[i:i + 1])
        elif isinstance(ins, isa.ALUV):
            a, b = spd[ins.ts1], spd[ins.ts2]
            out = np_alu(ins.op, a, b)
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                out = np.where(cond, out, np.zeros_like(out))
            spd[ins.td] = out.astype(NP_DTYPES[ins.dtype])
        elif isinstance(ins, isa.ALUS):
            a = spd[ins.ts]
            b = np.asarray(self._reg(regs, ins.rs)).astype(a.dtype)
            out = np_alu(ins.op, a, b)
            cond = self._cond(spd, ins.tc)
            if cond is not None:
                out = np.where(cond, out, np.zeros_like(out))
            spd[ins.td] = out.astype(NP_DTYPES[ins.dtype])
        elif isinstance(ins, isa.RNG):
            cap = self._reg(regs, ins.rs1)
            cap = self.tile_size if (isinstance(cap, int) and cap < 0) \
                else int(cap)
            lo = spd[ins.ts1].astype(np.int32)
            hi = spd[ins.ts2].astype(np.int32)
            cond = self._cond(spd, ins.tc)
            outer = np.zeros(cap, np.int32)
            inner = np.zeros(cap, np.int32)
            p = 0
            lanes = (np.flatnonzero(cond) if cond is not None
                     else range(lo.shape[0]))
            for i in lanes:                 # the naive nested loop itself
                for j in range(int(lo[i]), int(hi[i])):
                    if p >= cap:            # capacity truncation (engine
                        break               # clamps `total` identically)
                    outer[p] = i
                    inner[p] = j
                    p += 1
                if p >= cap:
                    break
            spd[ins.td1] = outer
            spd[ins.td2] = inner
            spd["_rng_total"] = np.int32(p)
            spd[ins.td1 + "__mask"] = (
                np.arange(cap, dtype=np.int32) < p).astype(np.int32)
        else:
            raise TypeError(f"unknown instruction {ins!r}")

    def run(self, program: isa.AccessProgram, env: Mapping,
            regs: Mapping | None = None, spd: Mapping | None = None):
        env = {k: _to_np(v) for k, v in env.items()}
        spd = {k: _to_np(v) for k, v in (spd or {}).items()}
        regs = dict(regs or {})
        program.check_inputs(env, regs, spd)   # same contract as Engine
        for self._ip, ins in enumerate(program.instrs):
            self._exec(ins, env, spd, regs)
        return env, spd


def oracle_run_tiled(p: compiler.Pattern, env: Mapping, *, n: int,
                     tile_size: int, extra_regs=None):
    """NumPy mirror of ``compiler.run_tiled``: compile once, launch per tile
    on the ISA oracle. Returns (env, spd_last, info)."""
    prog, info = compiler.compile_pattern(p, tile_size=tile_size)
    eng = OracleEngine(tile_size=tile_size)
    env = {k: _to_np(v) for k, v in env.items()}
    env["__iota__"] = np.arange(compiler._round_up(n, tile_size),
                                dtype=np.int32)
    spd_last = None
    for base in range(0, n, tile_size):
        count = min(tile_size, n - base)
        regs = {"tile_base": base, "N": count, "tile_end": base + count}
        regs.update(extra_regs or {})
        env, spd_last = eng.run(prog, env, regs)
    env.pop("__iota__")
    return env, spd_last, info


# ---------------------------------------------------------------------------
# source-level loop-nest evaluator for the Pattern IR
# ---------------------------------------------------------------------------

def eval_expr(e, env: Mapping, iters: Mapping, want: str = "i32",
              regs: Mapping | None = None) -> np.ndarray:
    """Vectorised-over-iterations evaluation of an index/value expression.

    Mirrors the compiler's dtype-inference rules (indices are i32, loads
    without a pinned dtype adopt ``want``, BinOp immediates are cast to the
    lhs dtype) so source semantics and compiled semantics are comparable.
    """
    if isinstance(e, compiler.Var):
        return iters[e.name].astype(np.int32)
    if isinstance(e, compiler.Load):
        idx = eval_expr(e.index, env, iters, "i32", regs)
        base = np.asarray(env[e.base])
        out = base[np.clip(idx.astype(np.int32), 0, base.shape[0] - 1)]
        return out.astype(NP_DTYPES[e.dtype or want])
    if isinstance(e, compiler.BinOp):
        lhs = eval_expr(e.lhs, env, iters, want, regs)
        if isinstance(e.rhs, (str, int, float)):
            r = regs[e.rhs] if (isinstance(e.rhs, str) and regs) else e.rhs
            rhs = np.asarray(r).astype(lhs.dtype)
        else:
            rhs = eval_expr(e.rhs, env, iters, want, regs)
        return np.asarray(np_alu(e.op, lhs, rhs)).astype(NP_DTYPES[want])
    raise TypeError(f"cannot evaluate {e!r}")


def _eval_cond(c: compiler.Compare, env, iters, regs=None) -> np.ndarray:
    lhs = eval_expr(c.lhs, env, iters, "f32", regs)
    if isinstance(c.rhs, (str, int, float)):
        r = regs[c.rhs] if (isinstance(c.rhs, str) and regs) else c.rhs
        rhs = np.asarray(r).astype(lhs.dtype)
    else:
        rhs = eval_expr(c.rhs, env, iters, "f32", regs)
    return np.asarray(np_alu(c.op, lhs, rhs)).astype(bool)


def pattern_range_lens(p: compiler.Pattern, env: Mapping,
                       n: int) -> np.ndarray:
    """Per-outer-iteration fused range lengths (zeros when no range)."""
    if p.range_loop is None:
        return np.zeros(n, np.int64)
    i_vals = np.arange(n, dtype=np.int32)
    rl = p.range_loop
    lo = eval_expr(rl.lo, env, {"i": i_vals}, "i32")
    hi = eval_expr(rl.hi, env, {"i": i_vals}, "i32")
    return np.maximum(hi.astype(np.int64) - lo, 0)


def pattern_max_tile_fill(p: compiler.Pattern, env: Mapping, n: int,
                          tile_size: int) -> int:
    """Largest fused-stream length any tile of ``tile_size`` sees.

    Above ``tile_size`` the engine's static-capacity range fuser truncates,
    so source-level parity does not apply at that tile size; ISA-level
    parity still does (the ISA oracle truncates identically).
    """
    if p.range_loop is None:
        return 0
    lens = pattern_range_lens(p, env, n)
    return max(int(lens[b:b + tile_size].sum())
               for b in range(0, n, tile_size))


def run_pattern(p: compiler.Pattern, env: Mapping, *, n: int,
                extra_regs=None):
    """Evaluate the source loop nest of a Pattern in pure NumPy.

    Returns (env, loads): the post-loop memory regions plus, per LD access,
    the full per-iteration stream of loaded values (one entry per (i) — or
    per fused (i, j) when a range loop is present).

    Statements are evaluated statement-major over the whole iteration
    space; the §4.2 legality rules (single writer, no read of any written
    region) make this equivalent to both the iteration-major source loop
    and the engine's tile-major execution, independent of tile size.
    """
    compiler.check_legality(p)
    env = {k: _to_np(v) for k, v in env.items()}
    i_vals = np.arange(n, dtype=np.int32)
    if p.range_loop is not None:
        rl = p.range_loop
        lo = eval_expr(rl.lo, env, {"i": i_vals}, "i32", extra_regs)
        hi = eval_expr(rl.hi, env, {"i": i_vals}, "i32", extra_regs)
        outs, inns = [], []
        for i in range(n):
            for j in range(int(lo[i]), int(hi[i])):
                outs.append(i)
                inns.append(j)
        iters = {"i": np.asarray(outs, np.int32),
                 "j": np.asarray(inns, np.int32)}
        if rl.var != "j":
            iters[rl.var] = iters.pop("j")
    else:
        iters = {"i": i_vals}
    n_items = iters["i"].shape[0]

    loads: Dict[str, np.ndarray] = {}
    for a in p.accesses:
        cond = (np.ones(n_items, bool) if a.cond is None
                else _eval_cond(a.cond, env, iters, extra_regs))
        idx = eval_expr(a.index, env, iters, "i32", extra_regs)
        if a.kind == "LD":
            base = env[a.base]
            vals = base[np.clip(idx, 0, base.shape[0] - 1)]
            vals = np.where(cond, vals, np.zeros_like(vals))
            loads[a.base] = vals.astype(NP_DTYPES[a.dtype])
        elif a.kind in ("ST", "RMW"):
            base = env[a.base]
            vals = eval_expr(a.value, env, iters, a.dtype,
                             extra_regs).astype(base.dtype)
            m = base.shape[0]
            for k in range(n_items):
                if not cond[k]:
                    continue
                t = int(idx[k])
                if not 0 <= t < m:
                    continue
                if a.kind == "ST":
                    base[t] = vals[k]
                else:
                    base[t:t + 1] = np_alu(a.op, base[t:t + 1],
                                           vals[k:k + 1])
        else:
            raise ValueError(a.kind)
    return env, loads

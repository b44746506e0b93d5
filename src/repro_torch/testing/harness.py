"""Differential-parity harness: engine config matrix vs the NumPy oracle.

The port's copy of the JAX package's ``testing.harness``, run on the port's
engine, scheduler, sharded engine, apps and serving layer. Every check
takes ``device`` (default ``"cuda"``): NumPy inputs go to that device and
results come back as NumPy in the types the oracle uses.

``check_pattern_parity`` compiles a Pattern once per tile size, runs it
through engine configurations (optimize on/off × row-table kernels on/off
× cached-executable/eager × tile size; on the CPU the kernels' plain
versions run), and asserts agreement with both oracles:

  * ISA-level: the ``OracleEngine`` interpreting the *same* compiled
    program tile by tile — every env region and every scratchpad tile must
    match (bit-exact for integers, allclose for floats, whose bulk RMW
    reductions the engine legally reorders);
  * source-level: the pure loop-nest evaluation of the Pattern itself —
    catching compiler bugs that both engine and ISA oracle would faithfully
    execute. Skipped per-config when the fused range stream overflows that
    tile size's static RNG capacity (the engine truncates by design; the
    ISA oracle mirrors the truncation, the source loop cannot).

Any divergence raises ``ParityError`` carrying the config and region/tile
name — the one-line reproducer for future perf/refactor PRs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import compiler, interop, isa
from repro_torch.core.engine import Engine
from repro_torch.core.scheduler import Scheduler
from repro_torch.testing import oracle, streams
from repro_torch.testing.fuzzer import FuzzCase

TILE_SIZES = (64, 1024, 16384)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    optimize: bool
    use_kernel: bool
    jit: bool
    tile_size: int

    @property
    def label(self) -> str:
        return (f"opt={int(self.optimize)} kern={int(self.use_kernel)} "
                f"jit={int(self.jit)} tile={self.tile_size}")


CONFIG_MATRIX = tuple(
    EngineConfig(optimize=o, use_kernel=k, jit=j, tile_size=t)
    for t in TILE_SIZES
    for o in (True, False)
    for k in (False, True)
    for j in (False, True))

EAGER_CONFIGS = tuple(c for c in CONFIG_MATRIX if not c.jit)
JIT_CONFIGS = tuple(c for c in CONFIG_MATRIX if c.jit)


class ParityError(AssertionError):
    pass


def _tile_dtypes(prog: isa.AccessProgram) -> Dict[str, str]:
    """ISA dtype of every scratchpad tile a program defines (the range
    fuser's outputs are i32)."""
    out: Dict[str, str] = {}
    for ins in prog.instrs:
        if isinstance(ins, isa.RNG):
            for t in (ins.td1, ins.td2, "_rng_total", ins.td1 + "__mask"):
                out[t] = "i32"
        else:
            for t in ins.defs():
                out[t] = ins.dtype
    return out


def run_engine_tiled(p: compiler.Pattern, env: Mapping, *, n: int,
                     config: EngineConfig, extra_regs=None, device="cuda"):
    """Mirror of ``compiler.run_tiled`` through the cached executable
    (``jit``) or ``Engine.run`` on ``device``; returns (env, spd_last,
    info) with everything as NumPy in the environment's / tiles' own
    types."""
    eng = Engine(tile_size=config.tile_size, optimize=config.optimize,
                 use_kernel=config.use_kernel, device=device)
    prog, info = compiler.compile_pattern(p, tile_size=eng.tile_size)
    dtypes = interop.dtypes_of(env)
    tenv = interop.env_from_numpy(env, device=eng.device)
    tenv["__iota__"] = torch.arange(
        compiler._round_up(n, eng.tile_size), dtype=torch.int32,
        device=eng.device)
    exe = eng.jit_run(prog) if config.jit else None
    spd_last = {}
    for base in range(0, n, eng.tile_size):
        count = min(eng.tile_size, n - base)
        regs = {"tile_base": base, "N": count, "tile_end": base + count}
        regs.update(extra_regs or {})
        if exe is not None:
            tenv, spd_last = exe(tenv, regs, {}, dtypes=dtypes)
        else:
            tenv, spd_last = eng.run(prog, tenv, regs, {}, dtypes=dtypes)
    tenv.pop("__iota__")
    out_env = {k: interop.to_numpy(v, np.asarray(env[k]).dtype)
               for k, v in tenv.items()}
    kinds = _tile_dtypes(prog)
    out_spd = {k: interop.to_numpy(v, kinds.get(k))
               for k, v in spd_last.items()}
    return out_env, out_spd, info


def _assert_match(what: str, got, want, *, rtol: float, atol: float):
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        got = interop.to_numpy(got, want.dtype)
    got = np.asarray(got)
    if got.shape != want.shape:
        raise ParityError(f"{what}: shape {got.shape} != {want.shape}")
    if np.issubdtype(np.asarray(want).dtype, np.floating) or \
            want.dtype == oracle.NP_DTYPES["bf16"]:
        try:
            np.testing.assert_allclose(
                got.astype(np.float64), want.astype(np.float64),
                rtol=rtol, atol=atol)
        except AssertionError as e:
            raise ParityError(f"{what}: {e}") from None
    else:
        if not np.array_equal(got, want):
            bad = np.flatnonzero(
                np.asarray(got != want).reshape(got.shape[0], -1).any(1))
            raise ParityError(
                f"{what}: int mismatch at rows {bad[:8]} "
                f"(got {got[bad[:3]]}, want {want[bad[:3]]})")


def check_pattern_parity(p: compiler.Pattern, env: Mapping, *, n: int,
                         configs: Sequence[EngineConfig] = EAGER_CONFIGS,
                         check_source: bool = True,
                         max_tile_fill=None,
                         extra_regs=None,
                         rtol: float = 1e-4, atol: float = 1e-5,
                         device="cuda") -> int:
    """Run ``p`` through every config and compare against both oracles.

    ``max_tile_fill``: optional callable tile_size -> worst-case fused
    stream length (see ``FuzzCase.max_tile_fill``); used to detect RNG
    capacity truncation, which disables the source-level check only.
    Returns the number of (config, oracle) comparisons performed.
    """
    checked = 0
    src_env = src_loads = None
    if check_source:
        src_env, src_loads = oracle.run_pattern(
            p, env, n=n, extra_regs=extra_regs)
    isa_cache: Dict[int, tuple] = {}
    for cfg in configs:
        if cfg.tile_size not in isa_cache:
            isa_cache[cfg.tile_size] = oracle.oracle_run_tiled(
                p, env, n=n, tile_size=cfg.tile_size, extra_regs=extra_regs)
        oenv, ospd, _ = isa_cache[cfg.tile_size]
        genv, gspd, info = run_engine_tiled(
            p, env, n=n, config=cfg, extra_regs=extra_regs, device=device)

        # --- ISA-level parity: env + every scratchpad tile ---------------
        for name in oenv:
            _assert_match(f"[{cfg.label}] env[{name}] vs ISA oracle",
                          genv[name], oenv[name], rtol=rtol, atol=atol)
            checked += 1
        for name in ospd:
            _assert_match(f"[{cfg.label}] spd[{name}] vs ISA oracle",
                          gspd[name], ospd[name], rtol=rtol, atol=atol)

        # --- source-level parity: written regions --------------------------
        if check_source:
            truncated = (p.range_loop is not None and max_tile_fill
                         is not None
                         and max_tile_fill(cfg.tile_size) > cfg.tile_size)
            if not truncated:
                for name in src_env:
                    _assert_match(
                        f"[{cfg.label}] env[{name}] vs source oracle",
                        genv[name], src_env[name], rtol=rtol, atol=atol)
                    checked += 1
                if p.range_loop is None:
                    # last-tile load tiles vs the tail of the source stream
                    last = n - (n - 1) // cfg.tile_size * cfg.tile_size
                    for base_name, tile_name in info["loads"].items():
                        got = gspd[tile_name][:last]
                        want = src_loads[base_name][-last:]
                        _assert_match(
                            f"[{cfg.label}] loads[{base_name}] vs source",
                            got, want, rtol=rtol, atol=atol)
                        checked += 1
    return checked


def check_scheduler_parity(cases: Sequence, *, tile_size: int = 1024,
                           optimize: bool = True, max_batch: int = 32,
                           tenants: Sequence[str] = ("a", "b", "c"),
                           scheduler: "Scheduler | None" = None,
                           rtol: float = 1e-4, atol: float = 1e-5,
                           device="cuda"):
    """Batched-execution parity: one Scheduler flush vs per-program oracle.

    ``cases``: sequence of ``(pattern, env, n)`` with ``n <= tile_size``
    (single-tile launches — the scheduler batches independent programs, so
    cross-tile sequential dependencies stay with the per-tile driver).
    Every submission is compiled, enqueued round-robin across ``tenants``,
    executed in ONE flush (signature-compatible cases fuse into batched
    groups), and compared region-by-region and tile-by-tile against an
    independent per-program ``OracleEngine`` run — bit-exact for integers,
    allclose for floats.

    Returns ``(checked, report)``: comparison count + the FlushReport.
    """
    sched = scheduler if scheduler is not None else Scheduler(
        engine=Engine(tile_size=tile_size, optimize=optimize,
                      device=device),
        max_batch=max_batch)
    iota = np.arange(tile_size, dtype=np.int32)
    entries = []
    for k, (p, env, n) in enumerate(cases):
        if n > tile_size:
            raise ValueError(
                f"case {k}: n={n} > tile_size={tile_size} "
                "(scheduler parity uses single-tile launches)")
        prog, info = compiler.compile_pattern(p, tile_size=tile_size)
        regs = {"tile_base": 0, "N": n, "tile_end": n}
        ticket = sched.submit(prog, {**env, "__iota__": iota}, regs,
                              tenant=tenants[k % len(tenants)])
        entries.append((ticket, prog, env, regs))
    report = sched.flush()

    checked = 0
    for ticket, prog, env, regs in entries:
        got = sched.result(ticket)
        genv, gspd = got
        oeng = oracle.OracleEngine(tile_size=tile_size)
        oenv_in = {name: np.asarray(v) for name, v in env.items()}
        oenv_in["__iota__"] = np.asarray(iota)
        oenv, ospd = oeng.run(prog, oenv_in, regs)
        label = f"[sched tid={ticket.tid} {prog.name}]"
        for name in oenv:
            if name == "__iota__":
                continue
            _assert_match(f"{label} env[{name}] vs ISA oracle",
                          genv[name], oenv[name], rtol=rtol, atol=atol)
            checked += 1
        for name in ospd:
            _assert_match(f"{label} spd[{name}] vs ISA oracle",
                          gspd[name], ospd[name], rtol=rtol, atol=atol)
            checked += 1
    return checked, report


def _np_rmw(table: np.ndarray, idx: np.ndarray, vals: np.ndarray,
            op: str, cond: np.ndarray | None = None) -> np.ndarray:
    """Sequential per-lane RMW ground truth (mirrors ``OracleEngine``'s
    IRMW loop): naive program order, no sorting, no segment combines.
    Stores drop (the unified OOB policy): out-of-range destinations are
    skipped; ``cond`` False lanes are no-ops."""
    out = np.array(table)
    vals = vals.reshape((idx.shape[0],) + out.shape[1:]).astype(out.dtype)
    for k in range(idx.shape[0]):
        a = int(idx[k])
        if not 0 <= a < out.shape[0]:
            continue
        if cond is not None and not bool(cond[k]):
            continue
        out[a:a + 1] = oracle.np_alu(op, out[a:a + 1], vals[k:k + 1])
    return out


def check_mixed_flush_parity(case, *, tile_size: int = 256,
                             scheduler: "Scheduler | None" = None,
                             tenants: Sequence[str] = ("a", "b", "c"),
                             rtol: float = 1e-4, atol: float = 1e-5,
                             device="cuda", mesh=None):
    """Mixed-window parity: programs + raw gathers + RMWs against shared
    tables in ONE flush, through the full plan pipeline, vs NumPy.

    ``case``: a ``fuzzer.MixedFlushCase`` (or compatible). Expectations
    mirror the window semantics: gather tickets read the window-initial
    table state (OOB clamped) — bit-exact; every RMW ticket on a table
    resolves to the end-of-window state — bit-exact for integer tables
    (one op per table, order-free mod 2^32), allclose for float ADD; each
    program matches an independent ``OracleEngine`` run. Returns
    ``(checked, report)``.

    ``mesh``, a ``distributed.ProcessMesh``, runs the window SPMD over a
    ``ShardedEngine`` on it (one scheduler per rank): every gather and RMW
    table is submitted as the rank's slice, each gather ticket is held
    whole and each RMW ticket as the rank's slice, and the verdict is
    all-reduced — a mismatch on any rank raises on every rank.
    """
    process = mesh is not None
    if process:
        from repro_torch.distributed import ShardedEngine
        sched = scheduler if scheduler is not None else Scheduler(
            engine=ShardedEngine(mesh, tile_size=tile_size, optimize=True))
    else:
        sched = scheduler if scheduler is not None else Scheduler(
            engine=Engine(tile_size=tile_size, optimize=True, device=device))
    iota = np.arange(tile_size, dtype=np.int32)
    eng = sched.engine
    # each table's submission: over a process mesh one slice object per
    # table (so a table's submissions still fuse), else the table
    rows = {name: eng.rank_rows(len(t)) if process else (0, len(t))
            for name, t in case.tables.items()}
    part = {name: (t[slice(*rows[name])], {"n_rows": len(t)}) if process
            else (t, {}) for name, t in case.tables.items()}

    prog_entries, gather_tickets, rmw_tickets = [], [], {}
    ti = 0

    def tenant():
        nonlocal ti
        ti += 1
        return tenants[ti % len(tenants)]

    # interleave submissions across the three queues and the tenants
    for p, env, n in case.programs:
        prog, _ = compiler.compile_pattern(p, tile_size=tile_size)
        regs = {"tile_base": 0, "N": n, "tile_end": n}
        t = sched.submit(prog, {**env, "__iota__": iota}, regs,
                         tenant=tenant())
        prog_entries.append((t, prog, env, regs))
    for name, idx in case.gathers:
        tab, kw = part[name]
        t = sched.submit_gather(tab, idx, tenant=tenant(), **kw)
        gather_tickets.append((t, name, idx))
    for name, idx, vals, cond in case.rmws:
        tab, kw = part[name]
        t = sched.submit_rmw(tab, idx, vals, op=case.table_ops[name],
                             cond=cond, tenant=tenant(), **kw)
        rmw_tickets.setdefault(name, []).append(t)

    report = sched.flush()
    if not process:
        return _check_mixed(case, sched, iota, tile_size, gather_tickets,
                            rmw_tickets, prog_entries, rows, rtol,
                            atol), report
    failure, checked = None, 0
    try:
        checked = _check_mixed(case, sched, iota, tile_size, gather_tickets,
                               rmw_tickets, prog_entries, rows, rtol, atol)
    except ParityError as e:
        failure = str(e)
    _process_verdict(mesh, failure, eng.device)
    return checked, report


def _process_verdict(mesh, failure: Optional[str], device) -> None:
    """All-reduce a process mesh's per-rank verdict: raises
    ``ParityError`` on every rank when any rank's check failed."""
    from repro_torch.distributed import all_gather
    ok = torch.tensor([failure is None], dtype=torch.int32, device=device)
    verdict = all_gather(ok, mesh).reshape(-1).tolist()
    if not all(verdict):
        bad = [i for i, v in enumerate(verdict) if not v]
        raise ParityError(f"process mesh of {mesh.num_shards}: rank(s) "
                          f"{bad} diverged"
                          + (f"; here: {failure}" if failure else ""))


def _check_mixed(case, sched, iota, tile_size, gather_tickets, rmw_tickets,
                 prog_entries, rows, rtol, atol) -> int:
    """``check_mixed_flush_parity``'s checks of the flushed window; RMW
    tickets are held as the rows ``rows[name]`` of the expected table."""
    checked = 0

    # gathers read the window-initial state; loads clamp
    for t, name, idx in gather_tickets:
        table = case.tables[name]
        want = table[np.clip(idx, 0, table.shape[0] - 1)]
        _assert_match(f"[{case.name} gather {name}] vs NumPy oracle",
                      sched.result(t), want, rtol=0, atol=0)
        checked += 1

    # RMW tickets resolve to the end-of-window state (single op per
    # table, so the sequential submission-order replay is THE answer on
    # integer tables and allclose on float ADD)
    for name, tickets in rmw_tickets.items():
        want = np.array(case.tables[name])
        for n2, idx, vals, cond in case.rmws:
            if n2 == name:
                want = _np_rmw(want, idx, vals, case.table_ops[name],
                               cond=cond)
        lo, hi = rows[name]
        for t in tickets:
            _assert_match(f"[{case.name} rmw {name}:"
                          f"{case.table_ops[name]}] vs NumPy oracle",
                          sched.result(t), want[lo:hi], rtol=rtol,
                          atol=atol)
            checked += 1

    # programs: independent per-program ISA-oracle runs
    for t, prog, env, regs in prog_entries:
        genv, gspd = sched.result(t)
        oeng = oracle.OracleEngine(tile_size=tile_size)
        oenv_in = {k: np.asarray(v) for k, v in env.items()}
        oenv_in["__iota__"] = np.asarray(iota)
        oenv, ospd = oeng.run(prog, oenv_in, regs)
        for name in oenv:
            if name == "__iota__":
                continue
            _assert_match(f"[{case.name} prog {prog.name} env[{name}]] "
                          "vs ISA oracle", genv[name], oenv[name],
                          rtol=rtol, atol=atol)
            checked += 1
        for name in ospd:
            _assert_match(f"[{case.name} prog {prog.name} spd[{name}]] "
                          "vs ISA oracle", gspd[name], ospd[name],
                          rtol=rtol, atol=atol)
            checked += 1
    return checked


def default_sharded_cases(seed: int = 0, *, n_rows: int = 257,
                          n_idx: int = 603) -> list:
    """Fuzzed gather / scatter-RMW streams for ``check_sharded_parity``.

    Index distributions span the paper's microbenchmark regimes (uniform,
    zipf-skewed, blocked) plus the sharding-specific hazards: rows sitting
    exactly on the owner boundaries of every mesh size in {2, 4, 8}, a
    single-owner hotspot (all lanes through one shard's fabric bucket),
    an all-duplicates stream, an empty stream, and an OOB stream (negatives
    + overshoots — the unified policy clamps them for gathers and drops
    them for RMWs, identically at every mesh size). RMW cases cover every
    ``RMW_OPS`` combine on an integer table (order-independent mod 2^32,
    hence bit-exact however shards merge) plus a float ADD checked to
    tolerance (§3.1: float reductions are legally reordered).
    """
    rng = np.random.default_rng(seed)

    def stream(kind: str, n: int = n_idx) -> np.ndarray:
        if kind in ("uniform", "zipf", "blocked"):
            return streams.make_indices(rng, n_rows, n, kind)
        if kind == "boundary":
            edges = [0, n_rows - 1]
            for m in (2, 4, 8):
                rows_per = -(-n_rows // m)
                edges += [k * rows_per for k in range(m)]
                edges += [k * rows_per - 1 for k in range(1, m)]
            edges = np.unique(np.clip(edges, 0, n_rows - 1))
            return rng.choice(edges, size=n).astype(np.int32)
        if kind == "dup":
            return np.full(n, int(rng.integers(0, n_rows)), np.int32)
        if kind == "owner_hot":
            # every lane in one mesh-8 shard's range: the single-owner
            # hotspot that maximizes one (source, owner) fabric bucket
            rows_per = -(-n_rows // 8)
            o = int(rng.integers(0, 8))
            lo = o * rows_per
            hi = min(lo + rows_per, n_rows)
            if lo >= hi:
                lo, hi = 0, rows_per
            return rng.integers(lo, hi, size=n).astype(np.int32)
        if kind == "oob":
            s = streams.make_indices(rng, n_rows, n, "uniform")
            pos = rng.choice(n, size=n // 4, replace=False)
            neg = -rng.integers(1, n_rows, size=pos.shape[0])
            big = n_rows + rng.integers(0, n_rows, size=pos.shape[0])
            s[pos] = np.where(rng.random(pos.shape[0]) < 0.5,
                              neg, big).astype(np.int32)
            return s
        raise ValueError(kind)

    t1 = rng.normal(size=(n_rows,)).astype(np.float32)
    t2 = rng.normal(size=(n_rows, 6)).astype(np.float32)
    ti = rng.integers(0, 2 ** 15, size=(n_rows,)).astype(np.int32)
    cases = []
    for kind in ("uniform", "zipf", "blocked", "boundary", "dup",
                 "owner_hot", "oob"):
        cases.append(("gather", t1, stream(kind)))
    cases.append(("gather", t2, stream("uniform")))
    cases.append(("gather", t1, np.zeros((0,), np.int32)))
    for op in isa.RMW_OPS:
        vals = rng.integers(0, 2 ** 10, size=n_idx).astype(np.int32)
        cases.append(("rmw", ti, stream("zipf"), vals, op))
    cases.append(("rmw", t1, stream("zipf"),
                  rng.normal(size=n_idx).astype(np.float32), "ADD"))
    cases.append(("rmw", ti, stream("oob"),
                  rng.integers(0, 2 ** 10, size=n_idx).astype(np.int32),
                  "ADD"))
    cases.append(("rmw", ti, stream("owner_hot"),
                  rng.integers(0, 2 ** 10, size=n_idx).astype(np.int32),
                  "XOR"))
    return cases


def check_sharded_parity(cases: Sequence | None = None, *,
                         mesh_sizes: Sequence[int] = (1, 2, 4, 8),
                         mesh=None, seed: int = 0, rtol: float = 1e-5,
                         atol: float = 1e-6, device="cuda"):
    """Sharded-engine parity: every mesh size vs the single-device NumPy
    oracle.

    ``cases``: ``("gather", table, idx)`` / ``("rmw", table, idx, vals,
    op)`` tuples (default: ``default_sharded_cases(seed)``). Gathers must
    be **bit-exact** (zero tolerance, floats included — no arithmetic
    happens); RMWs are bit-exact on integer tables (every ``RMW_OPS``
    combine is order-independent mod 2^32) and allclose on floats, whose
    reduction order the engine legally changes (§3.1).

    The port's logical shards (``distributed.mesh.Mesh``) run every mesh
    size, whatever the device count. ``mesh``, a ``ProcessMesh``, replaces
    ``mesh_sizes`` and is checked SPMD, on every rank at once: each rank
    passes its table slice and the whole stream, holds its own block of
    lanes (gathers) or its slice (RMWs) against the oracle, and the
    verdict is all-reduced — a mismatch on any rank raises
    ``ParityError`` on every rank. Returns ``(checked,
    ran_mesh_sizes)``.
    """
    from repro_torch.distributed import ProcessMesh, ShardedEngine
    if cases is None:
        cases = default_sharded_cases(seed)
    if mesh is not None:
        if not isinstance(mesh, ProcessMesh):
            raise TypeError(f"mesh= takes a ProcessMesh (logical meshes "
                            f"go in mesh_sizes), got {type(mesh).__name__}")
        return _check_process_parity(cases, mesh, rtol=rtol, atol=atol)
    checked, ran = 0, []
    for m in mesh_sizes:
        eng = ShardedEngine(mesh=int(m), device=device)
        ran.append(m)
        for k, case in enumerate(cases):
            if case[0] == "gather":
                _, table, idx = case
                got = eng.sharded_gather(table, idx)
                tn = np.asarray(table)
                # loads clamp (the unified OOB policy)
                want = tn[np.clip(np.asarray(idx), 0, tn.shape[0] - 1)]
                _assert_match(f"[mesh={m} case{k} gather] vs NumPy oracle",
                              got, want, rtol=0, atol=0)
            elif case[0] == "rmw":
                _, table, idx, vals, op = case
                got = eng.sharded_rmw(table, idx, vals, op=op)
                want = _np_rmw(np.asarray(table), np.asarray(idx),
                               np.asarray(vals), op)
                _assert_match(f"[mesh={m} case{k} rmw:{op}] vs NumPy "
                              "oracle", got, want, rtol=rtol, atol=atol)
            else:
                raise ValueError(f"unknown case kind {case[0]!r}")
            checked += 1
    return checked, ran


def _check_process_parity(cases, mesh, *, rtol: float, atol: float):
    """``check_sharded_parity`` on a ``ProcessMesh``: this rank's share of
    every case against the oracle, then one all-reduced verdict."""
    from repro_torch.distributed import ShardedEngine
    eng = ShardedEngine(mesh)
    m, r = eng.num_shards, eng.rank
    failure = None
    for k, case in enumerate(cases):
        tn = np.asarray(case[1])
        lo, hi = eng.rank_rows(tn.shape[0])
        idx = np.asarray(case[2])
        if case[0] == "gather":
            got = eng.sharded_gather(tn[lo:hi], idx, n_rows=tn.shape[0])
            a, b = eng.rank_lanes(idx.shape[0])
            want = tn[np.clip(idx[a:b], 0, tn.shape[0] - 1)]
            what, tol = f"[process mesh={m} rank {r} case{k} gather]", {}
        elif case[0] == "rmw":
            vals, op = np.asarray(case[3]), case[4]
            got = eng.sharded_rmw(tn[lo:hi], idx, vals, op=op,
                                  n_rows=tn.shape[0])
            want = _np_rmw(tn, idx, vals, op)[lo:hi]
            what = f"[process mesh={m} rank {r} case{k} rmw:{op}]"
            tol = dict(rtol=rtol, atol=atol)
        else:
            raise ValueError(f"unknown case kind {case[0]!r}")
        if failure is None:
            try:
                _assert_match(f"{what} vs NumPy oracle", got, want,
                              **{"rtol": 0, "atol": 0, **tol})
            except ParityError as e:
                failure = str(e)
    _process_verdict(mesh, failure, eng.device)
    return len(cases), [m]


def check_app_parity(app_names: Sequence[str] | None = None, *,
                     modes: Sequence[str] = ("eager", "pipelined"),
                     mesh_sizes: Sequence[int] = (),
                     seeds: Sequence[int] = (0,), device="cuda",
                     mesh=None):
    """End-to-end app parity: every ``repro_torch.apps`` driver vs its
    sequential NumPy oracle, **bit-exact** (zero tolerance, f32 included —
    the apps are constructed so every float reduction is exact and
    order-independent; see ``apps.spmv``).

    ``modes`` runs each app's single-device drivers; ``mesh_sizes``
    additionally runs the pipelined driver over a ``ShardedEngine`` of
    each size (logical shards: every size runs). Returns ``(checked,
    ran_mesh_sizes)``.

    ``mesh``, a ``distributed.ProcessMesh``, replaces ``modes`` and
    ``mesh_sizes``: every rank runs each app's pipelined driver over the
    mesh (SPMD) and holds what ``run`` returns against the oracle; the
    verdict is all-reduced.
    """
    from repro_torch.apps import APPS
    names = list(app_names) if app_names else list(APPS)
    if mesh is not None:
        return _process_apps(
            [(f"[app={name} seed={seed} pipelined process mesh]",
              lambda mod=APPS[name], seed=seed: mod.demo(
                  seed, mode="pipelined", mesh=mesh),
              lambda mod=APPS[name], seed=seed: mod.demo_reference(seed))
             for name in names for seed in seeds], mesh)
    checked, ran = 0, []
    for name in names:
        mod = APPS[name]
        for seed in seeds:
            want = mod.demo_reference(seed)
            for mode in modes:
                got = mod.demo(seed, mode=mode, device=device)
                _assert_match(
                    f"[app={name} seed={seed} {mode}] vs NumPy oracle",
                    got, want, rtol=0, atol=0)
                checked += 1
            for ms in mesh_sizes:
                if ms not in ran:
                    ran.append(ms)
                got = mod.demo(seed, mode="pipelined", mesh=ms,
                               device=device)
                _assert_match(
                    f"[app={name} seed={seed} pipelined mesh={ms}] "
                    "vs NumPy oracle", got, want, rtol=0, atol=0)
                checked += 1
    return checked, ran


def _process_apps(runs, mesh):
    """``(what, run, oracle)`` triples run SPMD on a process mesh; every
    rank's result is held bit for bit, then the verdict all-reduced.
    Returns ``(checked, [mesh size])``."""
    failure = None
    for what, run, want in runs:
        try:
            # a run's own ParityError (kv_serve's growth) comes after its
            # collectives, so every rank still reaches the verdict
            got = run()
            _assert_match(f"{what} vs NumPy oracle", got, want(), rtol=0,
                          atol=0)
        except ParityError as e:
            failure = failure or str(e)
    _process_verdict(mesh, failure, mesh.device)
    return len(runs), [mesh.num_shards]


def check_kv_parity(*, seeds: Sequence[int] = (0, 1),
                    modes: Sequence[str] = ("eager", "sequential",
                                            "pipelined"),
                    mesh_sizes: Sequence[int] = (),
                    n_steps: int = 6, device="cuda", mesh=None) -> int:
    """Paged-KV decode-batch parity (``apps.kv_serve``) with the two
    properties the generic app check cannot see:

      * the pool must actually grow **mid-flight** (``stats.growths > 0``)
        — otherwise the dynamic-table path (plan-cache miss on a new
        ``window_signature``, cost model re-decision) silently went
        unexercised;
      * cross-tenant coalescing on the shared prefix pages must be real:
        the scheduler's flush reports show fused gather nodes spanning
        multiple tenants.

    Every mode and every mesh size is compared bit-exact (rtol=0) against
    the sequential NumPy oracle. Returns the number of comparisons made.
    ``mesh``, a ``distributed.ProcessMesh``, replaces ``modes`` and
    ``mesh_sizes``: the pipelined run over it (SPMD, the pool grown
    mid-flight and re-cut by rank) on every rank, verdict all-reduced.
    """
    from repro_torch.apps import kv_serve
    from repro_torch.serve import AccessService

    if mesh is not None:
        def run(seed):
            stats: dict = {}
            got = kv_serve.run(kv_serve.make_problem(seed), n_steps,
                               mode="pipelined", mesh=mesh, stats_out=stats)
            if stats["growths"] == 0:
                raise ParityError(f"[kv seed={seed} process mesh] pool "
                                  "never grew mid-flight")
            return got
        return _process_apps(
            [(f"[kv seed={seed} process mesh]", lambda s=seed: run(s),
              lambda s=seed: kv_serve.reference(kv_serve.make_problem(s),
                                                n_steps))
             for seed in seeds], mesh)[0]
    checked = 0
    for seed in seeds:
        prob = kv_serve.make_problem(seed)
        want = kv_serve.reference(prob, n_steps)
        for mode in modes:
            stats: dict = {}
            got = kv_serve.run(kv_serve.make_problem(seed), n_steps,
                               mode=mode, stats_out=stats, device=device)
            _assert_match(f"[kv seed={seed} {mode}] vs NumPy oracle",
                          got, want, rtol=0, atol=0)
            if stats["growths"] == 0:
                raise ParityError(
                    f"[kv seed={seed} {mode}] pool never grew mid-flight "
                    "— the dynamic-table path was not exercised")
            checked += 1
        for ms in mesh_sizes:
            got = kv_serve.run(kv_serve.make_problem(seed), n_steps,
                               mode="pipelined", mesh=ms, device=device)
            _assert_match(f"[kv seed={seed} mesh={ms}] vs NumPy oracle",
                          got, want, rtol=0, atol=0)
            checked += 1
        # cross-tenant coalescing on the shared prefix pages must be
        # real: record every access window's report and demand a fused
        # gather whose cross-request gain beats 1x
        service = AccessService(auto_flush=0, device=device)
        reports = []
        orig_flush = service.flush_async

        def recording_flush(**kw):
            handle = orig_flush(**kw)
            reports.append(handle.report)
            return handle

        service.flush_async = recording_flush
        got = kv_serve.run(kv_serve.make_problem(seed), n_steps,
                           mode="pipelined", service=service)
        _assert_match(f"[kv seed={seed} recorded] vs NumPy oracle",
                      got, want, rtol=0, atol=0)
        gains = [g for rep in reports
                 for (g, _, _) in rep.gather_coalescing.values()]
        if not any(g > 1.0 for g in gains):
            raise ParityError(
                f"[kv seed={seed}] no fused gather window showed "
                f"cross-request coalescing gain > 1x (gains={gains}) — "
                "shared prefix pages were not actually shared")
        checked += 1
    return checked


def check_embedding_parity(*, seeds: Sequence[int] = (0, 1),
                           modes: Sequence[str] = ("eager", "sequential",
                                                   "pipelined"),
                           mesh_sizes: Sequence[int] = (),
                           device="cuda", mesh=None) -> int:
    """Embedding-bag lookup/update parity (``apps.embedding_bag``):
    lookup outputs AND the updated table compared bit-exact against the
    NumPy oracle in every mode (and on the mesh), plus a property check
    that ``segment_combine`` matches a naive duplicate-scatter oracle and
    emits unique in-range destinations (the unique-writer invariant the
    RMW backend depends on). Returns the number of comparisons made.
    ``mesh``, a ``distributed.ProcessMesh``, replaces ``modes`` and
    ``mesh_sizes`` (and the property check): the pipelined run over it on
    every rank, verdict all-reduced.
    """
    from repro_torch.apps import embedding_bag

    if mesh is not None:
        return _process_apps(
            [(f"[embedding seed={seed} process mesh]",
              lambda s=seed: embedding_bag.demo(s, mode="pipelined",
                                                mesh=mesh),
              lambda s=seed: embedding_bag.demo_reference(s))
             for seed in seeds], mesh)[0]
    checked = 0
    for seed in seeds:
        want = embedding_bag.demo_reference(seed)
        for mode in modes:
            got = embedding_bag.demo(seed, mode=mode, device=device)
            _assert_match(f"[embedding seed={seed} {mode}] vs NumPy "
                          "oracle", got, want, rtol=0, atol=0)
            checked += 1
        for ms in mesh_sizes:
            got = embedding_bag.demo(seed, mode="pipelined", mesh=ms,
                                     device=device)
            _assert_match(f"[embedding seed={seed} mesh={ms}] vs NumPy "
                          "oracle", got, want, rtol=0, atol=0)
            checked += 1
        # segment_combine vs the naive duplicate-index scatter
        rng = np.random.default_rng(0xD1_E3 + seed)
        rows, n, d = 16, 40, 5
        idx = rng.integers(-4, rows + 4, size=n)
        vals = rng.integers(0, 8, size=(n, d)).astype(np.float32)
        dest, summed = embedding_bag.segment_combine(idx, vals,
                                                     num_rows=rows,
                                                     device=device)
        # a dropping unique-writer scatter: out-of-range lanes land on a
        # spare row
        keep = torch.where((dest >= 0) & (dest < rows), dest, rows)
        got = torch.zeros((rows + 1, d), dtype=torch.float32,
                          device=summed.device).index_add_(
            0, keep.to(torch.int64), summed)[:rows]
        want_t = np.zeros((rows, d), np.float32)
        for i in range(n):
            if 0 <= idx[i] < rows:
                want_t[idx[i]] += vals[i]
        _assert_match(f"[segment_combine seed={seed}] vs naive scatter",
                      got, want_t, rtol=0, atol=0)
        dest = interop.to_numpy(dest)
        inr = dest[dest < rows]
        if len(inr) != len(set(inr.tolist())):
            raise ParityError(
                f"[segment_combine seed={seed}] duplicate in-range "
                "destinations — unique-writer invariant violated")
        checked += 1
    return checked


def check_case_parity(case: FuzzCase,
                      configs: Sequence[EngineConfig] = EAGER_CONFIGS,
                      **kw) -> int:
    return check_pattern_parity(
        case.pattern, case.env, n=case.n, configs=configs,
        max_tile_fill=case.max_tile_fill, **kw)


def rotating_configs(seed: int, *, n_eager: int = 2,
                     jit_every: int = 8) -> tuple:
    """Deterministic per-seed config subset that covers the full matrix
    across a corpus: ``n_eager`` eager configs round-robin, plus one
    cached-executable (``jit``) config every ``jit_every`` seeds."""
    cfgs = [EAGER_CONFIGS[(seed + k * 5) % len(EAGER_CONFIGS)]
            for k in range(n_eager)]
    if seed % jit_every == 0:
        cfgs.append(JIT_CONFIGS[(seed // jit_every) % len(JIT_CONFIGS)])
    # dedup, keep order
    seen, out = set(), []
    for c in cfgs:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return tuple(out)


# ---------------------------------------------------------------------------
# open-loop traffic replay parity
# ---------------------------------------------------------------------------

def check_traffic_parity(trace, service=None, *,
                         tile_size: Optional[int] = None,
                         service_time=None, rtol: float = 1e-4,
                         atol: float = 1e-5, device="cuda", mesh=None):
    """Replay an open-loop trace through a service and assert every
    ticket bit-exact vs the NumPy oracle — adaptive window sizing and WFQ
    must change *when* work runs, never *what* it computes.

    Expectations per kind (the mixed-window semantics, applied to
    whatever windows the controller happened to cut):

      * gather / kv_decode — the submit-time table snapshot, OOB
        clamped: bit-exact;
      * RMW / kv_append — the end state of *the window that drained the
        ticket*
        (membership recovered from each ``FlushReport.order``), replayed
        sequentially by ``_np_rmw`` from the original table: bit-exact on
        integer tables (the trace default), allclose on float ADD;
      * program — an independent ``OracleEngine`` run of the same
        compiled program (cached per program shape), to the harness's
        standard float tolerance;
      * rejected (``QueueFull``) — ``result()`` raises
        ``QueueFullError``; nothing was enqueued, so no table state to
        check.

    ``device``: where a service built here runs (a given ``service``
    brings its own); ``mesh``: a ``distributed.ProcessMesh`` the service
    built here spans instead, on its ranks' devices. Over a process mesh
    (this one or the given service's) the replay runs SPMD: each gather
    ticket is held whole, each RMW ticket as the rank's rows
    ``rank_rows`` of its window's end state, and the verdict is
    all-reduced — a mismatch on any rank raises on every rank. Returns
    ``(checked, ReplayResult)``.
    """
    from repro_torch.serve.access_service import (AccessService,
                                                  AdaptiveFlushController,
                                                  VirtualClock)
    from repro_torch.serve.traffic import replay_trace

    if service is None:
        # the replay reads no clock: the virtual one passes the service's
        # check that a controller over a process mesh has one
        service = AccessService(
            tile_size=tile_size or 256, auto_flush=0,
            controller=AdaptiveFlushController(overhead_us=200.0),
            clock=VirtualClock(),
            **({"device": device} if mesh is None else {"mesh": mesh}))
    if tile_size is None:
        # programs must compile at the engine's own tile so the oracle's
        # scratchpad shapes agree with what the service executed
        tile_size = service.scheduler.engine.tile_size
    if service_time is None:
        # deterministic service model: fixed overhead + linear drain cost
        def service_time(depth, report):
            return 200.0 + 8.0 * depth
    res = replay_trace(trace, service, service_time=service_time,
                       tile_size=tile_size)
    sched = service.scheduler
    if not sched.process:
        return _check_traffic(trace, res, sched, tile_size, rtol, atol,
                              None), res
    failure, checked = None, 0
    try:
        checked = _check_traffic(trace, res, sched, tile_size, rtol, atol,
                                 sched.engine.rank_rows)
    except ParityError as e:
        failure = str(e)
    _process_verdict(sched.engine.mesh, failure, sched.engine.device)
    return checked, res


def _check_traffic(trace, res, sched, tile_size, rtol, atol,
                   rank_rows) -> int:
    """``check_traffic_parity``'s checks of a replay's tickets; RMW
    tickets are held as the rows ``rank_rows(n)`` of their expected
    table (all of them when ``rank_rows`` is None)."""
    from repro_torch.core.scheduler import QueueFullError
    win_of = res.window_of()

    # RMW oracle: per (window, table), sequential submission-order replay
    # from the original table (single op per table -> order-free)
    rmw_events: Dict[tuple, list] = {}
    for ev, t in res.tickets:
        if ev.kind in ("rmw", "kv_append"):
            rmw_events.setdefault((win_of[t.tid], ev.table), []).append(ev)
    end_state = {}
    for (wi, name), evs in rmw_events.items():
        want = np.array(trace.tables[name])
        for ev in evs:
            want = _np_rmw(want, ev.idx, ev.values, ev.op, cond=ev.cond)
        end_state[(wi, name)] = want

    oracle_cache: Dict[int, tuple] = {}
    checked = 0
    for ev, t in res.tickets:
        got = sched.result(t)
        where = f"[traffic {ev.kind} @{ev.t_us:.0f}us tenant={ev.tenant}]"
        if ev.kind in ("gather", "kv_decode"):
            table = trace.tables[ev.table]
            want = table[np.clip(ev.idx, 0, table.shape[0] - 1)]
            _assert_match(f"{where} {ev.table} vs NumPy oracle", got, want,
                          rtol=0, atol=0)
        elif ev.kind in ("rmw", "kv_append"):
            want = end_state[(win_of[t.tid], ev.table)]
            if rank_rows is not None:
                want = want[slice(*rank_rows(want.shape[0]))]
            # kv_append streams are integer-valued f32 ADDs — exact and
            # order-free despite the float dtype
            exact = (trace.tables[ev.table].dtype != np.float32
                     or ev.kind == "kv_append")
            _assert_match(f"{where} {ev.table}:{ev.op} vs NumPy oracle",
                          got, want, rtol=0 if exact else rtol,
                          atol=0 if exact else atol)
        else:   # program
            genv, gspd = got
            if ev.program_id not in oracle_cache:
                pattern, env, n = trace.programs[ev.program_id]
                prog, _ = compiler.compile_pattern(pattern,
                                                   tile_size=tile_size)
                oeng = oracle.OracleEngine(tile_size=tile_size)
                oenv_in = {k: np.asarray(v) for k, v in env.items()}
                oenv_in["__iota__"] = np.arange(tile_size, dtype=np.int32)
                oracle_cache[ev.program_id] = oeng.run(
                    prog, oenv_in, {"tile_base": 0, "N": n, "tile_end": n})
            oenv, ospd = oracle_cache[ev.program_id]
            for name in oenv:
                if name == "__iota__":
                    continue
                _assert_match(f"{where} prog env[{name}] vs ISA oracle",
                              genv[name], oenv[name], rtol=rtol, atol=atol)
            for name in ospd:
                _assert_match(f"{where} prog spd[{name}] vs ISA oracle",
                              gspd[name], ospd[name], rtol=rtol, atol=atol)
        checked += 1

    for ev, t in res.rejected:
        try:
            sched.result(t)
        except QueueFullError:
            continue
        raise ParityError(f"rejected ticket {t} did not raise "
                          "QueueFullError from result()")
    return checked

"""Seeded generator of *legal* random Patterns + environments (Table-1 space).

The port's copy of the JAX package's ``testing.fuzzer``: ``generate_case``
(which also feeds the traffic trace's program events), the mixed flush
windows of ``generate_mixed_case`` and their hazardous ``mutate_case``
mutants, and the traffic corpus generator. The NumPy draws
are the reference's, in the same order, so a seed gives the same pattern,
environment and trace in both packages; the patterns are built from the
port's ``compiler`` classes.

Each ``FuzzCase`` is a compiler ``Pattern`` plus a NumPy environment sized so
that every generated index expression stays in range by construction:

  * index expressions are built top-down against a value *bound*: a fresh
    index region is filled with values in ``[0, bound)``, AND-masks shrink
    the range to a power of two, SHR shifts it down, MIN clamps it — the
    hash-style address math of Table 1 (hash join, XSBench);
  * 1–3 levels of indirection per expression (chained Loads);
  * optional direct or indirect CSR-style range loops (RNG fusion) with a
    monotone offsets array ``H``;
  * optional per-access compare conditions;
  * every written region is freshly created and never read anywhere in the
    pattern, so §4.2 legality holds and statement order cannot matter —
    the property that makes results tile-size-independent.

Determinism: ``generate_case(seed)`` depends only on the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core import compiler, isa

INT_DTYPES = ("i32", "u32")
FUZZ_DTYPES = ("f32", "i32", "u32")

# Region sizes and trip counts come from the JAX package's fixed menus (kept
# there so its jitted bulk ops hit their compile cache); the same menus
# make the same seed draw the same case here.
REGION_SIZES = (64, 128, 256, 512, 1024)
TRIP_COUNTS = (5, 37, 64, 100, 200, 333)


@dataclasses.dataclass
class FuzzCase:
    name: str
    pattern: compiler.Pattern
    env: Dict[str, np.ndarray]   # region name -> array
    n: int                       # outer trip count
    seed: int

    def max_tile_fill(self, tile_size: int) -> int:
        from repro_torch.testing import oracle
        return oracle.pattern_max_tile_fill(self.pattern, self.env, self.n,
                                            tile_size)


class _Gen:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.env: Dict[str, np.ndarray] = {}
        self._n_regions = 0
        self.n = int(self.rng.choice(TRIP_COUNTS))

    def _name(self, hint: str) -> str:
        self._n_regions += 1
        return f"{hint}{self._n_regions}"

    def _size(self) -> int:
        return int(self.rng.choice(REGION_SIZES))

    def new_index_region(self, bound: int, size: int | None = None) -> str:
        """Fresh int32 region with values uniform in [0, bound).

        ~1 in 8 regions is *poisoned* with out-of-range entries — negatives
        and values past ``bound`` — so the unified OOB policy (loads clamp,
        stores drop; DESIGN.md) is fuzzed across the whole config matrix,
        not just unit-tested. Legal by construction either way: the policy
        gives every OOB access defined semantics that the oracle mirrors.
        """
        size = int(size if size is not None else self._size())
        name = self._name("ix")
        vals = self.rng.integers(
            0, max(bound, 1), size=size).astype(np.int32)
        if self.rng.random() < 0.125:
            k = max(1, size // 8)
            pos = self.rng.choice(size, size=k, replace=False)
            neg = -self.rng.integers(1, bound + 2, size=k)
            big = bound + self.rng.integers(0, bound + 2, size=k)
            vals[pos] = np.where(self.rng.random(k) < 0.5,
                                 neg, big).astype(np.int32)
        self.env[name] = vals
        return name

    def new_value_region(self, dtype: str, size: int | None = None) -> str:
        size = int(size if size is not None else self._size())
        name = self._name("v")
        if dtype == "f32":
            self.env[name] = self.rng.normal(size=size).astype(np.float32)
        else:
            self.env[name] = self.rng.integers(
                0, 2 ** 16, size=size).astype(
                    np.int32 if dtype == "i32" else np.uint32)
        return name

    # -- index expressions --------------------------------------------------
    def index_expr(self, bound: int, depth: int,
                   allow_j: bool = False) -> compiler.Expr:
        """Expression whose values are guaranteed inside [0, bound)."""
        rng = self.rng
        if depth <= 0:
            # leaves: the induction variable, clamped into range if needed
            v = compiler.Var("j" if (allow_j and rng.random() < 0.6)
                             else "i")
            leaf_bound = self.j_bound if v.name == "j" else self.n
            if leaf_bound > bound:
                return compiler.BinOp("MIN", v, int(bound - 1))
            return v
        kind = rng.choice(["load", "hash", "shr", "min"])
        if kind == "load":
            size = self._size()
            region = self.new_index_region(bound, size)
            return compiler.Load(
                region, self.index_expr(size, depth - 1, allow_j))
        if kind == "hash":      # (x & F) — power-of-two bucket count
            k = max(int(bound).bit_length() - 1, 0)
            sub = self.index_expr(2 ** 16, depth - 1, allow_j)
            return compiler.BinOp("AND", sub, (1 << k) - 1)
        if kind == "shr":       # ((x & F) >> G) — hash-join style
            g = int(rng.integers(1, 5))
            k = max(int(bound).bit_length() - 1, 0)
            mask = ((1 << k) - 1) << g
            sub = self.index_expr(2 ** 16, depth - 1, allow_j)
            return compiler.BinOp(
                "SHR", compiler.BinOp("AND", sub, mask), g)
        # min-clamp: any subexpression forced into range
        sub = self.index_expr(2 ** 12, depth - 1, allow_j)
        return compiler.BinOp("MIN", sub, int(bound - 1))

    # -- value expressions --------------------------------------------------
    def value_expr(self, dtype: str, depth: int,
                   allow_j: bool = False) -> compiler.Expr:
        rng = self.rng
        region = self.new_value_region(dtype)
        size = self.env[region].shape[0]
        load = compiler.Load(
            region, self.index_expr(size, int(rng.integers(0, 2)), allow_j))
        if depth <= 0 or rng.random() < 0.5:
            return load
        op = rng.choice(["ADD", "MUL", "SUB", "MIN", "MAX"])
        if rng.random() < 0.5:
            imm = (float(rng.normal()) if dtype == "f32"
                   else int(rng.integers(0, 64)))
            return compiler.BinOp(op, load, imm)
        return compiler.BinOp(op, load,
                              self.value_expr(dtype, depth - 1, allow_j))

    def compare(self, allow_j: bool) -> compiler.Compare:
        rng = self.rng
        op = rng.choice(["LT", "LE", "GT", "GE", "EQ"])
        dtype = "f32" if rng.random() < 0.7 else "i32"
        region = self.new_value_region(dtype)
        size = self.env[region].shape[0]
        lhs = compiler.Load(
            region, self.index_expr(size, int(rng.integers(0, 2)), allow_j))
        if op == "EQ":  # make equality non-vacuous on small int ranges
            region2 = self._name("v")
            self.env[region2] = rng.integers(
                0, 4, size=size).astype(np.int32)
            lhs = compiler.Load(region2, lhs.index)
            return compiler.Compare(op, lhs, int(rng.integers(0, 4)))
        rhs = float(rng.normal()) if dtype == "f32" \
            else int(rng.integers(0, 2 ** 15))
        return compiler.Compare(op, lhs, rhs)

    # -- range loops --------------------------------------------------------
    def range_loop(self):
        """CSR-style offsets H (+ optional indirection K): returns RangeLoop
        and records the inner var's value bound."""
        rng = self.rng
        if rng.random() < 0.125:
            # empty frontier: every range [lo, hi) is zero-length (a BFS
            # whose frontier drained — legal Table-1 input). Keeps the
            # nightly sweep exercising the range fuser's total==0 path.
            lens = np.zeros(self.n, np.int64)
        else:
            # short ranges so even TILE=64 rarely truncates
            lens = rng.integers(0, 3, size=self.n)
        H = np.zeros(self.n + 1, np.int32)
        H[1:] = np.cumsum(lens)
        h_name = self._name("H")
        self.env[h_name] = H
        self.j_bound = max(int(H[-1]), 1)
        i_expr: compiler.Expr = compiler.Var("i")
        if rng.random() < 0.4:   # indirect range: H[K[i]] .. H[K[i]+1]
            k_name = self._name("K")
            self.env[k_name] = rng.permutation(self.n).astype(np.int32)
            i_expr = compiler.Load(k_name, compiler.Var("i"))
        return compiler.RangeLoop(
            "j",
            compiler.Load(h_name, i_expr),
            compiler.Load(h_name, compiler.BinOp("ADD", i_expr, 1)))


def generate_case(seed: int) -> FuzzCase:
    """Deterministically generate one legal FuzzCase from ``seed``."""
    g = _Gen(seed)
    rng = g.rng
    has_range = rng.random() < 0.35
    g.j_bound = 0
    range_loop = g.range_loop() if has_range else None

    accesses = []
    n_acc = int(rng.integers(1, 4))
    has_writer = False
    for a_i in range(n_acc):
        kind = str(rng.choice(["LD", "ST", "RMW"]))
        if a_i == n_acc - 1 and not has_writer:
            kind = str(rng.choice(["ST", "RMW"]))   # ensure env is observable
        cond = g.compare(has_range) if rng.random() < 0.4 else None
        depth = int(rng.integers(1, 4))             # 1-3 indirection levels
        if kind == "LD":
            dtype = str(rng.choice(["f32", "i32"]))
            region = g.new_value_region(dtype)
            size = g.env[region].shape[0]
            accesses.append(compiler.Access(
                "LD", region, g.index_expr(size, depth - 1, has_range),
                dtype=dtype, cond=cond))
            continue
        has_writer = True
        if kind == "ST":
            dtype = str(rng.choice(FUZZ_DTYPES))
            out_size = g._size()
            out = g._name("out")
            g.env[out] = (np.zeros(out_size, np.float32) if dtype == "f32"
                          else np.zeros(out_size,
                                        np.int32 if dtype == "i32"
                                        else np.uint32))
            accesses.append(compiler.Access(
                "ST", out, g.index_expr(out_size, depth - 1, has_range),
                value=g.value_expr(dtype, 1, has_range),
                dtype=dtype, cond=cond))
        else:
            op = str(rng.choice(isa.RMW_OPS))
            dtype = "f32" if (op in ("ADD", "MIN", "MAX", "MUL")
                              and rng.random() < 0.5) \
                else str(rng.choice(INT_DTYPES))
            if op == "MUL" and dtype == "f32":
                op = "ADD"      # float products over dup-heavy streams blow
                                # past allclose tolerance; keep MUL on ints
            out_size = int(rng.choice((16, 64, 256)))  # small -> duplicates
            out = g._name("acc")
            if dtype == "f32":
                g.env[out] = g.rng.normal(size=out_size).astype(np.float32)
            else:
                g.env[out] = g.rng.integers(
                    0, 2 ** 16, size=out_size).astype(
                        np.int32 if dtype == "i32" else np.uint32)
            accesses.append(compiler.Access(
                "RMW", out, g.index_expr(out_size, depth - 1, has_range),
                value=g.value_expr(dtype, 1, has_range),
                op=op, dtype=dtype, cond=cond))

    pattern = compiler.Pattern(
        tuple(accesses), range_loop=range_loop, name=f"fuzz{seed}")
    compiler.check_legality(pattern)    # by construction; fail loudly if not
    return FuzzCase(name=f"fuzz{seed}", pattern=pattern, env=g.env,
                    n=g.n, seed=seed)


@dataclasses.dataclass
class MixedFlushCase:
    """One *mixed* flush window: compiled programs + raw bulk gathers +
    bulk RMWs against shared tables, submitted by several tenants and
    executed in ONE ``Scheduler.flush`` — the full plan-IR pipeline
    (group + fuse + coalesce + backend selection) in a single window.

    Semantics fuzzed (and mirrored by the oracle in
    ``harness.check_mixed_flush_parity``): gathers read the window's
    *initial* table state, RMW tickets resolve to the *end-of-window*
    state, OOB indices clamp on loads and drop on stores, and per table
    only one RMW op appears (so the window's combine order is free —
    bit-exact on integer tables however the pipeline fuses it).
    """
    name: str
    seed: int
    programs: list            # (pattern, env, n) — independent envs
    gathers: list             # (table_name, idx)
    rmws: list                # (table_name, idx, values, cond-or-None)
    tables: Dict[str, np.ndarray]
    table_ops: Dict[str, str]   # RMW table -> its single op
    # set by ``mutate_case``: one extra hazardous submission, either
    # ("gather", table, idx) or ("rmw", table, idx, vals, op) — kept out
    # of ``gathers``/``rmws`` so parity replay of the base case is
    # unaffected and the driver controls when the hazard lands
    injected: tuple = ()


def generate_mixed_case(seed: int) -> MixedFlushCase:
    """Deterministically generate one mixed flush window from ``seed``."""
    rng = np.random.default_rng(0xD100 + seed)
    tables: Dict[str, np.ndarray] = {}
    table_ops: Dict[str, str] = {}

    # shared gather tables: 1-D and 2-D floats (values only, no math)
    n_gt = int(rng.integers(1, 3))
    for t in range(n_gt):
        rows = int(rng.choice((64, 127, 256)))
        if rng.random() < 0.5:
            tables[f"G{t}"] = rng.normal(size=(rows,)).astype(np.float32)
        else:
            d = int(rng.integers(2, 7))
            tables[f"G{t}"] = rng.normal(size=(rows, d)).astype(np.float32)

    # shared RMW tables: integers (order-free mod 2^32) + sometimes a
    # float ADD table (checked to tolerance — §3.1 reordered reduction)
    n_rt = int(rng.integers(1, 3))
    for t in range(n_rt):
        rows = int(rng.choice((16, 64, 128)))
        if rng.random() < 0.25:
            tables[f"R{t}"] = rng.normal(size=(rows,)).astype(np.float32)
            table_ops[f"R{t}"] = "ADD"
        else:
            dt = np.int32 if rng.random() < 0.5 else np.uint32
            tables[f"R{t}"] = rng.integers(
                0, 2 ** 12, size=(rows,)).astype(dt)
            table_ops[f"R{t}"] = str(rng.choice(isa.RMW_OPS))

    def stream(rows: int, n: int) -> np.ndarray:
        # ~1/8 of streams are sharding hazards, so the mesh's exchange
        # protocol (dedup, owner split, measured capacity, codecs) gets
        # fuzzed by the same corpus the single-device paths run:
        #   * boundary-straddling — lanes packed onto the owner-range
        #     edges of every mesh size in {2, 4, 8};
        #   * single-owner-hot — all traffic lands in one shard's range,
        #     the worst case for a measured per-(source, owner) capacity.
        r = rng.random()
        if n and r < 0.0625:
            from repro_torch.distributed.mesh import shard_row_ranges
            edges = [np.clip(lo + d, 0, rows - 1) for m in (2, 4, 8)
                     for lo, hi in shard_row_ranges(rows, m) if lo < hi
                     for d in (-1, 0)]
            return rng.choice(np.unique(edges), size=n).astype(np.int32)
        if n and r < 0.125:
            from repro_torch.distributed.mesh import shard_row_ranges
            ranges = [rg for rg in shard_row_ranges(rows, 8)
                      if rg[0] < rg[1]]
            lo, hi = ranges[int(rng.integers(0, len(ranges)))]
            return rng.integers(lo, hi, size=n).astype(np.int32)
        s = rng.integers(0, rows, size=n).astype(np.int32)
        if n and rng.random() < 0.125:      # OOB poison (clamp/drop policy)
            k = max(1, n // 8)
            pos = rng.choice(n, size=k, replace=False)
            bad = np.where(rng.random(k) < 0.5,
                           -rng.integers(1, rows + 2, size=k),
                           rows + rng.integers(0, rows + 2, size=k))
            s[pos] = bad.astype(np.int32)
        return s

    gathers = []
    for _ in range(int(rng.integers(2, 7))):
        name = f"G{int(rng.integers(0, n_gt))}"
        n = int(rng.choice((0, 33, 100, 256)))
        gathers.append((name, stream(tables[name].shape[0], n)))

    rmws = []
    for _ in range(int(rng.integers(2, 6))):
        name = f"R{int(rng.integers(0, n_rt))}"
        table = tables[name]
        n = int(rng.choice((7, 64, 200)))
        idx = stream(table.shape[0], n)
        if table.dtype == np.float32:
            vals = rng.normal(size=n).astype(np.float32)
        else:
            vals = rng.integers(0, 2 ** 10, size=n).astype(table.dtype)
        cond = (rng.random(n) < 0.7) if rng.random() < 0.4 else None
        rmws.append((name, idx, vals, cond))

    # independent compiled programs ride in the same window
    programs = []
    for k in range(int(rng.integers(1, 4))):
        c = generate_case(100_000 + seed * 11 + k)
        programs.append((c.pattern, c.env, min(c.n, 256)))

    return MixedFlushCase(name=f"mixed{seed}", seed=seed,
                          programs=programs, gathers=gathers, rmws=rmws,
                          tables=tables, table_ops=table_ops)


def mutate_case(case: MixedFlushCase, kind: str, seed: int = 0
                ) -> MixedFlushCase:
    """Inject a *known* order-dependent hazard into a legal mixed case.

    The returned case is a structural copy of ``case`` with one extra
    submission that makes the window order-dependent — the
    true-positive corpus for ``repro_torch.analysis.hazards`` (every mutant
    must be flagged; the unmutated corpus must stay ERROR-clean).

      mixed_op        : second RMW op on an existing R table (DX010)
      gather_rmw_race : gather against an R table that is also RMW-
                        updated in the window (DX011)
    """
    rng = np.random.default_rng(0xBAD + seed)
    tables = dict(case.tables)
    table_ops = dict(case.table_ops)
    rmws = list(case.rmws)
    # mutate the first R table that actually receives an RMW this window
    name = next((n for n, _, _, _ in rmws), None)
    if name is None:        # no RMW traffic: conjure a table + baseline op
        name = "Rmut"
        tables[name] = rng.integers(0, 2 ** 12, size=(64,)).astype(np.int32)
        table_ops[name] = "ADD"
        rmws.append((name, rng.integers(0, 64, size=16).astype(np.int32),
                     rng.integers(0, 8, size=16).astype(np.int32), None))
    table = tables[name]
    idx = rng.integers(0, table.shape[0], size=16).astype(np.int32)
    if kind == "gather_rmw_race":
        injected = ("gather", name, idx)
    elif kind == "mixed_op":
        pool = (("MIN", "MAX") if table.dtype == np.float32
                else isa.RMW_OPS)
        new_op = next(o for o in pool if o != table_ops[name])
        vals = (rng.normal(size=16).astype(np.float32)
                if table.dtype == np.float32
                else rng.integers(0, 8, size=16).astype(table.dtype))
        injected = ("rmw", name, idx, vals, new_op)
    else:
        raise ValueError(f"unknown mutation kind {kind!r}")
    return dataclasses.replace(
        case, name=f"{case.name}+{kind}", rmws=rmws, tables=tables,
        table_ops=table_ops, injected=injected)


def generate_traffic_case(seed: int):
    """Seeded open-loop traffic trace (``serve.traffic.Trace``) for the
    differential corpus: arrival-timed mixed submissions whose burst
    shape, tenant skew, event mix, and tick density vary across seeds —
    the adaptive flush controller gets exercised across burst/idle phase
    boundaries, and high-``p_tick`` seeds produce deadline pops on an
    already-drained queue (the empty-window flush). About a third of the
    seeds enable paged-KV serving events (``kv_decode`` page-table
    gathers + ``kv_append`` unique-slot RMWs against a shared pool, with
    pool wrap-around) so the serving shape rides the same differential
    corpus. Deterministic per seed; ``serve.traffic.replay_trace``
    replays it (the JAX package's ``harness.check_traffic_parity`` holds
    each ticket's NumPy expectation).
    """
    from repro_torch.serve.traffic import TrafficConfig, generate_trace
    rng = np.random.default_rng(0xD1_07AF + seed)
    cfg = TrafficConfig(
        seed=seed,
        n_events=int(rng.choice((120, 200, 320))),
        n_tenants=int(rng.choice((40, 400, 2000))),
        zipf_tenant=float(rng.choice((1.05, 1.2, 1.5))),
        idle_gap_us=float(rng.choice((200.0, 500.0, 1000.0))),
        burst_factor=float(rng.choice((20.0, 100.0, 400.0))),
        mean_phase_events=int(rng.choice((25, 60, 120))),
        p_rmw=float(rng.choice((0.2, 0.35))),
        p_program=float(rng.choice((0.0, 0.05))),
        p_tick=float(rng.choice((0.01, 0.08))),
        p_cond=float(rng.choice((0.0, 0.3))),
    )
    # KV knobs drawn AFTER the base config so pre-existing seeds keep the
    # exact burst/mix shapes the corpus property tests characterize
    p_kv = float(rng.choice((0.0, 0.0, 0.3)))
    if p_kv > 0:
        cfg = dataclasses.replace(
            cfg, p_kv_decode=p_kv / 2.0, p_kv_append=p_kv / 2.0,
            kv_pages=int(rng.choice((12, 48))))  # small wraps the pool
    return generate_trace(cfg)

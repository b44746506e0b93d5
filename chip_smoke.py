#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # one card

Phases, each ending in ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without its result line:

  1. device   the card's name and power limit (nvidia-smi); the CUDA
              kernels are built from src/repro_torch/kernels/csrc.
  2. kernels  each CUDA kernel against its plain PyTorch version on the
              card: the gather at D in {8, 128} x {f32, bf16, i32} with a
              partial last block; the scatter-RMW for all seven ops on i32
              and ADD/MIN/MAX/MUL on f32 and bf16, with negative,
              past-the-end and duplicate-after-clamp destinations, and on
              a plan whose rows repeat (runs across tiles) with a real
              value on every lane; then, bit for bit against a loop over
              the plan's lanes (``sequential_rmw``), the plans that split
              the RMW kernel's lanes between its two passes: a hot block
              of 5,000 lanes, a block with every row updated, real updates
              at offset 0 beside padding (-0.0 and NaN results), long
              identity runs on rows 0 and n-1, and 12-byte rows.
  3. main     the Indirect Access path through the port's entry points
              (``run_tiled`` on ``Engine(tile_size=16384, use_kernel=True)``)
              on a row table A of 2^20 x 128 f32 with 2^21 lookups from a
              seeded zipf(1.05) stream and a uniform one, for two patterns:
              GATHER out[i] = A[B[i]] and RMW A[B[i]] += V[i]. Each result is
              held against the port's plain engine (use_kernel=False) on the
              card and against direct torch indexing; both kernels' launch
              counters, set to 0 just before, must have advanced. Then each
              pattern's end-to-end time, warm, kernel and plain path
              alternating over E2E_RUNS runs each.
  4. timing   each kernel at the main path's shapes (one engine tile of the
              zipf stream), warm, with CUDA events over many launches,
              beside its byte bound, its plain version and a library call;
              the RMW kernel, its plain version and ``index_add_`` each
              update their own copy of the table in place, made before
              the timed loop. The RMW kernel and ``index_add_`` are also
              timed on one engine tile of the uniform stream (own line).
  5. profile  torch.profiler over four engine tiles (zipf) of each pattern
              on the kernel path: the device's busy share, the top kernels
              by device time, each of the port's own kernels by name, and
              the top operators by host time.
  6. window   the multi-tenant path: ``Scheduler`` on
              ``Engine(tile_size=16384, use_kernel=True)``, 8 tenants each
              submitting a gather of 2^18 zipf(1.05) lookups of A, an RMW
              ADD of 2^18 rows into a second 2^20 x 128 f32 table G and
              one launch of the phase-3 gather program over an engine tile
              (A shared by all: one batched group). Checked: gathers
              against A[idx], G against index_add_ on a copy, each program
              against the same program run alone, exactly two gather
              launches (the batched ILD, the fused gather) and one RMW
              launch, the executed plan the explained one, and a repeat
              window hitting the plan cache. Then the warm window time
              against the same submissions flushed one per window and
              plain index_select / index_add_, the cross-tenant
              coalescing factor, and under torch.profiler the device's
              busy share and each scheduler stage's host time and device
              span.
  7. pipeline 16 such windows (integer-valued RMW values, so every sum is
              exact) with a small matmul per window as compute, threading
              G through the windows: DecoupledLoop(depth=2) and
              run_sequential agree bit for bit and with the closed form;
              both wall times.
  8. apps     the five Table-1 apps through ``repro_torch.apps`` at the
              sizes of ``APP_SIZES``: SpMV on a NAS-CG-shaped matrix (2^21
              rows, ~16 nonzeros each) and on 16-wide feature blocks
              (2^20 rows), BFS on a GAP-urand-shaped graph (2^22 vertices,
              degree 16), a hash-join probe (2^22 probes of a 2^20-bucket
              table), an embedding bag (2^21 x 128 f32 table, 4096 bags x
              64 lanes, 8 tenants) and paged-KV decode (8 KV heads x 128,
              page size 16, 64 sequences, 8 tenants, the pool grown
              mid-flight). Each runs pipelined on an AccessService over
              Engine(tile_size=16384, use_kernel=True), sequentially on
              the same, and eagerly on the plain path: every result bit for
              bit its host oracle (scipy's CSR product, a level-by-level
              NumPy BFS, ``ht_key[probe & (m-1)] == probe``, the apps' own
              loop oracles); spmv_block, embedding_bag and kv_serve must
              launch the gather kernel and the last two the RMW kernel.
              Then each path's warm wall time and, under torch.profiler,
              one pipelined run's busy share, host syncs and top kernels.

Tolerances: gathers, integer RMWs and the apps (exact by construction) bit
for bit; float MIN/MAX bit for bit (NaN where NaN); the RMW aliasing
plans bit for bit, floats included; float
ADD/MUL RMW rtol=1e-5/atol=1e-6 in phase 2 (f32; bf16 one ulp, rtol=1e-2)
and rtol=1e-4/atol=1e-2 on the main path and the window, whose
duplicate-heavy zipf rows are summed with atomics in another order.

The last two lines are the kernel table (JSON; ``launches`` counts phase
3's run, ``scheduler_launches`` phase 6's window, ``app_launches`` each
app's checked pipelined run in phase 8) and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
ROWS, WIDTH = 2 ** 20, 128
TILE = 16384
LOOKUPS = 2 ** 21                  # per pattern and stream: 128 engine tiles
ITERS = 50                         # timed launches per kernel
E2E_RUNS = 3                       # warm end-to-end runs per path


def log(msg: str) -> None:
    print(msg, flush=True)


def sync():
    import torch
    torch.cuda.synchronize()


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` warm calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want) -> float:
    import torch
    g, w = got.double(), want.double()
    both_nan = torch.isnan(g) & torch.isnan(w)
    diff = torch.where(both_nan, 0.0, (g - w).abs())
    return float(torch.nan_to_num(diff, nan=float("inf")).max()) \
        if diff.numel() else 0.0


def assert_match(what, got, want, *, rtol=0.0, atol=0.0):
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if rtol == 0 and atol == 0 and not got.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bit for bit "
                                 f"(max abs err {max_abs_err(got, want)})")
        return
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               equal_nan=True, msg=lambda m: f"{what}: {m}")


# --- phase 1 ---------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    for source, text in logs.items():
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                   text)})
        spills = sorted(set(re.findall(
            r"[1-9]\d* bytes (?:spill \w+|stack frame)", text)))
        log(f"[ptxas {source}] registers per thread {regs}; "
            f"spills: {spills or 'none'}")
    log(f"phase 1 device: built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    return smi


# --- phase 2 ---------------------------------------------------------------

def phase_kernels(dev):
    import torch
    from repro_torch.core import coalesce, make_row_table_plan
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.gather import ops as gops
    from repro_torch.kernels.scatter_rmw import ops as sops
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    gen = torch.Generator(device=dev).manual_seed(2)
    n, br, lanes = 777, 128, 32                 # 777 rows: partial block
    checked = 0
    for d in (8, 128):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            table = (torch.randn(n, d, generator=gen, device=dev)
                     * 1000).to(dtype)
            idx = torch.randint(0, n, (600,), generator=gen, device=dev,
                                dtype=torch.int32)
            idx[:4] = torch.tensor([n - 1, n - 1, 0, n - 2], device=dev)
            plan = make_row_table_plan(coalesce(idx)[0], n_rows=896,
                                       block_rows=br, lanes=lanes)
            before = gk.launches
            got = gops.row_table_gather(table, plan)
            sync()
            assert gk.launches == before + 1
            assert_match(f"gather d={d} {dtype}", got,
                         gops.row_table_gather(table, plan, use_ref=True))
            checked += 1
    cases = [(op, torch.int32) for op in
             ("ADD", "MIN", "MAX", "AND", "OR", "XOR", "MUL")]
    cases += [(op, dt) for dt in (torch.float32, torch.bfloat16)
              for op in ("ADD", "MIN", "MAX", "MUL")]
    cases += [("MIN", "u32"), ("MAX", "u32")]
    for op, dtype in cases:
        unsigned = dtype == "u32"
        dt = torch.int32 if unsigned else dtype
        d = 64
        if dt == torch.int32:
            table = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, d),
                                  generator=gen, device=dev, dtype=dt)
        else:
            table = torch.randn(n, d, generator=gen, device=dev).to(dt)
            table[3, :4] = float("nan")
        uniq = torch.unique(torch.randint(0, n, (400,), generator=gen,
                                          device=dev, dtype=torch.int32))
        # negative, past-the-end and (after clamping) duplicate dests
        dest = torch.cat([torch.tensor([-9, -1, 0], device=dev,
                                       dtype=torch.int32),
                          uniq[uniq > 0],
                          torch.tensor([n, n + 5, n + 100], device=dev,
                                       dtype=torch.int32)])
        dest = torch.unique(dest)
        if dt == torch.int32:
            vals = torch.randint(-2 ** 31, 2 ** 31 - 1, (dest.shape[0], d),
                                 generator=gen, device=dev, dtype=dt)
        else:
            vals = torch.randn(dest.shape[0], d, generator=gen,
                               device=dev).to(dt)
            if op == "MUL":
                vals = 1 + vals / 64
            vals[5, :2] = float("nan")
        before = sk.launches
        got = sops.row_table_rmw(table, dest, vals, op=op, block_rows=br,
                                 lanes=lanes, unsigned=unsigned)
        sync()
        assert sk.launches == before + 1
        want = sops.row_table_rmw(table, dest, vals, op=op, block_rows=br,
                                  lanes=lanes, unsigned=unsigned,
                                  use_ref=True)
        tol = {}
        if dt.is_floating_point and op in ("ADD", "MUL"):
            tol = (dict(rtol=1e-5, atol=1e-6) if dt == torch.float32
                   else dict(rtol=1e-2, atol=1e-2))
        assert_match(f"rmw {op} {dtype}", got, want, **tol)
        checked += 1
    checked += check_rmw_duplicates(dev, gen)
    checked += check_rmw_aliasing(dev)
    sync()
    log(f"phase 2 kernels: {checked} kernel-vs-plain checks passed")


def check_rmw_duplicates(dev, gen) -> int:
    """The RMW kernel on a plan of a sorted stream with repeated rows
    (runs longer than a tile, across tile boundaries) and a real value on
    every lane, padded ones included: every update of a row must land, none
    lost to a stale read, so these results (ops whose order does not
    change them) are bit for bit the plain version's."""
    import torch
    from repro_torch.core import make_row_table_plan
    from repro_torch.kernels.scatter_rmw import ref as sref
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    n, br, lanes, d = 896, 128, 32, 16
    idx = torch.randint(0, n, (500,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx = torch.sort(torch.cat([idx, torch.full((70,), 130, device=dev,
                                                dtype=torch.int32)]))[0]
    plan = make_row_table_plan(idx, n_rows=n, block_rows=br, lanes=lanes)
    args = (plan.tile_block, plan.tile_first.to(torch.int32), plan.offsets)
    checked = 0
    for op, dt in (("ADD", torch.int32), ("MUL", torch.int32),
                   ("XOR", torch.int32), ("MIN", torch.float32)):
        if dt == torch.int32:
            table = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, d), generator=gen,
                                  device=dev, dtype=dt)
            vals = torch.randint(-2 ** 31, 2 ** 31 - 1,
                                 (plan.num_tiles * lanes, d), generator=gen,
                                 device=dev, dtype=dt)
        else:
            table = torch.randn(n, d, generator=gen, device=dev)
            vals = torch.randn(plan.num_tiles * lanes, d, generator=gen,
                               device=dev)
        kw = dict(block_rows=br, lanes=lanes, op=op)
        got = sk.row_table_rmw_(table.clone(), *args, vals, **kw)
        assert_match(f"rmw {op} {dt} duplicates in plan order", got,
                     sref.row_table_rmw_ref_(table.clone(), *args, vals,
                                             **kw))
        checked += 1
    return checked


RMW_ALIAS_ROWS, RMW_ALIAS_BLOCK = 4096, 1024


def rmw_aliasing_cases():
    """Streams on which lanes alias rows the way the RMW kernel's two
    passes split them (single-writer lanes applied by the streaming pass,
    the rest in plan order by the chains pass), on a table of 4096 rows in
    blocks of 1024. Yields ``(name, d, lanes, dest, vals)``: ``vals`` (f32,
    one row per destination) means plan the sorted, unique ``dest`` as
    bulk_rmw does (``plan_updates``: identity on padded, clamped and
    empty-segment lanes); ``vals=None`` means a plan of the sorted
    ``dest`` with duplicates and a real value on every lane, padded ones
    included."""
    import numpy as np
    rng = np.random.default_rng(12)
    n = RMW_ALIAS_ROWS
    # a hot block: 5,000 lanes on block 1 (> 4,096: two compaction windows
    # of the chains pass, many stream warps), single rows and 20 hot ones
    hot = np.sort(np.concatenate([
        1024 + rng.integers(0, 1024, size=3000),
        1024 + rng.integers(0, 20, size=2000) * 37,
        rng.integers(0, n, size=300)]))
    yield "hot block", 64, 256, hot, None
    # every row of block 2 updated once, plus a few rows elsewhere
    full = np.unique(np.concatenate([np.arange(2048, 3072),
                                     rng.integers(0, n, size=100)]))
    yield "full block", 128, 256, full, \
        rng.normal(size=(len(full), 128)).astype(np.float32)
    # real updates at offset 0: block 1 has padding lanes after its lanes
    # (-0.0 + -0.0, then the +0.0 identity), block 2 is exactly one full
    # tile (-0.0 stays -0.0); NaN in the table and in the values
    sz = np.unique(np.concatenate([[1024, 1030, 1031, 1500],
                                   2048 + np.arange(256), [3072, 3073]]))
    v = rng.normal(size=(len(sz), 64)).astype(np.float32)
    v[np.isin(sz, [1024, 2048, 3072])] = -0.0
    v[np.searchsorted(sz, 1500), :3] = np.nan
    yield "offset 0 with signed zeros and NaN", 64, 256, sz, v
    # long identity runs on rows 0 and n-1 across tile boundaries: 700
    # negative destinations before a real update of row 0, 900 past the
    # end (empty segments) after one of row n-1, all clamped
    ends = np.concatenate([-np.arange(700, 0, -1), [0],
                           np.unique(rng.integers(1, n - 1, size=200)),
                           [n - 1], np.full(900, n)])
    yield "identity runs on rows 0 and n-1", 64, 64, ends, \
        rng.normal(size=(len(ends), 64)).astype(np.float32)
    # rows that are not a whole number of 16-byte words: the scalar path
    yield "12-byte rows, hot block", 3, 256, hot, None
    yield "12-byte rows, identity runs", 3, 64, ends, \
        rng.normal(size=(len(ends), 3)).astype(np.float32)


def sequential_rmw(table, tile_block, offsets, vals, *, block_rows, op):
    """The function the RMW kernel computes, as a loop over the plan's
    lanes in order, on the tensors' device: each lane updates its row with
    one elementwise op (the kernel's float rounding; MIN/MAX propagate the
    table's NaN first, then the value's). Rows outside the table drop."""
    import torch
    rows = (tile_block[:, None].long() * block_rows + offsets).reshape(-1)
    n = table.shape[0]

    def fold(a, b):
        if op == "ADD":
            return a + b
        if op == "MUL":
            return a * b
        if op == "XOR":
            return a ^ b
        pick = b < a if op == "MIN" else b > a
        if a.is_floating_point():
            pick = ~torch.isnan(a) & (torch.isnan(b) | pick)
        return torch.where(pick, b, a)

    for lane, row in enumerate(rows.tolist()):
        if 0 <= row < n:
            table[row] = fold(table[row], vals[lane])
    return table


# (op, dtype) pairs of the aliasing checks
RMW_ALIAS_OPS = (("ADD", "f32"), ("MIN", "f32"), ("MUL", "f32"),
                 ("ADD", "bf16"), ("XOR", "i32"))


def bits(t):
    """A tensor's bits, for comparing floats bit for bit (-0.0, NaN)."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def rmw_aliasing_inputs(dev, name, d, lanes, dest, vals, op, dt):
    """The RMW kernel's arguments for one case of ``rmw_aliasing_cases``,
    one op and one dtype: ``(table, tile_block, tile_first, offsets,
    vals), kw``."""
    import numpy as np
    import torch
    from repro_torch.core import make_row_table_plan
    from repro_torch.kernels.scatter_rmw.ops import plan_updates
    rng = np.random.default_rng(len(name) * 1000 + d)
    n, br = RMW_ALIAS_ROWS, RMW_ALIAS_BLOCK

    def typed(x, values=True):
        x = torch.as_tensor(x, device=dev)
        if dt == "i32":
            return (x * 1e6).nan_to_num().to(torch.int32)
        if op == "MUL" and values:
            x = 1 + x / 64
        return x.to(torch.bfloat16 if dt == "bf16" else torch.float32)

    t = rng.normal(size=(n, d)).astype(np.float32)
    t[[0, 1024, 2048, 3072, n - 1]] = -0.0
    t[1030, :2] = np.nan
    dest_t = torch.as_tensor(np.asarray(dest, dtype=np.int32), device=dev)
    kw = dict(block_rows=br, lanes=lanes, op=op)
    if vals is None:
        plan = make_row_table_plan(dest_t, n_rows=n, block_rows=br,
                                   lanes=lanes)
        v = typed(rng.normal(size=(plan.num_tiles * lanes, d))
                  .astype(np.float32))
    else:
        plan, v = plan_updates(n, dest_t, typed(vals), op=op, block_rows=br,
                               lanes=lanes)
    first = plan.tile_first.to(torch.int32)
    return (typed(t, values=False), plan.tile_block, first, plan.offsets,
            v), kw


def check_rmw_aliasing(dev) -> int:
    """The RMW kernel against ``sequential_rmw`` on ``rmw_aliasing_cases``,
    bit for bit (``bits``), for f32 ADD/MIN/MUL, bf16 ADD and i32 XOR."""
    import torch
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    checked = 0
    for case in rmw_aliasing_cases():
        for op, dt in RMW_ALIAS_OPS:
            (table, tile_block, tile_first, offsets, vals), kw = \
                rmw_aliasing_inputs(dev, *case, op, dt)
            got = sk.row_table_rmw_(table.clone(), tile_block, tile_first,
                                    offsets, vals, **kw)
            want = sequential_rmw(table.clone(), tile_block, offsets, vals,
                                  block_rows=kw["block_rows"], op=op)
            if not torch.equal(bits(got), bits(want)):
                bad = (bits(got) != bits(want)).any(1).nonzero()[:5]
                raise AssertionError(
                    f"rmw aliasing {case[0]} {op} {dt}: not bit for bit, "
                    f"first rows {bad.reshape(-1).tolist()}")
            checked += 1
    return checked


# --- phase 3 ---------------------------------------------------------------

def make_data(dev, lookups: int, seed: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    streams = {
        "zipf": (rng.zipf(1.05, size=lookups) % ROWS).astype(np.int32),
        "uniform": rng.integers(0, ROWS, size=lookups).astype(np.int32),
    }
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(ROWS, WIDTH, generator=gen, device=dev)
    V = torch.randn(lookups, WIDTH, generator=gen, device=dev)
    B = {k: torch.from_numpy(v).to(dev) for k, v in streams.items()}
    return A, V, B


def patterns():
    from repro_torch.core import Access, Load, Pattern, Var
    gather = Pattern([Access("ST", "out", Var("i"),
                             value=Load("A", Load("B", Var("i"))),
                             dtype="f32")], name="gather")
    rmw = Pattern([Access("RMW", "A", Load("B", Var("i")),
                          value=Load("V", Var("i")), op="ADD",
                          dtype="f32")], name="rmw")
    return gather, rmw


def run_pattern(engine, pattern, env, n):
    from repro_torch.core import run_tiled
    sync()
    t0 = time.perf_counter()
    out_env, _, _ = run_tiled(engine, pattern, env, n=n)
    sync()
    return out_env, (time.perf_counter() - t0) * 1e3


def phase_main(dev, seed: int):
    import torch
    from repro_torch.core import Engine
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    lookups = LOOKUPS
    A, V, B = make_data(dev, lookups, seed)
    gather, rmw = patterns()
    fast = Engine(tile_size=TILE, use_kernel=True, device=dev)
    plain = Engine(tile_size=TILE, use_kernel=False, device=dev)
    out0 = torch.zeros(lookups, WIDTH, device=dev)
    cold = {}
    results = {}
    gk.launches = 0
    sk.launches = 0
    for name, b in B.items():
        env = {"A": A, "B": b, "out": out0}
        results[("gather", name)], cold[("gather", name, "kernel")] = \
            run_pattern(fast, gather, env, lookups)
        env = {"A": A, "B": b, "V": V}
        results[("rmw", name)], cold[("rmw", name, "kernel")] = \
            run_pattern(fast, rmw, env, lookups)
    launches = {"row_table_gather": gk.launches, "row_table_rmw": sk.launches}
    log(f"phase 3 main path: launches {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    for name, b in B.items():
        idx = b.long()
        out_p, cold[("gather", name, "plain")] = run_pattern(
            plain, gather, {"A": A, "B": b, "out": out0}, lookups)
        got = results[("gather", name)]["out"]
        assert_match(f"main gather {name} vs plain engine", got,
                     out_p["out"])
        assert_match(f"main gather {name} vs A[B]", got, A[idx])
        del out_p
        rmw_p, cold[("rmw", name, "plain")] = run_pattern(
            plain, rmw, {"A": A, "B": b, "V": V}, lookups)
        got = results[("rmw", name)]["A"]
        assert_match(f"main rmw {name} vs plain engine", got, rmw_p["A"],
                     rtol=1e-4, atol=1e-2)
        assert_match(f"main rmw {name} vs index_add", got,
                     A.clone().index_add_(0, idx, V), rtol=1e-4, atol=1e-2)
        assert torch.isfinite(got).all()
        del rmw_p
        results.pop(("gather", name))
        results.pop(("rmw", name))
        torch.cuda.empty_cache()
    for (pat, name, path), ms in sorted(cold.items()):
        log(f"e2e {pat:6s} {name:7s} {path:6s} first run {ms:10.3f} ms "
            f"({lookups} lookups, {lookups // TILE} engine tiles)")
    phase_e2e(fast, plain, A, V, B, out0, lookups)
    sync()
    return A, V, B, launches


def phase_e2e(fast, plain, A, V, B, out0, lookups: int):
    """Warm end-to-end time of each pattern and stream: kernel and plain
    path alternating, E2E_RUNS runs each (both paths ran once above)."""
    import statistics
    gather, rmw = patterns()
    for name, b in B.items():
        for pat, env in ((gather, {"A": A, "B": b, "out": out0}),
                         (rmw, {"A": A, "B": b, "V": V})):
            times = {"kernel": [], "plain": []}
            for _ in range(E2E_RUNS):
                for path, engine in (("kernel", fast), ("plain", plain)):
                    times[path].append(run_pattern(engine, pat, env,
                                                   lookups)[1])
            for path, ms in times.items():
                log(f"e2e {pat.name:6s} {name:7s} {path:6s} warm median "
                    f"{statistics.median(ms):10.3f} ms, runs "
                    f"{' '.join(f'{t:.3f}' for t in ms)} "
                    f"({lookups} lookups, {lookups // TILE} engine tiles)")


# --- phase 4 ---------------------------------------------------------------

def rmw_tile(A, V, idx, br: int = 1024, lanes: int = 256):
    """The RMW kernel's inputs for one engine tile ``idx`` of ADD updates
    from ``V``, as bulk_rmw hands them on (coalesced, planned with the bulk
    ops' defaults), with the bytes its function must move: each lane's
    value row and the plan read once, each touched table row read and
    written once. Returns ``(args, kw, bytes, touched rows)``."""
    import torch
    from repro_torch.core.bulk_ops import coalesce_updates
    from repro_torch.kernels.scatter_rmw.ops import plan_updates
    idx = idx.clamp(0, ROWS - 1)
    seg_dest, packed = coalesce_updates(idx, V[:idx.shape[0]], n=ROWS,
                                        op="ADD")
    plan, vals = plan_updates(ROWS, seg_dest, packed, op="ADD",
                              block_rows=br, lanes=lanes)
    rows = (plan.tile_block[:, None].long() * br + plan.offsets).reshape(-1)
    touched = torch.unique(rows).numel()
    row_bytes = A.shape[1] * A.element_size()
    nbytes = (vals.numel() * vals.element_size() + 2 * touched * row_bytes
              + plan.offsets.numel() * 4 + 2 * plan.tile_block.numel() * 4)
    args = (plan.tile_block, plan.tile_first.to(torch.int32), plan.offsets,
            vals)
    return args, dict(block_rows=br, lanes=lanes, op="ADD"), nbytes, touched


def phase_timing(dev, A, V, B, launches):
    import torch
    from repro_torch.core import coalesce, make_row_table_plan
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.gather import ref as gref
    from repro_torch.kernels.scatter_rmw import ref as sref
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk

    # one engine tile of the zipf stream, as bulk_gather / bulk_rmw see it
    idx = B["zipf"][:TILE].clamp(0, ROWS - 1)
    br, lanes = 1024, 256                       # bulk ops' defaults
    esize = A.element_size()
    row_bytes = WIDTH * esize
    table_rows = []

    uniq = coalesce(idx)[0]
    plan = make_row_table_plan(uniq, n_rows=ROWS, block_rows=br, lanes=lanes)
    rows = (plan.tile_block[:, None].long() * br + plan.offsets).reshape(-1)
    g_args = (A, plan.tile_block, plan.offsets)
    g_kw = dict(block_rows=br, lanes=lanes)
    g_out = gk.row_table_gather(*g_args, **g_kw)
    g_err = max_abs_err(g_out, gref.row_table_gather_ref(*g_args, **g_kw))
    assert g_err == 0.0, g_err
    g_bytes = (g_out.numel() * esize + torch.unique(rows).numel() * row_bytes
               + plan.tile_block.numel() * 4 + plan.offsets.numel() * 4)
    valid_bytes = int(plan.valid.sum()) * row_bytes
    table_rows.append(dict(
        name="row_table_gather", route="cuda",
        source="src/repro_torch/kernels/csrc/row_table_gather.cu",
        replaces="src/repro/kernels/gather/gather.py:67",
        launches=launches["row_table_gather"], max_abs_err=g_err,
        ms=time_ms(lambda: gk.row_table_gather(*g_args, **g_kw), ITERS),
        plain_ms=time_ms(lambda: gref.row_table_gather_ref(*g_args, **g_kw),
                         ITERS),
        bound_ms=g_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=time_ms(lambda: torch.index_select(A, 0, rows), ITERS)))
    log(f"gather plan: {plan.num_tiles} tiles x {lanes} lanes -> "
        f"{g_out.numel() * esize / 1e6:.1f} MB written per launch, "
        f"{valid_bytes / 1e6:.1f} MB of it valid rows")

    # the RMW kernel's inputs for the same tile, as bulk_rmw hands them on
    r_args, r_kw, r_bytes, touched = rmw_tile(A, V, idx)
    vals = r_args[-1]
    rrows = (r_args[0][:, None].long() * br + r_args[2]).reshape(-1)
    # each updates its own copy of A in place, as the kernel does: no
    # table copy inside any timed call
    work, plain_work, lib_work = A.clone(), A.clone(), A.clone()
    r_out = sk.row_table_rmw_(work, *r_args, **r_kw)
    r_err = max_abs_err(r_out, sref.row_table_rmw_ref_(plain_work, *r_args,
                                                       **r_kw))
    assert r_err <= 1e-4, r_err
    table_rows.append(dict(
        name="row_table_rmw", route="cuda",
        source="src/repro_torch/kernels/csrc/row_table_rmw.cu",
        replaces="src/repro/kernels/scatter_rmw/scatter_rmw.py:82",
        launches=launches["row_table_rmw"], max_abs_err=r_err,
        ms=time_ms(lambda: sk.row_table_rmw_(work, *r_args, **r_kw), ITERS),
        plain_ms=time_ms(lambda: sref.row_table_rmw_ref_(
            plain_work, *r_args, **r_kw), ITERS),
        bound_ms=r_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=time_ms(lambda: lib_work.index_add_(0, rrows, vals),
                           ITERS)))
    log(f"rmw plan: {r_args[0].numel()} tiles, {touched} rows touched, "
        f"{vals.numel() * esize / 1e6:.1f} MB of lane values read per "
        f"launch")
    # the same on one engine tile of the uniform stream (the zipf row above
    # is the kernel table's)
    u_args, u_kw, u_bytes, u_touched = rmw_tile(A, V, B["uniform"][:TILE])
    u_rows = (u_args[0][:, None].long() * br + u_args[2]).reshape(-1)
    u_ms = time_ms(lambda: sk.row_table_rmw_(work, *u_args, **u_kw), ITERS)
    u_lib = time_ms(lambda: lib_work.index_add_(0, u_rows, u_args[-1]),
                    ITERS)
    log(f"kernel row_table_rmw uniform tile: {u_ms:.4f} ms (bound "
        f"{u_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes), library "
        f"{u_lib:.4f} ms, {u_touched} rows touched")
    for r in table_rows:
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}"
            f" ms by {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, {r['launches']} launches on "
            f"the main path, max abs err {r['max_abs_err']}")
    sync()
    return table_rows


# --- phase 5 ---------------------------------------------------------------

# the __global__ functions of kernels/csrc, as the profiler names them
PORT_KERNELS = ("row_table_gather_kernel", "rmw_stream", "rmw_chains")


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or \
        getattr(event, "self_cuda_time_total", 0.0)


def phase_profile(dev, A, V, B, tiles: int = 4):
    """Where the main path's time goes: ``torch.profiler`` over ``tiles``
    engine tiles of each pattern on the kernel path (zipf stream, warm).
    Prints wall time under the profiler, the device's busy share (the sum
    of kernel time over wall time), the top kernels by device time and the
    top operators by host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Engine
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    fast = Engine(tile_size=TILE, use_kernel=True, device=dev)
    n = tiles * TILE
    b = B["zipf"][:n]
    gather, rmw = patterns()
    envs = {"gather": (gather, {"A": A, "B": b,
                                "out": torch.zeros(n, WIDTH, device=dev)}),
            "rmw": (rmw, {"A": A, "B": b, "V": V[:n]})}
    for name, (pat, env) in envs.items():
        run_pattern(fast, pat, env, n)
        with profile(activities=acts) as prof:
            _, ms = run_pattern(fast, pat, env, n)
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        ops = [e for e in events if e.device_type != DeviceType.CUDA]
        busy = sum(_device_us(e) for e in kernels) / 1e3
        log(f"profile {name}: {ms:.3f} ms wall under the profiler for "
            f"{tiles} engine tiles; device kernels {busy:.3f} ms "
            f"({100 * busy / ms:.1f}% busy)")
        for what, rows, key in (
                ("kernel", kernels, _device_us),
                ("host", ops, lambda e: e.self_cpu_time_total)):
            for e in sorted(rows, key=key, reverse=True)[:10]:
                log(f"  top {what:6s} {key(e) / 1e3:9.3f} ms  "
                    f"x{e.count:<5d} {e.key[:70]}")
        for e in kernels:           # each of the port's own kernels
            if any(k in e.key for k in PORT_KERNELS):
                log(f"  port kernel {_device_us(e) / 1e3:9.3f} ms  "
                    f"x{e.count:<5d} {e.key[:90]}")
    sync()


# --- phase 6 ---------------------------------------------------------------

TENANTS = 8                        # the survey's "shared across cores"
TENANT_LOOKUPS = 2 ** 18           # per tenant and stream: 2^21 per window
WINDOW_RUNS = 3                    # warm window runs per path
PIPE_WINDOWS = 16                  # windows of the decoupled-loop run


def window_data(dev, seed: int, *, integer_values: bool = False):
    """Each tenant's seeded streams: a zipf(1.05) % ROWS gather stream,
    another for its RMW ADD into G, its RMW values, and a second table G
    of ROWS x WIDTH f32. With ``integer_values`` G and the values are
    small integers held as floats, so every sum is exact in any order."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 100)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)

    def stream():
        return torch.from_numpy((rng.zipf(1.05, size=TENANT_LOOKUPS) % ROWS)
                                .astype(np.int32)).to(dev)

    if integer_values:
        G = torch.randint(-8, 9, (ROWS, WIDTH), generator=gen,
                          device=dev).float()
        vals = [torch.randint(-4, 5, (TENANT_LOOKUPS, WIDTH), generator=gen,
                              device=dev).float() for _ in range(TENANTS)]
    else:
        G = torch.randn(ROWS, WIDTH, generator=gen, device=dev)
        vals = [torch.randn(TENANT_LOOKUPS, WIDTH, generator=gen, device=dev)
                for _ in range(TENANTS)]
    gathers = [stream() for _ in range(TENANTS)]
    return {"G": G, "gather": gathers, "rmw": [stream()
                                               for _ in range(TENANTS)],
            "vals": vals,
            # each tenant's program runs the phase-3 gather pattern over
            # one engine tile of its own gather stream
            "prog_B": [g[:TILE] for g in gathers]}


class Window:
    """Submits one multi-tenant window: per tenant a gather of A, an RMW
    ADD into G and one launch of the gather program over an engine tile,
    its A shared by every tenant."""

    def __init__(self, dev, A, data):
        import torch
        from repro_torch.core import compile_pattern
        self.A, self.data = A, data
        self.prog, _ = compile_pattern(patterns()[0], tile_size=TILE)
        self.iota = torch.arange(TILE, dtype=torch.int32, device=dev)
        self.outs = [torch.zeros(TILE, WIDTH, device=dev)
                     for _ in range(TENANTS)]
        self.regs = {"tile_base": 0, "N": TILE, "tile_end": TILE}

    def env(self, t):
        return {"A": self.A, "B": self.data["prog_B"][t],
                "out": self.outs[t], "__iota__": self.iota}

    def submissions(self, G):
        """(kind, tenant, submit(target) -> ticket) in submission order."""
        d = self.data
        for t in range(TENANTS):
            name = f"core{t}"
            yield "program", t, lambda s, t=t, name=name: s.submit(
                self.prog, self.env(t), self.regs, tenant=name)
            yield "gather", t, lambda s, t=t, name=name: s.submit_gather(
                self.A, d["gather"][t], tenant=name)
            yield "rmw", t, lambda s, t=t, name=name: s.submit_rmw(
                G, d["rmw"][t], d["vals"][t], op="ADD", tenant=name)

    def submit(self, target, G):
        tickets = {"program": [], "gather": [], "rmw": []}
        for kind, _, fn in self.submissions(G):
            tickets[kind].append(fn(target))
        return tickets


def redeem(sched, tickets):
    return {k: [sched.result(t) for t in v] for k, v in tickets.items()}


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def check_window(win, G, results, report, ex, launches):
    """The window's results: gathers bit for bit against A[idx], G within
    the main path's tolerance of index_add_ on a copy, each program bit
    for bit against the same program run alone on the port's Engine, the
    kernels' launches on the fused and batched nodes, and the executed
    plan the one explain() showed."""
    import torch
    from repro_torch.core import Engine
    d, A = win.data, win.A
    if report.plan is not ex.plan:
        raise AssertionError("the executed plan is not the explained one")
    (group,) = report.plan.fused("program_group")
    (fused_gather,) = report.plan.fused("gather")
    (fused_rmw,) = report.plan.fused("rmw")
    if (group.backend, len(group.members), fused_gather.backend,
            fused_rmw.backend) != ("vmap", TENANTS, "bulk", "bulk") or \
            "A" not in group.shared or not report.groups[0].vmapped:
        raise AssertionError(f"unexpected plan:\n{ex.render()}")
    # one gather launch for the batched ILD of all lanes (A shared), one
    # for the fused gather; one RMW launch for the fused RMW
    want = {"row_table_gather": 2, "row_table_rmw": 1}
    if launches != want:
        raise AssertionError(f"window launches {launches}, want {want}")
    for t, got in enumerate(results["gather"]):
        assert_match(f"window gather core{t} vs A[idx]", got,
                     A[d["gather"][t].long()])
    want_g = G.clone().index_add_(0, torch.cat(d["rmw"]).long(),
                                  torch.cat(d["vals"]))
    for t, got in enumerate(results["rmw"]):
        assert_match(f"window rmw core{t} vs index_add_", got, want_g,
                     rtol=1e-4, atol=1e-2)
        assert torch.isfinite(got).all()
    alone = Engine(tile_size=TILE, use_kernel=True, device=A.device)
    for t, (env, spd) in enumerate(results["program"]):
        want_env, want_spd = alone.run(win.prog, win.env(t), win.regs)
        for name in want_env:
            assert_match(f"window program core{t} env[{name}] vs alone",
                         env[name], want_env[name])
        for name in want_spd:
            assert_match(f"window program core{t} spd[{name}] vs alone",
                         spd[name], want_spd[name])
        assert_match(f"window program core{t} out vs A[B]", env["out"],
                     A[d["prog_B"][t].long()])


def phase_window(dev, A, seed: int):
    """The multi-tenant window through the port's Scheduler on
    Engine(tile_size=16384, use_kernel=True): checked, then timed against
    the same submissions flushed one per window and against plain
    index_select / index_add_ over the same streams, then profiled."""
    import statistics
    from repro_torch.core import Engine, Scheduler
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    data = window_data(dev, seed)
    G = data["G"]
    win = Window(dev, A, data)
    sched = Scheduler(engine=Engine(tile_size=TILE, use_kernel=True,
                                    device=dev))
    tickets = win.submit(sched, G)
    ex = sched.explain()
    log("phase 6 window plan:\n" + ex.render())
    gk.launches = 0
    sk.launches = 0
    report, first_ms = timed(sched.flush)
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    results = redeem(sched, tickets)
    check_window(win, G, results, report, ex, launches)
    gain, per, fused = next(iter(report.gather_coalescing.values()))
    del results
    # a repeat window replays the cached plan
    tickets = win.submit(sched, G)
    report2 = sched.flush()
    redeem(sched, tickets)
    if not report2.plan.cache_hit or sched.stats["plan_cache_hits"] != 1:
        raise AssertionError(f"repeat window missed the plan cache: "
                             f"{sched.stats}")

    def fused_window():
        tk = win.submit(sched, G)
        sched.flush()
        return redeem(sched, tk)

    def one_per_window():
        out = []
        for _, _, fn in win.submissions(G):
            t = fn(sched)
            sched.flush()
            out.append(sched.result(t))
        return out

    def plain():
        d = data
        out = [A.index_select(0, s) for s in d["gather"]]
        g = G.clone()
        for s, v in zip(d["rmw"], d["vals"]):
            g.index_add_(0, s, v)
        out += [A.index_select(0, b) for b in d["prog_B"]]
        return out, g

    times = {"fused window": [], "one per window": [], "plain torch": []}
    for _ in range(WINDOW_RUNS):
        for name, fn in (("fused window", fused_window),
                         ("one per window", one_per_window),
                         ("plain torch", plain)):
            times[name].append(timed(fn)[1])
    log(f"window: {TENANTS} tenants, {TENANTS * TENANT_LOOKUPS} gather "
        f"lookups + {TENANTS * TENANT_LOOKUPS} RMW rows + {TENANTS} "
        f"programs of {TILE} lookups; launches {launches}; first run "
        f"{first_ms:.3f} ms")
    for name, ms in times.items():
        log(f"window {name:15s} warm median {statistics.median(ms):10.3f} "
            f"ms, runs {' '.join(f'{t:.3f}' for t in ms)}")
    log(f"window cross-tenant gather coalescing: gain {gain:.4f} "
        f"({per} distinct rows summed per tenant, {fused} in the fused "
        f"stream)")
    phase_window_profile(dev, fused_window)
    sync()
    return win, launches


# the scheduler's stages, each timed as a span on the host under the
# profiler (the span holds the host while the stage waits for the device)
WINDOW_SPANS = (("submit", ("submit", "submit_gather", "submit_rmw")),
                ("lower", ("_lower_pending",)),
                ("emit programs", ("_execute_group",)),
                ("emit gathers", ("_execute_gathers",)),
                ("emit rmws", ("_execute_rmws",)))


def log_window_stages(events):
    """Per scheduler stage (``WINDOW_SPANS``): its host time, the host
    synchronisations and kernel launches inside it, and on the device
    the span from its first kernel to its last and the kernel time in
    that span. A span shows twice in the trace: on the host, and as a
    device-side annotation."""
    from torch.autograd import DeviceType

    def on_card(e):
        return e.device_type == DeviceType.CUDA

    def inside(e, spans):
        return any(s.time_range.start <= e.time_range.start
                   and e.time_range.end <= s.time_range.end for s in spans)

    def ms(evs):
        return sum(e.time_range.elapsed_us() for e in evs) / 1e3

    spans = [e for e in events if e.name.startswith("window::")]
    kernels = [e for e in events if on_card(e) and e not in spans]
    syncs = [e for e in events if not on_card(e) and e.name in (
        "cudaStreamSynchronize", "cudaEventSynchronize",
        "cudaDeviceSynchronize")]
    launches = [e for e in events if e.name == "cudaLaunchKernel"]
    for label, _ in WINDOW_SPANS:
        name = f"window::{label}"
        host = [e for e in spans if e.name == name and not on_card(e)]
        card = [e for e in spans if e.name == name and on_card(e)]
        in_syncs = [e for e in syncs if inside(e, host)]
        log(f"  stage {label:14s} host {ms(host):8.3f} ms (x{len(host)}; "
            f"{len(in_syncs)} syncs {ms(in_syncs):.3f} ms, "
            f"{sum(inside(e, host) for e in launches)} launches); device "
            f"span {ms(card):8.3f} ms, kernels "
            f"{ms([e for e in kernels if inside(e, card)]):8.3f} ms")
    outside = [e for e in syncs if not inside(e, [e for e in spans
                                                  if not on_card(e)])]
    log(f"  stage {'(outside)':14s} {len(outside)} syncs "
        f"{ms(outside):.3f} ms; all kernels {ms(kernels):.3f} ms")


def phase_window_profile(dev, fused_window):
    """The device's busy share over one warm fused window, and the host
    time of each scheduler stage in it (``WINDOW_SPANS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.scheduler import Scheduler
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    saved = {}
    for label, attrs in WINDOW_SPANS:
        for attr in attrs:
            saved[attr] = fn = getattr(Scheduler, attr)

            def span(self, *a, _fn=fn, _label=label, **kw):
                with record_function(f"window::{_label}"):
                    return _fn(self, *a, **kw)
            setattr(Scheduler, attr, span)
    try:
        with profile(activities=acts) as prof:
            _, ms = timed(fused_window)
    finally:
        for attr, fn in saved.items():
            setattr(Scheduler, attr, fn)
    log_window_stages(prof.events())
    events = [e for e in prof.key_averages()
              if not e.key.startswith("window::")]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    log(f"profile window: {ms:.3f} ms wall under the profiler; device "
        f"kernels {busy:.3f} ms ({100 * busy / ms:.1f}% busy)")
    for what, rows, key in (("kernel", kernels, _device_us),
                            ("host", ops, lambda e: e.self_cpu_time_total)):
        for e in sorted(rows, key=key, reverse=True)[:8]:
            log(f"  top {what:6s} {key(e) / 1e3:9.3f} ms  "
                f"x{e.count:<5d} {e.key[:70]}")
    for e in kernels:
        if any(k in e.key for k in PORT_KERNELS):
            log(f"  port kernel {_device_us(e) / 1e3:9.3f} ms  "
                f"x{e.count:<5d} {e.key[:90]}")


# --- phase 7 ---------------------------------------------------------------

def phase_pipeline(dev, A, seed: int):
    """PIPE_WINDOWS multi-tenant windows with a small matmul per window as
    compute, threading G through the windows' RMWs: DecoupledLoop(depth=2)
    and run_sequential must agree bit for bit (the RMW values are
    integers held as floats, so every sum is exact in any order), and G
    must equal its start plus PIPE_WINDOWS times the window's updates."""
    import torch
    from repro_torch.core import Engine, Scheduler
    from repro_torch.pipeline import DecoupledLoop, run_sequential
    data = window_data(dev, seed + 1, integer_values=True)
    win = Window(dev, A, data)
    W = torch.randn(WIDTH, WIDTH,
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)

    def access(loop, k, state):
        return win.submit(loop, state[0])

    def compute(k, state, res):
        t = k % TENANTS
        x = res["gather"][t][:1024] @ W
        y = res["program"][t][0]["out"][:1024] @ W
        return res["rmw"][0], state[1] + x.sum(0) + y.sum(0)

    def run(kind):
        sched = Scheduler(engine=Engine(tile_size=TILE, use_kernel=True,
                                        device=dev))
        state = (data["G"], torch.zeros(WIDTH, device=dev))
        if kind == "decoupled":
            return DecoupledLoop(sched, depth=2).run(
                state, PIPE_WINDOWS, access, compute)
        return run_sequential(sched, state, PIPE_WINDOWS, access, compute)

    out, times = {}, {"sequential": [], "decoupled": []}
    for kind in ("sequential", "decoupled", "decoupled", "sequential"):
        out[kind], ms = timed(lambda: run(kind))
        times[kind].append(ms)
    for name in ("G", "acc"):
        i = ("G", "acc").index(name)
        if not torch.equal(out["decoupled"][i], out["sequential"][i]):
            raise AssertionError(f"pipeline {name}: DecoupledLoop and "
                                 "run_sequential differ")
    step = torch.zeros_like(data["G"]).index_add_(
        0, torch.cat(data["rmw"]).long(), torch.cat(data["vals"]))
    assert_match("pipeline G vs start + windows x index_add_",
                 out["decoupled"][0], data["G"] + PIPE_WINDOWS * step)
    for name, ms in times.items():
        log(f"pipeline {name:10s} {PIPE_WINDOWS} windows: "
            f"{' '.join(f'{t:.3f}' for t in ms)} ms "
            f"({sum(ms) / len(ms) / PIPE_WINDOWS:.3f} ms per window)")
    sync()


# --- phase 8 ---------------------------------------------------------------

APP_RUNS = 3                       # warm runs per path, after one warm-up
# each app at a size its users run; the sizes are phase 8's only knobs,
# so a rehearsal on the CPU shrinks them (widths d, page_size, lanes are
# part of each configuration and never cut)
APP_SIZES = {
    "spmv_cg": dict(n=2 ** 21, avg_nnz=16, d=1, iters=6),
    "spmv_block": dict(n=2 ** 20, avg_nnz=16, d=16, iters=6),
    "bfs": dict(n=2 ** 22, avg_deg=16, levels=8),
    "hashjoin": dict(n_build=2 ** 19, log2_buckets=20, n_probe=2 ** 22,
                     tile=TILE, tiles_per_window=4),
    "embedding_bag": dict(vocab=2 ** 21, d=128, n_bags=4096, lanes=64,
                          n_tenants=8, n_steps=4),
    "kv_serve": dict(d=1024, page_size=16, prefix_pages=64, max_prompt=512,
                     n_seqs=64, n_tenants=8, n_steps=16, growth_pages=64),
}
# each configuration's public source, and what was cut from it
APP_SOURCES = {
    "spmv_cg": ("NAS CG's random sparse matrix (~16 nonzeros per row)",
                None),
    "spmv_block": ("PageRank over 16-wide feature blocks (the reference "
                   "app's d > 1 case)", None),
    "bfs": ("GAP urand: uniform random graph, degree 16",
            "vertices 2^27 -> 2^22 (the run's time)"),
    "hashjoin": ("build side bounded by make_problem's 2^20 key universe",
                 None),
    "embedding_bag": ("MLPerf DLRM-DCNv2: embedding width 128, multi-hot "
                      "bags", None),
    "kv_serve": ("Llama-3-8B config.json: 8 KV heads x head_dim 128 (one "
                 "layer); vLLM's default block size 16", None),
}
# the apps whose tables are 2-D row tables, and the kernels they must reach
APP_KERNELS = {"spmv_block": ("row_table_gather",),
               "embedding_bag": ("row_table_gather", "row_table_rmw"),
               "kv_serve": ("row_table_gather", "row_table_rmw")}


def oracle_spmv(prob, iters: int):
    """The SpMV recurrence with scipy's CSR product per iteration (the
    same exact integer arithmetic as ``spmv.reference``, vectorised)."""
    import numpy as np
    import scipy.sparse
    a = scipy.sparse.csr_matrix((prob.val, prob.col, prob.indptr),
                                shape=(prob.n, prob.n))
    x = prob.x0.copy()
    for _ in range(iters):
        y = (a @ x).astype(x.dtype)
        if np.issubdtype(x.dtype, np.floating):
            x = np.mod(np.floor(y * (1.0 / 32)), 256.0).astype(x.dtype)
        else:
            x = (y >> 5) & 255
    return x


def oracle_bfs(g, src: int, levels: int):
    """``bfs.reference``'s semantics level by level: every frontier
    vertex's adjacency range at once (``np.repeat`` over the ranges), the
    neighbours not yet reached labelled with the level."""
    import numpy as np
    inf = np.int32(2 ** 30)
    dist = np.full(g.n, inf, np.int32)
    dist[src] = 0
    frontier = np.asarray([src], np.int64)
    for level in range(levels):
        lo = g.indptr[frontier].astype(np.int64)
        lens = g.indptr[frontier + 1] - lo
        starts = np.repeat(lo - np.cumsum(lens) + lens, lens)
        nbrs = g.adj[starts + np.arange(starts.shape[0])]
        dist[nbrs[dist[nbrs] == inf]] = level + 1
        frontier = np.flatnonzero(dist == level + 1)
    return dist


def oracle_hashjoin(prob):
    """``hashjoin.reference`` in one vector step:
    ``ht_key[probe & (m-1)] == probe``."""
    import numpy as np
    b = prob.probe & (prob.n_buckets - 1)
    hit = prob.ht_key[b] == prob.probe
    return (np.where(hit, prob.ht_val[b], -1).astype(np.int32),
            int(hit.sum()))


class AppCase:
    """One phase-8 configuration: its problem, its runner
    (``run(prob, mode=, service=, device=)``), its host oracle, and the
    ``stats_out`` its runs fill (kv_serve's)."""

    def __init__(self, name: str, make: Callable, run: Callable,
                 oracle: Callable, stats: dict | None = None):
        self.name, self.make, self.run, self.oracle = name, make, run, oracle
        self.stats = {} if stats is None else stats


def app_cases(seed: int):
    """Phase 8's six configurations at ``APP_SIZES``."""
    import dataclasses
    from repro_torch.apps import bfs, embedding_bag, hashjoin, kv_serve, spmv
    s = APP_SIZES
    cases = []
    for name in ("spmv_cg", "spmv_block"):
        c = s[name]
        cases.append(AppCase(
            name, lambda c=c: spmv.make_problem(seed, n=c["n"],
                                                avg_nnz=c["avg_nnz"],
                                                d=c["d"]),
            lambda prob, c=c, **kw: spmv.run(prob, c["iters"], **kw),
            lambda prob, c=c: oracle_spmv(prob, c["iters"])))
    c = s["bfs"]
    cases.append(AppCase(
        "bfs", lambda: bfs.make_graph(seed, n=c["n"], avg_deg=c["avg_deg"]),
        lambda g, **kw: bfs.run(g, 0, levels=c["levels"], **kw),
        lambda g: oracle_bfs(g, 0, c["levels"])))
    h = s["hashjoin"]
    cases.append(AppCase(
        "hashjoin", lambda: hashjoin.make_problem(
            seed, n_build=h["n_build"], n_probe=h["n_probe"],
            log2_buckets=h["log2_buckets"]),
        lambda prob, **kw: hashjoin.run(
            prob, tile_size=h["tile"],
            tiles_per_window=h["tiles_per_window"], **kw),
        oracle_hashjoin))
    e = s["embedding_bag"]
    cases.append(AppCase(
        "embedding_bag", lambda: embedding_bag.make_problem(
            seed, vocab=e["vocab"], d=e["d"], n_bags=e["n_bags"],
            lanes=e["lanes"], n_steps=e["n_steps"],
            n_tenants=e["n_tenants"]),
        embedding_bag.run, embedding_bag.reference))
    k, stats = s["kv_serve"], {}
    cases.append(AppCase(
        "kv_serve", lambda: dataclasses.replace(kv_serve.make_problem(
            seed, n_seqs=k["n_seqs"], n_tenants=k["n_tenants"],
            page_size=k["page_size"], d=k["d"],
            prefix_pages=k["prefix_pages"], max_prompt=k["max_prompt"],
            max_steps=k["n_steps"]), growth_pages=k["growth_pages"]),
        lambda prob, **kw: kv_serve.run(prob, k["n_steps"],
                                        stats_out=stats, **kw),
        lambda prob: kv_serve.reference(prob, k["n_steps"]), stats))
    return cases


def bitwise_equal(got, want) -> bool:
    """Results of the apps (arrays, ints, tuples of them), bit for bit."""
    import numpy as np
    if isinstance(want, tuple):
        return isinstance(got, tuple) and len(got) == len(want) and all(
            bitwise_equal(g, w) for g, w in zip(got, want))
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype
                and got.shape == want.shape
                and got.tobytes() == want.tobytes())
    return type(got) is type(want) and got == want


def check_kv_growth(case, prob, svc):
    """kv_serve's run grew the pool after prefill (mid-flight, between
    decode windows), and the service's last access window fused one
    gather across more than one tenant (the shared prefix pages)."""
    from repro_torch.apps import kv_serve
    st = kv_serve._PageState(prob)
    kv_serve._prefill_streams(prob, st)
    decode_start = st.cap_pages + prob.init_slack_pages
    stats = case.stats
    if stats["growths"] <= 0 or stats["final_pages"] <= decode_start:
        raise AssertionError(f"kv_serve: the pool did not grow mid-flight "
                             f"({stats}, {decode_start} pages at decode "
                             f"start)")
    spans = [len({m.ticket.tenant for m in g.members})
             for g in svc.last_report.plan.fused("gather")]
    if not any(n > 1 for n in spans):
        raise AssertionError(f"kv_serve: no fused gather spans more than "
                             f"one tenant (tenants per node {spans})")
    return (f"growths {stats['growths']}, pages {decode_start} at decode "
            f"start -> {stats['final_pages']}, t_cap {stats['t_cap']}, "
            f"tenants per fused gather {spans}")


SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")


def profile_app(dev, name, fn):
    """One run of ``fn`` under torch.profiler, logged: wall ms, the
    device's busy share (the time of kernels and copies on the device over
    wall time), the host synchronisations and kernel launches, the copies
    between host and device, the peak of allocated device memory, and the
    top five device activities by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=acts) as prof:
        _, ms = timed(fn)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else 0.0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    syncs = sum(e.count for e in events if e.key in SYNC_CALLS)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    copies = {}
    for way in ("HtoD", "DtoH"):
        evs = [e for e in kernels if e.key.startswith(f"Memcpy {way}")]
        copies[way] = (sum(e.count for e in evs),
                       sum(_device_us(e) for e in evs) / 1e3)
    log(f"profile app {name}: {ms:.3f} ms wall under the profiler, device "
        f"{busy:.3f} ms ({100 * busy / ms:.1f}% busy), {syncs} host syncs, "
        f"{launches} kernel launches; copies host->device "
        f"{copies['HtoD'][0]} ({copies['HtoD'][1]:.3f} ms), device->host "
        f"{copies['DtoH'][0]} ({copies['DtoH'][1]:.3f} ms); peak "
        f"{peak:.2f} GiB allocated")
    for e in sorted(kernels, key=_device_us, reverse=True)[:5]:
        log(f"  top kernel {_device_us(e) / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:70]}")


def phase_apps(dev, seed: int):
    """The five Table-1 apps (six configurations) through the port's entry
    points at full size. Each runs pipelined on an ``AccessService`` over
    ``Scheduler(engine=Engine(tile_size=16384, use_kernel=True))`` and
    must equal its host oracle bit for bit; the 2-D apps must launch the
    kernels of ``APP_KERNELS`` (counts set to 0 just before that run). The
    same must hold for the sequential kernel path and the eager plain
    path. Then the warm wall time of the three paths (median of
    APP_RUNS after the checked run), and one pipelined run under the
    profiler. Returns each kernel's launches per app."""
    import statistics
    import torch
    from repro_torch.core import Engine, Scheduler
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import AccessService
    app_launches = {"row_table_gather": {}, "row_table_rmw": {}}
    for case in app_cases(seed):
        name = case.name
        source, cut = APP_SOURCES[name]
        log(f"app {name}: {APP_SIZES[name]}; source: {source}")
        if cut:
            log(f"reduced {name}: {cut}")
        t0 = time.perf_counter()
        prob = case.make()
        t1 = time.perf_counter()
        want = case.oracle(prob)
        t2 = time.perf_counter()
        log(f"app {name}: problem made in {t1 - t0:.1f} s, host oracle in "
            f"{t2 - t1:.1f} s")
        svc = AccessService(Scheduler(engine=Engine(
            tile_size=TILE, use_kernel=True, device=dev)), auto_flush=0)
        paths = {
            "pipelined": lambda: case.run(prob, mode="pipelined",
                                          service=svc),
            "sequential": lambda: case.run(prob, mode="sequential",
                                           service=svc),
            "eager plain": lambda: case.run(prob, mode="eager", device=dev),
        }
        gk.launches = 0
        sk.launches = 0
        got, first = timed(paths["pipelined"])
        launches = {"row_table_gather": gk.launches,
                    "row_table_rmw": sk.launches}
        if not bitwise_equal(got, want):
            raise AssertionError(f"app {name} pipelined: not bit for bit "
                                 "the host oracle")
        missing = [k for k in APP_KERNELS.get(name, ()) if launches[k] < 1]
        if missing:
            raise AssertionError(f"app {name}: {missing} never launched on "
                                 f"the kernel path ({launches})")
        for kernel, n in launches.items():
            app_launches[kernel][name] = n
        extra = check_kv_growth(case, prob, svc) if name == "kv_serve" \
            else ""
        times = {"pipelined": [], "sequential": [], "eager plain": []}
        firsts = {"pipelined": first}
        for path in ("sequential", "eager plain"):
            got, firsts[path] = timed(paths[path])
            if not bitwise_equal(got, want):
                raise AssertionError(f"app {name} {path}: not bit for bit "
                                     "the host oracle")
        del got
        for _ in range(APP_RUNS):
            for path, fn in paths.items():
                times[path].append(timed(fn)[1])
        log(f"app {name}: pipelined launches {launches}; bit for bit the "
            f"host oracle on every path{'; ' + extra if extra else ''}")
        for path, ms in times.items():
            log(f"app {name:13s} {path:11s} warm median "
                f"{statistics.median(ms):10.3f} ms, runs "
                f"{' '.join(f'{t:.3f}' for t in ms)}; first "
                f"{firsts[path]:.3f} ms")
        profile_app(dev, name, paths["pipelined"])
        del prob, want, svc, paths
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    sync()
    return app_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi = phase_device()
    phase_kernels(dev)
    A, V, B, launches = phase_main(dev, args.seed)
    table = phase_timing(dev, A, V, B, launches)
    phase_profile(dev, A, V, B)
    del V, B
    _, window_launches = phase_window(dev, A, args.seed)
    for row in table:
        row["scheduler_launches"] = window_launches[row["name"]]
    phase_pipeline(dev, A, args.seed)
    del A
    app_launches = phase_apps(dev, args.seed)
    for row in table:
        row["app_launches"] = app_launches[row["name"]]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

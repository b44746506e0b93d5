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
  9. serving  (a) the committed bench trace of
              benchmarks/traffic_bench.py (``BENCH_TRACE``, copied) has
              its pinned digest; (b) a KV-heavy open-loop trace
              (``KV_TRACE``: 2000 events, a 4096-page x 16-slot pool of
              1024-wide rows on the card) replayed by ``replay_trace``
              through an AccessService over Engine(use_kernel=True) with
              the adaptive controller and wall-measured flushes, its
              hottest tenant capped at 2 pending: every gather bit for bit
              the NumPy table, every RMW bit for bit a lane-by-lane NumPy
              replay of its window's ``FlushReport.order``, every program
              against the plain engine, every rejection raising, and the
              kernels' launches those the windows' plans call for; (c)
              ``KvPoolServer`` (``KVPOOL``: page 16, d 1024, a 1024-token
              shared prefix, 64 sequences over 8 tenants, prompts of 1-512
              tokens, 16 decode batches, the pool grown mid-flight):
              histories and the final pool bit for bit a NumPy model,
              launches exactly ``KVPOOL_LAUNCHES``.
 10. serve    every model family of the port at published widths
              (``SERVE_MODELS``). Through ``ServeLoop``: Qwen3-0.6B whole, 8
              requests of 128-512 tokens in 2 waves of 4, 32 new tokens;
              DBRX's widths at 2 of its 40 layers, 2 requests of 128-256
              tokens, 16 new, the MoE dropless; RWKV-6 1.6B's widths at 4
              of its 24 layers (its eager WKV loop's time), as Qwen3;
              Jamba 1.5 Large's widths at one superblock cut to 2
              layers (a Mamba layer, an attention layer with the dropless
              MoE), as DBRX. Through the model API (``serve_encdec``):
              seamless-m4t-large-v2 whole, 4 sequences over 512 seeded
              stub source frames, 64-token prompts, a cache of 128, prefill
              then 32 greedy decode steps. In f32 each prefill's logits
              against ``forward`` over exactly the prefilled tokens, and
              every prefill and decode logit row against ``forward`` over
              the whole wave's tokens (and source), each within
              SERVE_ATOL + SERVE_RTOL |x| (``check_serve``), greedy tokens
              against its argmax where the top-2 margin exceeds twice
              the bound, and dx100_embed_fwd=True against False (bit for
              bit without experts; the MoE combine sums with atomics, so
              within the tolerance). RWKV-6's rows against the wave are
              held in a float64 run of the same weights instead, and
              only measured in f32 (``check_dtype``). Then in the
              config's bf16 (whose logits must fail the f32 tolerance)
              the warm prefill ms per wave, decode ms per step, tokens/s
              and peak memory, the first wave under the profiler, and
              the launches and busy share per decode step. The model
              path launches neither kernel.
 11. sharded  ``ShardedEngine(mesh=m, use_kernel=True)`` for m in {1, 2,
              4, 8} logical shards on this one card, over phase 3's A and
              2^21-lookup zipf and uniform streams: gathers bit for bit
              the single-device ``bulk_gather``, ADD (integer-valued f32)
              and MIN (an i32 table) bit for bit ``bulk_rmw`` and
              ``index_add`` / ``scatter_reduce``, ``ShardStats`` against
              NumPy owner counts, B1/B2 launches exactly one per call;
              per m the warm times against the single-device ops and the
              library calls, host syncs and launches per call, peak
              memory. Then spmv_block and embedding_bag at phase 8's sizes
              through AccessService over a 4-shard kernel engine (bit for
              bit their oracles), and the port's parity harness on the
              card: ``check_sharded_parity`` at every mesh size and
              ``check_pattern_parity`` on the 12 conformance patterns.
 12. train    (a) Qwen3-0.6B whole (28 layers, published widths, bf16
              params and AdamW moments) trained through
              ``repro_torch.launch.train.main`` on 8 x 512 zipf(1.3)
              tokens of ``SyntheticTokenPipeline``: run A 6 steps with
              checkpoints at 3 and 6, run B resumed from a copy of A's
              step_3; both step_6 manifests must carry the same per-leaf
              SHA-256 prefixes, every loss finite and B's metrics A's.
              Both runs under ``torch.use_deterministic_algorithms``
              (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA initialises;
              ops without a deterministic CUDA implementation named), the
              checkpoints in a temp dir under build/ removed after. (b)
              one f32 step of Qwen3-0.6B whole at 1 x 128 against the
              same step in float64 (on the card; a MoE model's on the
              CPU) from the same weights: the
              loss, every clipped gradient leaf and the global norm
              (``check_train_step``). (c) the same check for one reduced
              step of qwen2-vl, dbrx, jamba (attention period 2), rwkv6
              and seamless-m4t at 2 x 32; the MoE models again with the
              expert-parallel path over a (1, n_experts) logical mesh,
              which must also equal EP off. (d) the bf16 step of (a),
              warm, in the default mode: median ms of 3, tokens/s, peak
              memory, launches and busy share of one profiled step, the
              step's FLOPs and bytes counted by
              ``roofline.count_step`` against 6 N D and the H100 bounds.
              B1/B2 launches over the phase must be 0.
 13. process  ``ShardedEngine`` over a ``ProcessMesh``: one spawned
              process per rank (``distributed.spawn.run_ranks``), each
              holding only its slice of phase 11's tables on its card, the
              exchange over torch.distributed: an nccl group over every
              visible card (world 1 on a one-card machine), then gloo
              worlds 2 and 4 on card 0 side by side (``run_groups``; so
              in phases 14 and 16), each rank its own CUDA context,
              the buckets staged through pinned host memory. The ranks
              reuse phase 1's kernel build. Gathers (zipf and uniform),
              integer-valued f32 ADD and i32 MIN bit for bit: each rank's
              block or slice against A[idx] / ``index_add`` /
              ``scatter_reduce`` on the whole table, and the whole put
              back together by ``gather_blocks``; ``ShardStats`` against
              NumPy owner counts; one B1 or one B2 launch per rank per
              call. Then per group the warm median of 3 (slowest rank;
              the gloo groups time one warm call) per call beside phase
              11's logical time at that mesh size,
              and each rank's peak memory. A rank that raises, dies or
              hangs (collectives time out after 120 s, a group after
              300 s) fails the phase.
 14. service  the Scheduler, AccessService and the apps over a
              ``ProcessMesh``, SPMD, in phase 13's groups: every rank
              lowers the same window (one agreement per window), submits
              its slices of the row-sharded tables and runs B1/B2 on them.
              (a) Phase 6's window (integer-valued G and values), A and G
              row-sharded, the gather programs over the whole A split
              across the ranks: bit for bit on every rank (gathers whole
              against A[idx], G's slice against ``index_add_`` on the
              whole G, programs against A[B]), B1 2 and B2 1 per rank (the
              sharded gather node, the batched group's ILD; the sharded
              RMW node). (b) Phase 8's six configurations pipelined through
              ``AccessService(mesh=ProcessMesh, use_kernel=True)``: each
              rank's result has the digest of the host oracle's (bit for
              bit), and per rank B1 once per sharded gather node and B2
              once per sharded RMW node of the 2-D apps in which the rank
              serves rows (``ShardStats.received``), the 1-D apps none. The gloo groups keep every size and cut depth
              (``PS_GLOO_CUTS``, printed as ``reduced`` lines). Per group:
              the slowest rank's times (the window's warm run; the apps'
              checked run) beside phase 8's pipelined and
              phase 11's 4-shard times, collectives and agreements per
              window, B1/B2 per rank, peak memory per rank.
 15. serving  ``replay_trace`` and ``KvPoolServer`` over a ``ProcessMesh``
              in phase 13's groups, through ``AccessService(mesh=
              ProcessMesh, use_kernel=True)``. (a) Phase 9b's trace with
              the adaptive controller on a ``VirtualClock`` and
              wall-measured flushes (each window's duration agreed: the
              slowest rank's), the hottest tenant capped at 2 pending:
              each rank cuts every table, the 256 MiB pool included, to
              its rows on its card; every rank's window log equal; every
              ticket checked on every rank as in phase 9b (gathers whole,
              RMWs the rank's rows). (b) Phase 9c's KV pool: each rank
              holds its rows of the pool, re-cut at every growth; every
              history bit for bit the NumPy model's on every rank, each
              rank's final slice the model pool's rows, the growths the
              model's. B1/B2 per rank those of the plans' sharded 2-D
              nodes in which it serves rows. The gloo groups cut depth
              (``PV_GLOO_CUTS``: the trace's events, the pool's decode
              steps). Per group: the
              slowest rank's replay wall, virtual p50/p99 and ms per
              ``decode_batch`` beside phases 9b and 9c, peak and pool
              bytes per rank, rows moved per growth, collectives and
              agreements per window, B1/B2 per rank.

 16. train    the train step over a process mesh
     mesh     (``launch.mesh.make_process_mesh``: one spawned process per
              mesh position, tensor-parallel over ``model``, data-parallel
              with ZeRO-1 over ``data``, each rank holding only its
              shards) in phase 13's groups, on a (1, 1) mesh at world 1,
              (1, 2) at world 2, (2, 2) at world 4. (a) Qwen3-0.6B whole
              (bf16, AdamW bf16 moments, remat "full") at 8 x 512 through
              ``Trainer(mesh=...)``: a checkpoint at step 2 saved from the
              mesh, step 2, a resume from the checkpoint on the same mesh
              whose step 2 equals it bit for bit (deterministic mode), then
              ``elastic_restore`` onto (2, 1) / (4, 1): every leaf the
              saved whole leaf's slice bit for bit, one finite step; each
              rank's params and moments hold their shards' bytes; the
              gloo groups run (a) and (d) at TM_GLOO_LAYERS of the 28
              layers, widths kept. (b) one f32 step of Qwen3-0.6B whole
              (every group) at 2 x 128 on the mesh against the one-device
              float64 step, both from AdamW's state at step 200, past
              the warmup (lr > 0), the reference computed once before the
              group spawns and read by each rank for its own blocks: loss,
              global norm and every updated leaf (params and moments)
              within the TRAIN_* bounds; each rank's device and host
              peaks over it. (c) dbrx reduced likewise: EP over (1, w)
              with w experts, and at world 4 experts over ``model`` on
              (2, 2) with a capacity factor that drops tokens. (d) the
              warm bf16 step of (a) (slowest rank, median of 3; the gloo
              groups time one) beside phase 12's, tokens/s, peak per
              rank, and one step with every collective counted, its
              payload bytes and its share of the step. (e) B1/B2
              launches 0 on every rank.
 17. train    the same in phase 13's groups for the encoder-decoder
     families and VLM families. (a) SeamlessM4T-large-v2
              whole (12 + 12 layers, 1.02 B parameters, bf16) at 8 x 512
              (256 source frames, 256 target tokens): steps, a checkpoint
              at step 2 from the mesh, a resume on the same mesh bit for
              bit, each rank's bytes its shards'. (b) one f32 step of it,
              whole in every group, at 2 x 128 against the one-device
              float64 step, computed once before the groups spawn and
              read by each rank for its own blocks (no rank holds a
              float64 model): loss and global norm within TRAIN_*_RTOL,
              every updated leaf within TRAIN_GRAD_REL_L2 of relative L2
              over the ranks' blocks. (c) Qwen2-VL-72B reduced likewise,
              with ``positions3`` given on a patch grid (cut on its batch
              dim at data 2), then one bf16 step at published widths and
              1 of 80 layers on the meshes whose reckoned peaks fit. (d)
              the warm bf16 step of (a) beside phase 16's, with its
              collectives. (e) B1/B2 launches 0 on every rank.
 18. train    the same in phase 13's groups for the hybrid and RWKV-6
     recurrent families: Mamba's selective scan on the rank's channels, the
              WKV recurrence on its heads. (a) RWKV-6-1.6B whole (24
              layers, 1.34 B parameters, bf16) at 8 x 32: steps, a
              checkpoint at step 2 from the mesh, a resume on the same
              mesh bit for bit, each rank's bytes its shards'; the gloo
              groups at 1 of 24 layers. (b) the one-device f32 step of
              RWKV-6 whole against float64, printed as measured; then one
              step of it at 8 of 24 layers in float64 on the mesh against
              the one-device float64 step, computed once before the
              groups: loss and global norm within 1e-9, every updated
              leaf (AdamW's f32 output) within one f32 ulp, 2^-23, of
              relative L2. (c1) Jamba reduced (an attention layer and 7 Mamba
              layers, MoE over 4 experts) in f32 likewise within 1e-5
              and 2e-5. (c2) one bf16 step of Jamba 1.5 Large at
              published widths and one superblock (an attention and a
              Mamba layer, dense FFNs) on (1, 1) and (1, 2). (d) the warm
              bf16 step of (a) beside phases 16's and 17's, with its
              collectives, and (c2)'s steps at (1, 1). (e) B1/B2 launches
              0 on every rank.

Tolerances: gathers, integer RMWs and the apps (exact by construction) bit
for bit; float MIN/MAX bit for bit (NaN where NaN); the RMW aliasing
plans bit for bit, floats included; float
ADD/MUL RMW rtol=1e-5/atol=1e-6 in phase 2 (f32; bf16 one ulp, rtol=1e-2)
and rtol=1e-4/atol=1e-2 on the main path and the window, whose
duplicate-heavy zipf rows are summed with atomics in another order; the
replay's float program regions rtol=1e-4/atol=1e-5 of the plain engine
(atomic float RMWs); the served f32 logits 2e-4 + 2e-4 |x| of the
forward over the same tokens (cuBLAS reduces in another order per
shape); RWKV-6, whose random weights amplify that rounding ~1e4-fold,
is held to the same bound in float64, and in f32 on its prefill rows
only; a train step in f32 on the card against float64: the
loss and the global norm within 1e-5 relative, every gradient leaf
within a relative L2 error of 1e-4.

The last two lines are the kernel table (JSON; ``launches`` counts phase
3's run, ``scheduler_launches`` phase 6's window, ``app_launches`` each
app's checked pipelined run in phase 8, ``traffic_launches`` phase 9b's
replay, ``kvpool_launches`` phase 9c's run, ``serve_launches`` phase 10,
``sharded_launches`` phase 11's checked calls per mesh size,
``train_launches`` phase 12, ``process_mesh_launches`` phase 13's
checked calls per group, summed over its ranks,
``process_service_launches`` phase 14's checked window and apps per
group, one count per rank, ``process_serving_launches`` phase 15's
replay and KV pool per group, one count per rank, ``train_mesh_launches``
phase 16, ``train_families_launches`` phase 17 and
``train_recurrent_launches`` phase 18 per group, one count per rank) and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
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

APP_RUNS = 1                       # warm runs per path, after one warm-up
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


def app_cases(seed: int, sizes: dict | None = None):
    """Phase 8's six configurations at ``APP_SIZES`` (or ``sizes``)."""
    import dataclasses
    from repro_torch.apps import bfs, embedding_bag, hashjoin, kv_serve, spmv
    s = APP_SIZES if sizes is None else sizes
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


#: phase 8's pipelined warm median (ms) and its oracle's digest per app,
#: and phase 11's one timed 4-shard run (ms): what phase 14 stands beside
APP_RESULTS: dict = {}
SHARD_APP_MS: dict = {}


def result_digest(x) -> str:
    """SHA-256 of an app's result (arrays by dtype, shape and bytes;
    tuples element by element; ints by value): equal digests are bit for
    bit equal results, so a rank's result is checked without shipping it
    to the parent."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    if isinstance(x, tuple):
        for v in x:
            h.update(result_digest(v).encode())
    elif isinstance(x, np.ndarray):
        h.update(f"{x.dtype.str}{x.shape}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    else:
        h.update(f"{type(x).__name__}:{x!r}".encode())
    return h.hexdigest()


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
    top five device activities by time. Returns (kernel launches, busy
    share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=acts) as prof:
        _, ms = timed(fn)
    t0 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else 0.0
    # count and device time per name from the raw events: key_averages()
    # builds the whole operator tree in Python, which takes minutes for a
    # prefill of ~150,000 launches; the names counted here do not nest
    count, device_us = {}, {}
    for e in prof.profiler.kineto_results.events():
        key = e.name()
        count[key] = count.get(key, 0) + 1
        if e.device_type() == DeviceType.CUDA:
            device_us[key] = device_us.get(key, 0.0) + e.duration_ns() / 1e3
    busy = sum(device_us.values()) / 1e3
    syncs = sum(count.get(k, 0) for k in SYNC_CALLS)
    launches = count.get("cudaLaunchKernel", 0)
    copies = {}
    for way in ("HtoD", "DtoH"):
        keys = [k for k in device_us if k.startswith(f"Memcpy {way}")]
        copies[way] = (sum(count[k] for k in keys),
                       sum(device_us[k] for k in keys) / 1e3)
    log(f"profile app {name}: {ms:.3f} ms wall under the profiler, device "
        f"{busy:.3f} ms ({100 * busy / ms:.1f}% busy), {syncs} host syncs, "
        f"{launches} kernel launches; copies host->device "
        f"{copies['HtoD'][0]} ({copies['HtoD'][1]:.3f} ms), device->host "
        f"{copies['DtoH'][0]} ({copies['DtoH'][1]:.3f} ms); peak "
        f"{peak:.2f} GiB allocated; the profiler's own processing "
        f"{time.perf_counter() - t0:.1f} s")
    for k in sorted(device_us, key=device_us.get, reverse=True)[:5]:
        log(f"  top kernel {device_us[k] / 1e3:9.3f} ms  "
            f"x{count[k]:<5d} {k[:70]}")
    return launches, busy / ms


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
    APP_RESULTS.clear()
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
        APP_RESULTS[name] = {"ms": statistics.median(times["pipelined"]),
                             "digest": result_digest(want)}
        profile_app(dev, name, paths["pipelined"])
        del prob, want, svc, paths
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    sync()
    return app_launches


# --- phase 9 ---------------------------------------------------------------

# benchmarks/traffic_bench.py's committed trace (copied: the smoke imports
# nothing of the JAX package or its benchmarks) and its pinned digest
BENCH_TRACE = dict(seed=2028, n_events=1200, n_tenants=2000,
                   idle_gap_us=150.0, burst_factor=25.0,
                   mean_phase_events=40, p_program=0.0, p_tick=0.005)
BENCH_DIGEST = "891dd37224095fcf"
# a KV-heavy open-loop trace: Llama-3-8B's KV width (8 KV heads x 128),
# vLLM's block size 16, a 4096-page pool (256 MiB f32) whose 64-page
# (1024-token) shared prefix is hot across 64 sequences
KV_TRACE = dict(seed=0, n_events=2000, p_kv_decode=0.15, p_kv_append=0.15,
                kv_seqs=64, kv_page_size=16, kv_pages=4096,
                kv_prefix_pages=64, kv_d=1024, p_program=0.04)
# the KvPoolServer run: the same widths, a 1024-token shared prefix, 64
# sequences over 8 tenants with prompts of 1-512 tokens, 16 decode steps
KVPOOL = dict(page_size=16, d=1024, growth_pages=64, prefix_tokens=1024,
              n_seqs=64, n_tenants=8, max_prompt=512, n_steps=16)
# the launches PERF.md predicts for the KvPoolServer run: an RMW window
# for the prefix, one per admitted sequence and one per decode step (the
# appends); one fused page-history gather per decode step
KVPOOL_LAUNCHES = {"row_table_gather": 16, "row_table_rmw": 1 + 64 + 16}

_NP_RMW = {"ADD": "add", "MUL": "multiply", "MIN": "minimum",
           "MAX": "maximum", "AND": "bitwise_and", "OR": "bitwise_or",
           "XOR": "bitwise_xor"}


def np_rmw(table, idx, vals, op, cond=None):
    """Lane-by-lane RMW in NumPy, in program order (the JAX package's
    ``harness._np_rmw``): out-of-range destinations drop, lanes whose
    ``cond`` is False are no-ops."""
    import numpy as np
    out = np.array(table)
    vals = vals.reshape((idx.shape[0],) + out.shape[1:]).astype(out.dtype)
    fn = getattr(np, _NP_RMW[op])
    for k in range(idx.shape[0]):
        a = int(idx[k])
        if 0 <= a < out.shape[0] and (cond is None or bool(cond[k])):
            out[a:a + 1] = fn(out[a:a + 1], vals[k:k + 1])
    return out


def reset_peak(dev):
    import torch
    if dev.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else 0.0


def card_free_gib(dev) -> float:
    """The card's free memory, over every process on it (0 on the CPU)."""
    import torch
    return torch.cuda.mem_get_info(dev)[0] / 2 ** 30 \
        if dev.type == "cuda" else 0.0


def empty_cache(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def kernel_service(dev, controller=None):
    from repro_torch.core import Engine, Scheduler
    from repro_torch.serve import AccessService
    return AccessService(Scheduler(engine=Engine(
        tile_size=TILE, use_kernel=True, device=dev)), auto_flush=0,
        controller=controller)


def expected_replay_launches(res, ids_2d):
    """The kernel launches the replay's own plans call for: B1 for every
    fused gather of a 2-D table that took the coalesced path, B2 for every
    fused RMW of one."""
    b1 = b2 = 0
    for _, rep in res.windows:
        b1 += sum(1 for n in rep.plan.fused("gather")
                  if n.table_id in ids_2d and n.backend != "eager"
                  and n.n_lanes)
        b2 += sum(1 for n in rep.plan.fused("rmw")
                  if n.table_id in ids_2d and n.n_lanes)
    return {"row_table_gather": b1, "row_table_rmw": b2}


def check_replay(dev, trace, host, svc, res, k0, rank_rows=None):
    """Every ticket of the replay: gathers bit for bit the submit-time
    NumPy table (OOB clamped); RMWs bit for bit a lane-by-lane NumPy
    replay of their window's ``FlushReport.order`` from the original
    table (the KV pool compared on the rows the window touched, every
    other row unchanged); programs against the same compiled program on
    the port's plain engine (integers bit for bit, floats within
    rtol=1e-4/atol=1e-5: their float RMWs sum with atomics); rejected
    tickets raise. Over a process mesh (``rank_rows``, the engine's) an
    RMW ticket is the rank's rows ``rank_rows(n)`` of its table, ``k0``
    the rank's rows of the original pool. Returns the number of tickets
    checked."""
    import numpy as np
    import torch
    from repro_torch.core import Engine, compile_pattern, interop
    from repro_torch.core.scheduler import QueueFullError
    if rank_rows is None:
        def rank_rows(n):
            return 0, n
    sched = svc.scheduler
    ev_of = {t.tid: ev for ev, t in res.tickets}
    plain = Engine(tile_size=TILE, device=dev)
    checked, want_rmw, programs = 0, {}, {}
    for wi, (_, rep) in enumerate(res.windows):
        per_table = {}
        for _, tid in rep.order:
            ev = ev_of[tid]
            if ev.kind in ("rmw", "kv_append"):
                per_table.setdefault(ev.table, []).append(ev)
        for name, evs in per_table.items():
            if name == "K0":
                rows = np.unique(np.concatenate([e.idx for e in evs]))
                pos = np.searchsorted(rows, np.concatenate(
                    [e.idx for e in evs]))
                vals = np.concatenate([e.values for e in evs])
                want = np_rmw(host[name][rows], pos, vals, "ADD")
                want_rmw[(wi, name)] = (rows, want)
            else:
                want = host[name]
                for e in evs:
                    want = np_rmw(want, e.idx, e.values, e.op, e.cond)
                want_rmw[(wi, name)] = want
    win_of = res.window_of()
    seen = {}
    for ev, t in res.tickets:
        got = sched.result(t)
        if ev.kind in ("gather", "kv_decode"):
            table = host[ev.table]
            want = table[np.clip(ev.idx, 0, table.shape[0] - 1)]
            if not np.array_equal(interop.to_numpy(got, table.dtype), want):
                raise AssertionError(f"replay {ev.kind} of {ev.table} at "
                                     f"{ev.t_us:.0f} us: not bit for bit")
        elif ev.kind in ("rmw", "kv_append"):
            key = (win_of[t.tid], ev.table)
            if key in seen and got.data_ptr() == seen[key]:
                checked += 1
                continue                 # the window's one end state
            seen[key] = got.data_ptr()
            lo, hi = rank_rows(host[ev.table].shape[0])
            if ev.table == "K0":
                rows, want = want_rmw[key]
                mine = (rows >= lo) & (rows < hi)
                rows, want = rows[mine] - lo, want[mine]
                rows_d = torch.as_tensor(rows, device=dev).long()
                changed = (got != k0).any(dim=1)
                changed[rows_d] = False
                if changed.any() or not torch.equal(
                        got[rows_d].cpu(), torch.from_numpy(want)):
                    raise AssertionError(f"replay window {key[0]}: the KV "
                                         "pool is not the NumPy replay's")
            else:
                want = want_rmw[key][lo:hi]
                if not np.array_equal(interop.to_numpy(got, want.dtype),
                                      want):
                    raise AssertionError(f"replay window {key[0]} RMW "
                                         f"{ev.table}:{ev.op}: not bit for "
                                         "bit")
        else:
            pid = ev.program_id
            if pid not in programs:
                pattern, env, n = trace.programs[pid]
                prog, _ = compile_pattern(pattern, tile_size=TILE)
                denv = interop.env_from_numpy(env, device=dev)
                denv["__iota__"] = torch.arange(TILE, dtype=torch.int32,
                                                device=dev)
                programs[pid] = plain.run(
                    prog, denv, {"tile_base": 0, "N": n, "tile_end": n},
                    dtypes=interop.dtypes_of(env))
            for g, w in zip(got, programs[pid]):
                for k in w:
                    tol = 1e-4 if w[k].is_floating_point() else 0.0
                    assert_match(f"replay program {pid} {k}", g[k], w[k],
                                 rtol=tol, atol=tol / 10)
        checked += 1
    for _, t in res.rejected:
        try:
            sched.result(t)
        except QueueFullError:
            continue
        raise AssertionError(f"rejected ticket {t} did not raise")
    return checked


#: phases 9b and 9c's wall times, for phase 15 to print beside its own
SERVING_RESULTS: dict = {}


def phase_replay(dev):
    """(a) the bench trace's digest; (b) the KV-heavy trace replayed on
    the kernel path with wall-measured flushes, every ticket checked.
    Returns the kernels' launches in (b)."""
    import numpy as np
    import torch
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import (AdaptiveFlushController, TrafficConfig,
                                   generate_trace, replay_trace)
    digest = generate_trace(TrafficConfig(**BENCH_TRACE)).digest()
    if digest != BENCH_DIGEST:
        raise AssertionError(f"bench trace digest {digest} != "
                             f"{BENCH_DIGEST}")
    log(f"phase 9a traffic: bench trace digest {digest} (pinned)")
    t0 = time.perf_counter()
    trace = generate_trace(TrafficConfig(**KV_TRACE))
    log(f"phase 9b trace {KV_TRACE}: {trace.summary()} generated in "
        f"{time.perf_counter() - t0:.1f} s")
    host = dict(trace.tables)
    # the KV pool lives on the card, as a server holds it; the small G/R
    # tables (u32 among them) are submitted as NumPy
    k0 = torch.as_tensor(host["K0"], device=dev)
    trace.tables["K0"] = k0
    ids_2d = {id(k0)} | {id(v) for k, v in host.items()
                         if k != "K0" and v.ndim == 2}
    svc = kernel_service(dev, AdaptiveFlushController())
    counts = {}
    for e in trace.events:
        counts[e.tenant] = counts.get(e.tenant, 0) + 1
    svc.connect(max(counts, key=counts.get), max_pending=2)  # rejections
    reset_peak(dev)
    gk.launches = sk.launches = 0
    res, ms = timed(lambda: replay_trace(trace, svc))
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    peak = peak_gib(dev)
    want = expected_replay_launches(res, ids_2d)
    depths = [len(rep.order) for _, rep in res.windows]
    summ = svc.telemetry.summary()["overall"]
    log(f"phase 9b replay: {ms:.1f} ms wall, {res.n_flushes} windows "
        f"(mean depth {np.mean(depths):.2f}, max {max(depths)}), "
        f"{len(res.tickets)} tickets, {len(res.rejected)} rejected; "
        f"virtual p50 {summ['p50_us']:.1f} us p99 {summ['p99_us']:.1f} us, "
        f"{summ['throughput_per_s']:.1f} tickets/s, makespan "
        f"{res.makespan_us:.0f} us; peak {peak:.2f} GiB allocated")
    SERVING_RESULTS["replay"] = {"ms": ms, "p50": summ["p50_us"],
                                 "p99": summ["p99_us"],
                                 "windows": res.n_flushes}
    log(f"phase 9b launches {launches}; the plans call for {want}")
    if launches != want or min(launches.values()) < 1:
        raise AssertionError(f"replay launches {launches} != {want}")
    t0 = time.perf_counter()
    n = check_replay(dev, trace, host, svc, res, k0)
    if n != len(res.tickets) or not res.rejected:
        raise AssertionError(f"replay: {n} of {len(res.tickets)} checked, "
                             f"{len(res.rejected)} rejected")
    log(f"phase 9b: {n} tickets bit for bit their NumPy expectations "
        f"(programs against the plain engine), {len(res.rejected)} "
        f"rejections raised; checked in {time.perf_counter() - t0:.1f} s")
    del res, trace, svc, k0, host
    empty_cache(dev)
    return launches


def kvpool_problem(seed: int):
    """The KvPoolServer run's integer-valued K/V rows (exact in any
    order): the shared prefix, each sequence's prompt, each step's new
    token per sequence."""
    import numpy as np
    c = KVPOOL
    rng = np.random.default_rng(seed + 900)
    w = 2 * c["d"]
    prefix = rng.integers(0, 8, size=(c["prefix_tokens"], w)).astype(
        np.float32)
    lens = rng.integers(1, c["max_prompt"] + 1, size=c["n_seqs"])
    prompts = [rng.integers(0, 8, size=(int(n), w)).astype(np.float32)
               for n in lens]
    steps = rng.integers(0, 8, size=(c["n_steps"], c["n_seqs"], w)).astype(
        np.float32)
    return prefix, prompts, steps


class KvPoolModel:
    """The NumPy model of the pool: a bump page allocator that grows the
    pool by ``growth_pages`` when it runs out, each sequence's logical
    rows, and the physical pool they imply."""

    def __init__(self, page_size, growth_pages, init_pages):
        self.p, self.growth = page_size, growth_pages
        self.cap, self.head, self.growths = init_pages, 0, 0
        self.pages, self.rows = {}, {}

    def alloc(self, n):
        pages = list(range(self.head, self.head + n))
        self.head += n
        self.growths += self.cap < self.head
        while self.cap < self.head:
            self.cap += self.growth
        return pages

    def admit(self, name, shared, prefix_rows, prompt):
        import numpy as np
        rows = np.concatenate([prefix_rows, prompt]) if len(prefix_rows) \
            else prompt
        need = -(-rows.shape[0] // self.p) - len(shared)
        self.pages[name] = list(shared) + self.alloc(max(need, 0))
        self.rows[name] = rows

    def append(self, name, row):
        import numpy as np
        if self.rows[name].shape[0] % self.p == 0 and \
                self.rows[name].shape[0] // self.p == len(self.pages[name]):
            self.pages[name] += self.alloc(1)
        self.rows[name] = np.concatenate([self.rows[name], row[None]])

    def pool(self, width):
        import numpy as np
        out = np.zeros((self.cap * self.p, width), np.float32)
        for name, rows in self.rows.items():
            slots = (np.asarray(self.pages[name])[:, None] * self.p
                     + np.arange(self.p)[None, :]).reshape(-1)
            out[slots[:rows.shape[0]]] = rows
        return out


def phase_kvpool(dev, seed: int):
    """(c) ``KvPoolServer`` on the kernel path: a shared prefix, 64
    sequences over 8 tenants, 16 decode batches; the pool starts with
    exactly the pages admission takes, so decoding grows it. Every
    history bit for bit the NumPy model's rows, the final pool its
    physical pool, the launches PERF.md's prediction. Returns them."""
    import numpy as np
    import torch
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import KvPoolServer
    c = KVPOOL
    p, w = c["page_size"], 2 * c["d"]
    prefix, prompts, steps = kvpool_problem(seed)
    init_pages = c["prefix_tokens"] // p + sum(-(-x.shape[0] // p)
                                               for x in prompts)
    log(f"phase 9c kv pool: {c}, init_pages {init_pages}; source: "
        f"{APP_SOURCES['kv_serve'][0]}")
    srv = KvPoolServer(page_size=p, d=c["d"], growth_pages=c["growth_pages"],
                       init_pages=init_pages, service=kernel_service(dev))
    model = KvPoolModel(p, c["growth_pages"], init_pages)
    names = [f"s{i}" for i in range(c["n_seqs"])]
    gk.launches = sk.launches = 0
    t0 = time.perf_counter()
    srv.create_prefix("sys", prefix)
    shared = model.alloc(c["prefix_tokens"] // p)
    for i, name in enumerate(names):
        srv.admit(name, f"tenant{i % c['n_tenants']}", prompts[i],
                  prefix="sys")
        model.admit(name, shared, prefix, prompts[i])
    sync()
    admit_ms = (time.perf_counter() - t0) * 1e3
    cap_admitted = srv.stats()["cap_pages"]
    step_ms, check_s = [], 0.0
    for t in range(c["n_steps"]):
        new = {name: steps[t, i] for i, name in enumerate(names)}
        (hists, report), ms = timed(lambda: srv.decode_batch(new))
        step_ms.append(ms)
        t1 = time.perf_counter()
        for name in names:
            got = hists[name].cpu().numpy()
            if not np.array_equal(got, model.rows[name]):
                raise AssertionError(f"kv pool step {t} {name}: history "
                                     "not bit for bit the NumPy model's")
        for name in names:
            model.append(name, new[name])
        check_s += time.perf_counter() - t1
        del hists
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    st = srv.stats()
    SERVING_RESULTS["kvpool"] = {"ms": step_ms, "growths": st["growths"]}
    if not np.array_equal(srv.pool.cpu().numpy(), model.pool(w)):
        raise AssertionError("kv pool: the final pool is not the NumPy "
                             "model's")
    if st["growths"] < 1 or st["cap_pages"] <= cap_admitted \
            or st["cap_pages"] != model.cap:
        raise AssertionError(f"kv pool did not grow mid-flight as the "
                             f"model did: {st}, {cap_admitted} pages "
                             f"admitted, model {model.cap}")
    spans = [len({m.ticket.tenant for m in g.members})
             for g in report.plan.fused("gather")]
    log(f"phase 9c: admission (prefix + {c['n_seqs']} prompts) "
        f"{admit_ms:.1f} ms; "
        f"decode_batch ms {' '.join(f'{x:.1f}' for x in step_ms)}; "
        f"pool {cap_admitted} pages after admission -> {st['cap_pages']} "
        f"({st['growths']} growths), tenants per fused gather {spans}, "
        f"coalescing {sorted(report.gather_coalescing.values())}; "
        f"histories and the final pool bit for bit the NumPy model "
        f"(checked in {check_s:.1f} s)")
    log(f"phase 9c launches {launches}; predicted {KVPOOL_LAUNCHES}")
    if launches != KVPOOL_LAUNCHES:
        raise AssertionError(f"kv pool launches {launches} != "
                             f"{KVPOOL_LAUNCHES}")
    del srv, model
    empty_cache(dev)
    return launches


# --- phase 10 --------------------------------------------------------------

# Every model family of the port at published widths. Through ServeLoop:
# Qwen3-0.6B and RWKV-6 1.6B whole, DBRX's widths at 2 of its 40 layers and
# Jamba 1.5 Large's at 2 of its 72 (neither fits one card). Through the
# model API (ServeLoop sends no source; "src_len" marks this path):
# seamless-m4t-large-v2 whole, one wave of 4 sequences over 512 stub source
# frames. DBRX and Jamba are dropless MoEs (MegaBlocks; Jamba's MoE block
# routes every token): capacity_factor n_experts / top_k gives every expert
# room for every token, so prefill, decode and the full forward route
# alike.
SERVE_MODELS = {
    "qwen3-0.6b": dict(overrides={}, batch_slots=4, max_cache_len=1024,
                       n_requests=8, prompt=(128, 512), new_tokens=32),
    "dbrx-132b": dict(overrides={"n_layers": 2, "capacity_factor": 4.0},
                      reduced="layers 40 -> 2 (one card's memory)",
                      batch_slots=2, max_cache_len=512, n_requests=2,
                      prompt=(128, 256), new_tokens=16),
    # RWKV-6 at random weights amplifies f32 rounding ~1e4-fold over its
    # 24 layers (PERF.md §6): its rows differ from a forward whose
    # matmuls have other shapes by ~1e-3 in f32. The f32 run holds its
    # prefill rows to the forward over the same prompt (same shapes) and
    # measures the rest; a float64 run of the same weights holds every
    # row ("check_dtype"). Its eager WKV loop runs a layer and time step
    # at a time (~0.155 ms each): at 24 layers the model's seven serve
    # runs took 97 s of the smoke's 1200, so the depth is cut.
    "rwkv6-1.6b": dict(overrides={"n_layers": 4},
                       reduced="layers 24 -> 4 (the run's time: the eager "
                               "WKV loop, ~0.155 ms a layer and time step)",
                       batch_slots=4, max_cache_len=1024,
                       n_requests=8, prompt=(128, 512), new_tokens=32,
                       check_dtype="float64"),
    "jamba-1.5-large-398b": dict(
        overrides={"n_layers": 2, "attn_period": 2, "capacity_factor": 8.0},
        reduced="layers 72 -> 2 and attn_period 8 -> 2: one superblock of a "
                "Mamba layer (dense MLP) and an attention layer (MoE); the "
                "smallest superblock of the published period 8 has 44.7 B "
                "parameters, 89.4 GB in bf16, more than one card holds",
        batch_slots=2, max_cache_len=512, n_requests=2, prompt=(128, 256),
        new_tokens=16),
    "seamless-m4t-large-v2": dict(overrides={}, batch_slots=4,
                                  max_cache_len=128, n_requests=4,
                                  prompt=(64, 64), new_tokens=32,
                                  src_len=512),
}
SERVE_SOURCES = {
    "qwen3-0.6b": "Qwen/Qwen3-0.6B config.json (28 layers, d 1024, 16/8 "
                  "heads x 128, d_ff 3072, vocab 151936, qk_norm, theta 1e6)",
    "dbrx-132b": "databricks/dbrx-base config.json (d 6144, 48/8 heads x "
                 "128, d_ff 10752, 16 experts top-4, vocab 100352, theta "
                 "5e5)",
    "rwkv6-1.6b": "configs/rwkv6_1_6b.py, RWKV-6 Finch 1.6B (arXiv:2404."
                  "05892: 24 layers, d 2048, 32 heads x 64, d_ff 7168, "
                  "vocab 65536)",
    "jamba-1.5-large-398b": "configs/jamba15_large_398b.py, Jamba 1.5 Large "
                            "(arXiv:2403.19887: d 8192, 64/8 heads x 128, "
                            "d_ff 24576, 16 experts top-2, vocab 65536, "
                            "Mamba state 16 / expand 2 / conv 4, dt_rank "
                            "512, attention 1 layer in 8, MoE every 2nd)",
    "seamless-m4t-large-v2": "configs/seamless_m4t_large_v2.py, "
                             "SeamlessM4T Large v2 (arXiv:2308.11596: 12 + "
                             "12 layers, d 1024, 16 heads x 64, d_ff 8192, "
                             "vocab 256206; the speech frontend a stub of "
                             "seeded frame embeddings)",
}
# f32 logits of the served path against the forward: |err| <= ATOL +
# RTOL * |want|. Both compute the same f32 function; cuBLAS reduces in
# another order per shape, ~1e-6 relative per layer. bf16 misses it by
# far more (checked in the run: the bf16 logits must fail it).
SERVE_ATOL = SERVE_RTOL = 2e-4
DECODE_PROFILE_STEPS = 8           # decode steps in the per-step profile


def serve_requests(name, vocab, seed):
    import numpy as np
    from repro_torch.serve.serve import Request
    c = SERVE_MODELS[name]
    rng = np.random.default_rng(seed + 1000)
    lo, hi = c["prompt"]
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(lo, hi + 1))).astype(np.int32),
        max_new_tokens=c["new_tokens"]) for i in range(c["n_requests"])]


def serve_source(name, model, seed):
    """An encoder-decoder's stub source frames, (n_requests, src_len,
    d_model) f32 drawn on the card from the seed; None for a decoder."""
    import torch
    c = SERVE_MODELS[name]
    if "src_len" not in c:
        return None
    gen = torch.Generator(device=model.device).manual_seed(seed + 2000)
    return torch.randn((c["n_requests"], c["src_len"], model.cfg.d_model),
                       generator=gen, device=model.device)


def first_wave(name, model, seed, requests=None):
    """The first batch ServeLoop prefills: the first ``batch_slots``
    requests left-padded with token 0 (and their source frames)."""
    import numpy as np
    import torch
    b = SERVE_MODELS[name]["batch_slots"]
    reqs = (requests or serve_requests(name, model.cfg.vocab, seed))[:b]
    plen = max(len(r.prompt) for r in reqs)
    toks = np.stack([np.pad(r.prompt, (plen - len(r.prompt), 0))
                     for r in reqs]).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks, device=model.device)}
    src = serve_source(name, model, seed)
    if src is not None:
        batch["src_embeds"] = src[:b]
    return batch


def serve_encdec(name, model, params, seed, requests, prefill, decode):
    """One wave of an encoder-decoder through the model API, greedy as
    ServeLoop decodes: prefill over the source and the prompts, then
    ``new_tokens`` decode steps, each fed the argmax of the last logits."""
    import torch
    c = SERVE_MODELS[name]
    cache = model.init_cache(c["batch_slots"], c["max_cache_len"],
                             src_len=c["src_len"])
    logits, cache = prefill(params, first_wave(name, model, seed, requests),
                            cache)
    outs = [[] for _ in requests]
    for _ in range(c["new_tokens"]):
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        for out, tok in zip(outs, nxt.tolist()):
            out.append(tok)
        logits, cache = decode(params, {"tokens": nxt[:, None]}, cache)
    for r, out in zip(requests, outs):
        r.out_tokens = out
    return requests


def run_serve(name, model, params, seed, *, clock=False, waves=None):
    """One run over the model's requests (the first ``waves`` waves of
    them, if given): ``ServeLoop``, or ``serve_encdec`` for an
    encoder-decoder. Each prefill and decode call is recorded as (its
    input tokens, its logits, its ms when ``clock``: host clock between
    two synchronisations)."""
    import torch
    from repro_torch.serve import ServeLoop
    c = SERVE_MODELS[name]
    calls = []

    def wrap(fn, kind):
        def call(p, batch, cache):
            if clock:
                sync()
            t0 = time.perf_counter()
            logits, cache = fn(p, batch, cache)
            if clock:
                sync()
            calls.append((kind, batch["tokens"], logits,
                          (time.perf_counter() - t0) * 1e3))
            return logits, cache
        return call

    requests = serve_requests(name, model.cfg.vocab, seed)
    if waves is not None:
        requests = requests[:waves * c["batch_slots"]]
    with torch.no_grad():
        if "src_len" in c:
            done, ms = timed(lambda: serve_encdec(
                name, model, params, seed, requests,
                wrap(model.prefill, "prefill"),
                wrap(model.decode_step, "decode")))
        else:
            loop = ServeLoop(model, batch_slots=c["batch_slots"],
                             max_cache_len=c["max_cache_len"])
            loop.params = params
            loop._prefill = wrap(loop._prefill, "prefill")
            loop._decode = wrap(loop._decode, "decode")
            done, ms = timed(lambda: loop.run(requests))
    return done, calls, ms


def waves_of(calls):
    waves = []
    for call in calls:
        if call[0] == "prefill":
            waves.append([])
        waves[-1].append(call)
    return waves


def check_serve(name, model, params, seed, done, calls, bounded=True):
    """Every logit row the run computed against ``forward``, wave by wave
    (the left-padded prompts, the tokens fed back and, for an
    encoder-decoder, the same source frames). The prefill's row against
    ``forward`` over exactly the prefilled tokens, and every row (prefill
    and decode) against ``forward`` over the whole wave, each within
    SERVE_ATOL + SERVE_RTOL |x|; the greedy tokens against the forward's
    argmax where its top-2 margin exceeds twice that bound. With
    ``bounded`` False only the first check is made and the rows against
    the wave are measured, not held (RWKV-6 in f32, SERVE_MODELS). Returns
    a dict: the prefill's max abs err ("prefill"), the rows' max abs err
    ("err"), rows compared ("rows") and over the bound ("over"), greedy
    tokens checked ("tokens") and left to the margin ("near").
    """
    import torch
    b = SERVE_MODELS[name]["batch_slots"]
    src = serve_source(name, model, seed)
    by_rid = {r.rid: r for r in done}
    st = dict(prefill=0.0, err=0.0, rows=0, over=0, tokens=0, near=0)
    for w, wave in enumerate(waves_of(calls)):
        batch = {"tokens": torch.cat([c[1] for c in wave], dim=1)}
        if src is not None:
            batch["src_embeds"] = src[w * b:(w + 1) * b]
        plen = wave[0][1].shape[1]
        with torch.no_grad():
            head, _ = model.forward(params, {
                **batch, "tokens": batch["tokens"][:, :plen]})
        head = head[:, -1]
        got = wave[0][2][:, 0]
        bad = (got - head).abs() > SERVE_ATOL + SERVE_RTOL * head.abs()
        st["prefill"] = max(st["prefill"], max_abs_err(got, head))
        if bad.any():
            raise AssertionError(f"serve {name} wave {w} prefill: "
                                 f"{int(bad.sum())} logits off the forward "
                                 f"over the prompt by more than "
                                 f"{SERVE_ATOL} + {SERVE_RTOL} |x| (max "
                                 f"{max_abs_err(got, head)})")
        del head
        with torch.no_grad():
            full, _ = model.forward(params, batch)
        full = full[:, plen - 1:]
        for k, call in enumerate(wave):
            got, want = call[2][:, 0], full[:, k]
            bound = SERVE_ATOL + SERVE_RTOL * want.abs()
            bad = ((got - want).abs() > bound).any(-1)
            st["err"] = max(st["err"], max_abs_err(got, want))
            st["rows"] += got.shape[0]
            st["over"] += int(bad.sum())
            if not bounded:
                continue
            if bad.any():
                raise AssertionError(f"serve {name} wave {w} call {k}: "
                                     f"{int(bad.sum())} rows off by more "
                                     f"than {SERVE_ATOL} + {SERVE_RTOL} "
                                     f"|x| (max {max_abs_err(got, want)})")
            top2 = torch.topk(want, 2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).tolist()
            ref_tok = want.argmax(-1).tolist()
            for i in range(b):
                r = by_rid.get(w * b + i)
                if r is None or k >= len(r.out_tokens):
                    continue
                if margin[i] <= 2 * (SERVE_ATOL + SERVE_RTOL * abs(
                        float(top2[i, 0]))):
                    st["near"] += 1
                elif r.out_tokens[k] != ref_tok[i]:
                    raise AssertionError(f"serve {name} request {r.rid} "
                                         f"token {k}: {r.out_tokens[k]} != "
                                         f"forward's {ref_tok[i]} (margin "
                                         f"{margin[i]:.2e})")
                else:
                    st["tokens"] += 1
        del full
    return st


def log_check(name, dtype, ms, st, bounded=True):
    held = "within" if bounded else "measured against"
    log(f"phase 10 {name} {dtype}: {ms:.1f} ms; prefill rows within "
        f"{SERVE_ATOL} + {SERVE_RTOL}|x| of forward over the prompt (max "
        f"abs err {st['prefill']:.3e}); {st['rows']} logit rows {held} "
        f"{SERVE_ATOL} + {SERVE_RTOL}|x| of forward over the wave (max abs "
        f"err {st['err']:.3e}, {st['over']} rows over it); "
        f"{st['tokens']} greedy tokens equal forward's argmax, "
        f"{st['near']} left unchecked within the margin")


def profile_decode(dev, name, model, params, seed):
    """Kernel launches and the device's busy share per decode step: the
    first wave prefilled, two warm steps, then DECODE_PROFILE_STEPS steps
    under the profiler. Returns launches per step."""
    import torch
    c = SERVE_MODELS[name]
    kw = {"src_len": c["src_len"]} if "src_len" in c else {}
    state = {}

    def steps(n):
        for _ in range(n):
            nxt = torch.argmax(state["logits"][:, -1, :], dim=-1)
            state["logits"], state["cache"] = model.decode_step(
                params, {"tokens": nxt.to(torch.int32)[:, None]},
                state["cache"])

    with torch.no_grad():
        cache = model.init_cache(c["batch_slots"], c["max_cache_len"], **kw)
        state["logits"], state["cache"] = model.prefill(
            params, first_wave(name, model, seed), cache)
        steps(2)
        launches, busy = profile_app(
            dev, f"serve {name} bf16, {DECODE_PROFILE_STEPS} decode steps",
            lambda: steps(DECODE_PROFILE_STEPS))
    per_step = launches / DECODE_PROFILE_STEPS
    log(f"phase 10 {name} bf16: {per_step:.1f} kernel launches per decode "
        f"step, device {100 * busy:.1f}% busy over the steps")
    return per_step


def phase_serve(dev, seed: int):
    """Every model family of the port at the published widths, for each
    of SERVE_MODELS: a checked run in f32 (logits against the full
    forward, greedy tokens, and ``dx100_embed_fwd=True`` against False;
    and in ``check_dtype`` on the same weights where the model asks),
    then timed runs in the config's bf16 (after a warm-up run), the first
    wave under the profiler and a profile of decode steps alone. Returns
    the kernels' launches over the phase."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.models import build_model
    from repro_torch.pipeline.decoupled import tree_map
    gk.launches = sk.launches = 0
    for name, c in SERVE_MODELS.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name), **c["overrides"])
        via = (f"model API, source {c['src_len']} frames" if "src_len" in c
               else "ServeLoop")
        depth = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers}"
                 if cfg.family == "encdec" else f"{cfg.n_layers}")
        log(f"phase 10 serve {name} ({cfg.family}, {via}): {depth} "
            f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
            f"x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, experts "
            f"{cfg.n_experts} top {cfg.top_k}; {c['n_requests']} requests "
            f"of {c['prompt'][0]}-{c['prompt'][1]} tokens, "
            f"{c['new_tokens']} new, {c['batch_slots']} slots, cache "
            f"{c['max_cache_len']}; source: {SERVE_SOURCES[name]}")
        if "reduced" in c:
            log(f"reduced {name}: {c['reduced']}")
        f32 = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
        model = build_model(f32, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        done, calls, ms = run_serve(name, model, params, seed)
        st = check_serve(name, model, params, seed, done, calls,
                         bounded="check_dtype" not in c)
        log_check(name, "float32", ms, st, "check_dtype" not in c)
        if "check_dtype" in c:
            cast = getattr(torch, c["check_dtype"])
            wide = build_model(dataclasses.replace(
                f32, dtype=c["check_dtype"], param_dtype=c["check_dtype"]),
                device=dev)
            wide_params = tree_map(lambda t: t.to(cast), params,
                                   torch.is_tensor)
            done2, calls2, ms2 = run_serve(name, wide, wide_params, seed)
            log_check(name, c["check_dtype"], ms2, check_serve(
                name, wide, wide_params, seed, done2, calls2))
            del wide, wide_params, done2, calls2
            empty_cache(dev)
        model_fwd = build_model(dataclasses.replace(f32,
                                                    dx100_embed_fwd=True),
                                device=dev)
        done2, calls2, _ = run_serve(name, model_fwd, params, seed)
        same_tok = [r.out_tokens for r in done] == \
            [r.out_tokens for r in done2]
        fwd_err = max(max_abs_err(a[2], b[2]) for a, b in zip(calls, calls2))
        # without experts the path is deterministic, so bit for bit; the
        # MoE combine sums with atomics (index_add_), so within the
        # tolerance
        limit = SERVE_ATOL if cfg.n_experts else 0.0
        if not same_tok or fwd_err > limit:
            raise AssertionError(f"serve {name}: dx100_embed_fwd=True "
                                 f"differs (tokens equal {same_tok}, max "
                                 f"abs err {fwd_err})")
        log(f"phase 10 {name}: dx100_embed_fwd=True gives the same tokens, "
            f"logits max abs err {fwd_err:.3e}")
        f32_first = calls[0][2].float()
        del model, model_fwd, params, calls, calls2, done, done2
        empty_cache(dev)

        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        run_serve(name, model, params, seed)                  # warm-up
        reset_peak(dev)
        done, calls, ms = run_serve(name, model, params, seed, clock=True)
        peak = peak_gib(dev)
        bf_first = calls[0][2].float()
        bf_err = max_abs_err(bf_first, f32_first)
        if not ((bf_first - f32_first).abs()
                > SERVE_ATOL + SERVE_RTOL * f32_first.abs()).any():
            raise AssertionError(f"serve {name}: bf16 logits are within "
                                 f"the f32 tolerance ({bf_err}): the check "
                                 "would not tell bf16 from f32")
        pre = [x[3] for x in calls if x[0] == "prefill"]
        dec = [x[3] for x in calls if x[0] == "decode"]
        n_tok = sum(len(r.out_tokens) for r in done)
        log(f"phase 10 {name} bf16: {ms:.1f} ms for {n_tok} tokens "
            f"({n_tok / ms * 1e3:.1f} tokens/s); prefill ms per wave "
            f"{' '.join(f'{x:.2f}' for x in pre)}; decode ms per step "
            f"median {statistics.median(dec):.3f} (min {min(dec):.3f}, max "
            f"{max(dec):.3f}, {len(dec)} steps, "
            f"{c['batch_slots'] / statistics.median(dec) * 1e3:.1f} "
            f"tokens/s per step); peak {peak:.2f} GiB allocated; bf16 "
            f"prefill logits off f32 by {bf_err:.3e} (fails the f32 "
            f"tolerance, as it must)")
        profile_app(dev, f"serve {name} bf16, the first wave",
                    lambda: run_serve(name, model, params, seed, waves=1))
        profile_decode(dev, name, model, params, seed)
        del model, params, calls, done
        empty_cache(dev)
        log(f"phase 10 {name}: {time.perf_counter() - t0:.1f} s")
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    log(f"phase 10 launches {launches} (the model path calls no kernel)")
    if any(launches.values()):
        raise AssertionError(f"serve path launched {launches}")
    return launches


# --- phase 11 --------------------------------------------------------------

SHARD_MESHES = (1, 2, 4, 8)        # logical shards, all on the one card
SHARD_RUNS = 2                     # warm timed runs per path
# phase 8's configurations that phase 11 serves over AccessService(mesh=4)
SHARD_APPS = ("spmv_block", "embedding_bag")
# predicted B1/B2 launches per sharded call on a 2-D table: the owners'
# takes are one bulk_gather, their updates one bulk_rmw
SHARD_CALL_LAUNCHES = {"gather": {"row_table_gather": 1, "row_table_rmw": 0},
                       "rmw": {"row_table_gather": 0, "row_table_rmw": 1}}


def np_shard_counts(idx, n_rows: int, m: int, placement: str):
    """``ShardStats``' counts from NumPy for a stream of in-range rows
    under the call's placement ("block" slices, or the owner-major
    permutation). ``sent[s, o]`` distinct rows of slice s owned by o;
    ``received[o]`` its column sum (the capacity drops nothing: a stream
    on the card runs at the slice length, a measured one at its exact
    spill); ``unique[o]`` distinct rows owned by o over all slices."""
    import numpy as np
    n = idx.shape[0]
    per, rows_per = -(-n // m), -(-n_rows // m)
    pad = np.zeros(per * m, np.int64)
    pad[:n] = idx
    valid = np.arange(per * m) < n
    if placement == "owner":
        perm = np.argsort(np.where(valid, pad // rows_per, m),
                          kind="stable")
        pad, valid = pad[perm], valid[perm]
    sent = np.zeros((m, m), np.int64)
    for s in range(m):
        sl = slice(s * per, (s + 1) * per)
        u = np.unique(pad[sl][valid[sl]])
        sent[s] = np.bincount(u // rows_per, minlength=m)
    unique = np.bincount(np.unique(idx) // rows_per, minlength=m)
    return sent, sent.sum(0), unique


def check_shard_stats(what, st, want):
    import numpy as np
    for name, got, w in zip(("sent", "received", "unique"),
                            (st.sent, st.received, st.unique), want):
        if not np.array_equal(got.astype(np.int64), w):
            raise AssertionError(f"{what}: ShardStats.{name} {got.tolist()}"
                                 f" != NumPy {w.tolist()}")


def call_profile(dev, fn):
    """(host syncs, kernel launches) of one call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    events = prof.key_averages()
    syncs = sum(e.count for e in events if e.key in SYNC_CALLS)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    return syncs - 1, launches      # less the closing synchronize


def phase_sharded(dev, seed: int):
    """The sharded engine on the card: ``ShardedEngine(mesh=m,
    use_kernel=True)`` for m logical shards on this one card, over phase
    3's table A (2^20 x 128 f32) and 2^21-lookup zipf/uniform streams.
    Gathers bit for bit the single-device ``bulk_gather``; ADD (integer
    valued f32) and MIN (an i32 table) bit for bit ``bulk_rmw`` and
    ``index_add`` / ``scatter_reduce``; ``ShardStats`` against NumPy owner
    counts; B1/B2 launches exactly ``SHARD_CALL_LAUNCHES`` per call. Then
    per m the warm median of SHARD_RUNS against the single-device bulk ops
    and the library calls, the host syncs and launches of one call, and
    the peak memory. Then ``AccessService`` over a 4-shard kernel engine on
    ``SHARD_APPS`` at phase 8's sizes, bit for bit their oracles, and the
    port's harness on the card: ``check_sharded_parity`` at every mesh
    size and ``check_pattern_parity`` on the 12 conformance patterns
    (kernel path). Returns each kernel's launches per mesh size and each
    mesh size's warm median ms per timed path."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.core import Scheduler, bulk_gather, bulk_rmw
    from repro_torch.distributed import ShardedEngine
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import AccessService
    from repro_torch.testing import (EngineConfig, build_conformance,
                                     conformance_names, harness)
    A, V, B = make_data(dev, LOOKUPS, seed)
    del V
    host = {k: v.cpu().numpy() for k, v in B.items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    Vi = torch.randint(-8, 8, (LOOKUPS, WIDTH), generator=gen, device=dev,
                       dtype=torch.int32)
    Vf = Vi.float()
    I = torch.randint(0, 2 ** 20, (ROWS, WIDTH), generator=gen, device=dev,
                      dtype=torch.int32)
    Af = (I - 2 ** 19).float()      # integer-valued: every ADD is exact
    z = B["zipf"]
    zl = z.long()
    want_g = {k: bulk_gather(A, b, use_kernel=True,
                                     device=dev) for k, b in B.items()}
    want_add = Af.index_add(0, zl, Vf)
    want_min = I.scatter_reduce(0, zl[:, None].expand(-1, WIDTH), Vi,
                                "amin")
    assert_match("single-device bulk_rmw ADD vs index_add",
                 bulk_rmw(Af, z, Vf, op="ADD", use_kernel=True, device=dev),
                 want_add)
    assert_match("single-device bulk_rmw MIN vs scatter_reduce",
                 bulk_rmw(I, z, Vi, op="MIN", use_kernel=True, device=dev),
                 want_min)
    sharded_launches = {"row_table_gather": {}, "row_table_rmw": {}}
    logical_ms = {}
    for m in SHARD_MESHES:
        eng = ShardedEngine(mesh=m, use_kernel=True, device=dev)
        empty_cache(dev)
        reset_peak(dev)
        totals = {"row_table_gather": 0, "row_table_rmw": 0}
        calls = [(f"gather {k}", "gather", lambda b=b: eng.sharded_gather(
            A, b), want_g[k], host[k], ROWS) for k, b in B.items()]
        calls += [("rmw ADD zipf", "rmw", lambda: eng.sharded_rmw(
            Af, z, Vf, op="ADD"), want_add, host["zipf"], ROWS),
                  ("rmw MIN zipf i32", "rmw", lambda: eng.sharded_rmw(
                      I, z, Vi, op="MIN"), want_min, host["zipf"], ROWS)]
        for what, kind, fn, want, hidx, n_rows in calls:
            g0, s0 = gk.launches, sk.launches
            got = fn()
            sync()
            launched = {"row_table_gather": gk.launches - g0,
                        "row_table_rmw": sk.launches - s0}
            if launched != SHARD_CALL_LAUNCHES[kind]:
                raise AssertionError(f"mesh {m} {what}: launches {launched}"
                                     f" != {SHARD_CALL_LAUNCHES[kind]}")
            for k_, v in launched.items():
                totals[k_] += v
            assert_match(f"mesh {m} {what}", got, want)
            st = eng.last_shard_stats
            check_shard_stats(f"mesh {m} {what}", st, np_shard_counts(
                hidx, n_rows, m, st.placement))
            del got
        peak = peak_gib(dev)
        for k_, v in totals.items():
            sharded_launches[k_][str(m)] = v
        st = eng.last_shard_stats
        log(f"sharded mesh {m}: bit for bit on every call; launches "
            f"{totals}; capacity {st.capacity} codec {st.codec} placement "
            f"{st.placement}; local fraction {st.local_fraction:.4f}; "
            f"bytes on wire {st.bytes_on_wire}; peak {peak:.2f} GiB "
            "allocated")
        paths = {
            "sharded gather": lambda: eng.sharded_gather(A, z),
            "bulk_gather": lambda: bulk_gather(A, z, use_kernel=True,
                                               device=dev),
            "index_select": lambda: A.index_select(0, zl),
            "sharded rmw ADD": lambda: eng.sharded_rmw(Af, z, Vf,
                                                       op="ADD"),
            "bulk_rmw ADD": lambda: bulk_rmw(Af, z, Vf, op="ADD",
                                             use_kernel=True, device=dev),
            "index_add": lambda: Af.index_add(0, zl, Vf),
        }
        times = {k: [] for k in paths}
        for _ in range(SHARD_RUNS):
            for k, fn in paths.items():
                times[k].append(timed(fn)[1])
        logical_ms[m] = {k: statistics.median(ms) for k, ms in times.items()}
        for k, ms in times.items():
            log(f"sharded mesh {m} zipf {k:16s} warm median "
                f"{statistics.median(ms):9.3f} ms, runs "
                f"{' '.join(f'{t:.3f}' for t in ms)}")
        for k in ("sharded gather", "sharded rmw ADD"):
            syncs, launches = call_profile(dev, paths[k])
            log(f"sharded mesh {m} {k}: {syncs} host syncs, {launches} "
                "kernel launches per call")
        del eng, paths
    del Vi, Vf, I, Af, want_g, want_add, want_min
    empty_cache(dev)
    for case in app_cases(seed):
        if case.name not in SHARD_APPS:
            continue
        prob = case.make()
        want = case.oracle(prob)
        svc = AccessService(Scheduler(engine=ShardedEngine(
            mesh=4, tile_size=TILE, use_kernel=True, device=dev)),
            auto_flush=0)
        g0, s0 = gk.launches, sk.launches
        got, ms = timed(lambda: case.run(prob, mode="pipelined",
                                         service=svc))
        if not bitwise_equal(got, want):
            raise AssertionError(f"app {case.name} over mesh 4: not bit "
                                 "for bit the host oracle")
        ex = svc.telemetry.exchange_summary()
        SHARD_APP_MS[case.name] = ms
        log(f"sharded app {case.name} (mesh 4): bit for bit the host "
            f"oracle in {ms:.3f} ms; launches B1 {gk.launches - g0} B2 "
            f"{sk.launches - s0}; exchange {ex}")
        del prob, want, svc, got
        empty_cache(dev)
    checked, ran = harness.check_sharded_parity(
        mesh_sizes=SHARD_MESHES, device=dev)
    cfgs = [EngineConfig(optimize=True, use_kernel=True, jit=False,
                         tile_size=t) for t in (64, TILE)]
    n_conf = sum(harness.check_pattern_parity(
        c.pattern, c.env, n=c.n, configs=cfgs,
        max_tile_fill=c.max_tile_fill, device=dev)
        for c in (build_conformance(name) for name in conformance_names()))
    log(f"harness on the card: check_sharded_parity {checked} cases at "
        f"mesh {ran}; check_pattern_parity {n_conf} comparisons over the "
        f"12 conformance patterns (kernel path, tiles 64 and {TILE})")
    sync()
    return sharded_launches, logical_ms



# --- phase 12 --------------------------------------------------------------

TRAIN_ARCH = "qwen3-0.6b"          # whole: 28 layers, published widths
TRAIN_RUN = ["--steps", "6", "--batch", "8", "--seq", "512",
             "--ckpt-every", "3", "--log-every", "1"]
TRAIN_TOKENS = 8 * 512
TRAIN_CHECK = (1, 128)             # (b): batch x seq of the f32 step
TRAIN_FAMILY_CHECK = (2, 32)       # (c): each reduced family's step
TRAIN_FAMILIES = {                 # reduced; overrides of cfg.reduced()
    "qwen2-vl-72b": {}, "dbrx-132b": {},
    "jamba-1.5-large-398b": {"attn_period": 2, "n_layers": 2},
    "rwkv6-1.6b": {}, "seamless-m4t-large-v2": {}}
TRAIN_LOSS_RTOL = 1e-5             # f32 on the card against float64
TRAIN_GRAD_REL_L2 = 1e-4           # per gradient leaf
TRAIN_NORM_RTOL = 1e-5             # the global norm
TRAIN_TIMED = 3                    # warm timed bf16 steps (median)
TRAIN_RESULTS: dict = {}           # (d)'s step, printed beside phase 16's


def check_train_step(what, dev, cfg, params, batch, *, mesh=None):
    """One f32 train step's gradient half (loss, clipped gradients,
    global norm) on ``dev`` against the same step in float64 from the
    same weights and batch (on ``dev``; a MoE model's on the CPU, as
    ``tf_reference``); raises past the TRAIN_* bounds.
    Returns the card's (loss, clipped grads, norm) and the errors."""
    import contextlib
    import dataclasses
    import torch
    from repro_torch.core.tree import tree_leaves_with_path, tree_map
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.trainer import loss_and_clipped_grads
    ctx = meshlib.set_mesh(mesh) if mesh is not None \
        else contextlib.nullcontext()
    with ctx:
        loss, grads, norm = loss_and_clipped_grads(
            build_model(cfg, device=dev), params, batch)
    sync()
    wide = dataclasses.replace(cfg, dtype="float64", param_dtype="float64",
                               moe_a2a=False)
    cpu = torch.device("cpu")
    ref_dev = dev if cfg.n_experts == 0 else cpu
    loss64, grads64, norm64 = loss_and_clipped_grads(
        build_model(wide, device=ref_dev),
        tree_map(lambda t: to_float64(t, ref_dev), params),
        {k: to_float64(v, ref_dev) for k, v in batch.items()})
    loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    norm_err = abs(float(norm) - float(norm64)) / abs(float(norm64))
    worst, leaves = ("", 0.0), 0
    for (p, g), (_, w) in zip(tree_leaves_with_path(grads),
                              tree_leaves_with_path(grads64)):
        err = float((g.to(w.device, torch.float64) - w).norm()
                    / w.norm().clamp(min=1e-300))
        leaves += 1
        if err > worst[1] or not err == err:
            worst = ("/".join(map(str, p)), err)
    log(f"phase 12 {what}: f32 on the card against float64 on "
        f"{ref_dev.type}: "
        f"loss {float(loss):.6f} (rel err {loss_err:.3e}), {leaves} "
        f"gradient leaves, worst rel L2 {worst[1]:.3e} ({worst[0]}), "
        f"global norm {float(norm):.6f} (rel err {norm_err:.3e})")
    if not (loss_err <= TRAIN_LOSS_RTOL and worst[1] <= TRAIN_GRAD_REL_L2
            and norm_err <= TRAIN_NORM_RTOL):
        raise AssertionError(
            f"train {what}: f32 step off float64 (loss {loss_err:.3e}, "
            f"grad {worst[1]:.3e} at {worst[0]}, norm {norm_err:.3e}; "
            f"bounds {TRAIN_LOSS_RTOL}, {TRAIN_GRAD_REL_L2}, "
            f"{TRAIN_NORM_RTOL})")
    return (loss, grads, norm), (loss_err, worst[1], norm_err)


def train_resume(dev, tmp: Path, seed: int):
    """(a): run A trains 6 steps with checkpoints at 3 and 6; run B resumes
    from a copy of A's step_3; both step_6 manifests must carry the same
    per-leaf hashes. Returns A's per-step history."""
    import shutil
    import warnings
    import torch
    from repro_torch.launch import train as train_cli
    base = ["--arch", TRAIN_ARCH, "--device", str(dev), "--seed",
            str(seed)] + TRAIN_RUN
    hist_a, hist_b = [], []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            train_cli.main(base + ["--ckpt-dir", str(tmp / "a")],
                           history=hist_a)
            sync()
            t_a = time.perf_counter() - t0
            (tmp / "b").mkdir()
            shutil.copytree(tmp / "a" / "step_3", tmp / "b" / "step_3")
            t0 = time.perf_counter()
            train_cli.main(base + ["--ckpt-dir", str(tmp / "b"),
                                   "--resume"], history=hist_b)
            sync()
            t_b = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    log(f"phase 12 (a) ops without a deterministic CUDA implementation: "
        f"{nondet or 'none'}")
    manifests = []
    for run in ("a", "b"):
        with open(tmp / run / "step_6" / "manifest.json") as f:
            manifests.append(json.load(f)["entries"])
    a, b = manifests
    differ = sorted(k for k in a if a[k]["hash"] != b.get(k, {}).get("hash"))
    losses = [h["loss"] for h in hist_a]
    fmt = lambda xs: " ".join(f"{x:.4f}" for x in xs)
    log(f"phase 12 (a) run A: {len(hist_a)} steps in {t_a:.1f} s (2 "
        f"checkpoint writes included), losses {fmt(losses)}; run B resumed "
        f"at step {hist_b[0]['step']}, {len(hist_b)} steps in {t_b:.1f} s "
        f"(a load and a write included), losses "
        f"{fmt(h['loss'] for h in hist_b)}")
    if differ or set(a) != set(b):
        raise AssertionError(f"train resume: step_6 hashes differ on "
                             f"{len(differ)} of {len(a)} leaves "
                             f"({differ[:5]})")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if hist_b != hist_a[3:]:
        raise AssertionError("train resume: run B's metrics differ from "
                             "run A's steps 3-5")
    log(f"phase 12 (a) resume bit for bit: {len(a)} leaves of step_6 carry "
        f"equal hashes; last loss {losses[-1]:.4f} against first "
        f"{losses[0]:.4f}")
    return hist_a


def train_measure(dev, seed: int):
    """(d): the bf16 step of (a), warm, in the default (non-deterministic)
    mode: median of TRAIN_TIMED steps, tokens/s, peak memory, one step
    under the profiler, the counted FLOPs and bytes against 6 N D and the
    H100 bounds."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.models import build_model
    from repro_torch.roofline import analysis as roofline
    from repro_torch.train.trainer import Trainer
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    trainer = Trainer(model=model, mesh=None, warmup=1, total_steps=6)
    params, opt = trainer.init_state(seed)
    step = trainer.jitted_step()
    batch = SyntheticTokenPipeline(cfg, 8, 512, seed=seed,
                                   device=dev).get_batch(0)
    params, opt, _ = step(params, opt, batch)                # warm-up
    sync()
    reset_peak(dev)
    times = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = peak_gib(dev)
    ms = statistics.median(times)
    state = {"p": params, "o": opt}

    def one_step():
        state["p"], state["o"], _ = step(state["p"], state["o"], batch)
    launches, busy = profile_app(dev, "train qwen3-0.6b bf16, one step",
                                 one_step)
    _, flops, nbytes, ops = roofline.count_step(step, state["p"], state["o"],
                                                batch)
    sync()
    n = roofline.count_params(params)
    mflops = roofline.model_flops(cfg, batch=8, seq=512, n_params=n)
    rep = roofline.roofline_terms(hlo_flops=flops, hlo_bytes=nbytes,
                                  coll_bytes={}, chips=1,
                                  model_flops_total=mflops)
    bound_ms = max(rep.compute_s, rep.memory_s) * 1e3
    TRAIN_RESULTS.update(ms=ms, peak_gib=peak)
    log(f"phase 12 (d) train {TRAIN_ARCH} bf16 (8 x 512, AdamW bf16 "
        f"moments): {ms:.3f} ms per step (median of "
        f"{' '.join(f'{t:.3f}' for t in times)}), "
        f"{TRAIN_TOKENS / ms * 1e3:.1f} tokens/s, peak {peak:.2f} GiB "
        f"allocated; {launches} kernel launches per step, "
        f"{100 * busy:.1f}% busy; counted {flops:.4e} FLOPs "
        f"({flops / mflops:.3f} x 6 N D = {mflops:.4e}, N = {n}), "
        f"{nbytes:.4e} bytes over {ops} aten ops; bounds: compute "
        f"{rep.compute_s * 1e3:.3f} ms, memory {rep.memory_s * 1e3:.3f} ms "
        f"({rep.dominant}); the step at {100 * bound_ms / ms:.1f}% of the "
        f"larger; last loss {float(m['loss']):.4f}")
    return ms


def phase_train(dev, seed: int):
    """Phase 12: train Qwen3-0.6B whole through ``launch.train.main`` and
    resume it bit for bit (a), one f32 step against float64 (b), every
    family's reduced step (c), the bf16 step measured (d); B1/B2
    launches over the phase must be 0 (e)."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    gk.launches = sk.launches = 0
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build"))
    try:
        train_resume(dev, tmp, seed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    empty_cache(dev)
    t_a = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32",
                              param_dtype="float32")
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    b, s = TRAIN_CHECK
    batch = SyntheticTokenPipeline(cfg, b, s, seed=seed,
                                   device=dev).get_batch(0)
    check_train_step(f"(b) {TRAIN_ARCH} whole, {b} x {s}", dev, cfg,
                     params, batch)
    del params
    empty_cache(dev)
    t_b = time.perf_counter() - t0

    t0 = time.perf_counter()
    b, s = TRAIN_FAMILY_CHECK
    for name, ov in TRAIN_FAMILIES.items():
        cfg = get_config(name).reduced(**ov)
        params = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(seed))
        batch = SyntheticTokenPipeline(cfg, b, s, seed=seed,
                                       device=dev).get_batch(0)
        what = f"(c) {name} reduced ({cfg.family}), {b} x {s}"
        (loss, grads, norm), _ = check_train_step(what, dev, cfg, params,
                                                  batch)
        if cfg.n_experts:
            mesh = meshlib.make_host_mesh(1, cfg.n_experts, device=dev)
            (l_ep, g_ep, n_ep), _ = check_train_step(
                f"{what}, EP over a {mesh.axis_sizes} mesh", dev,
                dataclasses.replace(cfg, moe_a2a=True), params, batch,
                mesh=mesh)
            ep_err = max(float((a - c).double().norm() / c.double().norm())
                         for a, c in zip(tree_leaves(g_ep),
                                         tree_leaves(grads)))
            loss_err = abs(float(l_ep) - float(loss)) / abs(float(loss))
            log(f"phase 12 {what}: EP on against EP off on the card: loss "
                f"rel err {loss_err:.3e}, worst gradient rel L2 "
                f"{ep_err:.3e}")
            if loss_err > TRAIN_LOSS_RTOL or ep_err > TRAIN_GRAD_REL_L2:
                raise AssertionError(f"train {name}: EP on differs from "
                                     f"EP off ({loss_err}, {ep_err})")
        del params, grads
    t_c = time.perf_counter() - t0

    t0 = time.perf_counter()
    train_measure(dev, seed)
    empty_cache(dev)
    t_d = time.perf_counter() - t0
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    log(f"phase 12 launches {launches} (the train path calls no kernel); "
        f"(a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) {t_c:.1f} s, (d) "
        f"{t_d:.1f} s, phase {time.perf_counter() - t_phase:.1f} s")
    if any(launches.values()):
        raise AssertionError(f"train path launched {launches}")
    return launches


# --- phase 13 --------------------------------------------------------------

# (backend, world, device): nccl over every visible card (world None, each
# rank on cuda:{rank}), gloo worlds on card 0, each rank its own CUDA
# context, the buckets staged through pinned host memory
PM_GROUPS = (("nccl", None, None), ("gloo", 2, "cuda:0"),
             ("gloo", 4, "cuda:0"))
# warm timed calls per path (median); the gloo groups time one
PM_RUNS = {"nccl": 3, "gloo": 1}
PM_COLLECTIVE_S = 120              # init_process_group's timeout
PM_JOIN_S = 300                    # a group not done by then fails


def group_batches(groups):
    """Phase 13's groups in the batches they run in: the nccl group alone,
    then the gloo groups side by side (``run_side_by_side``)."""
    alone = [[g] for g in groups if g[0] != "gloo"]
    gloo = [g for g in groups if g[0] == "gloo"]
    return alone + ([gloo] if gloo else [])


def run_side_by_side(jobs: list) -> list:
    """Every job of a batch at once, each from a thread of this process,
    and their results in order. Phases 13, 14 and 16 run their gloo
    groups so: both worlds share card 0 and their ranks wait mostly on
    host collectives, so the two take about the longer one's time, and
    their timings (host-bound already) were taken side by side. A job
    that raises is raised once every job has ended."""
    from concurrent.futures import ThreadPoolExecutor
    if len(jobs) == 1:
        return [jobs[0]()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = [ex.submit(job) for job in jobs]
        return [f.result() for f in futures]


def run_groups(groups, spawn) -> list:
    """``spawn(backend, world, device)`` for each group, batch by batch
    (``group_batches``). Returns ``(backend, world, device, result,
    seconds)`` per group, in the groups' order."""
    import torch

    def timed_spawn(backend, world, device):
        world = torch.cuda.device_count() if world is None else world
        t0 = time.perf_counter()
        res = spawn(backend, world, device)
        return backend, world, device, res, time.perf_counter() - t0
    out = []
    for batch in group_batches(groups):
        out += run_side_by_side([lambda g=g: timed_spawn(*g) for g in batch])
    return out


def side_note(backend: str) -> str:
    """What a gloo group's summary line says of the group beside it."""
    return " (side by side with the other gloo group)" \
        if backend == "gloo" else ""


def pm_data(dev, seed: int, rows: tuple):
    """Phase 11's inputs, generated whole on this rank's card (same seeds)
    and cut to the rank's rows ``rows``: A (2^20 x 128 f32), the i32
    table I for MIN, Af = I - 2^19 as f32 (integer-valued, so every ADD
    is exact), and the replicated streams and values. Returns the slices,
    the streams (card and host) and the values."""
    import torch
    lo, hi = rows
    A, V, B = make_data(dev, LOOKUPS, seed)
    del V
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    Vi = torch.randint(-8, 8, (LOOKUPS, WIDTH), generator=gen, device=dev,
                       dtype=torch.int32)
    I = torch.randint(0, 2 ** 20, (ROWS, WIDTH), generator=gen, device=dev,
                      dtype=torch.int32)
    slices = {"A": A[lo:hi].clone(), "I": I[lo:hi].clone(),
              "Af": (I[lo:hi] - 2 ** 19).float()}
    del A, I
    host = {k: v.cpu().numpy() for k, v in B.items()}
    return slices, B, host, Vi, Vi.float()


def pm_expected(dev, seed: int, B, Vi, Vf):
    """The whole-table results on one card: A[idx] per stream, index_add
    into Af and scatter_reduce amin into I (the sequential results)."""
    import torch
    A, V, _ = make_data(dev, LOOKUPS, seed)
    del V
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    torch.randint(-8, 8, (LOOKUPS, WIDTH), generator=gen, device=dev,
                  dtype=torch.int32)
    I = torch.randint(0, 2 ** 20, (ROWS, WIDTH), generator=gen, device=dev,
                      dtype=torch.int32)
    zl = B["zipf"].long()
    want = {f"gather {k}": A.index_select(0, b.long())
            for k, b in B.items()}
    want["rmw ADD zipf"] = (I - 2 ** 19).float().index_add(0, zl, Vf)
    want["rmw MIN zipf i32"] = I.scatter_reduce(
        0, zl[:, None].expand(-1, WIDTH), Vi, "amin")
    return want


def pm_rank(rank, world, backend, device, seed):
    """One rank of phase 13 (spawned): its slices of phase 11's tables on
    its device, every call checked (its block or slice, the whole through
    ``gather_blocks`` for the RMWs and the zipf gather, ``ShardStats``
    against NumPy, B1/B2 launches), then the timed calls."""
    import statistics
    import torch.distributed as dist
    from repro_torch.core.device import synchronize
    from repro_torch.distributed import (ShardedEngine, gather_blocks,
                                         process_mesh)
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    mesh = process_mesh(device=device)
    dev = mesh.device
    eng = ShardedEngine(mesh, use_kernel=True)
    rows = eng.rank_rows(ROWS)
    t0 = time.perf_counter()
    tab, B, host, Vi, Vf = pm_data(dev, seed, rows)
    z = B["zipf"]
    empty_cache(dev)
    reset_peak(dev)
    calls = [(f"gather {k}", "gather", lambda b=b: eng.sharded_gather(
        tab["A"], b, n_rows=ROWS), host[k]) for k, b in B.items()]
    calls += [("rmw ADD zipf", "rmw", lambda: eng.sharded_rmw(
        tab["Af"], z, Vf, op="ADD", n_rows=ROWS), host["zipf"]),
              ("rmw MIN zipf i32", "rmw", lambda: eng.sharded_rmw(
                  tab["I"], z, Vi, op="MIN", n_rows=ROWS), host["zipf"])]
    got, launches = {}, {"row_table_gather": 0, "row_table_rmw": 0}
    for what, kind, fn, hidx in calls:
        g0, s0 = gk.launches, sk.launches
        out = fn()
        synchronize(dev)
        launched = {"row_table_gather": gk.launches - g0,
                    "row_table_rmw": sk.launches - s0}
        if launched != SHARD_CALL_LAUNCHES[kind]:
            raise AssertionError(f"rank {rank} {what}: launches {launched} "
                                 f"!= {SHARD_CALL_LAUNCHES[kind]}")
        for k, v in launched.items():
            launches[k] += v
        st = eng.last_shard_stats
        check_shard_stats(f"rank {rank} {what}", st, np_shard_counts(
            hidx, ROWS, world, st.placement))
        got[what] = (out, st.transport, st.collectives)
    peak = peak_gib(dev)
    setup_s = time.perf_counter() - t0
    # the checks: every rank's block / slice, and the whole via
    # gather_blocks where its size allows
    want = pm_expected(dev, seed, B, Vi, Vf)
    lo, hi = eng.rank_lanes(LOOKUPS)
    for what, (out, transport, coll) in got.items():
        if what.startswith("gather"):
            assert_match(f"rank {rank} {what} block", out,
                         want[what][lo:hi])
        else:
            assert_match(f"rank {rank} {what} slice", out,
                         want[what][rows[0]:rows[1]])
    for what in ("gather zipf", "rmw ADD zipf", "rmw MIN zipf i32"):
        assert_match(f"rank {rank} {what} whole (gather_blocks)",
                     gather_blocks(got[what][0], mesh), want[what])
    transport, collectives = got["gather zipf"][1:]
    del want, got
    empty_cache(dev)
    paths = {"gather zipf": calls[0][2], "rmw ADD zipf": calls[2][2]}
    times = {k: [] for k in paths}
    for _ in range(PM_RUNS[backend]):
        for k, fn in paths.items():
            dist.barrier()
            synchronize(dev)
            t = time.perf_counter()
            fn()
            synchronize(dev)
            times[k].append((time.perf_counter() - t) * 1e3)
    return {"rank": rank, "device": str(dev), "transport": transport,
            "collectives": collectives, "launches": launches,
            "peak_gib": peak, "rows": rows, "setup_s": setup_s,
            "ms": times, "median": {k: statistics.median(v)
                                    for k, v in times.items()}}


def phase_process_mesh(dev, seed: int, logical_ms: dict, groups=PM_GROUPS):
    """``ShardedEngine`` over a ``ProcessMesh``: one process per rank
    (spawned), each holding only its slice of phase 11's tables on its
    card, the exchange over torch.distributed: an nccl group over every
    visible card, then gloo worlds 2 and 4 on card 0 (buckets staged
    through pinned host memory). Gathers and integer-valued ADD / i32 MIN
    bit for bit (each rank's block or slice, and the whole through
    ``gather_blocks``), ``ShardStats`` against NumPy, one B1 or one B2
    launch per rank per call; then per group the warm median of PM_RUNS
    (slowest rank; one warm call in the gloo groups) beside phase 11's
    logical time at that mesh size, and each rank's peak memory. Returns
    each kernel's launches per group."""
    import tempfile
    from repro_torch.distributed.spawn import run_ranks
    empty_cache(dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {"row_table_gather": {}, "row_table_rmw": {}}

    def spawn(backend, world, device):
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            return run_ranks(pm_rank, world, args=(backend, device, seed),
                             backend=backend,
                             init_method=f"file://{tmp}/store",
                             timeout=PM_COLLECTIVE_S, join_timeout=PM_JOIN_S)
    for backend, world, device, ranks, wall in run_groups(groups, spawn):
        name = f"{backend}-{world}"
        for k in out:
            out[k][name] = sum(r["launches"][k] for r in ranks)
        ms = {k: [max(r["ms"][k][i] for r in ranks)
                  for i in range(PM_RUNS[backend])]
              for k in ranks[0]["ms"]}
        logical = logical_ms.get(world, {})
        for k, runs in ms.items():
            ref_k = {"gather zipf": "sharded gather",
                     "rmw ADD zipf": "sharded rmw ADD"}[k]
            beside = (f"{logical[ref_k]:.3f} ms" if ref_k in logical
                      else "not run")
            log(f"phase 13 {name} ({ranks[0]['transport']}) {k:13s} warm "
                f"median {sorted(runs)[len(runs) // 2]:9.3f} ms per call "
                f"(slowest rank), runs "
                f"{' '.join(f'{t:.3f}' for t in runs)}; phase 11 logical "
                f"mesh {world}: {beside}")
        log(f"phase 13 {name}: bit for bit on every rank and call; "
            f"ShardStats equal NumPy; launches per rank per call B1 1/0, "
            f"B2 0/1 ({out['row_table_gather'][name]} B1, "
            f"{out['row_table_rmw'][name]} B2 over 4 calls x {world} "
            f"ranks); {ranks[0]['collectives']} collectives per gather; "
            f"peak per rank "
            f"{[round(r['peak_gib'], 2) for r in ranks]} GiB allocated; "
            f"rows per rank {[r['rows'] for r in ranks]}; devices "
            f"{sorted({r['device'] for r in ranks})}; {wall:.1f} s"
            f"{side_note(backend)}")
    return out


# --- phase 14 --------------------------------------------------------------

# the gloo groups (host-staged collectives, ~0.5-1.2 s a sharded call)
# keep every size and cut depth only; the nccl group runs the full depth
# (hashjoin's depth is its probe windows: 2^22 probes are 64 windows of
# 4 tiles, each all-gathering its programs' whole-stream OUT regions)
PS_GLOO_CUTS = {"spmv_cg": {"iters": 1}, "spmv_block": {"iters": 1},
                "bfs": {"levels": 2}, "hashjoin": {"n_probe": 2 ** 20},
                "embedding_bag": {"n_steps": 1}, "kv_serve": {"n_steps": 2}}
# the apps whose tables are 2-D (B1 per sharded gather node, B2 per
# sharded RMW node); the 1-D apps launch neither
PS_2D = ("spmv_block", "embedding_bag", "kv_serve")


def served_launches(report, rank, is_2d) -> dict:
    """The B1/B2 launches one window's plan calls for on this rank: one
    per sharded gather / RMW node of a 2-D table (``is_2d(table_id)``) in
    which the rank serves rows (``ShardStats.received``: a rank that owns
    none of a node's rows launches nothing for it)."""
    out = {"row_table_gather": 0, "row_table_rmw": 0}
    for n in report.plan.roots:
        if n.kind != "sharded" or not is_2d(n.inner.table_id):
            continue
        g = n.inner
        st = report.shard_stats.get(g.table_id if g.kind == "gather"
                                    else ("rmw", g.table_id, g.op))
        if st is not None and int(st.received[rank]) > 0:
            out["row_table_gather" if g.kind == "gather"
                else "row_table_rmw"] += 1
    return out


def _add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def ps_sizes(cut: bool) -> dict:
    """Phase 8's sizes, with the gloo groups' cuts of depth."""
    sizes = {k: dict(v) for k, v in APP_SIZES.items()}
    if cut:
        for name, c in PS_GLOO_CUTS.items():
            sizes[name].update(c)
    return sizes


def ps_window(rank, dev, mesh, seed, runs):
    """Phase 6's multi-tenant window over the process mesh: A and G
    row-sharded (each rank submits its slices), the gather programs over
    the whole A every rank holds (one batched group, split across the
    ranks). Checked bit for bit on this rank (integer-valued G and
    values): every gather whole against A[idx], G's slice against
    index_add_ on the whole G, each program's out against A[B]; B1/B2
    launches per rank. Then the warm window time."""
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import AccessService
    A = make_data(dev, LOOKUPS, seed)[0]
    data = window_data(dev, seed, integer_values=True)
    win = Window(dev, A, data)
    svc = AccessService(mesh=mesh, use_kernel=True, auto_flush=0,
                        tile_size=TILE)
    sched, eng = svc.scheduler, svc.scheduler.engine
    lo, hi = eng.rank_rows(ROWS)
    A_s, G_s = A[lo:hi], data["G"][lo:hi].clone()

    def submit():
        d, out = data, {"program": [], "gather": [], "rmw": []}
        for t in range(TENANTS):
            name = f"core{t}"
            out["program"].append(sched.submit(win.prog, win.env(t),
                                               win.regs, tenant=name))
            out["gather"].append(sched.submit_gather(
                A_s, d["gather"][t], tenant=name, n_rows=ROWS))
            out["rmw"].append(sched.submit_rmw(
                G_s, d["rmw"][t], d["vals"][t], op="ADD", tenant=name,
                n_rows=ROWS))
        return out

    tickets = submit()
    gk.launches = 0
    sk.launches = 0
    c0, a0 = eng.collectives, sched.stats["agreements"]
    report = sched.flush()
    sync()
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    collectives = eng.collectives - c0
    agreements = sched.stats["agreements"] - a0
    results = redeem(sched, tickets)
    kinds = sorted((n.kind, getattr(getattr(n, "inner", None), "kind", None))
                   for n in report.plan.roots)
    if kinds != [("program_group", None), ("sharded", "gather"),
                 ("sharded", "rmw")] or not report.groups[0].vmapped:
        raise AssertionError(f"rank {rank}: unexpected window plan {kinds}")
    want = {"row_table_gather": 2, "row_table_rmw": 1}
    if launches != want:
        raise AssertionError(f"rank {rank} window launches {launches}, "
                             f"want {want} (the sharded gather and the "
                             "group's batched ILD; the sharded RMW)")
    for t, got in enumerate(results["gather"]):
        assert_match(f"rank {rank} window gather core{t} vs A[idx]", got,
                     A[data["gather"][t].long()])
    want_g = data["G"].clone().index_add_(
        0, torch.cat(data["rmw"]).long(), torch.cat(data["vals"]))[lo:hi]
    for t, got in enumerate(results["rmw"]):
        assert_match(f"rank {rank} window rmw core{t} slice vs index_add_",
                     got, want_g)
    for t, (env, _) in enumerate(results["program"]):
        assert_match(f"rank {rank} window program core{t} out vs A[B]",
                     env["out"], A[data["prog_B"][t].long()])
    del results, want_g
    times = []
    for _ in range(runs):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        tickets = submit()
        sched.flush()
        redeem(sched, tickets)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    del A, data, win, svc, sched, eng, A_s, G_s
    empty_cache(dev)
    return {"launches": launches, "collectives": collectives,
            "agreements": agreements, "ms": times,
            "median": statistics.median(times)}


def ps_app(rank, dev, mesh, case):
    """One app pipelined through ``AccessService(mesh=ProcessMesh,
    use_kernel=True)``: the checked run's result digest and time, its
    B1/B2 launches beside the sharded nodes of the windows it flushed
    (all of them, and those in which this rank serves rows: a rank that
    owns none of a node's rows has nothing to gather or update, and
    launches nothing for it), its windows, collectives and agreements.
    No warm run: the checked run is the time every group reports."""
    import torch.distributed as dist
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import AccessService
    prob = case.make()
    svc = AccessService(mesh=mesh, use_kernel=True, auto_flush=0,
                        tile_size=TILE)
    sched, eng = svc.scheduler, svc.scheduler.engine
    nodes = {"gather": 0, "rmw": 0}
    served = {"row_table_gather": 0, "row_table_rmw": 0}
    flush_async = sched.flush_async

    def counted(**kw):
        nonlocal served
        handle = flush_async(**kw)
        rep = handle.report
        for n in rep.plan.roots:
            if n.kind == "sharded":
                nodes[n.inner.kind] += 1
        served = _add(served, served_launches(rep, eng.rank,
                                              lambda i: True))
        return handle
    sched.flush_async = counted
    gk.launches = 0
    sk.launches = 0
    c0 = eng.collectives
    dist.barrier()
    got, ms = timed(lambda: case.run(prob, mode="pipelined",
                                     service=svc))
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    out = {"digest": result_digest(got), "launches": launches,
           "nodes": nodes, "served": served,
           "windows": sched.stats["flushes"],
           "collectives": eng.collectives - c0,
           "agreements": sched.stats["agreements"],
           "agreement_ms": 1e3 * sched.stats["agreement_s"], "ms": ms}
    del got, prob, svc
    empty_cache(dev)
    return out


def ps_rank(rank, world, backend, device, seed, cut):
    """One rank of phase 14 (spawned): the window, then the six app
    configurations (with the gloo groups' cuts when ``cut``)."""
    import torch
    from repro_torch.distributed import process_mesh
    mesh = process_mesh(device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)     # a gloo rank's context, before stats
    t0 = time.perf_counter()
    empty_cache(dev)
    reset_peak(dev)
    out = {"rank": rank, "device": str(dev),
           "window": ps_window(rank, dev, mesh, seed, 1), "apps": {}}
    for case in app_cases(seed, ps_sizes(cut)):
        out["apps"][case.name] = ps_app(rank, dev, mesh, case)
    out["peak_gib"] = peak_gib(dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_process_service(dev, seed: int, groups=PM_GROUPS):
    """The Scheduler, AccessService and the apps over a ProcessMesh, SPMD:
    per group (phase 13's: nccl over every card, gloo worlds 2 and 4 on
    card 0) the multi-tenant window of phase 6 (bit for bit on every rank,
    B1 2 and B2 1 per rank: the sharded gather, the group's batched ILD,
    the sharded RMW) and the six app configurations of phase 8 pipelined
    through ``AccessService(mesh=ProcessMesh, use_kernel=True)`` (each
    rank's result digest that of the host oracle; per rank B1 once per
    sharded gather node and B2 once per sharded RMW node of a 2-D app in
    which the rank serves rows, none for the 1-D apps). The gloo groups cut depth (``PS_GLOO_CUTS``).
    Prints per group the slowest rank's warm time beside phase 8's
    pipelined and phase 11's 4-shard times, peak memory per rank,
    collectives and agreements per window, B1/B2 per rank. Returns each
    kernel's launches per group and rank (window and apps summed)."""
    import tempfile
    from repro_torch.distributed.spawn import run_ranks
    empty_cache(dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    oracles = {}
    for cut in sorted({backend == "gloo" for backend, _, _ in groups}):
        for case in app_cases(seed, ps_sizes(cut)):
            if not cut and case.name in APP_RESULTS:
                oracles[(cut, case.name)] = APP_RESULTS[case.name]["digest"]
                continue
            t0 = time.perf_counter()
            oracles[(cut, case.name)] = result_digest(case.oracle(
                case.make()))
            log(f"phase 14 oracle {case.name}{' (cut)' if cut else ''}: "
                f"{time.perf_counter() - t0:.1f} s")
    for name, c in PS_GLOO_CUTS.items():
        log(f"reduced phase 14 gloo groups {name}: "
            + ", ".join(f"{k} {APP_SIZES[name][k]} -> {v}"
                        for k, v in c.items()))
    out = {"row_table_gather": {}, "row_table_rmw": {}}

    def spawn(backend, world, device):
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            return run_ranks(ps_rank, world,
                             args=(backend, device, seed, backend == "gloo"),
                             backend=backend,
                             init_method=f"file://{tmp}/store",
                             timeout=PM_COLLECTIVE_S,
                             join_timeout=PM_JOIN_S)
    for backend, world, device, ranks, wall in run_groups(groups, spawn):
        cut = backend == "gloo"
        name = f"{backend}-{world}"
        for k in out:
            out[k][name] = [r["window"]["launches"][k] + sum(
                a["launches"][k] for a in r["apps"].values())
                for r in ranks]
        w = [r["window"] for r in ranks]
        log(f"phase 14 {name} window: bit for bit on every rank; B1/B2 "
            f"per rank {[tuple(x['launches'].values()) for x in w]}; "
            f"collectives {w[0]['collectives']}, agreements "
            f"{w[0]['agreements']}; warm (slowest rank) "
            + " ".join(f"{max(x['ms'][i] for x in w):.3f}"
                       for i in range(len(w[0]['ms'])))
            + f" ms; phase 6 (one device, float values) in this run's log")
        for app in ranks[0]["apps"]:
            rs = [r["apps"][app] for r in ranks]
            bad = [r for r, a in enumerate(rs)
                   if a["digest"] != oracles[(cut, app)]]
            if bad:
                raise AssertionError(f"phase 14 {name} {app}: rank(s) {bad} "
                                     "not bit for bit the host oracle")
            for r, a in enumerate(rs):
                want = a["served"] if app in PS_2D else \
                    {"row_table_gather": 0, "row_table_rmw": 0}
                if a["launches"] != want:
                    raise AssertionError(
                        f"phase 14 {name} {app} rank {r}: launches "
                        f"{a['launches']}, the plans' sharded nodes in "
                        f"which it serves rows call for {want} (of "
                        f"{a['nodes']})")
            slowest = max(a["ms"] for a in rs)
            p8 = APP_RESULTS.get(app, {}).get("ms")
            p11 = SHARD_APP_MS.get(app)
            log(f"phase 14 {name} {app:13s} checked run (slowest rank) "
                f"{slowest:10.3f} ms"
                f"{' (cut depth)' if cut and app in PS_GLOO_CUTS else ''}; "
                f"phase 8 "
                f"pipelined {'%.3f ms' % p8 if p8 else 'not run'}; phase "
                f"11 4-shard {'%.3f ms' % p11 if p11 else 'not run'}; "
                f"B1/B2 per rank "
                f"{[tuple(a['launches'].values()) for a in rs]} (sharded "
                f"gather/RMW nodes {tuple(rs[0]['nodes'].values())}); "
                f"{rs[0]['windows']} windows, "
                f"{rs[0]['collectives'] / max(rs[0]['windows'], 1):.1f} "
                f"collectives and "
                f"{rs[0]['agreements'] / max(rs[0]['windows'], 1):.1f} "
                f"agreements per window, agreement host ms per window "
                f"(max over ranks) "
                f"{max(a['agreement_ms'] / max(a['windows'], 1) for a in rs):.3f}")
        log(f"phase 14 {name}: every app bit for bit its oracle on every "
            f"rank; peak per rank {[round(r['peak_gib'], 2) for r in ranks]}"
            f" GiB allocated; devices {sorted({r['device'] for r in ranks})};"
            f" ranks {[round(r['seconds'], 1) for r in ranks]} s; "
            f"{wall:.1f} s{side_note(backend)}")
    return out


# --- phase 15 --------------------------------------------------------------

# the gloo groups (host-staged collectives, ~1-1.7 s a decode step) keep
# every width and cut depth: the trace's events (its tables stay whole)
# and the pool's decode steps
PV_GLOO_CUTS = {"n_events": 500, "n_steps": 8}


def pv_replay(rank, dev, mesh, n_events):
    """Phase 9b's trace replayed SPMD over the process mesh: each rank
    cuts every table to its rows on its card (the 256 MiB pool K0
    included), flushes are wall-measured (each window's duration agreed:
    the slowest rank's), the hottest tenant capped at 2 pending. Every
    ticket checked on this rank (gathers whole, RMWs its rows), the window
    log's digest returned for the parent to hold equal across ranks, and
    B1/B2 against the plans' sharded 2-D nodes this rank serves."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import (AccessService, AdaptiveFlushController,
                                   TrafficConfig, VirtualClock,
                                   generate_trace, replay_trace)
    t0 = time.perf_counter()
    trace = generate_trace(TrafficConfig(**{**KV_TRACE,
                                            "n_events": n_events}))
    host = dict(trace.tables)
    gen_s = time.perf_counter() - t0
    svc = AccessService(mesh=mesh, use_kernel=True, auto_flush=0,
                        tile_size=TILE, controller=AdaptiveFlushController(),
                        clock=VirtualClock())
    sched, eng = svc.scheduler, svc.scheduler.engine
    ndim = {}                         # id(submitted table) -> its ndim

    def noting(submit):
        def sub(table, *a, **kw):
            ndim[id(table)] = table.ndim
            return submit(table, *a, **kw)
        return sub
    sched.submit_gather = noting(sched.submit_gather)
    sched.submit_rmw = noting(sched.submit_rmw)
    counts = {}
    for e in trace.events:
        counts[e.tenant] = counts.get(e.tenant, 0) + 1
    svc.connect(max(counts, key=counts.get), max_pending=2)  # rejections
    empty_cache(dev)
    reset_peak(dev)
    gk.launches = sk.launches = 0
    c0 = eng.collectives
    dist.barrier()
    res, ms = timed(lambda: replay_trace(trace, svc))
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    peak = peak_gib(dev)
    collectives = eng.collectives - c0
    want = {"row_table_gather": 0, "row_table_rmw": 0}
    for _, rep in res.windows:
        want = _add(want, served_launches(rep, rank,
                                          lambda i: ndim.get(i) == 2))
    if launches != want:
        raise AssertionError(f"rank {rank} replay launches {launches}, the "
                             f"plans' sharded 2-D nodes it serves call for "
                             f"{want}")
    lo, hi = eng.rank_rows(host["K0"].shape[0])
    k0 = torch.as_tensor(host["K0"][lo:hi], device=dev)
    t1 = time.perf_counter()
    n = check_replay(dev, trace, host, svc, res, k0,
                     rank_rows=eng.rank_rows)
    if n != len(res.tickets) or not res.rejected:
        raise AssertionError(f"rank {rank} replay: {n} of "
                             f"{len(res.tickets)} checked, "
                             f"{len(res.rejected)} rejected")
    summ = svc.telemetry.summary()
    log_digest = hashlib.sha256(repr((
        [(s, rep.order) for s, rep in res.windows],
        [t.tid for _, t in res.tickets], [t.tid for _, t in res.rejected],
        res.makespan_us, summ)).encode()).hexdigest()[:16]
    out = {"ms": ms, "gen_s": gen_s, "check_s": time.perf_counter() - t1,
           "windows": res.n_flushes, "tickets": n,
           "rejected": len(res.rejected),
           "depth": (float(np.mean([len(r.order) for _, r in res.windows])),
                     max(len(r.order) for _, r in res.windows)),
           "p50": summ["overall"]["p50_us"], "p99": summ["overall"]["p99_us"],
           "makespan": res.makespan_us, "log": log_digest,
           "launches": launches, "peak_gib": peak,
           "pool_mib": k0.numel() * 4 / 2 ** 20,
           "collectives": collectives,
           "agreements": sched.stats["agreements"],
           "agreement_ms": 1e3 * sched.stats["agreement_s"]}
    del res, trace, svc, sched, eng, k0, host
    empty_cache(dev)
    return out


def pv_kvpool(rank, dev, mesh, seed, n_steps):
    """Phase 9c's KvPoolServer over the process mesh: each rank holds only
    its rows of the pool, re-cut at every growth; every history (whole on
    every rank) bit for bit the NumPy model's rows, the rank's final slice
    the model pool's rows, the growths the model's; B1/B2 against the
    plans' sharded nodes this rank serves."""
    import statistics
    import numpy as np
    import torch.distributed as dist
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    from repro_torch.serve import AccessService, KvPoolServer
    c = KVPOOL
    p, w = c["page_size"], 2 * c["d"]
    prefix, prompts, steps = kvpool_problem(seed)
    init_pages = c["prefix_tokens"] // p + sum(-(-x.shape[0] // p)
                                               for x in prompts)
    svc = AccessService(mesh=mesh, use_kernel=True, auto_flush=0,
                        tile_size=TILE)
    sched, eng = svc.scheduler, svc.scheduler.engine
    srv = KvPoolServer(page_size=p, d=c["d"], growth_pages=c["growth_pages"],
                       init_pages=init_pages, service=svc)
    model = KvPoolModel(p, c["growth_pages"], init_pages)
    names = [f"s{i}" for i in range(c["n_seqs"])]
    want = {"row_table_gather": 0, "row_table_rmw": 0}
    flush_async = sched.flush_async

    def counted(**kw):
        nonlocal want
        handle = flush_async(**kw)
        want = _add(want, served_launches(handle.report, rank,
                                          lambda i: True))
        return handle
    sched.flush_async = counted
    empty_cache(dev)
    reset_peak(dev)
    gk.launches = sk.launches = 0
    c0, w0 = eng.collectives, sched.stats["flushes"]
    dist.barrier()
    t0 = time.perf_counter()
    srv.create_prefix("sys", prefix)
    shared = model.alloc(c["prefix_tokens"] // p)
    for i, name in enumerate(names):
        srv.admit(name, f"tenant{i % c['n_tenants']}", prompts[i],
                  prefix="sys")
        model.admit(name, shared, prefix, prompts[i])
    sync()
    admit_ms = (time.perf_counter() - t0) * 1e3
    grown_admit = srv.stats()["growths"]
    step_ms, check_s = [], 0.0
    for t in range(n_steps):
        new = {name: steps[t, i] for i, name in enumerate(names)}
        dist.barrier()
        (hists, _), ms = timed(lambda: srv.decode_batch(new))
        step_ms.append(ms)
        t1 = time.perf_counter()
        for name in names:
            if not np.array_equal(hists[name].cpu().numpy(),
                                  model.rows[name]):
                raise AssertionError(f"rank {rank} kv pool step {t} "
                                     f"{name}: history not bit for bit "
                                     "the NumPy model's")
            model.append(name, new[name])
        check_s += time.perf_counter() - t1
        del hists
    launches = {"row_table_gather": gk.launches,
                "row_table_rmw": sk.launches}
    sched.flush_async = flush_async
    st = srv.stats()
    lo, hi = st["rank_rows"]
    if not np.array_equal(srv.pool.cpu().numpy(), model.pool(w)[lo:hi]):
        raise AssertionError(f"rank {rank} kv pool: its final slice is not "
                             "the NumPy model pool's rows")
    if st["growths"] <= grown_admit or st["cap_pages"] != model.cap \
            or st["growths"] != model.growths:
        raise AssertionError(f"rank {rank} kv pool did not grow while "
                             f"decoding as the model did: {st}, "
                             f"{grown_admit} growths at admission, model "
                             f"{model.cap} pages, {model.growths} growths")
    if launches != want:
        raise AssertionError(f"rank {rank} kv pool launches {launches}, the "
                             f"plans' sharded nodes it serves call for "
                             f"{want}")
    out = {"admit_ms": admit_ms, "ms": step_ms,
           "median": statistics.median(step_ms), "check_s": check_s,
           "stats": st, "launches": launches, "peak_gib": peak_gib(dev),
           "pool_mib": srv.pool.numel() * 4 / 2 ** 20,
           "windows": sched.stats["flushes"] - w0,
           "collectives": eng.collectives - c0,
           "agreements": sched.stats["agreements"]}
    del srv, model, svc, sched, eng
    empty_cache(dev)
    return out


def pv_rank(rank, world, backend, device, seed, cut):
    """One rank of phase 15 (spawned): the replay, then the KV pool (with
    the gloo groups' cuts of depth when ``cut``)."""
    import torch
    from repro_torch.distributed import process_mesh
    mesh = process_mesh(device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)     # a gloo rank's context, before stats
    depth = {"n_events": KV_TRACE["n_events"], "n_steps": KVPOOL["n_steps"],
             **(PV_GLOO_CUTS if cut else {})}
    t0 = time.perf_counter()
    out = {"rank": rank, "device": str(dev),
           "replay": pv_replay(rank, dev, mesh, depth["n_events"]),
           "kvpool": pv_kvpool(rank, dev, mesh, seed, depth["n_steps"])}
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_process_serving(dev, seed: int, groups=PM_GROUPS):
    """``replay_trace`` and ``KvPoolServer`` over a ProcessMesh, SPMD, in
    phase 13's groups: (a) phase 9b's trace with wall-measured flushes
    (every rank's window log equal, every ticket checked on every rank),
    (b) phase 9c's KV pool (every history bit for bit the NumPy model's,
    each rank's slice the model pool's rows, growths the model's), B1/B2
    per rank those of the plans' sharded 2-D nodes it serves. The gloo
    groups cut depth (``PV_GLOO_CUTS``). Prints per group the slowest
    rank's times beside phases 9b and 9c, peak and pool bytes per rank,
    rows moved per growth, collectives and agreements per window, B1/B2
    per rank. Returns each kernel's launches per group and rank."""
    import statistics
    import tempfile
    import torch
    from repro_torch.distributed.spawn import run_ranks
    empty_cache(dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    whole = {"n_events": KV_TRACE["n_events"], "n_steps": KVPOOL["n_steps"]}
    log("reduced phase 15 gloo groups: " + ", ".join(
        f"{k} {whole[k]} -> {v}" for k, v in PV_GLOO_CUTS.items()))
    p9b = SERVING_RESULTS.get("replay")
    p9c = SERVING_RESULTS.get("kvpool")
    out = {"row_table_gather": {}, "row_table_rmw": {}}
    for backend, world, device in groups:
        world = torch.cuda.device_count() if world is None else world
        cut = backend == "gloo"
        name = f"{backend}-{world}"
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            ranks = run_ranks(pv_rank, world,
                              args=(backend, device, seed, cut),
                              backend=backend,
                              init_method=f"file://{tmp}/store",
                              timeout=PM_COLLECTIVE_S,
                              join_timeout=PM_JOIN_S)
        wall = time.perf_counter() - t0
        for k in out:
            out[k][name] = [r["replay"]["launches"][k]
                            + r["kvpool"]["launches"][k] for r in ranks]
            for part in ("replay", "kvpool"):
                if not sum(r[part]["launches"][k] for r in ranks):
                    raise AssertionError(f"phase 15 {name} {part}: no rank "
                                         f"launched {k}")
        rp = [r["replay"] for r in ranks]
        logs = {x["log"] for x in rp}
        if len(logs) != 1:
            raise AssertionError(f"phase 15 {name}: the ranks' window logs "
                                 f"differ ({logs})")
        nw = rp[0]["windows"]
        beside = (f"phase 9b {p9b['ms']:.1f} ms wall, p50 "
                  f"{p9b['p50']:.1f} us, p99 {p9b['p99']:.1f} us, "
                  f"{p9b['windows']} windows" if p9b else "phase 9b not run")
        log(f"phase 15 {name} replay: "
            f"{max(x['ms'] for x in rp):.1f} ms wall (slowest rank), {nw} "
            f"windows (mean depth {rp[0]['depth'][0]:.2f}, max "
            f"{rp[0]['depth'][1]}), {rp[0]['tickets']} tickets, "
            f"{rp[0]['rejected']} rejected; virtual p50 {rp[0]['p50']:.1f} "
            f"us p99 {rp[0]['p99']:.1f} us, makespan "
            f"{rp[0]['makespan']:.0f} us; window log {rp[0]['log']} on every "
            f"rank; {beside}")
        log(f"phase 15 {name} replay: every ticket checked on every rank "
            f"(check {max(x['check_s'] for x in rp):.1f} s, generation "
            f"{max(x['gen_s'] for x in rp):.1f} s); B1/B2 per rank "
            f"{[tuple(x['launches'].values()) for x in rp]}; per window "
            f"{rp[0]['collectives'] / max(nw, 1):.1f} collectives, "
            f"{(rp[0]['agreements'] + nw) / max(nw, 1):.1f} agreements "
            f"(the plan's and the flush duration's), plan agreement host ms "
            f"(max over ranks) "
            f"{max(x['agreement_ms'] for x in rp) / max(nw, 1):.3f}; K0 "
            f"slice per rank {[round(x['pool_mib'], 1) for x in rp]} MiB; "
            f"peak per rank {[round(x['peak_gib'], 2) for x in rp]} GiB")
        kv = [r["kvpool"] for r in ranks]
        slowest = [max(x["ms"][i] for x in kv) for i in range(len(kv[0]["ms"]))]
        st = kv[0]["stats"]
        beside = (f"phase 9c {statistics.median(p9c['ms']):.1f} ms median, "
                  f"{p9c['growths']} growths" if p9c else "phase 9c not run")
        log(f"phase 15 {name} kv pool{' (cut depth)' if cut else ''}: "
            f"decode_batch ms (slowest rank) "
            f"{' '.join(f'{x:.1f}' for x in slowest)}, median "
            f"{statistics.median(slowest):.1f}; admission "
            f"{max(x['admit_ms'] for x in kv):.1f} ms; {beside}; pool "
            f"{st['cap_pages']} pages, {st['growths']} growths (the model's)")
        log(f"phase 15 {name} kv pool: every history and slice bit for bit "
            f"on every rank (check {max(x['check_s'] for x in kv):.1f} s); "
            f"rows per rank {[x['stats']['rank_rows'] for x in kv]}, slice "
            f"{[round(x['pool_mib'], 1) for x in kv]} MiB; rows moved per "
            f"growth (sent, received) "
            f"{[tuple(round(m / st['growths'], 1) for m in x['stats']['moved_rows']) for x in kv]}"
            f", growth collectives {st['growth_collectives']}; per window "
            f"{kv[0]['collectives'] / max(kv[0]['windows'], 1):.1f} "
            f"collectives, "
            f"{kv[0]['agreements'] / max(kv[0]['windows'], 1):.1f} "
            f"agreements; B1/B2 per rank "
            f"{[tuple(x['launches'].values()) for x in kv]}; peak per rank "
            f"{[round(x['peak_gib'], 2) for x in kv]} GiB")
        log(f"phase 15 {name}: devices {sorted({r['device'] for r in ranks})}"
            f"; ranks {[round(r['seconds'], 1) for r in ranks]} s; "
            f"{wall:.1f} s")
    return out


# --- phase 16 --------------------------------------------------------------

TRAIN_CHECK_MESH = (2, 128)        # (b): batch x seq of the f32 step
# the one-step checks of phases 16-18 start from AdamW's state at this
# step, past the schedule's warmup of 100, so that lr > 0 and the params
# move (at step 0 the lr is 0 and only the moments carry the gradient)
TRAIN_CHECK_STEP = 200
TM_DROP_CF = 0.5                   # (c): the GSPMD MoE's capacity factor
# (d): warm timed bf16 steps (median); the gloo groups time one
TM_TIMED = {"nccl": 3, "gloo": 1}
TM_JOIN_S = 900                    # a group not done by then fails
TM_GLOO_LAYERS = 4                 # the gloo groups' (a)/(d) depth (of 28)
TM_RESULTS: dict = {}              # (d) per group, printed beside phase 17's


def tm_shapes(world: int):
    """(data, model) of the group's mesh, and of the mesh its elastic
    restore lands on (none at world 1)."""
    if world == 1:
        return (1, 1), None
    return (world // 2, 2), (world, 1)


def tm_template(cfg):
    """Whole-leaf shapes of a params/optimizer state (elastic restore's
    template): fake tensors, no storage."""
    from repro_torch.launch.dryrun import abstract_params
    _, shapes, _ = abstract_params(cfg)
    return {"params": shapes, "opt": {"mu": shapes, "nu": shapes,
                                      "step": None}}


def tm_held(step, template, params, opt) -> int:
    """Bytes the rank's params and moments hold; raises unless every leaf
    is its shard (the shape under the step's specs, a storage of that
    many bytes): no sharded leaf held whole."""
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.launch import mesh as meshlib
    mesh = step.mesh
    total = 0
    for tree, specs in ((params, step.in_specs[0]),
                        (opt["mu"], step.in_specs[1]["mu"]),
                        (opt["nu"], step.in_specs[1]["nu"])):
        spec_of = dict(tree_leaves_with_path(specs, is_leaf=meshlib.is_spec))
        full = dict(tree_leaves_with_path(template))
        for p, t in tree_leaves_with_path(tree):
            want = meshlib.shard_shape(tuple(full[p].shape), spec_of[p],
                                       mesh)
            nbytes = t.untyped_storage().nbytes()
            if tuple(t.shape) != want or \
                    nbytes != t.numel() * t.element_size():
                raise AssertionError(
                    f"rank {mesh.rank} {'/'.join(map(str, p))}: shape "
                    f"{tuple(t.shape)} ({nbytes} bytes held), its shard is "
                    f"{want}")
            total += nbytes
    return total


def tm_collectives(stats: dict):
    """Count every collective of ``distributed.exchange`` the train step
    calls (the layers', the loss's, the step's): calls, payload bytes and
    time, each bracketed by device synchronisations. Returns the undo."""
    from repro_torch.core.device import synchronize
    from repro_torch.distributed import exchange
    real = {k: getattr(exchange, k) for k in
            ("all_reduce", "all_gather", "reduce_scatter")}

    def wrap(name, fn):
        def counted(x, mesh, *a, **kw):
            synchronize(x.device)
            t = time.perf_counter()
            out = fn(x, mesh, *a, **kw)
            synchronize(x.device)
            stats["s"] += time.perf_counter() - t
            stats["calls"][name] = stats["calls"].get(name, 0) + 1
            stats["bytes"] += x.numel() * x.element_size()
            return out
        return counted
    for k, fn in real.items():
        setattr(exchange, k, wrap(k, fn))
    return lambda: [setattr(exchange, k, fn) for k, fn in real.items()]


def tm_saved(directory: Path, step: int):
    """``(key, tensor)`` of every leaf of a saved step, read one leaf at a
    time (the elastic check's independent reader; the loader's hash
    checks already ran in ``elastic_restore``)."""
    import numpy as np
    from repro_torch.train import checkpoint as ckpt
    path = directory / f"step_{step}"
    entries = json.loads((path / "manifest.json").read_text())["entries"]
    for sid in sorted({e["shard"] for e in entries.values()}):
        with np.load(path / f"shard_{sid}.npz") as z:
            for key in z.files:
                yield key, ckpt._decode(z[key], entries[key]["dtype"])


def tm_train(rank, device, seed, tmp: Path, cfg, *, timed: int,
             elastic: bool = True, seq: int = 512) -> dict:
    """(a) and (d) on one rank: ``cfg`` (phase 16: Qwen3-0.6B, phase 17:
    SeamlessM4T-large-v2, phase 18: RWKV-6) in bf16 at 8 x ``seq`` on the
    group's mesh
    (``Trainer(mesh=...)``), steps 0-1, a checkpoint at step 2 from the
    mesh, step 2; a resume from it on the same mesh whose step 2 must
    equal bit for bit (deterministic mode); then, in the default mode,
    ``timed`` timed steps and, over several ranks, one step whose
    collectives are counted and timed; then, with ``elastic``,
    ``elastic_restore`` of step 2 onto the other shape: every leaf the
    checkpoint's whole leaf's slice, one finite step."""
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch.core.tree import tree_leaves_with_path, path_key
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.train.trainer import Trainer
    t_start = time.perf_counter()
    shape, other = tm_shapes(dist.get_world_size())
    mesh = meshlib.make_process_mesh(shape, ("data", "model"), device=device)
    dev = mesh.device
    template = tm_template(cfg)
    model = build_model(cfg, device=dev)
    total = 4 + timed

    def trainer_on(m):
        return Trainer(model=model, mesh=m, warmup=1, total_steps=total)
    pipe = SyntheticTokenPipeline(cfg, 8, seq, seed=seed, device=dev)
    step = trainer_on(mesh).jitted_step(pipe.get_batch(0))
    batch = lambda i: meshlib.batch_block(pipe.get_batch(i),
                                          step.in_specs[2], mesh)
    other = other if elastic else None
    out = {"shape": shape, "other": other, "device": str(dev)}
    empty_cache(dev)
    reset_peak(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    params, opt = trainer_on(mesh).init_state(seed)
    out["init_s"] = time.perf_counter() - t_start
    out["held"] = tm_held(step, template["params"], params, opt)
    losses = []
    for i in range(2):
        params, opt, m = step(params, opt, batch(i))
        losses.append(float(m["loss"]))
    specs = {"params": step.in_specs[0], "opt": step.in_specs[1]}
    t0 = time.perf_counter()
    ckpt.save_checkpoint(str(tmp / "ckpt"), 2, {"params": params,
                                                "opt": opt},
                         mesh=mesh, specs=specs,
                         extra=pipe.cursor_state(2))
    out["save_s"] = time.perf_counter() - t0
    params, opt, m = step(params, opt, batch(2))
    losses.append(float(m["loss"]))
    t0 = time.perf_counter()
    state, _, at = elastic_restore(str(tmp / "ckpt"), template, mesh)
    out["load_s"] = time.perf_counter() - t0
    p2, o2, m2 = step(state["params"], state["opt"], batch(2))
    del state
    pairs = list(zip(tree_leaves_with_path({"params": params, "opt": opt}),
                     tree_leaves_with_path({"params": p2, "opt": o2})))
    differ = [path_key(p) for (p, a), (_, b) in pairs
              if not torch.equal(a, b)]
    if differ or float(m2["loss"]) != losses[-1] or at != 2:
        raise AssertionError(f"rank {rank}: the resume from step 2 differs "
                             f"on {len(differ)} of {len(pairs)} leaves "
                             f"({differ[:4]}), loss {float(m2['loss'])} "
                             f"against {losses[-1]}")
    out.update(losses=losses, leaves=len(pairs),
               held_after=tm_held(step, template["params"], params, opt),
               resume_s=time.perf_counter() - t_start - out["init_s"])
    del p2, o2, pairs
    torch.use_deterministic_algorithms(False)
    empty_cache(dev)
    reset_peak(dev)
    times = []
    for i in range(3, 3 + timed):
        b = batch(i)
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    stats = {"s": 0.0, "calls": {}, "bytes": 0, "step_ms": times[-1]}
    if mesh.size > 1:                  # one rank makes no collective
        b = batch(3 + timed)
        undo = tm_collectives(stats)
        try:
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            sync()
            stats["step_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            undo()
    out.update(ms=times, median=statistics.median(times), coll=stats,
               peak_gib=peak_gib(dev), last_loss=float(m["loss"]))
    del params, opt
    empty_cache(dev)
    t_elastic = time.perf_counter()
    out["d_s"] = t_elastic - t_start - out["init_s"] - out["resume_s"]
    if other is not None:
        mesh2 = meshlib.make_process_mesh(other, ("data", "model"),
                                          device=device)
        step2 = trainer_on(mesh2).jitted_step(pipe.get_batch(0))
        state, _, _ = elastic_restore(str(tmp / "ckpt"), template, mesh2)
        specs2 = {"params": step2.in_specs[0], "opt": step2.in_specs[1]}
        spec_of = {path_key(p): s for p, s in tree_leaves_with_path(
            specs2, is_leaf=meshlib.is_spec)}
        held = {path_key(p): t for p, t in tree_leaves_with_path(state)}
        for key, w in tm_saved(tmp / "ckpt", 2):
            for d, ax in enumerate(spec_of[key]):
                if ax is not None:       # this rank's chunk along d
                    w = torch.chunk(w, mesh2.count(ax), d)[mesh2.index(ax)]
            if not torch.equal(held.pop(key).cpu(), w):
                raise AssertionError(f"rank {rank}: elastic restore onto "
                                     f"{other}: {key} is not its slice of "
                                     "the saved leaf")
        if held:
            raise AssertionError(f"rank {rank}: restored leaves the "
                                 f"checkpoint lacks: {sorted(held)}")
        tm_held(step2, template["params"], state["params"], state["opt"])
        _, _, m = step2(state["params"], state["opt"],
                        meshlib.batch_block(pipe.get_batch(2),
                                            step2.in_specs[2], mesh2))
        out["elastic_loss"] = float(m["loss"])
        if not abs(out["elastic_loss"]) < float("inf"):
            raise AssertionError(f"rank {rank}: the step after the elastic "
                                 f"restore is not finite")
        del state
    out["elastic_s"] = time.perf_counter() - t_elastic
    return out


def tm_seconds(a: list) -> str:
    """Where (a) + (d) spent the slowest rank's seconds (``tm_train``)."""
    slow = {k: max(x[k] for x in a)
            for k in ("init_s", "resume_s", "d_s", "elastic_s")}
    return (f"seconds (slowest rank): set-up {slow['init_s']:.1f}, steps, "
            f"checkpoint and resume {slow['resume_s']:.1f}, (d) "
            f"{slow['d_s']:.1f}, elastic restore {slow['elastic_s']:.1f}")


def host_rss_gib() -> float:
    """This process's resident host memory now (``VmRSS``). Its peak
    (``ru_maxrss``) is no use in a spawned rank: it carries the parent's
    over the fork, and the card's machine has no ``VmHWM``."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2 ** 20
    return 0.0


def tm_family_checks(world: int) -> dict:
    """(c) of phase 16 at ``world``: ``{what: (cfg, mesh shape)}``, dbrx
    reduced with EP over (1, world) and world experts, and at world 4 its
    experts over ``model`` on (2, 2) at a capacity that drops tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    dbrx = get_config("dbrx-132b")
    b, s = TRAIN_FAMILY_CHECK
    out = {f"(c) dbrx-132b reduced, EP, {world} experts, {b} x {s}": (
        dataclasses.replace(dbrx.reduced(n_experts=world,
                                         top_k=min(2, world)),
                            moe_a2a=True), (1, world))}
    if world == 4:
        out[f"(c) dbrx-132b reduced, experts over model, capacity factor "
            f"{TM_DROP_CF}, {b} x {s}"] = (
                dbrx.reduced(capacity_factor=TM_DROP_CF), (2, 2))
    return out


def f32_config(cfg):
    import dataclasses
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def tm_rank(rank, world, backend, device, seed, tmp, refs):
    """One rank of phase 16 (spawned): (a) + (d), (b), (c); the kernels'
    launch counters from 0 over the phase's work on this rank. A failure
    is printed with the rank's traceback before it propagates (the spawn
    names one failed rank only). The rank drops the parent's reference
    leaves before it ends (``release_references``)."""
    try:
        return tm_phases(rank, world, backend, device, seed, tmp, refs)
    except BaseException:
        import traceback
        print(f"phase 16 rank {rank} of {backend}-{world} failed:\n"
              f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        release_references(refs)


def release_references(refs: dict) -> None:
    """The rank's side of the parent's reference leaves (CUDA tensors it
    mapped through IPC): drop them before the rank ends. A spawned process
    ends in ``os._exit``, which never tells the parent that they were
    released, and the parent could then never free them."""
    refs.clear()


def tm_phases(rank, world, backend, device, seed, tmp, refs):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    gk.launches = sk.launches = 0
    t0 = time.perf_counter()
    qwen = get_config(TRAIN_ARCH)
    cut = dataclasses.replace(qwen, n_layers=TM_GLOO_LAYERS) \
        if backend == "gloo" else qwen
    depth = "whole" if cut is qwen else f"{cut.n_layers} layers"
    out = {"rank": rank, "depth": depth,
           "a": tm_train(rank, device, seed, Path(tmp), cut,
                         timed=TM_TIMED[backend])}
    dev_shape = out["a"]["shape"]
    empty_cache(torch.device(out["a"]["device"]))
    t_a = time.perf_counter() - t0
    b, s = TRAIN_CHECK_MESH
    out["b"] = tf_check(rank, device, seed, f32_config(qwen), dev_shape, b,
                        s, refs["b"])
    t_b = time.perf_counter() - t0 - t_a
    b, s = TRAIN_FAMILY_CHECK
    out["c"] = [tf_check(rank, device, seed, cfg, shape, b, s, ref)
                for (cfg, shape), ref in zip(
                    tm_family_checks(world).values(), refs["c"])]
    out["launches"] = {"row_table_gather": gk.launches,
                       "row_table_rmw": sk.launches}
    out["seconds"] = (t_a, t_b, time.perf_counter() - t0 - t_a - t_b)
    return out


def free_references(refs: dict, dev) -> None:
    """Drop the one-device steps' leaves the ranks read through CUDA IPC
    (the ranks have released them and exited) and return them to the
    card."""
    import torch
    refs.clear()
    if dev.type == "cuda":
        torch.cuda.ipc_collect()
    empty_cache(dev)


def phase_train_mesh(dev, seed: int, groups=PM_GROUPS):
    """The train step over a process mesh (``launch.mesh.RankMesh``), one
    spawned process per rank, in phase 13's groups: tensor-parallel over
    ``model``, data-parallel with ZeRO-1 over ``data``, every rank holding
    only its shards. (a) Qwen3-0.6B whole (bf16, AdamW bf16 moments,
    remat "full") at 8 x 512: a checkpoint at step 2 from the mesh, a
    resume on the same mesh bit for bit, ``elastic_restore`` onto the
    other shape (every leaf its slice of the saved leaf, one finite
    step), each rank's bytes its shards'; (b) one f32 step of it at
    TRAIN_CHECK_MESH against the one-device float64 step, both from
    AdamW's state at TRAIN_CHECK_STEP (lr > 0), computed here before each
    group spawns and read by each rank for its own blocks (``tf_check``);
    (c) dbrx reduced, EP over (1, world) and, at world 4, experts over
    ``model`` on (2, 2) with a capacity that drops tokens, likewise; (d)
    the warm bf16 step of (a) (slowest rank, median of TM_TIMED) beside
    phase 12's, tokens/s, peak per rank, collectives, bytes and their
    share of one step; (e) B1/B2 launches 0 on every rank. Returns each
    kernel's launches per group, one count per rank."""
    import statistics
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.spawn import run_ranks
    empty_cache(dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {"row_table_gather": {}, "row_table_rmw": {}}
    log(f"reduced phase 16 gloo groups, (a) and (d): {TRAIN_ARCH} "
        f"n_layers 28 -> {TM_GLOO_LAYERS}, (d) {TM_TIMED['gloo']} timed "
        "step (widths kept; (b) whole)")
    beside = (f"phase 12: {TRAIN_RESULTS['ms']:.3f} ms, peak "
              f"{TRAIN_RESULTS['peak_gib']:.2f} GiB" if TRAIN_RESULTS
              else "phase 12 not run")
    b, s = TRAIN_CHECK_MESH
    fb, fs = TRAIN_FAMILY_CHECK

    def spawn(backend, world, device, refs):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            ranks = run_ranks(tm_rank, world,
                              args=(backend, device, seed, tmp, refs),
                              backend=backend,
                              init_method=f"file://{tmp}/store",
                              timeout=PM_COLLECTIVE_S,
                              join_timeout=TM_JOIN_S)
        return ranks, time.perf_counter() - t0
    results = []
    for batch in group_batches(groups):
        # the batch's one-device float64 steps, all before its ranks
        # spawn: (b) once, read by every group of the batch; (c) per world
        batch = [(backend, torch.cuda.device_count() if world is None
                  else world, device) for backend, world, device in batch]
        ref_b = tf_reference(dev, seed, f32_config(get_config(TRAIN_ARCH)),
                             b, s)
        jobs = []
        for backend, world, device in batch:
            checks = tm_family_checks(world)
            ref = {"b": ref_b, "c": [tf_reference(dev, seed, cfg, fb, fs)
                                     for cfg, _ in checks.values()]}
            refs = {"b": ref_b["leaves"],
                    "c": [r.pop("leaves") for r in ref["c"]]}
            log(f"phase 16 {backend}-{world}: the one-device float64 steps, "
                f"(b) {TRAIN_ARCH} whole, {b} x {s}, {ref_b['s']:.1f} s "
                f"(once for {' and '.join(f'{g[0]}-{g[1]}' for g in batch)})"
                f", card peak {ref_b['peak_gib']:.2f} GiB; (c) "
                f"{sum(r['s'] for r in ref['c']):.1f} s")
            jobs.append(((backend, world, device), checks, ref, refs))
        del ref_b["leaves"]
        try:
            spawned = run_side_by_side(
                [lambda j=j: spawn(*j[0], j[3]) for j in jobs])
        finally:
            for j in jobs:
                free_references(j[3], dev)
        results += [(j[0], j[1], j[2], ranks, wall)
                    for j, (ranks, wall) in zip(jobs, spawned)]
    for (backend, world, device), checks, ref, ranks, wall in results:
        name = f"{backend}-{world}"
        for k in out:
            out[k][name] = [r["launches"][k] for r in ranks]
            if any(out[k][name]):
                raise AssertionError(f"phase 16 {name}: the train path "
                                     f"launched {k} {out[k][name]}")
        a = [r["a"] for r in ranks]
        if len({tuple(x["losses"]) for x in a}) != 1:
            raise AssertionError(f"phase 16 {name}: the ranks' losses "
                                 f"differ: {[x['losses'] for x in a]}")
        slowest = [max(x["ms"][i] for x in a)
                   for i in range(TM_TIMED[backend])]
        ms = statistics.median(slowest)
        TM_RESULTS[name] = {"ms": ms, "depth": ranks[0]["depth"]}
        coll = a[0]["coll"]
        log(f"phase 16 {name} (a) Qwen3-0.6B {ranks[0]['depth']}, mesh "
            f"{a[0]['shape']}: "
            f"losses {' '.join(f'{x:.4f}' for x in a[0]['losses'])} on "
            f"every rank; checkpoint at step 2 from the mesh "
            f"({max(x['save_s'] for x in a):.1f} s), resumed on the same "
            f"mesh bit for bit ({a[0]['leaves']} leaves a rank, load "
            f"{max(x['load_s'] for x in a):.1f} s); elastic restore onto "
            + (f"{a[0]['other']}: every leaf its slice, step loss "
               f"{a[0]['elastic_loss']:.4f}" if a[0]["other"] else "(none "
               "at world 1)")
            + f"; params + moments held per rank "
            f"{[round(x['held'] / 2 ** 30, 3) for x in a]} GiB (their "
            f"shards' bytes); {tm_seconds(a)}")
        log(f"phase 16 {name} (d) bf16 step, {ranks[0]['depth']}, 8 x 512: "
            f"{ms:.3f} ms (slowest "
            f"rank, median of {' '.join(f'{t:.3f}' for t in slowest)}), "
            f"{8 * 512 / ms * 1e3:.1f} tokens/s; {beside}; peak per rank "
            f"over those steps {[round(x['peak_gib'], 2) for x in a]} GiB; "
            f"one counted step "
            f"{coll['step_ms']:.3f} ms with each collective synchronised: "
            f"{coll['calls']} per rank, {coll['bytes'] / 2 ** 20:.1f} MiB "
            f"handed to them, {coll['s'] * 1e3:.3f} ms in them "
            f"({100 * coll['s'] * 1e3 / coll['step_ms']:.1f}% of that "
            f"step); devices {sorted({x['device'] for x in a})}")
        tf_judge(name, f"(b) {TRAIN_ARCH} whole, {b} x {s} on "
                 f"{a[0]['shape']}", ref["b"], [r["b"] for r in ranks],
                 phase=16)
        for i, (what, (_, shape)) in enumerate(checks.items()):
            tf_judge(name, f"{what} on {shape}", ref["c"][i],
                     [r["c"][i] for r in ranks], phase=16)
        log(f"phase 16 {name}: B1/B2 launches per rank "
            f"{[tuple(r['launches'].values()) for r in ranks]} (the train "
            f"path calls no kernel); seconds per rank (a+d, b, c) "
            f"{[tuple(round(t, 1) for t in r['seconds']) for r in ranks]}; "
            f"{wall:.1f} s{side_note(backend)}")
    return out


# --- phase 17 --------------------------------------------------------------

TF_ARCH = "seamless-m4t-large-v2"  # whole: 12 + 12 layers, published widths
TF_VLM = "qwen2-vl-72b"
TF_VLM_CHECK = (4, 64, (1, 2, 2))  # (c) reduced: batch, seq, patch grid
TF_VLM_WIDE = (2, 256, (1, 4, 4))  # (c) published widths, 1 of 80 layers
# meshes whose reckoned (c) peaks leave the card 10 GiB: (2, 2)'s four
# ranks would need ~80 GiB (PERF.md)
TF_VLM_WIDE_MESHES = ((1, 1), (1, 2))
# the phase's 180 s budget cuts the gloo groups first in (d)'s timed
# steps (TM_TIMED), then in (a)/(d)'s depth (PERF.md): (b) stays whole
TF_GLOO_LAYERS = 1                 # the gloo groups' (a)/(d) depth: 1 + 1
TF_RESULTS: dict = {}              # (d) per group, printed beside phase 18's


def vlm_positions3(batch: int, s_img: int, s_txt: int, grid: tuple):
    """M-RoPE position streams (3, batch, s_img + s_txt) as Qwen2-VL
    builds them: the patch tokens on a (temporal, height, width) ``grid``,
    the text continuing after the grid's largest position in all three
    streams; row b shifted by 2b (as after a prompt of 2b tokens)."""
    import numpy as np
    t, h, w = grid
    cells = np.indices((t, h, w)).reshape(3, s_img)
    text = cells.max() + 1 + np.arange(s_txt)
    one = np.concatenate([cells, np.broadcast_to(text, (3, s_txt))], 1)
    return (one[:, None, :] + 2 * np.arange(batch)[None, :, None]).astype(
        np.int32)


def tf_batch(cfg, b: int, s: int, seed: int, dev, grid=None) -> dict:
    """The seeded batch of (b)/(c): the same on the parent and every rank;
    the VLM's with ``positions3`` given on a patch ``grid``."""
    import torch
    from repro_torch.data import SyntheticTokenPipeline
    batch = SyntheticTokenPipeline(cfg, b, s, seed=seed,
                                   device=dev).get_batch(0)
    if grid is not None:
        s_img = batch["patch_embeds"].shape[1]
        batch["positions3"] = torch.from_numpy(vlm_positions3(
            b, s_img, batch["tokens"].shape[1], grid)).to(dev)
    return batch


def tf_key(path) -> str:
    return ".".join(map(str, path))


def check_state(params):
    """AdamW's state of the one-step checks, the same on both sides: f32
    moments at zero and ``step`` TRAIN_CHECK_STEP, past the warmup (lr >
    0)."""
    from repro_torch.optim import adamw_init
    opt = adamw_init(params, state_dtype="float32")
    opt["step"].fill_(TRAIN_CHECK_STEP)
    return opt


def to_float64(t, dev=None):
    """A floating tensor widened to float64 (on ``dev``), others as they
    are."""
    import torch
    dev = t.device if dev is None else dev
    return t.to(dev, torch.float64) if t.is_floating_point() else t.to(dev)


def tf_reference(dev, seed: int, cfg, b: int, s: int, grid=None) -> dict:
    """The one-device step of a one-step check (phases 16-18), once, in
    this process before the group spawns, so that no rank holds its
    float64 model: ``cfg``'s f32 params from ``seed`` widened to float64,
    one step of ``make_train_step`` from ``check_state`` (the EP path off;
    a MoE model on the CPU). AdamW's math is f32 in every dtype, so its
    moments are f32 and the new params f32 values: each updated leaf is
    kept on ``dev`` in f32 (exact), and the spawn hands it to the ranks
    through CUDA IPC (``torch.multiprocessing`` pickles a CUDA tensor by
    its memory handle), each rank reading its own blocks in place.
    Returns the metrics, the seconds, the card's peak and ``leaves``."""
    import dataclasses
    import torch
    from repro_torch.core.tree import tree_leaves_with_path, tree_map
    from repro_torch.models import build_model
    from repro_torch.train.trainer import make_train_step
    t0 = time.perf_counter()
    empty_cache(dev)
    reset_peak(dev)
    wide = dataclasses.replace(cfg, dtype="float64", param_dtype="float64",
                               moe_a2a=False)
    ref_dev = dev if cfg.n_experts == 0 else torch.device("cpu")
    p64 = tree_map(lambda t: to_float64(t, ref_dev), build_model(
        cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed)))
    batch = {k: to_float64(v, ref_dev)
             for k, v in tf_batch(cfg, b, s, seed, dev, grid).items()}
    p64, o, m = make_train_step(build_model(wide, device=ref_dev))(
        p64, check_state(p64), batch)
    leaves = {tf_key(path): t.to(dev, torch.float32)
              for path, t in tree_leaves_with_path(
                  {"p": p64, "o": {"mu": o["mu"], "nu": o["nu"]}})}
    peak = peak_gib(dev)
    del p64, o, batch
    empty_cache(dev)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "s": time.perf_counter() - t0,
            "peak_gib": peak, "leaves": leaves}


def tf_check(rank, device, seed, cfg, shape, b, s, ref: dict,
             grid=None, wide: bool = False) -> dict:
    """(b), (c): one step of ``cfg`` (f32; in float64 with ``wide``, the
    f32 params widened) on a process mesh of ``shape`` from
    ``check_state``, each updated leaf of the rank (params and AdamW's
    moments, which carry the clipped gradient) held against its block of
    the one-device step's (``tf_reference``'s ``leaves``, ``ref``): the
    squared error and the squared reference, each divided by the number
    of ranks that hold the same block, so that the sums over the ranks
    are the whole leaf's. Returns them with the metrics and the rank's
    device peak and largest resident host memory."""
    import dataclasses
    import torch
    from repro_torch.core.tree import tree_leaves_with_path, tree_map
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.trainer import shard_train_step
    mesh = meshlib.make_process_mesh(shape, ("data", "model"), device=device)
    dev = mesh.device
    empty_cache(dev)
    reset_peak(dev)
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    batch = tf_batch(cfg, b, s, seed, dev, grid)
    if wide:
        params = tree_map(to_float64, params)
        batch = {k: to_float64(v) for k, v in batch.items()}
        cfg = dataclasses.replace(cfg, dtype="float64",
                                  param_dtype="float64")
    step = shard_train_step(build_model(cfg, device=dev), mesh, params, None,
                            batch)
    ps, ospecs, bs = step.in_specs
    p = meshlib.shard_tree(params, ps, mesh)
    o = check_state(meshlib.shard_tree(params, ospecs["mu"], mesh))
    bb = meshlib.batch_block(batch, bs, mesh)
    del params, batch
    host = host_rss_gib()
    p, o, m = step(p, o, bb)
    sync()
    host = max(host, host_rss_gib())
    spec_of = dict(tree_leaves_with_path({"p": ps, "o": ospecs},
                                         is_leaf=meshlib.is_spec))
    sums = {}
    for path, t in tree_leaves_with_path({"p": p, "o": {
            "mu": o["mu"], "nu": o["nu"]}}):
        want, copies = ref[tf_key(path)], mesh.size
        for d, ax in enumerate(spec_of[path]):
            if ax is not None:
                n = want.shape[d] // mesh.count(ax)
                want = want.narrow(d, mesh.index(ax) * n, n)
                copies //= mesh.count(ax)
        w = want.to(dev).double()
        sums[tf_key(path)] = (float(((t.double() - w) ** 2).sum()) / copies,
                              float((w * w).sum()) / copies)
        del w
    host = max(host, host_rss_gib())
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "step": int(o["step"]), "sums": sums,
            "peak_gib": peak_gib(dev), "host_gib": host}


def tf_wide(device, seed, shape, cfg, b: int, s: int, grid=None,
            steps: int = 1) -> dict:
    """A published-width step on one rank (phase 17's Qwen2-VL-72B at 1
    of its 80 layers, ``positions3`` given; phase 18's Jamba at one
    superblock): ``steps`` bf16 steps of ``cfg`` at b x s on the group's
    mesh of ``shape`` (``Trainer``); returns the last loss, each step's
    wall time and the rank's device peak."""
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer
    mesh = meshlib.make_process_mesh(shape, ("data", "model"), device=device)
    dev = mesh.device
    empty_cache(dev)
    reset_peak(dev)
    trainer = Trainer(model=build_model(cfg, device=dev), mesh=mesh,
                      warmup=1, total_steps=steps + 1)
    params, opt = trainer.init_state(seed)
    batch = tf_batch(cfg, b, s, seed, dev, grid)
    step = trainer.jitted_step(batch)
    bb = meshlib.batch_block(batch, step.in_specs[2], mesh)
    times = []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, bb)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"loss": float(m["loss"]), "ms": times, "peak_gib": peak_gib(dev),
           "shape": shape}
    del params, opt, m
    empty_cache(dev)
    return out


def tf_rank(rank, world, backend, device, seed, tmp, refs):
    """One rank of phase 17 (spawned): (a) + (d), (b), (c); the kernels'
    launch counters from 0 over the phase's work on this rank. A failure
    is printed with the rank's traceback before it propagates."""
    try:
        return tf_phases(rank, world, backend, device, seed, tmp, refs)
    except BaseException:
        import traceback
        print(f"phase 17 rank {rank} of {backend}-{world} failed:\n"
              f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise


def tf_phases(rank, world, backend, device, seed, tmp, refs):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    gk.launches = sk.launches = 0
    t0 = time.perf_counter()
    seamless = get_config(TF_ARCH)
    cut = seamless if backend != "gloo" else dataclasses.replace(
        seamless, n_layers=2 * TF_GLOO_LAYERS, n_enc_layers=TF_GLOO_LAYERS,
        n_dec_layers=TF_GLOO_LAYERS)
    out = {"rank": rank,
           "depth": f"{cut.n_enc_layers} + {cut.n_dec_layers} layers",
           "a": tm_train(rank, device, seed, Path(tmp), cut,
                         timed=TM_TIMED[backend], elastic=False)}
    shape = out["a"]["shape"]
    empty_cache(torch.device(out["a"]["device"]))
    t_a = time.perf_counter() - t0
    b, s = TRAIN_CHECK_MESH
    out["b"] = tf_check(rank, device, seed, f32_config(seamless), shape, b,
                        s, refs["b"])
    t_b = time.perf_counter() - t0 - t_a
    b, s, grid = TF_VLM_CHECK
    out["c"] = tf_check(rank, device, seed, get_config(TF_VLM).reduced(),
                        shape, b, s, refs["c"], grid)
    dev = torch.device(out["a"]["device"])
    empty_cache(dev)
    tf_hand_back(rank, refs, Path(tmp))
    t_c = time.perf_counter()
    out["wide_free_gib"] = card_free_gib(dev)
    if shape in TF_VLM_WIDE_MESHES:
        b, s, grid = TF_VLM_WIDE
        out["c_wide"] = tf_wide(device, seed, shape, dataclasses.replace(
            get_config(TF_VLM), n_layers=1), b, s, grid)
    out["wide_s"] = time.perf_counter() - t_c
    out["launches"] = {"row_table_gather": gk.launches,
                       "row_table_rmw": sk.launches}
    out["seconds"] = (t_a, t_b, t_c - t0 - t_a - t_b)
    return out


TF_HAND_BACK_S = 120               # a rank waits this long for the parent


def tf_hand_back(rank, refs: dict, tmp: Path) -> None:
    """The rank's side of handing the parent's reference leaves back
    before (c)'s published-width step, which does not fit on the card
    beside them: every rank drops them (a spawned process ends in
    ``os._exit``, where it would never release them, and the parent
    could not free them), rank 0 says so once all have, and every rank
    waits for the parent to have freed them (``tf_free_on_hand_back``)."""
    import torch.distributed as dist
    release_references(refs)
    dist.barrier()
    if rank == 0:
        (tmp / "released").touch()
    t0 = time.monotonic()
    while not (tmp / "freed").exists():
        if time.monotonic() - t0 > TF_HAND_BACK_S:
            raise TimeoutError(f"rank {rank}: the parent did not free the "
                               f"reference leaves in {TF_HAND_BACK_S} s")
        time.sleep(0.05)


def tf_free_on_hand_back(refs: dict, tmp: Path, dev, done) -> None:
    """The parent's side (a thread beside the spawn): once rank 0 says
    every rank has dropped the leaves, drop them here (``refs`` is the
    dict the spawn was handed: clearing it frees them), collect what the
    ranks had mapped, return it to the card and say so. Stops when
    ``done`` is set (the spawn ended)."""
    import torch
    while not (tmp / "released").exists():
        if done.wait(0.05):
            return
    refs.clear()
    if dev.type == "cuda":
        torch.cuda.ipc_collect()
    empty_cache(dev)
    (tmp / "freed").touch()


def tf_judge(name, what, ref: dict, ranks: list, *, phase: int = 17,
             bounds=(TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_GRAD_REL_L2),
             precision: str = "f32") -> None:
    """A one-step check of one group (phases 16-18): the metrics equal on
    every rank, the loss and the global norm within ``bounds[:2]``
    (relative) of the one-device float64 step's, the same lr, every
    updated leaf within ``bounds[2]`` (relative L2 over the ranks' summed
    blocks), the optimizer one step past TRAIN_CHECK_STEP."""
    import math
    loss_rtol, norm_rtol, leaf_rel_l2 = bounds
    if len({(r["loss"], r["grad_norm"], r["step"]) for r in ranks}) != 1:
        raise AssertionError(f"phase {phase} {name} {what}: the ranks' "
                             f"metrics differ: "
                             f"{[(r['loss'], r['grad_norm']) for r in ranks]}")
    loss_err = abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    norm_err = abs(ranks[0]["grad_norm"] - ref["grad_norm"]) \
        / abs(ref["grad_norm"])
    worst = ("", 0.0)
    for key in ranks[0]["sums"]:
        d2 = sum(r["sums"][key][0] for r in ranks)
        w2 = sum(r["sums"][key][1] for r in ranks)
        err = math.sqrt(d2 / max(w2, 1e-300))
        if err > worst[1] or not err == err:
            worst = (key, err)
    log(f"phase {phase} {name} {what}: {precision} mesh step from step "
        f"{TRAIN_CHECK_STEP} (lr {ranks[0]['lr']:.4e}) against the "
        f"one-device float64 step: loss {ranks[0]['loss']:.6f} (rel err "
        f"{loss_err:.3e}), global norm {ranks[0]['grad_norm']:.6f} (rel "
        f"err {norm_err:.3e}), worst updated leaf rel L2 {worst[1]:.3e} "
        f"({worst[0]}, {len(ranks[0]['sums'])} leaves, params and both "
        f"moments; bounds {loss_rtol}, {norm_rtol}, {leaf_rel_l2}); peak "
        f"per rank: device {[round(r['peak_gib'], 2) for r in ranks]} GiB, "
        f"host resident {[round(r['host_gib'], 2) for r in ranks]} GiB")
    if not (loss_err <= loss_rtol and norm_err <= norm_rtol
            and worst[1] <= leaf_rel_l2 and ref["lr"] > 0
            # a MoE model's reference runs on the CPU, whose cosine may
            # round the schedule's last bit otherwise
            and abs(ranks[0]["lr"] / ref["lr"] - 1) <= 1e-6
            and ranks[0]["step"] == TRAIN_CHECK_STEP + 1):
        raise AssertionError(
            f"phase {phase} {name} {what}: the mesh step is off the "
            f"one-device step (loss {loss_err:.3e}, norm {norm_err:.3e}, "
            f"leaf {worst[1]:.3e} at {worst[0]}, lr {ranks[0]['lr']} "
            f"against {ref['lr']}, step {ranks[0]['step']}; bounds "
            f"{bounds})")


def phase_train_families(dev, seed: int, groups=PM_GROUPS):
    """The train step over a process mesh for the encoder-decoder and VLM
    families, one spawned process per rank, in phase 13's groups. (a)
    SeamlessM4T-large-v2 whole (bf16, AdamW bf16 moments, remat "full")
    at 8 x 512 (256 source frames, 256 target tokens): steps, a
    checkpoint at step 2 from the mesh, a resume on the same mesh bit for
    bit, each rank's bytes its shards'; the gloo groups at TF_GLOO_LAYERS
    + TF_GLOO_LAYERS layers. (b) one f32 step of it, whole, at
    TRAIN_CHECK_MESH against the one-device float64 step, computed here
    before each group spawns (``tf_reference``); (c) Qwen2-VL-72B
    reduced likewise with ``positions3`` given (cut on its batch dim at
    data 2); then, once the ranks have handed the references back and
    they are freed (``tf_hand_back``), one bf16 step of it at published
    widths and 1 of 80 layers on the meshes of TF_VLM_WIDE_MESHES; (d)
    the warm bf16 step of (a) beside phase 16's; (e) B1/B2 launches 0 on
    every rank. Returns each kernel's launches per group, one count per
    rank."""
    import dataclasses
    import statistics
    import tempfile
    import threading
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.spawn import run_ranks
    empty_cache(dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {"row_table_gather": {}, "row_table_rmw": {}}
    b, s = TRAIN_CHECK_MESH
    vb, vs, grid = TF_VLM_CHECK
    wb, ws, _ = TF_VLM_WIDE
    log(f"reduced phase 17 gloo groups, (a) and (d): {TF_ARCH} 12 + 12 -> "
        f"{TF_GLOO_LAYERS} + {TF_GLOO_LAYERS} layers, (d) {TM_TIMED['gloo']} "
        f"timed step (widths kept; (b) whole); this process holds "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30 if dev.type == 'cuda' else 0.0:.2f}"
        f" GiB of the card, {card_free_gib(dev):.2f} GiB free")
    for backend, world, device in groups:
        world = torch.cuda.device_count() if world is None else world
        name = f"{backend}-{world}"
        ref = {"b": tf_reference(dev, seed, dataclasses.replace(
            get_config(TF_ARCH), dtype="float32", param_dtype="float32"), b,
            s), "c": tf_reference(dev, seed, get_config(TF_VLM).reduced(),
                                  vb, vs, grid)}
        refs = {k: r.pop("leaves") for k, r in ref.items()}
        gib = sum(t.nbytes for t in refs["b"].values()) / 2 ** 30
        log(f"phase 17 {name}: the one-device float64 steps, (b) {TF_ARCH} "
            f"whole, {b} x {s}, {ref['b']['s']:.1f} s, card peak "
            f"{ref['b']['peak_gib']:.2f} GiB, its updated leaves kept on the "
            f"card in f32 ({gib:.2f} GiB, read by the ranks through CUDA "
            f"IPC); (c) {TF_VLM} reduced, {vb} x {vs}, {ref['c']['s']:.1f} "
            f"s; {card_free_gib(dev):.2f} GiB of the card free")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            done = threading.Event()
            free = threading.Thread(target=tf_free_on_hand_back,
                                    args=(refs, Path(tmp), dev, done))
            free.start()
            try:
                ranks = run_ranks(tf_rank, world,
                                  args=(backend, device, seed, tmp, refs),
                                  backend=backend,
                                  init_method=f"file://{tmp}/store",
                                  timeout=PM_COLLECTIVE_S,
                                  join_timeout=TM_JOIN_S)
            finally:
                done.set()
                free.join()
                del refs
        wall = time.perf_counter() - t0
        for k in out:
            out[k][name] = [r["launches"][k] for r in ranks]
            if any(out[k][name]):
                raise AssertionError(f"phase 17 {name}: the train path "
                                     f"launched {k} {out[k][name]}")
        a = [r["a"] for r in ranks]
        if len({tuple(x["losses"]) for x in a}) != 1:
            raise AssertionError(f"phase 17 {name}: the ranks' losses "
                                 f"differ: {[x['losses'] for x in a]}")
        slowest = [max(x["ms"][i] for x in a)
                   for i in range(TM_TIMED[backend])]
        ms = statistics.median(slowest)
        TF_RESULTS[name] = {"ms": ms, "depth": ranks[0]["depth"]}
        coll = a[0]["coll"]
        p16 = TM_RESULTS.get(name)
        beside = (f"phase 16 Qwen3-0.6B ({p16['depth']}): {p16['ms']:.3f} "
                  "ms" if p16 else "phase 16 not run")
        log(f"phase 17 {name} (a) {TF_ARCH} {ranks[0]['depth']}, mesh "
            f"{a[0]['shape']}: losses "
            f"{' '.join(f'{x:.4f}' for x in a[0]['losses'])} on every rank; "
            f"checkpoint at step 2 from the mesh "
            f"({max(x['save_s'] for x in a):.1f} s), resumed on the same "
            f"mesh bit for bit ({a[0]['leaves']} leaves a rank, load "
            f"{max(x['load_s'] for x in a):.1f} s); params + moments held "
            f"per rank {[round(x['held'] / 2 ** 30, 3) for x in a]} GiB "
            f"(their shards' bytes); {tm_seconds(a)}")
        log(f"phase 17 {name} (d) bf16 step, {ranks[0]['depth']}, 8 x 512: "
            f"{ms:.3f} ms (slowest rank, median of "
            f"{' '.join(f'{t:.3f}' for t in slowest)}), "
            f"{8 * 512 / ms * 1e3:.1f} tokens/s; {beside}; peak per rank "
            f"over those steps {[round(x['peak_gib'], 2) for x in a]} GiB; "
            f"one counted step {coll['step_ms']:.3f} ms with each "
            f"collective synchronised: {coll['calls']} per rank, "
            f"{coll['bytes'] / 2 ** 20:.1f} MiB handed to them, "
            f"{coll['s'] * 1e3:.3f} ms in them "
            f"({100 * coll['s'] * 1e3 / coll['step_ms']:.1f}% of that step)"
            f"; devices {sorted({x['device'] for x in a})}")
        tf_judge(name, f"(b) {TF_ARCH} whole, {b} x {s} on {a[0]['shape']}",
                 ref["b"], [r["b"] for r in ranks])
        tf_judge(name, f"(c) {TF_VLM} reduced, positions3 on a {grid} "
                 f"grid, {vb} x {vs} on {a[0]['shape']}", ref["c"],
                 [r["c"] for r in ranks])
        if "c_wide" in ranks[0]:
            wide = [r["c_wide"] for r in ranks]
            if len({x["loss"] for x in wide}) != 1 or \
                    not abs(wide[0]["loss"]) < float("inf"):
                raise AssertionError(f"phase 17 {name} (c) published "
                                     f"widths: losses "
                                     f"{[x['loss'] for x in wide]}")
            log(f"phase 17 {name} (c) {TF_VLM} published widths, 1 of 80 "
                f"layers, bf16, {wb} x {ws} on {a[0]['shape']}, after the "
                f"leaves were handed back: loss {wide[0]['loss']:.4f} on "
                f"every rank, first step "
                f"{max(x['ms'][0] for x in wide):.1f} ms (slowest rank), peak "
                f"per rank {[round(x['peak_gib'], 2) for x in wide]} GiB, "
                f"{ranks[0]['wide_free_gib']:.2f} GiB of the card free "
                "before it")
        else:
            log(f"phase 17 {name} (c) {TF_VLM} published widths: not run on "
                f"{a[0]['shape']} (its reckoned peaks leave the card under "
                "10 GiB)")
        log(f"phase 17 {name}: B1/B2 launches per rank "
            f"{[tuple(r['launches'].values()) for r in ranks]} (the train "
            f"path calls no kernel); seconds per rank (a+d, b, c reduced, "
            f"c published) "
            f"{[tuple(round(t, 1) for t in r['seconds']) + (round(r['wide_s'], 1),) for r in ranks]}"
            f"; {wall:.1f} s")
    return out


# --- phase 18 --------------------------------------------------------------

TR_ARCH = "rwkv6-1.6b"             # whole: 24 layers, published widths
TR_JAMBA = "jamba-1.5-large-398b"
# (a)/(d): 8 x TR_SEQ tokens, the sequence cut from phases 16-17's 512:
# the eager WKV loop takes ~TR_WKV_MS per layer and time step (phase 10)
TR_SEQ = 32
TR_WKV_MS = 0.155
TR_STEP_X = 12                     # a step's time over a forward's (PERF.md)
TR_CHECK = (2, 64)                 # (b), (c1): batch x seq of the one step
# (b) runs in float64 on the mesh: RWKV-6 at random weights amplifies f32
# rounding ~1e4-fold, so its one-device f32 step is off the float64 one
# by more than 2e-5 (measured and printed each run); TR_B_LAYERS of the 24
# layers is the depth whose float64 step gloo-4's four ranks hold on one
# card beside the reference's leaves (PERF.md)
TR_B_LAYERS = 8
# loss and global norm, float64 throughout, within 1e-9 relative; every
# updated leaf within one f32 ulp (2^-23) of relative L2: AdamW's math is
# f32 whatever the params' dtype, so the moments and the new params are
# f32 roundings of float64 gradients that agree to ~1e-11, a few of whose
# elements round to the neighbouring f32 value (PERF.md)
TR_B_BOUNDS = (1e-9, 1e-9, 2.0 ** -23)
TR_C1_BOUNDS = (TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, 2e-5)
TR_WIDE = (2, 256)                 # (c2): batch x seq at published widths
# meshes whose reckoned (c2) peaks leave the card 10 GiB (PERF.md)
TR_WIDE_MESHES = ((1, 1), (1, 2))
TR_GLOO_LAYERS = 1                 # the gloo groups' (a)/(d) depth (of 24)
TR_TIMED = 1                       # (d): warm timed bf16 steps, every group


def tr_b_config():
    """(b): RWKV-6 at published widths and TR_B_LAYERS layers, f32 (the
    check widens it to float64)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(f32_config(get_config(TR_ARCH)),
                               n_layers=TR_B_LAYERS)


def tr_c1_config():
    """(c1): Jamba reduced, f32: one superblock of attention period 8 (an
    attention layer and 7 Mamba layers), MoE over 4 experts every second
    layer."""
    from repro_torch.configs import get_config
    return get_config(TR_JAMBA).reduced()


def tr_wide_config():
    """(c2): Jamba 1.5 Large at published widths, bf16, cut to one
    superblock of attention period 2 (an attention layer and a Mamba
    layer) whose FFNs are both dense (MoE period 4)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TR_JAMBA), n_layers=2,
                               attn_period=2, moe_period=4)


def tr_f32_measure(dev, seed: int) -> None:
    """RWKV-6 whole: the one-device f32 step at TR_CHECK against the
    float64 step, both from ``check_state``, printed as measured (it is
    why (b) runs in float64)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.models import build_model
    from repro_torch.train.trainer import make_train_step
    cfg = f32_config(get_config(TR_ARCH))
    b, s = TR_CHECK
    ref = tf_reference(dev, seed, cfg, b, s)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    p, o, m = make_train_step(model)(params, check_state(params),
                                     tf_batch(cfg, b, s, seed, dev))
    del params
    worst = ("", 0.0)
    for path, t in tree_leaves_with_path(
            {"p": p, "o": {"mu": o["mu"], "nu": o["nu"]}}):
        w = ref["leaves"][tf_key(path)].double()
        err = float((t.double() - w).norm() / w.norm().clamp(min=1e-300))
        if err > worst[1] or not err == err:
            worst = (tf_key(path), err)
    peak = peak_gib(dev)
    loss_err = abs(float(m["loss"]) - ref["loss"]) / abs(ref["loss"])
    norm_err = abs(float(m["grad_norm"]) - ref["grad_norm"]) \
        / abs(ref["grad_norm"])
    del p, o, m, ref
    empty_cache(dev)
    log(f"phase 18 {TR_ARCH} whole, {b} x {s}, one device: the f32 step "
        f"against the float64 step from step {TRAIN_CHECK_STEP}: loss rel "
        f"err {loss_err:.3e}, global norm rel err {norm_err:.3e}, worst "
        f"updated leaf rel L2 {worst[1]:.3e} ({worst[0]}) against 2e-5 "
        f"(measured, not bounded: (b) runs in float64); card peak "
        f"{peak:.2f} GiB")


def tr_rank(rank, world, backend, device, seed, tmp, refs):
    """One rank of phase 18 (spawned): (a) + (d), (b), (c1), (c2); the
    kernels' launch counters from 0 over the phase's work on this rank. A
    failure is printed with the rank's traceback before it propagates;
    the rank drops the parent's reference leaves before it ends."""
    try:
        return tr_phases(rank, world, backend, device, seed, tmp, refs)
    except BaseException:
        import traceback
        print(f"phase 18 rank {rank} of {backend}-{world} failed:\n"
              f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        release_references(refs)


def tr_phases(rank, world, backend, device, seed, tmp, refs):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather import gather as gk
    from repro_torch.kernels.scatter_rmw import scatter_rmw as sk
    gk.launches = sk.launches = 0
    t0 = time.perf_counter()
    rwkv = get_config(TR_ARCH)
    cut = dataclasses.replace(rwkv, n_layers=TR_GLOO_LAYERS) \
        if backend == "gloo" else rwkv
    out = {"rank": rank, "depth": f"{cut.n_layers} layers",
           "a": tm_train(rank, device, seed, Path(tmp), cut,
                         timed=TR_TIMED, elastic=False, seq=TR_SEQ)}
    shape = out["a"]["shape"]
    dev = torch.device(out["a"]["device"])
    empty_cache(dev)
    marks = [time.perf_counter()]
    b, s = TR_CHECK
    out["b"] = tf_check(rank, device, seed, tr_b_config(), shape, b, s,
                        refs["b"], wide=True)
    marks.append(time.perf_counter())
    out["c1"] = tf_check(rank, device, seed, tr_c1_config(), shape, b, s,
                         refs["c1"])
    empty_cache(dev)
    marks.append(time.perf_counter())
    out["c2_free_gib"] = card_free_gib(dev)
    if shape in TR_WIDE_MESHES:
        wb, ws = TR_WIDE
        out["c2"] = tf_wide(device, seed, shape, tr_wide_config(), wb, ws,
                            steps=2 if shape == (1, 1) else 1)
    marks.append(time.perf_counter())
    out["launches"] = {"row_table_gather": gk.launches,
                       "row_table_rmw": sk.launches}
    out["seconds"] = tuple(y - x for x, y in zip([t0] + marks, marks))
    return out


def phase_train_recurrent(dev, seed: int, groups=PM_GROUPS):
    """The train step over a process mesh for the hybrid and RWKV-6
    families, one spawned process per rank, in phase 13's groups: the
    selective scan on the rank's channels and the WKV recurrence on its
    heads, tensor-parallel over ``model``. (a) RWKV-6-1.6B whole (bf16,
    AdamW bf16 moments, remat "full") at 8 x TR_SEQ: steps, a checkpoint
    at step 2 from the mesh, a resume on the same mesh bit for bit, each
    rank's bytes its shards'; the gloo groups at TR_GLOO_LAYERS layers.
    (b) one step of RWKV-6 at TR_B_LAYERS layers in float64 on the mesh
    against the one-device float64 step within TR_B_BOUNDS, from AdamW's
    state at TRAIN_CHECK_STEP (lr > 0), the reference computed here once
    before the groups and read by each rank for its own blocks; the
    one-device f32 step of the whole model against float64 is measured
    and printed first. (c1) Jamba reduced likewise in f32 within
    TR_C1_BOUNDS; (c2) one bf16 step of Jamba at published widths and one
    superblock on TR_WIDE_MESHES. (d) the warm bf16 step of (a) beside
    phases 16's and 17's, with its collectives, and (c2)'s steps at
    (1, 1). (e) B1/B2 launches 0 on every rank. Returns each kernel's
    launches per group, one count per rank."""
    import statistics
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.spawn import run_ranks
    empty_cache(dev)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out = {"row_table_gather": {}, "row_table_rmw": {}}
    rwkv, wide = get_config(TR_ARCH), tr_wide_config()
    jamba = get_config(TR_JAMBA)
    fwd_ms = rwkv.n_layers * TR_WKV_MS
    log(f"reduced phase 18 (a)/(d): {TR_ARCH} at 8 x {TR_SEQ} (phases "
        f"16-17: 8 x 512): the eager WKV loop takes ~{TR_WKV_MS} ms a layer "
        f"and time step, a forward ~{fwd_ms * TR_SEQ / 1e3:.2f} s at "
        f"{TR_SEQ} and ~{fwd_ms * 512 / 1e3:.2f} s at 512, a step (forward, "
        f"remat's recompute, backward) ~{TR_STEP_X}x that (measured at 8 x "
        f"128: 5.8 s); gloo groups n_layers "
        f"{rwkv.n_layers} -> {TR_GLOO_LAYERS} (widths kept); (d) {TR_TIMED} "
        "timed step in every group")
    log(f"reduced phase 18 (b): {TR_ARCH} n_layers {rwkv.n_layers} -> "
        f"{TR_B_LAYERS}, in float64 on the mesh (widths kept)")
    log(f"reduced phase 18 (c2): {TR_JAMBA} n_layers {jamba.n_layers} -> "
        f"{wide.n_layers}, attn_period {jamba.attn_period} -> "
        f"{wide.attn_period} (one attention and one Mamba layer), "
        f"moe_period {jamba.moe_period} -> {wide.moe_period} (both FFNs "
        f"dense: one published MoE layer holds {jamba.n_experts} experts of "
        f"{3 * jamba.d_model * jamba.d_ff / 1e6:.0f} M parameters), widths "
        f"kept; run on {list(TR_WIDE_MESHES)}")
    b, s = TR_CHECK
    t0 = time.perf_counter()
    tr_f32_measure(dev, seed)
    ref = {"b": tf_reference(dev, seed, tr_b_config(), b, s),
           "c1": tf_reference(dev, seed, tr_c1_config(), b, s)}
    refs = {k: r.pop("leaves") for k, r in ref.items()}
    gib = sum(t.nbytes for t in refs["b"].values()) / 2 ** 30
    log(f"phase 18: the one-device float64 steps, (b) {TR_ARCH} at "
        f"{TR_B_LAYERS} layers, {b} x {s}, {ref['b']['s']:.1f} s, card peak "
        f"{ref['b']['peak_gib']:.2f} GiB, its updated leaves kept on the "
        f"card in f32 ({gib:.2f} GiB) for every group; (c1) {TR_JAMBA} "
        f"reduced, "
        f"{ref['c1']['s']:.1f} s; {time.perf_counter() - t0:.1f} s with the "
        f"f32 measure; {card_free_gib(dev):.2f} GiB of the card free")
    try:
        for backend, world, device in groups:
            world = torch.cuda.device_count() if world is None else world
            name = f"{backend}-{world}"
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=build) as tmp:
                ranks = run_ranks(tr_rank, world,
                                  args=(backend, device, seed, tmp, refs),
                                  backend=backend,
                                  init_method=f"file://{tmp}/store",
                                  timeout=PM_COLLECTIVE_S,
                                  join_timeout=TM_JOIN_S)
            wall = time.perf_counter() - t0
            for k in out:
                out[k][name] = [r["launches"][k] for r in ranks]
                if any(out[k][name]):
                    raise AssertionError(f"phase 18 {name}: the train path "
                                         f"launched {k} {out[k][name]}")
            a = [r["a"] for r in ranks]
            if len({tuple(x["losses"]) for x in a}) != 1:
                raise AssertionError(f"phase 18 {name}: the ranks' losses "
                                     f"differ: {[x['losses'] for x in a]}")
            slowest = [max(x["ms"][i] for x in a) for i in range(TR_TIMED)]
            ms = statistics.median(slowest)
            coll = a[0]["coll"]
            beside = "; ".join(
                f"phase {ph} {arch} ({res[name]['depth']}, 8 x 512): "
                f"{res[name]['ms']:.3f} ms" if name in res else
                f"phase {ph} not run"
                for ph, arch, res in ((16, "Qwen3-0.6B", TM_RESULTS),
                                      (17, "SeamlessM4T-large-v2",
                                       TF_RESULTS)))
            log(f"phase 18 {name} (a) {TR_ARCH} {ranks[0]['depth']}, mesh "
                f"{a[0]['shape']}: losses "
                f"{' '.join(f'{x:.4f}' for x in a[0]['losses'])} on every "
                f"rank; checkpoint at step 2 from the mesh "
                f"({max(x['save_s'] for x in a):.1f} s), resumed on the same "
                f"mesh bit for bit ({a[0]['leaves']} leaves a rank, load "
                f"{max(x['load_s'] for x in a):.1f} s); params + moments "
                f"held per rank {[round(x['held'] / 2 ** 30, 3) for x in a]}"
                f" GiB (their shards' bytes); {tm_seconds(a)}")
            log(f"phase 18 {name} (d) bf16 step, {ranks[0]['depth']}, 8 x "
                f"{TR_SEQ}: {ms:.3f} ms (slowest rank, median of "
                f"{' '.join(f'{t:.3f}' for t in slowest)}), "
                f"{8 * TR_SEQ / ms * 1e3:.1f} tokens/s; {beside}; peak per "
                f"rank over those steps "
                f"{[round(x['peak_gib'], 2) for x in a]} GiB; one counted "
                f"step {coll['step_ms']:.3f} ms with each collective "
                f"synchronised: {coll['calls']} per rank, "
                f"{coll['bytes'] / 2 ** 20:.1f} MiB handed to them, "
                f"{coll['s'] * 1e3:.3f} ms in them "
                f"({100 * coll['s'] * 1e3 / coll['step_ms']:.1f}% of that "
                f"step); devices {sorted({x['device'] for x in a})}")
            tf_judge(name, f"(b) {TR_ARCH} at {TR_B_LAYERS} layers, {b} x {s} "
                     f"on {a[0]['shape']}", ref["b"], [r["b"] for r in ranks],
                     phase=18, bounds=TR_B_BOUNDS, precision="float64")
            tf_judge(name, f"(c1) {TR_JAMBA} reduced, {b} x {s} on "
                     f"{a[0]['shape']}", ref["c1"], [r["c1"] for r in ranks],
                     phase=18, bounds=TR_C1_BOUNDS)
            if "c2" in ranks[0]:
                c2 = [r["c2"] for r in ranks]
                if len({x["loss"] for x in c2}) != 1 or \
                        not abs(c2[0]["loss"]) < float("inf"):
                    raise AssertionError(f"phase 18 {name} (c2): losses "
                                         f"{[x['loss'] for x in c2]}")
                steps = [max(x["ms"][i] for x in c2)
                         for i in range(len(c2[0]["ms"]))]
                log(f"phase 18 {name} (c2) {TR_JAMBA} published widths, "
                    f"one superblock, bf16, {TR_WIDE[0]} x {TR_WIDE[1]} on "
                    f"{a[0]['shape']}: loss {c2[0]['loss']:.4f} on every "
                    f"rank; steps {' '.join(f'{t:.1f}' for t in steps)} ms "
                    f"(slowest rank; the first cold); peak per rank "
                    f"{[round(x['peak_gib'], 2) for x in c2]} GiB, "
                    f"{ranks[0]['c2_free_gib']:.2f} GiB of the card free "
                    "before it")
            else:
                log(f"phase 18 {name} (c2) {TR_JAMBA} published widths: not "
                    f"run on {a[0]['shape']} (its reckoned peaks leave the "
                    "card under 10 GiB)")
            log(f"phase 18 {name}: B1/B2 launches per rank "
                f"{[tuple(r['launches'].values()) for r in ranks]} (the "
                f"train path calls no kernel); seconds per rank (a+d, b, "
                f"c1, c2) "
                f"{[tuple(round(t, 1) for t in r['seconds']) for r in ranks]}"
                f"; {wall:.1f} s")
    finally:
        free_references(refs, dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # phase 12 runs cuBLAS deterministically, which needs this set before
    # CUDA initialises
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    seconds = {}

    def phase(name, fn, *a):
        """``fn(*a)``, its seconds kept under ``name`` for the summary."""
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out
    smi = phase("1", phase_device)
    phase("2", phase_kernels, dev)
    A, V, B, launches = phase("3", phase_main, dev, args.seed)
    table = phase("4", phase_timing, dev, A, V, B, launches)
    phase("5", phase_profile, dev, A, V, B)
    del V, B
    _, window_launches = phase("6", phase_window, dev, A, args.seed)
    for row in table:
        row["scheduler_launches"] = window_launches[row["name"]]
    phase("7", phase_pipeline, dev, A, args.seed)
    del A
    app_launches = phase("8", phase_apps, dev, args.seed)
    traffic_launches = phase("9b", phase_replay, dev)
    kvpool_launches = phase("9c", phase_kvpool, dev, args.seed)
    serve_launches = phase("10", phase_serve, dev, args.seed)
    sharded_launches, logical_ms = phase("11", phase_sharded, dev,
                                         args.seed)
    train_launches = phase("12", phase_train, dev, args.seed)
    process_launches = phase("13", phase_process_mesh, dev, args.seed,
                             logical_ms)
    service_launches = phase("14", phase_process_service, dev, args.seed)
    serving_launches = phase("15", phase_process_serving, dev, args.seed)
    train_mesh_launches = phase("16", phase_train_mesh, dev, args.seed)
    train_families_launches = phase("17", phase_train_families, dev,
                                    args.seed)
    train_recurrent_launches = phase("18", phase_train_recurrent, dev,
                                     args.seed)
    for row in table:
        row["app_launches"] = app_launches[row["name"]]
        row["traffic_launches"] = traffic_launches[row["name"]]
        row["kvpool_launches"] = kvpool_launches[row["name"]]
        row["serve_launches"] = serve_launches[row["name"]]
        row["sharded_launches"] = sharded_launches[row["name"]]
        row["train_launches"] = train_launches[row["name"]]
        row["process_mesh_launches"] = process_launches[row["name"]]
        row["process_service_launches"] = service_launches[row["name"]]
        row["process_serving_launches"] = serving_launches[row["name"]]
        row["train_mesh_launches"] = train_mesh_launches[row["name"]]
        row["train_families_launches"] = \
            train_families_launches[row["name"]]
        row["train_recurrent_launches"] = \
            train_recurrent_launches[row["name"]]
    log("seconds per phase: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in seconds.items()))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

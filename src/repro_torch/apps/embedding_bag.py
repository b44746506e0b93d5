"""Embedding-bag lookup/update — the duplicate-index scatter workload.

Recommendation / LM embedding tables are the canonical pooled-memory
indirection pattern: a huge row table, reads that hit a few hot rows from
every bag in the batch, and a gradient push where *most destinations
repeat*. Mapping onto the engine:

  lookup          = ILD ``submit_gather``: all tenants' token streams
                    against the same table fuse into one plan node; the
                    coalescing backend fetches each hot row once however
                    many bags reference it (the row-table gather kernel
                    on an ``Engine(use_kernel=True)``)
  gradient push   = duplicate-destination ADD RMW (``submit_rmw``): the
                    backend segment-combines per-row contributions before
                    a single unique-writer update (the row-table
                    scatter-RMW kernel) — the paper's read-modify-write
                    unit, and the same sort→segment→scatter pipeline
                    ``segment_combine`` below exposes for host-side reuse
  OOB tokens      = the unified policy end to end: lookups clamp into
                    range, pushes drop — so a bad token can skew a bag
                    sum but can never corrupt the table

Each training step is one lookup window and one push window, multi-tenant
(the batch's bags are split across tenants that share the physical
table). Values are integer-valued f32 (table in [0, 8), per-step sums
bounded far below 2^24) so every mode — eager, sequential, pipelined —
reproduces the NumPy oracle bit for bit, duplicates and all.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.apps import _common
from repro_torch.core import bulk_ops
from repro_torch.core.device import on, resolve_device, synchronize
from repro_torch.pipeline import DecoupledLoop, run_sequential

_GMOD = 4.0    # gradient surrogate modulus: g = (bag sum) mod 4


def segment_combine(idx, vals, *, num_rows: int, device=None):
    """Combine duplicate-destination contributions: one (row, sum) pair
    per distinct in-range row — the host-callable core of the RMW
    backend's sort -> segment-reduce -> unique-scatter pipeline
    (``core.bulk_ops.bulk_rmw``).

    idx: (N,) int destinations; vals: (N, ...) addends (tensors or NumPy,
    moved to ``device``, ``None`` = CUDA); num_rows: table extent.
    Returns ``(dest, summed)`` where ``dest`` is (N,) int32 with one
    segment-leader lane per distinct row and every other lane set to
    ``num_rows`` (the one-past-the-end sentinel a dropping scatter
    discards), and ``summed`` is (N, ...) with each leader lane carrying
    its segment's exact sum. Out-of-range destinations (< 0 or >=
    num_rows) land on the sentinel too — stores drop, per the unified OOB
    policy. Correctness requires exact, order-independent addition
    (integers, or integer-valued floats below 2^24).
    """
    dev = resolve_device(device)
    idx = on(idx, dev).to(torch.int32).reshape(-1)
    n = idx.shape[0]
    vals = on(vals, dev)
    vals = vals.reshape((n,) + tuple(vals.shape[1:])) if vals.ndim > 1 \
        else vals.reshape(n)
    oob = (idx < 0) | (idx >= num_rows)
    sidx = torch.where(oob, num_rows, idx)   # sort OOB to the end
    sidx, order = torch.sort(sidx, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sidx[1:] != sidx[:-1]
    seg = torch.cumsum(first, 0) - 1         # 0..n_segments-1 per lane
    summed = torch.zeros_like(vals).index_add_(0, seg, vals[order])
    # every lane of a segment carries its row, so the scatter is exact;
    # empty segments (past the last) and the OOB segment keep the sentinel
    dest = torch.full((n,), num_rows, dtype=torch.int32,
                      device=dev).scatter_(0, seg, sidx)
    return dest, summed


@dataclasses.dataclass
class BagProblem:
    """A multi-tenant embedding-bag training stream (NumPy).

    ``tokens`` holds ``n_steps`` batches of ``n_bags`` bags with ``lanes``
    token slots each; ``valid`` masks the live slots. Some valid lanes
    carry deliberately out-of-range tokens (negative / >= vocab): lookups
    clamp them, pushes drop them — both asserted against the oracle.
    """
    table: np.ndarray           # (vocab, d) integer-valued f32 in [0, 8)
    tokens: np.ndarray          # (n_steps, n_bags, lanes) int32, may be OOB
    valid: np.ndarray           # (n_steps, n_bags, lanes) bool
    tenants: Sequence[str]      # per-bag owning tenant

    @property
    def n_steps(self) -> int:
        return self.tokens.shape[0]

    @property
    def n_bags(self) -> int:
        return self.tokens.shape[1]


def make_problem(seed: int = 0, *, vocab: int = 64, d: int = 8,
                 n_bags: int = 12, lanes: int = 6, n_steps: int = 4,
                 n_tenants: int = 3, p_oob: float = 0.08) -> BagProblem:
    """Random bag stream with hot rows (Zipf-ish head) so duplicate
    destinations are common, plus a sprinkle of OOB tokens."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 8, size=(vocab, d)).astype(np.float32)
    # head-heavy token draw: half the lanes from the first vocab/8 rows
    hot = rng.integers(0, max(vocab // 8, 1),
                       size=(n_steps, n_bags, lanes))
    cold = rng.integers(0, vocab, size=(n_steps, n_bags, lanes))
    tokens = np.where(rng.random(hot.shape) < 0.5, hot, cold)
    oob = rng.random(tokens.shape) < p_oob
    tokens = np.where(
        oob, rng.integers(-vocab, 2 * vocab, size=tokens.shape), tokens)
    valid = rng.random(tokens.shape) < 0.85
    valid[..., 0] = True                     # never an empty bag
    return BagProblem(table=table, tokens=tokens.astype(np.int32),
                      valid=valid,
                      tenants=tuple(f"tenant{i % n_tenants}"
                                    for i in range(n_bags)))


def reference(prob: BagProblem) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential NumPy oracle. Returns (outs, final_table) where outs is
    (n_steps, n_bags) of bag-sum checksums."""
    table = prob.table.copy()
    vocab, d = table.shape
    outs = np.zeros((prob.n_steps, prob.n_bags, d), np.float32)
    for t in range(prob.n_steps):
        tok = prob.tokens[t]
        val = prob.valid[t]
        clamped = np.clip(tok, 0, vocab - 1)          # loads clamp
        rows = table[clamped] * val[..., None]
        outs[t] = rows.sum(axis=1)
        g = np.mod(outs[t], _GMOD)                    # surrogate gradient
        push_ok = val & (tok >= 0) & (tok < vocab)    # stores drop
        for b in range(prob.n_bags):
            for l in range(tok.shape[1]):
                if push_ok[b, l]:
                    table[tok[b, l]] += g[b]
    return outs, table


def run(prob: BagProblem, *, mode: str = "pipelined", service=None,
        mesh=None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Run the training stream; returns (outs, final_table) as NumPy.

    mode:
      "eager"      direct ``bulk_ops`` calls, hard barrier per phase
      "sequential" scheduler-submitted windows, barrier per phase
      "pipelined"  ``DecoupledLoop.run``: step t+1's lookup window is
                   queued while step t's bag reduction may still run
    service: an ``AccessService`` to share (default: a private one on
    ``device``, ``None`` = CUDA); mesh: must be None (ROADMAP A11).

    Raises ValueError on an unknown ``mode``.
    """
    service, dev = _common.placement(mode, service, mesh, device)
    vocab, d = prob.table.shape
    lanes = prob.tokens.shape[2]
    by_tenant = _common.by_tenant(prob.tenants)
    outs: List = [None] * prob.n_steps

    def bag_out(t, tname, rows):
        """Masked bag sums for one tenant's block of bags at step t."""
        bags = by_tenant[tname]
        val = torch.as_tensor(prob.valid[t][bags], device=dev)
        return torch.einsum("bld,bl->bd", rows, val.to(rows.dtype))

    def push_streams(t, g_by_bag):
        """(idx, grads, cond) per tenant for step t's gradient push —
        duplicate destinations on purpose; invalid lanes masked by cond,
        OOB tokens left in to exercise the drop policy."""
        per = {}
        for tname, bags in by_tenant.items():
            tok = prob.tokens[t][bags].reshape(-1)
            val = prob.valid[t][bags].reshape(-1)
            grads = torch.repeat_interleave(
                g_by_bag[torch.as_tensor(bags, device=dev)], lanes, dim=0)
            per[tname] = (torch.as_tensor(tok, device=dev), grads,
                          torch.as_tensor(val, device=dev))
        return per

    if mode == "eager":
        table = torch.as_tensor(prob.table, device=dev)
        for t in range(prob.n_steps):
            per_out = {}
            for tname, bags in by_tenant.items():
                tok = torch.as_tensor(prob.tokens[t][bags], device=dev)
                rows = bulk_ops.bulk_gather(table, tok, device=dev)
                per_out[tname] = bag_out(t, tname, rows)
            outs[t] = _common.collate(by_tenant, per_out)
            g = torch.remainder(outs[t], _GMOD)
            for tname, (tok, grads, cond) in push_streams(t, g).items():
                table = bulk_ops.bulk_rmw(table, tok, grads, op="ADD",
                                          cond=cond, device=dev)
            synchronize(dev)
        return torch.stack(outs).cpu().numpy(), table.cpu().numpy()

    sched = service.scheduler

    def access(loop, t, table):
        return {tname: loop.submit_gather(
                    table, np.asarray(prob.tokens[t][bags]), tenant=tname)
                for tname, bags in by_tenant.items()}

    def compute(t, table, results):
        per_out = {}
        for tname, bags in by_tenant.items():
            rows = results[tname].reshape(len(bags), lanes, d)
            per_out[tname] = bag_out(t, tname, rows)
        outs[t] = _common.collate(by_tenant, per_out)
        g = torch.remainder(outs[t], _GMOD)
        ts = [sched.submit_rmw(table, tok, grads, op="ADD", cond=cond,
                               tenant=tname)
              for tname, (tok, grads, cond) in push_streams(t, g).items()]
        # the push is the step's second window (the BFS/kv_serve shape);
        # every RMW ticket on the table resolves to its end-of-window
        # state. All are redeemed: a long-lived service would otherwise
        # keep each step's table alive through the others.
        sched.flush_async(inflight_ok=True)
        return [sched.result(tk) for tk in ts][0]

    table = torch.as_tensor(prob.table, device=dev)
    if mode == "sequential":
        table = run_sequential(service, table, prob.n_steps, access,
                               compute)
    else:
        table = DecoupledLoop(service).run(table, prob.n_steps, access,
                                           compute)
    return torch.stack(outs).cpu().numpy(), table.cpu().numpy()


def demo(seed: int = 0, *, mode: str = "pipelined", mesh=None,
         service=None, device=None) -> np.ndarray:
    """Seeded end-to-end training stream, flattened to one array (the
    parity checks compare lookup outputs AND the updated table)."""
    outs, table = run(make_problem(seed), mode=mode, mesh=mesh,
                      service=service, device=device)
    return np.concatenate([outs.reshape(-1), table.reshape(-1)])


def demo_reference(seed: int = 0) -> np.ndarray:
    """NumPy-oracle counterpart of ``demo`` (identical seeding)."""
    outs, table = reference(make_problem(seed))
    return np.concatenate([outs.reshape(-1), table.reshape(-1)])

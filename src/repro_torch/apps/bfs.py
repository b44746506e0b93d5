"""Level-synchronous BFS push — the paper's graph domain (GAP BFS).

Each level expands the frontier's CSR adjacency ranges through the Range
Fuser (``fuse_ranges`` — the paper's Fig. 5 unit, exactly the
frontier-expansion shape it exists for), gathers the neighbor ids with one
bulk fetch, and relaxes distances with one fused conditional ``MIN`` RMW:

    access  k : (outer, inner, total) = fuse_ranges(H[:-1], H[1:],
                                                    cond=frontier_k)
                nbrs = adj[inner]                   (submit_gather)
    compute k : dist = MIN-RMW(dist, nbrs, k+1, cond=valid)
                frontier_{k+1} = (dist == k+1)      (newly discovered)

The frontier is a dense boolean mask on the device and the fused edge
stream has static capacity (the edge count), so every shape is static and
the level loop never reads a value back on the host: pipelined, level
k+1's expansion is queued while level k's relaxation may still run on the
device (the planning's own dedup still sizes its output on the host).
Everything is int32, so every mode is bit-exact against the sequential
NumPy oracle (MIN is order-independent).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.apps import _common
from repro_torch.core import bulk_ops, range_fuser
from repro_torch.core.device import synchronize
from repro_torch.pipeline import DecoupledLoop, run_sequential

INF = np.int32(2 ** 30)


@dataclasses.dataclass
class Graph:
    indptr: np.ndarray   # (n+1,) int32 CSR offsets
    adj: np.ndarray      # (E,)   int32 neighbor ids

    @property
    def n(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.adj.shape[0]


def make_graph(seed: int = 0, *, n: int = 512, avg_deg: int = 4) -> Graph:
    """Random directed graph in CSR (degree-capped, self-loops allowed —
    they relax to a no-op)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 2 * avg_deg + 1, size=n)
    indptr = np.zeros(n + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    adj = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    return Graph(indptr, adj)


def reference(g: Graph, src: int, *, levels: int) -> np.ndarray:
    """Sequential frontier-queue BFS capped at ``levels`` hops."""
    dist = np.full(g.n, INF, np.int32)
    dist[src] = 0
    frontier = [src]
    for level in range(levels):
        nxt = []
        for v in frontier:
            for e in range(g.indptr[v], g.indptr[v + 1]):
                w = g.adj[e]
                if dist[w] == INF:
                    dist[w] = level + 1
                    nxt.append(w)
        frontier = nxt
    return dist


def run(g: Graph, src: int, *, levels: int, mode: str = "pipelined",
        service=None, mesh=None, device=None) -> np.ndarray:
    """BFS distances after ``levels`` push iterations (NumPy int32).

    Modes, ``service``, ``mesh`` and ``device`` as in ``apps.spmv.run``.
    The access phase exercises ``range_fuser`` (frontier expansion) + the
    scheduler's gather fast path; the compute phase submits the fused
    conditional MIN RMW.
    """
    service, dev = _common.placement(mode, service, mesh, device)
    lo = torch.as_tensor(g.indptr[:-1], device=dev)
    hi = torch.as_tensor(g.indptr[1:], device=dev)
    # an edgeless graph still runs: one sentinel row (every fused lane is
    # invalid, so it is never observed — gathers just need a non-empty table)
    adj = torch.as_tensor(g.adj if g.n_edges else np.zeros(1, np.int32),
                          device=dev)
    cap = max(g.n_edges, 1)
    dist0 = torch.full((g.n,), int(INF), dtype=torch.int32, device=dev)
    dist0[src] = 0
    frontier0 = torch.zeros((g.n,), dtype=torch.bool, device=dev)
    frontier0[src] = True

    def expand(frontier):
        outer, inner, total = range_fuser.fuse_ranges(
            lo, hi, capacity=cap, cond=frontier)
        valid = range_fuser.fused_valid_mask(total, cap)
        return inner, valid

    def level_values(level):
        return torch.full((cap,), level + 1, dtype=torch.int32, device=dev)

    if mode == "eager":
        dist, frontier = dist0, frontier0
        for level in range(levels):
            inner, valid = expand(frontier)
            nbrs = bulk_ops.bulk_gather(adj, inner, device=dev)
            dist = bulk_ops.bulk_rmw(dist, nbrs, level_values(level),
                                     op="MIN", cond=valid, device=dev)
            frontier = dist == (level + 1)
            synchronize(dev)
        return dist.cpu().numpy()

    sched = service.scheduler
    aux = {}   # k -> validity mask of that level's fused edge stream

    def access(loop, k, state):
        _, frontier = state
        inner, valid = expand(frontier)
        aux[k] = valid
        return loop.submit_gather(adj, inner)

    def compute(k, state, nbrs):
        dist, _ = state
        valid = aux.pop(k)
        t = sched.submit_rmw(dist, nbrs, level_values(k), op="MIN",
                             cond=valid)
        # second window of the level: the RMW. inflight_ok — this window
        # deliberately overlaps the loop's already-dispatched access
        # window (the in-flight guard exists for accidental overlap)
        sched.flush_async(inflight_ok=True)
        dist = sched.result(t)    # queued on the device, never read here
        return dist, dist == (k + 1)

    state = (dist0, frontier0)
    if mode == "sequential":
        state = run_sequential(service, state, levels, access, compute)
    else:
        state = DecoupledLoop(service).run(state, levels, access, compute)
    return state[0].cpu().numpy()


def demo(seed: int = 0, *, mode: str = "pipelined", mesh=None,
         levels: int = 8, service=None, device=None) -> np.ndarray:
    return run(make_graph(seed), 0, levels=levels, mode=mode, mesh=mesh,
               service=service, device=device)


def demo_reference(seed: int = 0, *, levels: int = 8) -> np.ndarray:
    return reference(make_graph(seed), 0, levels=levels)

"""Table-1 conformance suite: the paper's 12 benchmark access kernels as
compiler ``Pattern``s, with deterministic environments.

The port's copy of the JAX package's registry: the same builders, drawing
the same NumPy values in the same order, so ``build(name, seed)`` gives an
environment byte for byte the reference's; the patterns are the port's
``compiler`` classes. ``harness.check_pattern_parity`` holds every case
against the NumPy oracles.

Coverage of the Table-1 access-pattern space:
  direct range loops        spmv_csr, pagerank_pull, spmm_row_gather
  indirect range loops      bfs_push, bc_update
  1-3 indirection levels    everything; 3-level in pagerank_pull/bfs_push
  hash-style address math   hashjoin_build, hashjoin_probe, spatter_gather
  conditional accesses      ume_gradzone, db_filter, bc_update
  RMW ADD / MIN             histogram_is, spmv_csr, bfs_push, cc_propagate
  indirect ST / LD          hashjoin_build, xsbench_lookup, db_filter
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch.core.compiler import (Access, BinOp, Compare, Load, Pattern,
                                 RangeLoop, Var)


@dataclasses.dataclass
class Case:
    name: str
    pattern: Pattern
    env: Dict[str, np.ndarray]
    n: int

    def max_tile_fill(self, tile_size: int) -> int:
        """Worst per-tile fused-range fill (0 when no range loop)."""
        from repro_torch.testing import oracle
        return oracle.pattern_max_tile_fill(self.pattern, self.env, self.n,
                                            tile_size)


_BUILDERS: Dict[str, Callable] = {}


def _register(fn: Callable) -> Callable:
    _BUILDERS[fn.__name__] = fn
    return fn


def all_names():
    return tuple(_BUILDERS)


def build(name: str, seed: int = 0) -> Case:
    rng = np.random.default_rng(seed + 0xD100)
    return _BUILDERS[name](rng)


def _csr(rng, rows: int, max_len: int = 3):
    lens = rng.integers(0, max_len, size=rows)
    H = np.zeros(rows + 1, np.int32)
    H[1:] = np.cumsum(lens)
    return H, int(H[-1])


@_register
def spmv_csr(rng) -> Case:
    """y[i] += Aval[j] * x[col[j]] over j in [H[i], H[i+1])  (NAS CG/SpMV)."""
    rows, cols = 200, 160
    H, nnz = _csr(rng, rows)
    env = {"H": H,
           "Aval": rng.normal(size=max(nnz, 1)).astype(np.float32),
           "col": rng.integers(0, cols, size=max(nnz, 1)).astype(np.int32),
           "x": rng.normal(size=cols).astype(np.float32),
           "y": np.zeros(rows, np.float32)}
    pat = Pattern([Access(
        "RMW", "y", Var("i"),
        value=BinOp("MUL", Load("Aval", Var("j")),
                    Load("x", Load("col", Var("j")))),
        op="ADD", dtype="f32")],
        range_loop=RangeLoop("j", Load("H", Var("i")),
                             Load("H", BinOp("ADD", Var("i"), 1))),
        name="spmv_csr")
    return Case("spmv_csr", pat, env, rows)


@_register
def spmm_row_gather(rng) -> Case:
    """out[i] += Xflat[col[i]*D + j] over j in [0, D) — dense row gather
    and reduce of sparse-selected rows (SpMM row-gather)."""
    rows, nrows_x, D = 150, 64, 2
    env = {"Z": np.zeros(rows, np.int32),
           "Dv": np.full(rows, D, np.int32),
           "col": rng.integers(0, nrows_x, size=rows).astype(np.int32),
           "Xflat": rng.normal(size=nrows_x * D).astype(np.float32),
           "out": np.zeros(rows, np.float32)}
    pat = Pattern([Access(
        "RMW", "out", Var("i"),
        value=Load("Xflat",
                   BinOp("ADD", BinOp("MUL", Load("col", Var("i")), D),
                         Var("j"))),
        op="ADD", dtype="f32")],
        range_loop=RangeLoop("j", Load("Z", Var("i")),
                             Load("Dv", Var("i"))),
        name="spmm_row_gather")
    return Case("spmm_row_gather", pat, env, rows)


@_register
def hashjoin_build(rng) -> Case:
    """HT[key[i] & MASK] = payload[i]  (hash-join build, PRB)."""
    n, buckets = 400, 256
    env = {"K": rng.integers(0, 2 ** 20, size=n).astype(np.int32),
           "V": rng.normal(size=n).astype(np.float32),
           "HT": np.zeros(buckets, np.float32)}
    pat = Pattern([Access(
        "ST", "HT", BinOp("AND", Load("K", Var("i")), buckets - 1),
        value=Load("V", Var("i")), dtype="f32")],
        name="hashjoin_build")
    return Case("hashjoin_build", pat, env, n)


@_register
def hashjoin_probe(rng) -> Case:
    """out[i] = HT[B[(C[i] & F) >> G]]  (hash-join probe, PRH)."""
    n, buckets = 300, 256
    env = {"C": rng.integers(0, 2 ** 16, size=n).astype(np.int32),
           "B": rng.permutation(buckets).astype(np.int32),
           "HT": rng.normal(size=buckets).astype(np.float32),
           "out": np.zeros(n, np.float32)}
    pat = Pattern([Access(
        "ST", "out", Var("i"),
        value=Load("HT", Load("B", BinOp(
            "SHR", BinOp("AND", Load("C", Var("i")), 0xFF0), 4))),
        dtype="f32")],
        name="hashjoin_probe")
    return Case("hashjoin_probe", pat, env, n)


@_register
def histogram_is(rng) -> Case:
    """hist[key[i]] += 1  (NAS IS bucket counting)."""
    n, nbins = 500, 64
    env = {"key": (rng.zipf(1.4, size=n) % nbins).astype(np.int32),
           "one": np.ones(n, np.int32),
           "hist": np.zeros(nbins, np.int32)}
    pat = Pattern([Access(
        "RMW", "hist", Load("key", Var("i")),
        value=Load("one", Var("i")), op="ADD", dtype="i32")],
        name="histogram_is")
    return Case("histogram_is", pat, env, n)


@_register
def bfs_push(rng) -> Case:
    """depth[dst[j]] MIN= lvl[i] over j in [H[F[i]], H[F[i]+1])  (GAP BFS
    push step over a frontier F — indirect range loop)."""
    nodes, frontier = 128, 100
    H, nedge = _csr(rng, nodes)
    env = {"H": H,
           "F": rng.permutation(nodes)[:frontier].astype(np.int32),
           "dst": rng.integers(0, nodes,
                               size=max(nedge, 1)).astype(np.int32),
           "lvl": rng.integers(1, 10, size=frontier).astype(np.int32),
           "depth": np.full(nodes, 2 ** 30, np.int32)}
    pat = Pattern([Access(
        "RMW", "depth", Load("dst", Var("j")),
        value=Load("lvl", Var("i")), op="MIN", dtype="i32")],
        range_loop=RangeLoop(
            "j", Load("H", Load("F", Var("i"))),
            Load("H", BinOp("ADD", Load("F", Var("i")), 1))),
        name="bfs_push")
    return Case("bfs_push", pat, env, frontier)


@_register
def pagerank_pull(rng) -> Case:
    """rank[i] += contrib[src[j]] over j in [H[i], H[i+1])  (GAP PR)."""
    nodes = 160
    H, nedge = _csr(rng, nodes)
    env = {"H": H,
           "src": rng.integers(0, nodes,
                               size=max(nedge, 1)).astype(np.int32),
           "contrib": rng.random(nodes).astype(np.float32),
           "rank": np.zeros(nodes, np.float32)}
    pat = Pattern([Access(
        "RMW", "rank", Var("i"),
        value=Load("contrib", Load("src", Var("j"))),
        op="ADD", dtype="f32")],
        range_loop=RangeLoop("j", Load("H", Var("i")),
                             Load("H", BinOp("ADD", Var("i"), 1))),
        name="pagerank_pull")
    return Case("pagerank_pull", pat, env, nodes)


@_register
def ume_gradzone(rng) -> Case:
    """if D[i] >= 0: A[B[i]] += V[i]  (UME gradient-zone conditional RMW)."""
    n, zones = 400, 96
    env = {"B": rng.integers(0, zones, size=n).astype(np.int32),
           "D": rng.normal(size=n).astype(np.float32),
           "V": rng.normal(size=n).astype(np.float32),
           "A": np.zeros(zones, np.float32)}
    pat = Pattern([Access(
        "RMW", "A", Load("B", Var("i")), value=Load("V", Var("i")),
        op="ADD", dtype="f32",
        cond=Compare("GE", Load("D", Var("i")), 0.0))],
        name="ume_gradzone")
    return Case("ume_gradzone", pat, env, n)


@_register
def xsbench_lookup(rng) -> Case:
    """out[i] = xs[mat[i]*G + grid[i]]  (XSBench macro-XS lookup)."""
    n, mats, G = 350, 12, 32
    env = {"mat": rng.integers(0, mats, size=n).astype(np.int32),
           "grid": rng.integers(0, G, size=n).astype(np.int32),
           "xs": rng.random(mats * G).astype(np.float32),
           "out": np.zeros(n, np.float32)}
    pat = Pattern([Access(
        "ST", "out", Var("i"),
        value=Load("xs", BinOp("ADD",
                               BinOp("MUL", Load("mat", Var("i")), G),
                               Load("grid", Var("i")))),
        dtype="f32")],
        name="xsbench_lookup")
    return Case("xsbench_lookup", pat, env, n)


@_register
def spatter_gather(rng) -> Case:
    """out[i] = data[idxbuf[i & 127]]  (Spatter repeating gather pattern)."""
    n, npat, rows = 512, 128, 1024
    env = {"idxbuf": rng.integers(0, rows, size=npat).astype(np.int32),
           "data": rng.normal(size=rows).astype(np.float32),
           "out": np.zeros(n, np.float32)}
    pat = Pattern([Access(
        "ST", "out", Var("i"),
        value=Load("data", Load("idxbuf",
                                BinOp("AND", Var("i"), npat - 1))),
        dtype="f32")],
        name="spatter_gather")
    return Case("spatter_gather", pat, env, n)


@_register
def bc_update(rng) -> Case:
    """if D[j] < c: delta[dst[j]] += w[i] over j in [H[i], H[i+1])
    (GAP BC dependency accumulation — conditional + fused range)."""
    nodes = 144
    H, nedge = _csr(rng, nodes)
    env = {"H": H,
           "dst": rng.integers(0, nodes,
                               size=max(nedge, 1)).astype(np.int32),
           "D": rng.normal(size=max(nedge, 1)).astype(np.float32),
           "w": rng.random(nodes).astype(np.float32),
           "delta": np.zeros(nodes, np.float32)}
    pat = Pattern([Access(
        "RMW", "delta", Load("dst", Var("j")),
        value=Load("w", Var("i")), op="ADD", dtype="f32",
        cond=Compare("LT", Load("D", Var("j")), 0.5))],
        range_loop=RangeLoop("j", Load("H", Var("i")),
                             Load("H", BinOp("ADD", Var("i"), 1))),
        name="bc_update")
    return Case("bc_update", pat, env, nodes)


@_register
def db_filter(rng) -> Case:
    """if qual[i] < 0.5: out[pos[i]] = val[i]  (DB selection scatter)."""
    n = 320
    env = {"qual": rng.random(n).astype(np.float32),
           "pos": rng.permutation(n).astype(np.int32),
           "val": rng.normal(size=n).astype(np.float32),
           "out": np.zeros(n, np.float32)}
    pat = Pattern([Access(
        "ST", "out", Load("pos", Var("i")), value=Load("val", Var("i")),
        dtype="f32", cond=Compare("LT", Load("qual", Var("i")), 0.5))],
        name="db_filter")
    return Case("db_filter", pat, env, n)

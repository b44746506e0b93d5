"""Hash-join probe — the paper's database domain (hash join, Table 1).

The build side lives in an open-addressed hash table (one slot per
bucket, collisions dropped at build time — the probe side never chains).
Probing is the DX100 shape end to end, expressed as an *AccessProgram*
per probe tile, so it exercises the ISA paths the bulk fast-lanes don't:

    SLD   t_k  = S[tile_base + i]          probe keys (strided stream)
    SLD   t_i  = iota[tile_base + i]       global positions
    ALUS  t_b  = t_k AND (m-1)             hash (bucket index)
    ILD   t_h  = HTK[t_b]                  bucket key (indirect load)
    ALUS  t_v  = t_i LT tile_end           trip-count guard
    ALUV  t_eq = t_h EQ t_k                key match
    ALUV  t_c  = t_eq AND t_v              condition tile (TC)
    ILD   t_p  = HTV[t_b]        if t_c    conditional payload load
    IST   OUT[t_i] = t_p         if t_c    conditional store of matches
    IRMW  CNT[0] += 1            if t_c    conditional match counter

Probe tiles are independent, so the pipelined mode drives them through
``DecoupledLoop.run_windows``: ``tiles_per_window`` same-signature
programs per flush window batch into ONE lane-batched engine run (the
scheduler's structural grouping), and up to ``depth`` windows stay in
flight ahead of the compute that slices the matches back out. Integer
end to end — every mode is bit-exact against the NumPy oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.apps import _common
from repro_torch.core import isa
from repro_torch.core.device import synchronize
from repro_torch.core.engine import Engine
from repro_torch.pipeline import DecoupledLoop

MISS = np.int32(-1)


@dataclasses.dataclass
class JoinProblem:
    ht_key: np.ndarray    # (m,) int32 bucket keys (MISS = empty)
    ht_val: np.ndarray    # (m,) int32 payloads
    probe: np.ndarray     # (n_probe,) int32 probe keys

    @property
    def n_buckets(self) -> int:
        return self.ht_key.shape[0]


def make_problem(seed: int = 0, *, n_build: int = 300, n_probe: int = 1024,
                 log2_buckets: int = 11) -> JoinProblem:
    """Build table + probe stream. Half the probes hit inserted keys."""
    rng = np.random.default_rng(seed)
    m = 1 << log2_buckets
    keys = rng.choice(1 << 20, size=n_build, replace=False).astype(np.int32)
    ht_key = np.full(m, MISS, np.int32)
    ht_val = np.zeros(m, np.int32)
    inserted = []
    for k in keys:
        b = int(k) & (m - 1)
        if ht_key[b] == MISS:          # collisions dropped at build time
            ht_key[b] = k
            ht_val[b] = int(k) % 9973 + 1
            inserted.append(k)
    hits = rng.choice(np.asarray(inserted, np.int32), size=n_probe // 2)
    misses = rng.integers(0, 1 << 20, size=n_probe - hits.shape[0])
    probe = np.concatenate([hits, misses.astype(np.int32)])
    rng.shuffle(probe)
    return JoinProblem(ht_key, ht_val, probe.astype(np.int32))


def reference(prob: JoinProblem) -> tuple:
    """Sequential NumPy oracle: (out, n_matches)."""
    m = prob.n_buckets
    out = np.full(prob.probe.shape[0], MISS, np.int32)
    count = 0
    for i, k in enumerate(prob.probe):
        b = int(k) & (m - 1)
        if prob.ht_key[b] == k:
            out[i] = prob.ht_val[b]
            count += 1
    return out, count


def probe_program(tile_size: int, m: int) -> isa.AccessProgram:
    """The conditional-ILD/IST probe kernel for one tile (docstring ISA)."""
    return isa.AccessProgram([
        isa.SLD("i32", "S", "t_k", rs1="tile_base"),
        isa.SLD("i32", "__iota__", "t_i", rs1="tile_base"),
        isa.ALUS("i32", "AND", "t_b", "t_k", rs=m - 1),
        isa.ILD("i32", "HTK", "t_h", "t_b"),
        isa.ALUS("i32", "LT", "t_v", "t_i", rs="tile_end"),
        isa.ALUV("i32", "EQ", "t_eq", "t_h", "t_k"),
        isa.ALUV("i32", "AND", "t_c", "t_eq", "t_v"),
        isa.ALUS("i32", "MUL", "t_z", "t_i", rs=0),        # zero tile
        isa.ALUS("i32", "ADD", "t_one", "t_z", rs=1),      # ones tile
        isa.ILD("i32", "HTV", "t_p", "t_b", tc="t_c"),     # conditional ILD
        isa.IST("i32", "OUT", "t_i", "t_p", tc="t_c"),     # conditional IST
        isa.IRMW("i32", "CNT", "ADD", "t_z", "t_one", tc="t_c"),
    ], tile_size=tile_size, name="hashjoin_probe")


def _tile_env(prob: JoinProblem, tile_size: int, dev) -> Dict:
    """Shared env pieces (padded probe stream + iota + scratch tiles)."""
    n = prob.probe.shape[0]
    n_pad = -(-n // tile_size) * tile_size
    s = np.full(n_pad, 0, np.int32)
    s[:n] = prob.probe
    return {
        "S": torch.as_tensor(s, device=dev),
        "__iota__": torch.arange(n_pad, dtype=torch.int32, device=dev),
        "HTK": torch.as_tensor(prob.ht_key, device=dev),
        "HTV": torch.as_tensor(prob.ht_val, device=dev),
    }


def run(prob: JoinProblem, *, tile_size: int = 256,
        tiles_per_window: int = 4, mode: str = "pipelined",
        service=None, mesh=None, device=None) -> tuple:
    """Probe every key; returns ``(out, n_matches)`` — ``out[i]`` is the
    matched payload or MISS.

    Eager runs one ``Engine.run`` per tile with a barrier each; pipelined
    drives ``tiles_per_window``-program windows through
    ``DecoupledLoop.run_windows`` (lane-batched by the scheduler, ``depth``
    windows in flight); sequential is the same at ``depth=1`` with a
    barrier around every compute phase. ``service``, ``mesh`` and
    ``device`` as in ``apps.spmv.run``."""
    service, dev = _common.placement(mode, service, mesh, device,
                             tile_size=tile_size)
    n = prob.probe.shape[0]
    tile_size = int(tile_size)
    env0 = _tile_env(prob, tile_size, dev)
    n_tiles = env0["S"].shape[0] // tile_size
    prog = probe_program(tile_size, prob.n_buckets)

    def tile_env(t0):
        count = min(tile_size, max(n - t0 * tile_size, 0))
        env = dict(env0)
        env["OUT"] = torch.full((env0["S"].shape[0],), int(MISS),
                                dtype=torch.int32, device=dev)
        env["CNT"] = torch.zeros((1,), dtype=torch.int32, device=dev)
        regs = {"tile_base": t0 * tile_size, "N": count,
                "tile_end": t0 * tile_size + count}
        return env, regs

    def slice_out(env_out, t0):
        # a copy of the tile's slice, so the full-length OUT is released
        lo = t0 * tile_size
        return env_out["OUT"][lo:lo + tile_size].clone(), env_out["CNT"]

    if mode == "eager":
        eng = Engine(tile_size=tile_size, device=dev)
        outs = []
        for t0 in range(n_tiles):
            env, regs = tile_env(t0)
            env_out, _ = eng.run(prog, env, regs)
            outs.append(slice_out(env_out, t0))
            synchronize(dev)
    else:
        windows = [list(range(w, min(w + tiles_per_window, n_tiles)))
                   for w in range(0, n_tiles, tiles_per_window)]

        def access(loop, k, tiles):
            tickets = []
            for t0 in tiles:
                env, regs = tile_env(t0)
                tickets.append(loop.submit(prog, env, regs,
                                           tenant=f"tile{t0}"))
            return tickets

        def compute(k, tiles, results):
            return [slice_out(env_out, t0)
                    for t0, (env_out, _) in zip(tiles, results)]

        if mode == "pipelined":
            outs = DecoupledLoop(service).run_windows(
                windows, access, compute)
        else:
            # strictly-coupled baseline: one window in flight, hard
            # barrier around every compute phase
            def compute_sync(k, tiles, results):
                synchronize(dev)
                out = compute(k, tiles, results)
                synchronize(dev)
                return out

            outs = DecoupledLoop(service, depth=1).run_windows(
                windows, access, compute_sync)
        outs = [piece for win in outs for piece in win]

    out = torch.cat([o for o, _ in outs]).cpu().numpy()[:n]
    n_matches = int(torch.cat([c for _, c in outs]).sum())
    return out, n_matches


def demo(seed: int = 0, *, mode: str = "pipelined", mesh=None,
         service=None, device=None) -> np.ndarray:
    out, count = run(make_problem(seed), mode=mode, mesh=mesh,
                     service=service, device=device)
    return np.concatenate([out, np.asarray([count], np.int32)])


def demo_reference(seed: int = 0) -> np.ndarray:
    out, count = reference(make_problem(seed))
    return np.concatenate([out, np.asarray([count], np.int32)])

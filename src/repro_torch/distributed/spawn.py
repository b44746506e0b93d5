"""Run a function on every rank of a fresh process group, one process per
rank: the launcher behind the process-mesh tests and ``chip_smoke.py``'s
phases 13–18, and the ``torch.multiprocessing`` route to a
``ProcessMesh`` (``torchrun --nproc-per-node=N`` is the other).

The ranks are forked from ``torch.multiprocessing``'s forkserver, which
has imported torch once (``PRELOAD``): a rank starts in about a second
where a spawned interpreter spends seconds importing torch again (on an
H100 machine, ~11.5 s to start four spawned ranks, ~1.6 s from a warm
forkserver: ``src/repro_torch/bench/spawn_cost.py``). The server also
imports ``torch._dynamo``, which a process's first ``FakeTensorMode``
imports (sympy among its many modules): the process-mesh train step
builds its params' shapes as fake tensors, and each rank would pay for
that import again (``src/repro_torch/bench/rank_setup_cost.py``). The
server never initialises CUDA, so its children may. As with spawn,
``fn`` and its arguments are pickled (module-level functions), and the
ranks inherit the environment the parent had when the server started.

    def work(rank, world, scale):          # module level: spawn pickles it
        mesh = process_mesh(device="cpu")
        ...
        return result                      # picklable

    results = run_ranks(work, 4, args=(2,), backend="gloo",
                        init_method="file://" + store_path)

A rank that raises, dies or outlives ``join_timeout`` fails the call: the
others are killed and ``RankFailure`` names what happened on each rank.
"""
from __future__ import annotations

import datetime
import os
import time


# imported once, by the server (none starts a thread or touches CUDA)
PRELOAD = ("torch", "torch.distributed", "torch._dynamo")


class RankFailure(RuntimeError):
    """A rank raised, died or hung."""


def _child(rank, world, fn, args, backend, init_method, timeout, results):
    import torch
    import torch.distributed as dist
    # ranks share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    if backend == "nccl":
        os.environ["LOCAL_RANK"] = str(rank % torch.cuda.device_count())
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        # every rank has joined before any runs fn: a rank that returns at
        # once would otherwise tear its side down while another is still
        # connecting (gloo's connectFullMesh then fails on that one)
        dist.barrier()
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def run_ranks(fn, world: int, *, args: tuple = (), backend: str = "gloo",
              init_method: str, timeout: float = 120.0,
              join_timeout: float = 600.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned processes joined in
    one ``backend`` group (``init_method``: a ``file://`` store or a
    ``tcp://localhost:<port>`` address; ``timeout`` seconds for each
    collective). Returns every rank's result in rank order. Raises
    ``RankFailure`` if a rank raises, exits without a result or has not
    finished ``join_timeout`` seconds after the start."""
    import torch.multiprocessing as mp
    mp_ctx = mp.get_context("forkserver")
    mp_ctx.set_forkserver_preload(list(PRELOAD))
    results = mp_ctx.SimpleQueue()
    ctx = mp.start_processes(
        _child, args=(world, fn, args, backend, init_method, timeout,
                      results),
        nprocs=world, join=False, daemon=True, start_method="forkserver")
    got, deadline = {}, time.monotonic() + join_timeout

    def drain():                    # a rank blocks on a full pipe
        while not results.empty():
            rank, out = results.get()
            got[rank] = out
    try:
        while True:
            drain()
            try:
                if ctx.join(timeout=1.0):
                    break
            except mp.ProcessRaisedException as e:
                # join stopped the other ranks; e names the failed one
                raise RankFailure(f"--- rank {e.error_index} raised:"
                                  f"{e}") from None
            except mp.ProcessExitedException as e:
                raise RankFailure(f"rank(s) [{e.error_index}] died "
                                  f"(exit code {e.exit_code})") from None
            if time.monotonic() > deadline:
                hung = [r for r, p in enumerate(ctx.processes)
                        if p.is_alive()]
                raise RankFailure(f"rank(s) {hung} hung past "
                                  f"{join_timeout:.0f} s")
        drain()
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    missing = [r for r in range(world) if r not in got]
    if missing:
        raise RankFailure(f"rank(s) {missing} exited without a result")
    return [got[r] for r in range(world)]

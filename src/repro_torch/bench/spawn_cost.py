"""Seconds to start a trivial process group on the card, by start method.

    python3 src/repro_torch/bench/spawn_cost.py

Each group (worlds 1 and 4, gloo, every rank on card 0) joins, touches
the card, meets at a barrier and exits; "spawn" starts a fresh
interpreter per rank, which imports torch again, "forkserver" forks the
ranks from a server that imported torch once (``distributed.spawn``'s
launcher). Each method runs twice: the forkserver's first group pays for
starting the server.
"""
import datetime
import time


def child(rank, world, init, q):
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    torch.zeros(1, device="cuda")
    dist.barrier()
    dist.destroy_process_group()
    q.put(rank)


def main():
    import tempfile
    t = time.perf_counter()
    import torch.multiprocessing as mp
    print(f"import torch {time.perf_counter() - t:.2f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for i, method in enumerate(("spawn", "forkserver") * 2):
            ctx = mp.get_context(method)
            if method == "forkserver":
                ctx.set_forkserver_preload(["torch", "torch.distributed"])
            for world in (1, 4):
                q = ctx.SimpleQueue()
                t = time.perf_counter()
                mp.start_processes(
                    child, args=(world, f"file://{tmp}/store{i}_{world}", q),
                    nprocs=world, join=True, start_method=method)
                print(f"{method} world {world}: "
                      f"{time.perf_counter() - t:.2f} s", flush=True)


if __name__ == "__main__":
    main()

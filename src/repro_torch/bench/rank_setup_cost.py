"""Seconds a spawned rank spends before its first train step, by what the
launcher's forkserver preloads.

    python3 src/repro_torch/bench/rank_setup_cost.py [--device cuda:0]

For each preload set (torch alone, as the launcher had it, then
``distributed.spawn.PRELOAD``) a fresh interpreter starts a forkserver
with that set and forks one gloo rank, which times its set-up steps on
``device`` twice over: the first ``abstract_params`` (the process-mesh
step's fake-tensor shapes) pays for importing ``torch._dynamo`` unless
the server already has it.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BASE = ("torch", "torch.distributed")


def rank(rank, world, device, q):
    import datetime
    import torch
    import torch.distributed as dist
    t = [time.perf_counter()]
    marks = []

    def mark(what):
        now = time.perf_counter()
        marks.append((what, round(now - t[0], 3)))
        t[0] = now
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
    mark("init_process_group")
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import abstract_params
    mark("import repro_torch")
    torch.zeros(1, device=device).sum().item()
    mark("first op on the device")
    cfg = get_config("rwkv6-1.6b")
    for i in (1, 2):
        abstract_params(cfg)
        mark(f"abstract_params #{i}")
    dist.destroy_process_group()
    q.put(marks)


def one(preload: list, device: str) -> list:
    import torch.multiprocessing as mp
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(preload)
    q = ctx.SimpleQueue()
    t = time.perf_counter()
    p = ctx.Process(target=rank, args=(0, 1, device, q))
    p.start()
    marks = q.get()
    p.join()
    return [("server start and fork to result", round(time.perf_counter()
                                                      - t, 3))] + marks


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--preload", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    if args.preload is not None:                    # the child interpreter
        print(json.dumps(one(json.loads(args.preload), args.device)))
        return
    from repro_torch.distributed.spawn import PRELOAD
    for preload in (list(BASE), list(PRELOAD)):
        out = subprocess.run([sys.executable, __file__, "--device",
                              args.device, "--preload", json.dumps(preload)],
                             check=True, capture_output=True, text=True)
        marks = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"preload {preload}: " + ", ".join(f"{w} {s:.2f} s"
                                                 for w, s in marks))


if __name__ == "__main__":
    main()

"""Card and host memory of ``chip_smoke.py`` phase 16's f32 check when
four ranks share one GPU.

    python3 src/repro_torch/bench/train_mesh_memory.py [--phase16]

Spawns four gloo ranks on card 0 (mesh (2, 2)). Each runs phase 16 (a)
at Qwen3-0.6B's whole depth (``chip_smoke.tm_train``), then one f32 step
of the whole model at 2 x 128 on the mesh, after rank 0 has run the
one-device step in float64 with float64 AdamW moments and copied its
result to the host: the heaviest form of the check, the one that leaves
the least card memory to the others. Every rank prints to stderr, at
each stage, the card memory it has allocated, its peak and its reserve,
the card's free memory (all ranks together), its resident host memory
and the host's available memory. A rank that raises prints its
traceback and its memory first. ``--phase16`` runs phase 16's gloo
groups (``chip_smoke.phase_train_mesh``) before. Prints the card's name
and power limit first and each rank's result last.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
WORLD = 4


def report(rank, tag, dev):
    import torch
    status = dict(line.split(":", 1) for line in
                  Path("/proc/self/status").read_text().splitlines()
                  if line.startswith(("VmRSS", "VmHWM")))
    avail = next(line for line in
                 Path("/proc/meminfo").read_text().splitlines()
                 if line.startswith("MemAvailable"))
    free, total = torch.cuda.mem_get_info(dev)
    gib = 2 ** 30
    print(f"rank {rank} {tag}: card allocated "
          f"{torch.cuda.memory_allocated(dev) / gib:.2f} peak "
          f"{torch.cuda.max_memory_allocated(dev) / gib:.2f} reserved "
          f"{torch.cuda.memory_reserved(dev) / gib:.2f} GiB, card free "
          f"{free / gib:.2f} of {total / gib:.2f} GiB; host "
          f"{ {k: v.strip() for k, v in status.items()} }; {avail}",
          file=sys.stderr, flush=True)


def f64_check(rank, dev, seed, cfg, shape, b, s):
    """One f32 mesh step; rank 0 first runs the float64 one-device step
    with float64 moments and copies it to the host."""
    import dataclasses
    import torch
    from repro_torch.core.tree import tree_map
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import make_train_step, shard_train_step
    mesh = meshlib.make_process_mesh(shape, ("data", "model"), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    report(rank, "check start", dev)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    batch = SyntheticTokenPipeline(cfg, b, s, seed=seed,
                                   device=dev).get_batch(0)
    report(rank, "check init", dev)
    ref = None
    if rank == 0:
        wide = dataclasses.replace(cfg, dtype="float64",
                                   param_dtype="float64", moe_a2a=False)
        to64 = lambda t: t.to(dev, torch.float64) \
            if t.is_floating_point() else t
        p64 = tree_map(to64, params)
        p64, o64, m64 = make_train_step(build_model(wide, device=dev))(
            p64, adamw_init(p64, state_dtype="float64"),
            {k: to64(v) for k, v in batch.items()})
        torch.cuda.synchronize(dev)
        report(rank, "check float64 step", dev)
        ref = (tree_map(lambda t: t.cpu(), {"p": p64, "o": o64}),
               {k: float(v) for k, v in m64.items()})
        report(rank, "check float64 state on the host", dev)
        del p64, o64
        torch.cuda.empty_cache()
    step = shard_train_step(model, mesh, params, None, batch)
    ps, ospecs, bs = step.in_specs
    p = meshlib.shard_tree(params, ps, mesh)
    o = adamw_init(meshlib.shard_tree(params, ospecs["mu"], mesh),
                   state_dtype="float32")
    bb = meshlib.shard_tree(batch, bs, mesh)
    del params
    report(rank, "check before the mesh step", dev)
    p, o, m = step(p, o, bb)
    torch.cuda.synchronize(dev)
    report(rank, "check after the mesh step", dev)
    return {"loss": float(m["loss"]),
            "float64_loss": ref[1]["loss"] if ref else None}


def rank_main(rank, world, seed, tmp):
    import dataclasses
    import torch
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    dev = torch.device("cuda", 0)
    try:
        report(rank, "start", dev)
        qwen = get_config(cs.TRAIN_ARCH)
        a = cs.tm_train(rank, "cuda:0", seed, Path(tmp), qwen)
        report(rank, "after (a)", dev)
        torch.cuda.empty_cache()
        f32 = dataclasses.replace(qwen, dtype="float32",
                                  param_dtype="float32")
        b, s = cs.TRAIN_CHECK_MESH
        return {"a_ms": a["median"],
                "check": f64_check(rank, dev, seed, f32, a["shape"], b, s)}
    except BaseException:
        print(f"rank {rank} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        report(rank, "at the failure", dev)
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase16", action="store_true",
                    help="run phase 16's gloo groups first")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import tempfile
    import torch
    import chip_smoke as cs
    from repro_torch.distributed.spawn import run_ranks
    if not torch.cuda.is_available():
        print("train_mesh_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.phase_device(), flush=True)
    if args.phase16:
        t0 = time.perf_counter()
        print(cs.phase_train_mesh(dev, 0, groups=cs.PM_GROUPS[1:]),
              flush=True)
        print(f"phase 16 gloo groups {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        got = run_ranks(rank_main, WORLD, args=(0, tmp), backend="gloo",
                        init_method=f"file://{tmp}/store",
                        timeout=cs.PM_COLLECTIVE_S, join_timeout=600)
    print(f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(got)
    return 0


if __name__ == "__main__":
    sys.exit(main())

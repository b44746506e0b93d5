"""End-to-end training launcher with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 50 --batch 8 --seq 128 [--reduced] [--ckpt-dir ckpts] \\
      [--ckpt-every 20] [--resume] [--data-shards 1 --shard 0] \\
      [--device cuda]

The port of the JAX package's ``launch.train``, with its flags plus
``--device`` (default ``cuda``; ``--device cpu --reduced`` runs on a CPU).
Batches come from ``SyntheticTokenPipeline`` (seeded by ``--seed``), so a
run resumed from a checkpoint replays the same batches and, where the
device's kernels are deterministic, the same steps bit for bit.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer


def main(argv=None, *, history: Optional[list] = None) -> int:
    """Run the CLI. ``history``, when given, receives one dict per step
    (``step`` and the step's metrics as Python floats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    trainer = Trainer(model=model, mesh=None, peak_lr=args.lr,
                      warmup=max(args.steps // 10, 1),
                      total_steps=args.steps)
    params, opt = trainer.init_state(args.seed)
    start_step = 0

    if args.ckpt_dir and args.resume:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, extra, start_step = ckpt.load_checkpoint(
                args.ckpt_dir, {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            print(f"resumed from step {start_step}")

    pipe = SyntheticTokenPipeline(cfg, args.batch, args.seq,
                                  seed=args.seed,
                                  num_shards=args.data_shards,
                                  shard=args.shard, device=model.device)
    step_fn = trainer.jitted_step()

    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = pipe.get_batch(step)
        params, opt, metrics = step_fn(params, opt, batch)
        if history is not None:
            history.append({"step": step, **{k: float(v)
                                             for k, v in metrics.items()}})
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save_checkpoint(
                args.ckpt_dir, step + 1, {"params": params, "opt": opt},
                extra=pipe.cursor_state(step + 1))
            print(f"checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

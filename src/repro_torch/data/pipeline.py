"""Deterministic synthetic token pipeline, shardable across hosts.

Batch content is a pure function of (seed, step, shard): any host can
(re)produce any shard of any step, so a restarted or re-balanced job
resumes bit-exactly from the checkpointed step cursor with no data-loader
state to restore.

The port of the JAX package's ``data.pipeline``: the same generator and
draws, so every batch is the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.batches import _token_shapes, normal_tensor


@dataclasses.dataclass
class SyntheticTokenPipeline:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 1234
    kind: str = "train"
    num_shards: int = 1
    shard: int = 0
    device: Any = None             # where batches land; None = CUDA

    def __post_init__(self):
        if self.global_batch % self.num_shards != 0:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split into {self.num_shards} shards")
        self.local_batch = self.global_batch // self.num_shards
        self.device = resolve_device(self.device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))

    def get_batch(self, step: int):
        """Local shard of the global batch for ``step`` (pure function)."""
        rng = self._rng(step)
        shapes = _token_shapes(self.cfg, self.local_batch, self.seq_len,
                               self.kind)
        out = {}
        for k, (shape, dt) in shapes.items():
            if dt == torch.int32:
                # zipf-ish skewed token stream: exercises the coalescing
                # path the way real text (and the paper's workloads) do
                toks = rng.zipf(1.3, size=shape) % self.cfg.vocab
                out[k] = torch.from_numpy(toks.astype(np.int32))
            else:
                out[k] = normal_tensor(rng, shape, dt, self.device)
        if self.kind == "train":
            # next-token labels
            toks = out["tokens"]
            out["labels"] = torch.cat([toks[:, 1:],
                                       torch.zeros_like(toks[:, :1])], 1)
        return {k: v.to(self.device) for k, v in out.items()}

    def cursor_state(self, step: int) -> dict:
        """What the checkpoint manifest stores to resume the pipeline."""
        return {"seed": self.seed, "step": step, "kind": self.kind,
                "num_shards": self.num_shards}

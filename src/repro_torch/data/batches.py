"""Batch construction: concrete tensors (tests/benchmarks) and
``ShapeDtypeStruct`` stand-ins (the dry run: no allocation).

Per-family input trees:
  dense/moe/ssm : {"tokens", "labels"} (train) | {"tokens"} (serve)
  vlm           : + "patch_embeds" (stubbed modality frontend): the text
                  stream shrinks so text+patches == seq_len.
  encdec        : {"src_embeds" (stub audio frames), "tokens", "labels"};
                  seq_len splits half source / half target.

The port of the JAX package's ``data.batches``: the same NumPy draws in
the same order, so a batch is the reference's bit for bit (bf16 stubs
rounded to nearest even from the same f32 draws).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device

VLM_PATCH_FRAC = 16   # 1/16 of the sequence are image patches


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A tensor's shape and dtype with no storage: the counterpart of
    ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _token_shapes(cfg: ModelConfig, batch: int, seq: int, kind: str):
    """Returns dict name -> (shape, dtype) for the given cell."""
    emb_dt = cfg.activation_dtype
    out = {}
    if cfg.family == "encdec":
        s_src = seq // 2
        s_tgt = seq - s_src
        out["src_embeds"] = ((batch, s_src, cfg.d_model), emb_dt)
        out["tokens"] = ((batch, s_tgt), torch.int32)
        if kind == "train":
            out["labels"] = ((batch, s_tgt), torch.int32)
        return out
    if cfg.family == "vlm" and kind in ("train", "prefill"):
        s_img = max(seq // VLM_PATCH_FRAC, 1)
        s_txt = seq - s_img
        out["patch_embeds"] = ((batch, s_img, cfg.d_model), emb_dt)
        out["tokens"] = ((batch, s_txt), torch.int32)
        if kind == "train":
            out["labels"] = ((batch, s_txt), torch.int32)
        return out
    out["tokens"] = ((batch, seq), torch.int32)
    if kind == "train":
        out["labels"] = ((batch, seq), torch.int32)
    return out


def _shapes(cfg, batch, seq, kind):
    if kind == "decode":
        return {"tokens": ((batch, 1), torch.int32)}
    return _token_shapes(cfg, batch, seq, kind)


def input_specs(cfg: ModelConfig, *, batch: int, seq: int,
                kind: str = "train"):
    """``ShapeDtypeStruct`` tree of a cell's inputs — no allocation.

    For decode, ``seq`` is the CONTEXT length; tokens are (batch, 1) and
    the KV cache (sized seq) is a separate argument.
    """
    return {k: ShapeDtypeStruct(tuple(s), d)
            for k, (s, d) in _shapes(cfg, batch, seq, kind).items()}


def normal_tensor(rng: np.random.Generator, shape, dtype,
                  device) -> torch.Tensor:
    """``rng.normal`` drawn in f32, then cast (round to nearest even)."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(device=device, dtype=dtype)


def make_batch(cfg: ModelConfig, *, batch: int, seq: int,
               kind: str = "train", seed: int = 0, device=None):
    """Concrete synthetic batch matching ``input_specs``, on ``device``
    (None = CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dt) in _shapes(cfg, batch, seq, kind).items():
        if dt == torch.int32:
            toks = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
            out[k] = torch.from_numpy(toks).to(dev)
        else:
            out[k] = normal_tensor(rng, shape, dt, dev)
    return out

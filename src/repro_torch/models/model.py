"""build_model(cfg) -> Model: a uniform facade over the model families.

Model methods (all plain functions of (params, batch[, cache])):
  init(seed | generator)          -> params                  [random init]
  forward(params, batch)          -> (logits, aux_loss)      [train]
  loss(params, batch)             -> scalar                  [train]
  init_cache(batch, max_len)      -> cache                   [serve]
  prefill(params, batch, cache)   -> (logits, cache)         [serve]
  decode_step(params, batch, cache) -> (logits, cache)       [serve]

The port of the JAX package's ``models.model``. ``build_model`` takes the
device the model runs on (``None`` = CUDA, ``core.device``); params are a
dict of tensors with the reference's keys and layouts
(``core.interop.params_from_numpy`` carries a JAX parameter tree over).
The dense, MoE and VLM families are built; hybrid, SSM and encoder-decoder
models are ROADMAP A12.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as TF


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (B,S,V), labels (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable

    def loss(self, params, batch):
        logits, aux = self.forward(params, batch)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=logits.device)
        return softmax_xent(logits, labels, mask) + 0.01 * aux


def _generator(seed_or_gen, device: torch.device) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


def build_model(cfg: ModelConfig, *, device=None) -> Model:
    """The model of ``cfg`` on ``device``. ``init`` takes a seed or a
    ``torch.Generator`` (whose device the params land on)."""
    fam = cfg.family
    dev = resolve_device(device)
    if fam in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg, device=dev,
            init=lambda key: TF.init_lm(_generator(key, dev), cfg),
            forward=lambda p, b: TF.lm_forward(p, b, cfg),
            init_cache=lambda batch, max_len, **kw: TF.lm_init_cache(
                cfg, batch, max_len, device=dev, **kw),
            prefill=lambda p, b, c: TF.lm_prefill(p, b, cfg, c),
            decode_step=lambda p, b, c: TF.lm_decode_step(p, b, cfg, c),
        )
    if fam in ("hybrid", "ssm", "encdec"):
        raise NotImplementedError(
            f"family {fam!r} ({cfg.name}) is not ported yet: ROADMAP A12")
    raise ValueError(f"unknown family {fam!r}")

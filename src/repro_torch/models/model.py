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
All five families are built: dense/MoE/VLM (``transformer``), hybrid
(``hybrid``: Mamba + attention), SSM (``rwkv_lm``) and encoder-decoder
(``encdec``, whose ``init_cache`` takes ``src_len``, default ``max_len``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import parallel as P
from repro_torch.models import rwkv_lm as RW
from repro_torch.models import transformer as TF
from repro_torch.models.layers import acc


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, *,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; logits (B,S,V), labels (B,S).

    On a process mesh (``models.parallel``) ``logits`` may be the rank's
    vocabulary columns of ``vocab`` (the tied head's ``model`` cut): the
    log-sum-exp takes its maximum and sum over ``model``, the gold logit
    comes from the rank that owns the label. The mean is over the global
    batch: the sum and the count are summed over the data-parallel axes
    (nothing where the batch is whole on every rank), never a mean of
    the shards' means."""
    mesh = P.rank_mesh()
    logits = acc(logits)
    v = logits.shape[-1]
    if vocab is not None and P.sharded(v, vocab):
        top = P.all_max(logits.amax(dim=-1), mesh)
        sumexp = torch.exp(logits - top[..., None]).sum(dim=-1)
        logz = top + torch.log(P.reduce(sumexp, mesh))
        row = labels.long() - mesh.index("model") * v
        own = (row >= 0) & (row < v)
        gold = torch.gather(logits, -1, row.clamp(0, v - 1)[..., None])
        gold = P.reduce(torch.where(own, gold[..., 0], 0.0), mesh)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        total = P.reduce(torch.sum(nll * mask), mesh, "dp")
        count = P.all_sum(torch.sum(mask), mesh, "dp")
        return total / torch.clamp(count, min=1)
    total = P.reduce(torch.sum(nll), mesh, "dp")
    count = P.all_sum(torch.tensor(float(nll.numel()), device=nll.device),
                      mesh, "dp")
    return total / count.to(total.dtype)


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
        return softmax_xent(logits, labels, mask, vocab=self.cfg.vocab) \
            + 0.01 * aux


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
    if fam == "hybrid":
        return Model(
            cfg=cfg, device=dev,
            init=lambda key: HY.init_hybrid_lm(_generator(key, dev), cfg),
            forward=lambda p, b: HY.hybrid_forward(p, b, cfg),
            init_cache=lambda batch, max_len, **kw: HY.hybrid_init_cache(
                cfg, batch, max_len, device=dev, **kw),
            prefill=lambda p, b, c: HY.hybrid_step(p, b, cfg, c,
                                                   prefill=True),
            decode_step=lambda p, b, c: HY.hybrid_step(p, b, cfg, c),
        )
    if fam == "ssm":
        return Model(
            cfg=cfg, device=dev,
            init=lambda key: RW.init_rwkv_lm(_generator(key, dev), cfg),
            forward=lambda p, b: RW.rwkv_forward(p, b, cfg),
            init_cache=lambda batch, max_len, **kw: RW.rwkv_init_cache(
                cfg, batch, max_len, device=dev, **kw),
            prefill=lambda p, b, c: RW.rwkv_step(p, b, cfg, c,
                                                 prefill=True),
            decode_step=lambda p, b, c: RW.rwkv_step(p, b, cfg, c),
        )
    if fam == "encdec":
        return Model(
            cfg=cfg, device=dev,
            init=lambda key: ED.init_encdec(_generator(key, dev), cfg),
            forward=lambda p, b: ED.encdec_forward(p, b, cfg),
            init_cache=lambda batch, max_len, src_len=None, **kw:
                ED.encdec_init_cache(cfg, batch, max_len, src_len or max_len,
                                     device=dev, **kw),
            prefill=lambda p, b, c: ED.encdec_prefill(p, b, cfg, c),
            decode_step=lambda p, b, c: ED.encdec_decode_step(p, b, cfg, c),
        )
    raise ValueError(f"unknown family {fam!r}")

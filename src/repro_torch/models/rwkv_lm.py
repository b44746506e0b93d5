"""RWKV-6 language model assembly (a loop over stacked layers).

The port of the JAX package's ``models.rwkv_lm``. The cache is
``{"S" (L, B, H, hd, hd), "x_prev" (L, B, D), "x_prev_c" (L, B, D)}`` in
f32 and ``"len"``, a Python int; prefill and decode write its tensors in
place (the reference's decode returns ``x_prev`` in the activation dtype,
the same values).

Over a process mesh (``models.parallel``) the training forward runs each
layer's time-mix and channel-mix tensor-parallel over ``model``
(``models.rwkv``); serving (``rwkv_step``) runs on one device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models.remat import wrap_scan_body
from repro_torch.models.transformer import embed_tokens, layer_params


def init_rwkv_lm(gen: torch.Generator, cfg: ModelConfig):
    stack = (cfg.n_layers,)
    dev = gen.device
    layers = {
        "ln1": torch.ones(stack + (cfg.d_model,), device=dev),
        "ln2": torch.ones(stack + (cfg.d_model,), device=dev),
        "tmix": R.init_rwkv_tmix(gen, cfg.d_model, cfg.n_heads,
                                 dtype=cfg.weight_dtype, layers=stack),
        "cmix": R.init_rwkv_cmix(gen, cfg.d_model, cfg.d_ff,
                                 dtype=cfg.weight_dtype, layers=stack),
    }
    return {
        "embed": emb.init_embedding(gen, cfg.vocab, cfg.d_model,
                                    dtype=cfg.weight_dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), device=dev),
    }


def rwkv_forward(params, batch: dict, cfg: ModelConfig):
    _, x = embed_tokens(params, batch["tokens"], cfg)

    def body(x, lp):
        h = L.rms_norm(x, lp["ln1"])
        x = x + R.rwkv_tmix_forward(lp["tmix"], h, cfg.n_heads,
                                    bf16_comm=cfg.bf16_collectives,
                                    shard_hints=cfg.opt_shard_hints)
        h = L.rms_norm(x, lp["ln2"])
        return x + R.rwkv_cmix_forward(lp["cmix"], h,
                                       bf16_comm=cfg.bf16_collectives)

    body = wrap_scan_body(body, cfg)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(params["layers"], i))
    x = L.rms_norm(x, params["final_norm"])
    return (emb.logits_out(params["embed"], x, vocab=cfg.vocab),
            torch.zeros((), dtype=torch.float32, device=x.device))


def rwkv_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                    *, device=None):
    """The recurrent state of every layer, O(1) in length, in f32 (f64
    for f64 activations): ``max_len`` and ``dtype`` are the facade's and
    unused."""
    hd = cfg.d_model // cfg.n_heads
    nl = cfg.n_layers
    kw = {"dtype": R._acc(cfg.activation_dtype), "device": device}
    return {
        "S": torch.zeros((nl, batch, cfg.n_heads, hd, hd), **kw),
        "x_prev": torch.zeros((nl, batch, cfg.d_model), **kw),
        "x_prev_c": torch.zeros((nl, batch, cfg.d_model), **kw),
        "len": 0,
    }


def rwkv_step(params, batch: dict, cfg: ModelConfig, cache: dict,
              prefill: bool = False):
    """Single decode step (or prompt prefill: the full time-mix forward
    from a zero state, keeping the final states)."""
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["ln1"])
        if prefill:
            out, nst = R.rwkv_tmix_forward(lp["tmix"], h, cfg.n_heads,
                                           return_state=True,
                                           bf16_comm=cfg.bf16_collectives,
                                           shard_hints=cfg.opt_shard_hints)
        else:
            out, nst = R.rwkv_tmix_step(
                lp["tmix"], {"S": cache["S"][i], "x_prev": cache["x_prev"][i]},
                h, cfg.n_heads, bf16_comm=cfg.bf16_collectives)
        x = x + out
        h2 = L.rms_norm(x, lp["ln2"])
        x = x + R.rwkv_cmix_forward(lp["cmix"], h2, cache["x_prev_c"][i],
                                    bf16_comm=cfg.bf16_collectives)
        cache["S"][i] = nst["S"]
        cache["x_prev"][i] = nst["x_prev"]
        # the channel-mix carry is the normalised input, not the residual
        cache["x_prev_c"][i] = h2[:, -1, :]
    x = L.rms_norm(x, params["final_norm"])
    logits = emb.logits_out(params["embed"], x[:, -1:, :])
    return logits, {**cache, "len": cache["len"] + tokens.shape[1]}

"""Jamba-style hybrid: superblocks of `attn_period` layers — one GQA
attention layer + (attn_period-1) Mamba layers — with MoE FFNs every
`moe_period` layers (Jamba 1.5: period 8, attn at index 4, MoE every 2).

Serve state per superblock: one KV cache (attention layer) + per-mamba-layer
(conv, ssm) states => O(1) memory in context length except the single
attention cache — this is what makes jamba long_500k-runnable.

The port of the JAX package's ``models.hybrid``: superblocks are stacked on
a leading axis as there, and the reference's ``lax.scan`` over them is a
Python loop (``transformer.layer_params``). The cache keeps the reference's
layout — ``k``/``v`` (nsb, B, S_max, n_kv, hd), ``conv`` (nsb, n_mamba, B,
d_conv-1, d_inner) f32, ``ssm`` (nsb, n_mamba, B, d_inner, d_state) f32 —
with ``"len"`` a Python int; prefill and decode write its tensors in place.

Over a process mesh (``models.parallel``) the training forward runs each
layer tensor-parallel over ``model``: the attention layer on the rank's
kv groups, the Mamba layers on its channel block, the dense FFN as
Megatron's pair and the MoE with its experts over ``model``. Serving
(``hybrid_step``) runs on one device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models import layers as L
from repro_torch.models import mamba as S
from repro_torch.models import moe as M
from repro_torch.models.remat import wrap_scan_body
from repro_torch.models.transformer import (embed_tokens, layer_params,
                                            make_positions)


def _attn_index(cfg: ModelConfig) -> int:
    return cfg.attn_period // 2          # jamba places attn mid-block


def _moe_slots(cfg: ModelConfig) -> list:
    """Layer indices of a superblock whose FFN is MoE (every
    moe_period-th layer); the others have a dense MLP."""
    return [i for i in range(cfg.attn_period)
            if i % cfg.moe_period == cfg.moe_period - 1]


def init_hybrid_lm(gen: torch.Generator, cfg: ModelConfig):
    """Parameters on ``gen``'s device, superblocks stacked on axis 0 and
    each superblock's mamba/moe/mlp slots on axis 1."""
    assert cfg.n_layers % cfg.attn_period == 0
    nsb = cfg.n_layers // cfg.attn_period
    n = cfg.attn_period
    n_moe = len(_moe_slots(cfg))
    dev = gen.device
    blocks = {
        "ln1": torch.ones((nsb, n, cfg.d_model), device=dev),
        "ln2": torch.ones((nsb, n, cfg.d_model), device=dev),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim,
                                 dtype=cfg.weight_dtype, layers=(nsb,)),
        "mamba": S.init_mamba(gen, cfg.d_model, expand=cfg.ssm_expand,
                              d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                              dt_rank=cfg.dt_rank, dtype=cfg.weight_dtype,
                              layers=(nsb, n - 1)),
        "moe": M.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                          dtype=cfg.weight_dtype, layers=(nsb, n_moe)),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                          dtype=cfg.weight_dtype, layers=(nsb, n - n_moe)),
    }
    return {
        "embed": emb.init_embedding(gen, cfg.vocab, cfg.d_model,
                                    dtype=cfg.weight_dtype),
        "blocks": blocks,
        "final_norm": torch.ones((cfg.d_model,), device=dev),
    }


def _ffn(p, x, slot_moe, slot_mlp, use_moe, cfg):
    if use_moe:
        out, logits = M.moe_ffn_auto(
            layer_params(p["moe"], slot_moe), x, n_experts=cfg.n_experts,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            use_ep=cfg.moe_a2a)
        return out, M.moe_aux_loss(logits, cfg.n_experts, cfg.top_k)
    return (L.mlp(layer_params(p["mlp"], slot_mlp), x, d_ff=cfg.d_ff),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _superblock(p, x, *, cfg: ModelConfig, positions, cache=None,
                cache_len=None, mamba_state=None,
                return_mamba_state: bool = False):
    """One superblock forward. Returns (x, new_cache, new_mamba_state, aux)."""
    n, ai = cfg.attn_period, _attn_index(cfg)
    moe_slots = _moe_slots(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mi = 0          # mamba slot
    fi_moe = fi_mlp = 0
    new_cache, new_mstate = None, []
    for i in range(n):
        h = L.rms_norm(x, p["ln1"][i])
        if i == ai:
            r = L.attention(p["attn"], h, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                            positions=positions, theta=cfg.rope_theta,
                            cache=cache, cache_len=cache_len,
                            packed_gqa=cfg.opt_attention)
            if cache is not None:
                r, new_cache = r
        else:
            lp = layer_params(p["mamba"], mi)
            if mamba_state is not None:
                r, st = S.mamba_step(lp, mamba_state[mi], h)
                new_mstate.append(st)
            elif return_mamba_state:
                r, st = S.mamba_forward(lp, h, return_state=True)
                new_mstate.append(st)
            else:
                r = S.mamba_forward(lp, h,
                                    d_inner=cfg.ssm_expand * cfg.d_model)
            mi += 1
        x = x + r
        h = L.rms_norm(x, p["ln2"][i])
        use_moe = i in moe_slots
        f, a = _ffn(p, h, fi_moe, fi_mlp, use_moe, cfg)
        if use_moe:
            fi_moe += 1
        else:
            fi_mlp += 1
        x = x + f
        aux = aux + a
    return x, new_cache, new_mstate, aux


def hybrid_forward(params, batch: dict, cfg: ModelConfig):
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    b, s = tokens.shape
    positions, _ = make_positions(b, s, 0, cfg, x.device)

    def body(x, aux, bp):
        x, _, _, a = _superblock(bp, x, cfg=cfg, positions=positions)
        return x, aux + a

    body = wrap_scan_body(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(cfg.n_layers // cfg.attn_period):
        x, aux = body(x, aux, layer_params(params["blocks"], j))
    x = L.rms_norm(x, params["final_norm"])
    return (emb.logits_out(params["embed"], x, vocab=cfg.vocab),
            aux / max(cfg.n_layers, 1))


# --- serving ----------------------------------------------------------------

def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, *, device=None):
    dtype = dtype or cfg.activation_dtype
    nsb = cfg.n_layers // cfg.attn_period
    nmamba = cfg.attn_period - 1
    d_inner = cfg.ssm_expand * cfg.d_model
    kshape = (nsb, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kshape, dtype=dtype, device=device),
        "v": torch.zeros(kshape, dtype=dtype, device=device),
        "conv": torch.zeros((nsb, nmamba, batch, cfg.ssm_conv - 1, d_inner),
                            device=device),
        "ssm": torch.zeros((nsb, nmamba, batch, d_inner, cfg.ssm_state),
                           device=device),
        "len": 0,
    }


def hybrid_step(params, batch: dict, cfg: ModelConfig, cache: dict,
                prefill: bool = False):
    """Decode one token (or prefill a prompt when prefill=True)."""
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    b, s = tokens.shape
    cache_len = 0 if prefill else cache["len"]
    positions, _ = make_positions(b, s, cache_len, cfg, x.device)
    for j in range(cfg.n_layers // cfg.attn_period):
        mstate = None
        if not prefill:
            mstate = [{"conv": cache["conv"][j, m], "ssm": cache["ssm"][j, m]}
                      for m in range(cfg.attn_period - 1)]
        x, _, nmstate, _ = _superblock(
            layer_params(params["blocks"], j), x, cfg=cfg,
            positions=positions, cache=(cache["k"][j], cache["v"][j]),
            cache_len=cache_len, mamba_state=mstate,
            return_mamba_state=prefill)
        for m, st in enumerate(nmstate):
            cache["conv"][j, m] = st["conv"]
            cache["ssm"][j, m] = st["ssm"]
    x = L.rms_norm(x, params["final_norm"])
    logits = emb.logits_out(params["embed"], x[:, -1:, :])
    return logits, {**cache, "len": cache["len"] + (s if prefill else 1)}

"""Decoder-only LM covering the dense, MoE, and VLM families.

Layers are stacked along a leading axis, as the JAX package stacks them for
``lax.scan``; here a Python loop runs them one by one (the remat policy
applies per layer body). The embedding runs through embedding.py; MoE FFNs
run the reorder/coalesce dispatch of moe.py.

The port of the JAX package's ``models.transformer``. The KV cache is
``{"k", "v"}`` tensors of shape (L, B, S_max, n_kv, hd) and ``"len"``, a
Python int (the host needs it to place the write); prefill and decode
write the new K/V into the cache's tensors in place and return the cache
with its new length.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.remat import wrap_scan_body


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(gen: torch.Generator, cfg: ModelConfig):
    """Parameters on ``gen``'s device: N(0, 0.02) weights in
    ``cfg.weight_dtype``, f32 ones for the norms, layers stacked."""
    stack = (cfg.n_layers,)
    dev = gen.device
    embed = emb.init_embedding(gen, cfg.vocab, cfg.d_model,
                               dtype=cfg.weight_dtype)
    layers = {
        "ln1": torch.ones(stack + (cfg.d_model,), device=dev),
        "ln2": torch.ones(stack + (cfg.d_model,), device=dev),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim,
                                 qk_norm=cfg.qk_norm,
                                 dtype=cfg.weight_dtype, layers=stack),
    }
    if cfg.family == "moe":
        layers["moe"] = M.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                   dtype=cfg.weight_dtype, layers=stack)
    else:
        layers["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                   dtype=cfg.weight_dtype, layers=stack)
    return {"embed": embed, "layers": layers,
            "final_norm": torch.ones((cfg.d_model,), device=dev)}


def layer_params(tree, i: int):
    """Layer ``i``'s slice of the stacked layer parameters."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# layer body (shared by train / prefill / decode)
# ---------------------------------------------------------------------------

def _layer(p, x, *, cfg: ModelConfig, positions, positions3=None,
           cache=None, cache_len=None, ring=False):
    h = L.rms_norm(x, p["ln1"])
    attn_out = L.attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions, theta=cfg.rope_theta,
        window=cfg.sliding_window, mrope_sections=cfg.mrope_sections,
        positions3=positions3, cache=cache, cache_len=cache_len, ring=ring,
        packed_gqa=cfg.opt_attention)
    new_cache = None
    if cache is not None:
        attn_out, new_cache = attn_out
    x = x + attn_out
    h = L.rms_norm(x, p["ln2"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "moe":
        ffn_out, router_logits = M.moe_ffn_auto(
            p["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, use_ep=cfg.moe_a2a)
        aux = M.moe_aux_loss(router_logits, cfg.n_experts, cfg.top_k)
    else:
        ffn_out = L.mlp(p["mlp"], h)
    return x + ffn_out, new_cache, aux


def embed_tokens(params, tokens, cfg: ModelConfig):
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    x = emb.embed_lookup(params["embed"], tokens, cfg.dx100_embed_fwd,
                         cfg.dx100_embed_bwd)
    return tokens, x.to(cfg.activation_dtype)


def make_positions(b: int, s: int, start: int, cfg: ModelConfig, device):
    positions = (torch.arange(s, dtype=torch.int32, device=device)
                 + start).expand(b, s)
    positions3 = None
    if cfg.mrope_sections is not None:
        positions3 = positions[None].expand(3, b, s)
    return positions, positions3


# ---------------------------------------------------------------------------
# forward (train) — full sequence, no cache
# ---------------------------------------------------------------------------

def lm_forward(params, batch: dict, cfg: ModelConfig):
    """batch: {"tokens": (B,S)} (+ "patch_embeds", "positions3" for vlm).
    Returns (logits (B,S,V), aux_loss scalar)."""
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    b = tokens.shape[0]
    if "patch_embeds" in batch:          # vlm: prepend stubbed patch tokens
        patches = torch.as_tensor(batch["patch_embeds"], device=x.device)
        x = torch.cat([patches.to(cfg.activation_dtype), x], dim=1)
    s = x.shape[1]
    positions, positions3 = make_positions(b, s, 0, cfg, x.device)
    if batch.get("positions3") is not None:
        positions3 = torch.as_tensor(batch["positions3"], device=x.device)

    def body(x, aux, lp):
        x, _, a = _layer(lp, x, cfg=cfg, positions=positions,
                         positions3=positions3)
        return x, aux + a

    body = wrap_scan_body(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = body(x, aux, layer_params(params["layers"], i))
    x = L.rms_norm(x, params["final_norm"])
    if "patch_embeds" in batch:
        x = x[:, -tokens.shape[1]:, :]   # logits only over text positions
    logits = emb.logits_out(params["embed"], x)
    return logits, aux / max(cfg.n_layers, 1)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with per-layer KV caches
# ---------------------------------------------------------------------------

def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  *, device=None):
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


def _run_cached(params, x, cfg: ModelConfig, cache: dict, *, positions,
                positions3, cache_len: int, ring: bool = False):
    for i in range(cfg.n_layers):
        x, _, _ = _layer(layer_params(params["layers"], i), x, cfg=cfg,
                         positions=positions, positions3=positions3,
                         cache=(cache["k"][i], cache["v"][i]),
                         cache_len=cache_len, ring=ring)
    return L.rms_norm(x, params["final_norm"])


def lm_prefill(params, batch: dict, cfg: ModelConfig, cache: dict):
    """Run the prompt, filling the cache. Returns (last_logits, cache)."""
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    b, s = tokens.shape
    positions, positions3 = make_positions(b, s, 0, cfg, x.device)
    x = _run_cached(params, x, cfg, cache, positions=positions,
                    positions3=positions3, cache_len=0)
    logits = emb.logits_out(params["embed"], x[:, -1:, :])
    return logits, {"k": cache["k"], "v": cache["v"], "len": s}


def lm_decode_step(params, batch: dict, cfg: ModelConfig, cache: dict):
    """One token for every sequence. batch: {"tokens": (B, 1)}."""
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    b = tokens.shape[0]
    positions, positions3 = make_positions(b, 1, cache["len"], cfg, x.device)
    # ring/SWA: a cache sized exactly to the sliding window wraps around
    ring = (cfg.sliding_window is not None
            and cache["k"].shape[2] <= cfg.sliding_window)
    x = _run_cached(params, x, cfg, cache, positions=positions,
                    positions3=positions3, cache_len=cache["len"], ring=ring)
    logits = emb.logits_out(params["embed"], x)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "len": cache["len"] + 1}

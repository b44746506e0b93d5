"""Encoder-decoder transformer (seamless-m4t-large-v2 backbone).

The audio frontend is a STUB: callers feed precomputed frame embeddings
(B, S_src, D). n_layers (24) splits into n_enc + n_dec. Decoder layers:
causal self-attn + cross-attn + MLP. Cross K/V is computed once per
sequence and reused every decode step — the stream-once pattern of the
paper's SLD unit.

The port of the JAX package's ``models.encdec``: layer loops for its
``lax.scan``s. The cache is ``{"k", "v"}`` (L, B, S_max, n_kv, hd) written
in place, ``{"xk", "xv"}`` (L, B, S_src, n_kv, hd) and ``"len"``, a Python
int. Prefill *replaces* ``xk``/``xv`` with the cross K/V of the source it
encodes, whatever source length the cache was made for.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models import layers as L
from repro_torch.models.remat import wrap_scan_body
from repro_torch.models.transformer import (embed_tokens, layer_params,
                                            make_positions)


def init_encdec(gen: torch.Generator, cfg: ModelConfig):
    dev = gen.device

    def ones(n):
        return torch.ones((n, cfg.d_model), device=dev)

    def attn(n):
        return L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim,
                                dtype=cfg.weight_dtype, layers=(n,))

    def mlp(n):
        return L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                          dtype=cfg.weight_dtype, layers=(n,))

    ne, nd = cfg.n_enc_layers, cfg.n_dec_layers
    return {
        "embed": emb.init_embedding(gen, cfg.vocab, cfg.d_model,
                                    dtype=cfg.weight_dtype),
        "enc": {"ln1": ones(ne), "ln2": ones(ne), "attn": attn(ne),
                "mlp": mlp(ne)},
        "dec": {"ln1": ones(nd), "ln_x": ones(nd), "ln2": ones(nd),
                "attn": attn(nd), "xattn": attn(nd), "mlp": mlp(nd)},
        "enc_norm": torch.ones((cfg.d_model,), device=dev),
        "final_norm": torch.ones((cfg.d_model,), device=dev),
    }


def encode(params, src_embeds, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional encoder over stubbed frame embeddings."""
    x = torch.as_tensor(src_embeds, device=params["embed"].device)
    x = x.to(cfg.activation_dtype)
    b, s, _ = x.shape
    positions, _ = make_positions(b, s, 0, cfg, x.device)

    def body(x, lp):
        h = L.rms_norm(x, lp["ln1"])
        x = x + L.attention(lp["attn"], h, n_heads=cfg.n_heads,
                            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                            positions=positions, theta=cfg.rope_theta,
                            causal=False)
        h = L.rms_norm(x, lp["ln2"])
        return x + L.mlp(lp["mlp"], h, d_ff=cfg.d_ff)

    body = wrap_scan_body(body, cfg)
    for i in range(cfg.n_enc_layers):
        x = body(x, layer_params(params["enc"], i))
    return L.rms_norm(x, params["enc_norm"])


def _dec_layer(lp, x, *, cfg, positions, enc_kv, cache=None, cache_len=None):
    h = L.rms_norm(x, lp["ln1"])
    r = L.attention(lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, positions=positions,
                    theta=cfg.rope_theta, cache=cache, cache_len=cache_len)
    if cache is not None:
        r, _ = r
    x = x + r
    h = L.rms_norm(x, lp["ln_x"])
    x = x + L.attention(lp["xattn"], h, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                        positions=positions, theta=cfg.rope_theta,
                        kv=enc_kv)
    h = L.rms_norm(x, lp["ln2"])
    return x + L.mlp(lp["mlp"], h, d_ff=cfg.d_ff)


def _cross_kv(lp, enc_out, cfg: ModelConfig):
    return L.cross_kv(lp["xattn"], enc_out, n_kv=cfg.n_kv_heads,
                      head_dim=cfg.head_dim, n_heads=cfg.n_heads)


def encdec_forward(params, batch: dict, cfg: ModelConfig):
    """Teacher-forced training forward.
    batch: {"src_embeds": (B,S_src,D), "tokens": (B,S_tgt)}; over a
    process mesh, the rank's block of both and its shards of the params
    (``models.parallel``)."""
    enc_out = encode(params, batch["src_embeds"], cfg)
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    b, s = tokens.shape
    positions, _ = make_positions(b, s, 0, cfg, x.device)

    def body(x, lp):
        return _dec_layer(lp, x, cfg=cfg, positions=positions,
                          enc_kv=_cross_kv(lp, enc_out, cfg))

    body = wrap_scan_body(body, cfg)
    for i in range(cfg.n_dec_layers):
        x = body(x, layer_params(params["dec"], i))
    x = L.rms_norm(x, params["final_norm"])
    return (emb.logits_out(params["embed"], x, vocab=cfg.vocab),
            torch.zeros((), dtype=torch.float32, device=x.device))


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      src_len: int, dtype=None, *, device=None):
    dtype = dtype or cfg.activation_dtype
    nl = cfg.n_dec_layers

    def zeros(s):
        return torch.zeros((nl, batch, s, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dtype, device=device)

    # cross K/V computed at prefill, reused each step
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(src_len), "xv": zeros(src_len), "len": 0}


def encdec_prefill(params, batch: dict, cfg: ModelConfig, cache: dict):
    """Encode source + run the target prompt through the decoder."""
    enc_out = encode(params, batch["src_embeds"], cfg)
    tokens, x = embed_tokens(params, batch["tokens"], cfg)
    b, s = tokens.shape
    positions, _ = make_positions(b, s, 0, cfg, x.device)
    xk, xv = [], []
    for i in range(cfg.n_dec_layers):
        lp = layer_params(params["dec"], i)
        kv = _cross_kv(lp, enc_out, cfg)
        x = _dec_layer(lp, x, cfg=cfg, positions=positions, enc_kv=kv,
                       cache=(cache["k"][i], cache["v"][i]), cache_len=0)
        xk.append(kv[0].to(cache["k"].dtype))
        xv.append(kv[1].to(cache["v"].dtype))
    x = L.rms_norm(x, params["final_norm"])
    logits = emb.logits_out(params["embed"], x[:, -1:, :])
    return logits, {"k": cache["k"], "v": cache["v"],
                    "xk": torch.stack(xk), "xv": torch.stack(xv), "len": s}


def encdec_decode_step(params, batch: dict, cfg: ModelConfig, cache: dict):
    tokens, x = embed_tokens(params, batch["tokens"], cfg)   # (B, 1)
    b = tokens.shape[0]
    positions, _ = make_positions(b, 1, cache["len"], cfg, x.device)
    for i in range(cfg.n_dec_layers):
        x = _dec_layer(layer_params(params["dec"], i), x, cfg=cfg,
                       positions=positions,
                       enc_kv=(cache["xk"][i], cache["xv"][i]),
                       cache=(cache["k"][i], cache["v"][i]),
                       cache_len=cache["len"])
    x = L.rms_norm(x, params["final_norm"])
    logits = emb.logits_out(params["embed"], x)
    return logits, {**cache, "len": cache["len"] + 1}

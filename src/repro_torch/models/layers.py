"""Shared transformer layers: RMSNorm, RoPE/M-RoPE, GQA attention (qk-norm,
sliding-window), SwiGLU MLP. Pure functional; params are nested dicts of
tensors.

The port of the JAX package's ``models.layers``. Weights keep the JAX
layout ``(d_in, d_out)`` and every projection is ``x @ W``, so a
parameter tree carries over key for key (``core.interop.params_from_numpy``).
Attention is the reference's einsum/softmax in plain torch ops, with its
``-1e30`` mask and f32 logits; ``scaled_dot_product_attention`` would mask
with ``-inf`` and fuse the softmax, and so round differently.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG = -1e30                          # the reference's mask value


def dense_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """N(0, 0.02) on ``gen``'s device, drawn in f32 and cast, so one seed
    gives the same weights (rounded) in every dtype."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(0.0, 0.02, generator=gen).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def maybe_constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding hint; the identity here (no mesh)."""
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE), half-split convention
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); ang: (B, S, hd/2) f32."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL §3): the hd/2 frequency slots are split
    into (temporal, height, width) sections, each rotated by its own
    position stream. positions3: (3, B, S)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device))[:half]
    # jnp.repeat(total_repeat_length=) pads with the last section's id
    sec_id = torch.cat([sec_id, sec_id[-1:].expand(half - sec_id.shape[0])])
    pos = positions3[sec_id]                            # (hd/2, B, S)
    return _rotate(x, torch.movedim(pos, 0, -1).float() * freqs)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, qk_norm: bool = False,
                   dtype=torch.float32, layers: tuple = ()):
    """``layers=(L,)`` stacks L layers' weights on a leading axis."""
    p = {
        "wq": dense_init(gen, layers + (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(gen, layers + (d_model, n_kv * head_dim), dtype),
        "wv": dense_init(gen, layers + (d_model, n_kv * head_dim), dtype),
        "wo": dense_init(gen, layers + (n_heads * head_dim, d_model), dtype),
    }
    if qk_norm:
        p["q_norm"] = torch.ones(layers + (head_dim,), device=gen.device)
        p["k_norm"] = torch.ones(layers + (head_dim,), device=gen.device)
    return p


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _causal_mask(sq: int, skv: int, *, window: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """mask[i, j] True if query i may attend key j."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def update_slice(buf: torch.Tensor, upd: torch.Tensor, start: int) -> None:
    """``buf[:, start:start+s] = upd`` in place, with the start clamped so
    the update fits, as ``jax.lax.dynamic_update_slice`` clamps it."""
    s = upd.shape[1]
    start = max(0, min(int(start), buf.shape[1] - s))
    buf[:, start:start + s] = upd.to(buf.dtype)


def attention(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
              head_dim: int, positions: torch.Tensor, theta: float = 1e4,
              window: Optional[int] = None,
              mrope_sections: Optional[tuple] = None,
              positions3: Optional[torch.Tensor] = None,
              cache: Optional[tuple] = None,
              cache_len: Optional[int] = None,
              ring: bool = False, packed_gqa: bool = False):
    """Causal GQA self-attention (the reference's cross-attention mode
    waits for the encoder-decoder family, ROADMAP A12).

    Modes:
      train/prefill: cache=None -> self-attn over x, causal.
      decode       : cache=(ck, cv) (B, S_max, n_kv, hd), cache_len an int
                     = #valid entries; x is (B, s, D). The new K/V are
                     written into ck/cv in place; returns (out, (ck, cv)).
    """
    b, s, d = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    k = (x @ p["wk"]).reshape(b, s, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv, head_dim)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"])
    if mrope_sections is not None:
        q = apply_mrope(q, positions3, theta, mrope_sections)
        k = apply_mrope(k, positions3, theta, mrope_sections)
    else:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)

    new_cache = None
    if cache is not None:
        ck, cv = cache
        # ring mode (sliding-window cache sized == window): the cache IS
        # the window; writes wrap around
        write_pos = cache_len % ck.shape[1] if ring else cache_len
        update_slice(ck, k, write_pos)
        update_slice(cv, v, write_pos)
        new_cache = (ck, cv)
        k, v = ck, cv

    n_rep = n_heads // n_kv
    scale = head_dim ** -0.5
    skv = k.shape[1]
    if packed_gqa:
        # grouped einsum: KV stays un-replicated and in its storage dtype;
        # products of storage-dtype values accumulated in f32
        qg = q.reshape(b, s, n_kv, n_rep, head_dim)
        logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float(),
                              k.float()) * scale
    else:
        kf = _repeat_kv(k, n_rep)
        vf = _repeat_kv(v, n_rep)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              kf.float()) * scale

    dev = x.device
    if cache is not None:
        kj = torch.arange(skv, device=dev)[None, :]
        if ring:
            # every live slot is inside the window by construction
            m = kj < min(cache_len + s, skv)
        else:
            qi = cache_len + torch.arange(s, device=dev)[:, None]
            m = kj <= qi
            if window is not None:
                m &= kj > qi - window
    else:
        m = _causal_mask(s, skv, window=window, device=dev)

    if packed_gqa:
        logits = torch.where(m[None, None, None], logits, _NEG)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkrqs,bskd->bqkrd", w.to(v.dtype).float(),
                           v.float())
        out = out.reshape(b, s, n_heads * head_dim).to(x.dtype)
    else:
        logits = torch.where(m[None, None], logits, _NEG)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vf.float())
        out = out.reshape(b, s, n_heads * head_dim).to(x.dtype)
    out = out @ p["wo"]
    if cache is not None:
        return out, new_cache
    return out


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, layers: tuple = ()):
    return {
        "w_gate": dense_init(gen, layers + (d_model, d_ff), dtype),
        "w_up": dense_init(gen, layers + (d_model, d_ff), dtype),
        "w_down": dense_init(gen, layers + (d_ff, d_model), dtype),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]

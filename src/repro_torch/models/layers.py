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

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import parallel as P

_NEG = -1e30                          # the reference's mask value


def dense_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """N(0, 0.02) on ``gen``'s device, drawn in f32 and cast, so one seed
    gives the same weights (rounded) in every dtype."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(0.0, 0.02, generator=gen).to(dtype)


def acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, where the reference computes in f32, or in float64 for
    a float64 ``x`` (a float64 model, the train check's reference step)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def maybe_constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding hint; the identity here (no mesh)."""
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.promote_types(dt, torch.float32))   # f32, or f64
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(x.dtype)).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE), half-split convention
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); ang: (B, S, hd/2) f32."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(acc(x), 2, dim=-1)
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
    sec = [i for i, n in enumerate(sections) for _ in range(n)][:half]
    # jnp.repeat(total_repeat_length=) pads with the last section's id
    sec_id = torch.tensor(sec + sec[-1:] * (half - len(sec)),
                          device=x.device)
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
              window: Optional[int] = None, causal: bool = True,
              mrope_sections: Optional[tuple] = None,
              positions3: Optional[torch.Tensor] = None,
              kv: Optional[tuple] = None,
              cache: Optional[tuple] = None,
              cache_len: Optional[int] = None,
              ring: bool = False, packed_gqa: bool = False):
    """GQA attention.

    Modes:
      train/prefill: kv=None, cache=None -> self-attn over x, causal
                     unless causal=False (the encoder: no mask).
      cross-attn   : kv=(k, v) precomputed from encoder states
                     (``cross_kv``): neither q nor k is rotated, no mask;
                     called without a cache.
      decode       : cache=(ck, cv) (B, S_max, n_kv, hd), cache_len an int
                     = #valid entries; x is (B, s, D). The new K/V are
                     written into ck/cv in place; returns (out, (ck, cv)).
    """
    mesh = P.rank_mesh()
    if P.model_split(mesh) > 1:
        if cache is not None:
            raise NotImplementedError(
                "attention over a process mesh's model axis runs the "
                "training forward only (no cache)")
        return _attention_tp(
            p, x, mesh, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
            positions=positions, theta=theta, window=window, causal=causal,
            mrope_sections=mrope_sections, positions3=positions3, kv=kv,
            packed_gqa=packed_gqa)
    b, s, d = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    if kv is None:
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
    else:
        # cross-attention: K/V precomputed and un-rotated; q stays
        # un-rotated too (content-based addressing into encoder states)
        k, v = kv

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

    skv = k.shape[1]
    dev = x.device
    m = None
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
    elif causal and kv is None:
        m = _causal_mask(s, skv, window=window, device=dev)

    out = _attend(q, k, v, m, packed_gqa=packed_gqa, dtype=x.dtype)
    out = out @ p["wo"]
    if cache is not None:
        return out, new_cache
    return out


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            m: Optional[torch.Tensor], *, packed_gqa: bool,
            dtype) -> torch.Tensor:
    """Softmax attention of q (B, S, H, hd) over k, v (B, Skv, K, hd),
    query head h reading kv head h // (H / K); ``m`` (S, Skv) the mask or
    None. Returns (B, S, H * hd) in ``dtype``."""
    b, s, n_heads, head_dim = q.shape
    n_kv = k.shape[2]
    n_rep = n_heads // max(n_kv, 1)   # a mesh rank may compute no head
    scale = head_dim ** -0.5
    if packed_gqa:
        # grouped einsum: KV stays un-replicated and in its storage dtype;
        # products of storage-dtype values accumulated in f32
        qg = q.reshape(b, s, n_kv, n_rep, head_dim)
        logits = torch.einsum("bqkrd,bskd->bkrqs", acc(qg),
                              acc(k)) * scale
        if m is not None:
            logits = torch.where(m[None, None, None], logits, _NEG)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkrqs,bskd->bqkrd", acc(w.to(v.dtype)),
                           acc(v))
    else:
        kf = _repeat_kv(k, n_rep)
        vf = _repeat_kv(v, n_rep)
        logits = torch.einsum("bqhd,bkhd->bhqk", acc(q),
                              acc(kf)) * scale
        if m is not None:
            logits = torch.where(m[None, None], logits, _NEG)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, acc(vf))
    return out.reshape(b, s, n_heads * head_dim).to(dtype)


def _columns(xc: torch.Tensor, w: torch.Tensor, full: int, lo: int,
             hi: int, mesh, lines_up: bool, mm=torch.matmul) -> torch.Tensor:
    """Columns ``[lo, hi)`` of ``mm(x, W)`` (``x @ W``) for a weight of
    ``full`` columns that ``param_specs`` cuts over ``model`` or leaves
    whole; ``xc`` is x after ``parallel.copy``. A cut weight gives the
    rank's own columns when ``lines_up`` (every rank needs only its own:
    no collective), else all-gathers them (the gradient returns as a
    reduce-scatter). A whole weight is itself ``copy``-ed: each rank uses
    part of it."""
    if not P.sharded(w.shape[-1], full):
        return mm(xc, P.copy(w, mesh)[..., lo:hi])
    if lines_up:
        return mm(xc, w)
    return P.gather_last(mm(xc, w), mesh)[..., lo:hi]


@dataclasses.dataclass(frozen=True)
class _Share:
    """A rank's share of an attention layer over a process mesh's
    ``model`` line: the kv groups ``[g0, g1)`` it computes, its output
    columns ``[lo, hi)`` (rows of ``wo``), and whether every rank's
    groups are exactly its own columns of ``wq`` (``q_up``) and of
    ``wk``/``wv`` (``kv_up``). A rank past the last group has an empty
    share: it computes nothing, adds zeros to the output's sum, and
    still makes every collective its peers make, so every width is
    counted from the layer's per-group widths, never from the share's."""
    g0: int
    g1: int
    lo: int
    hi: int
    q_up: bool
    kv_up: bool

    @property
    def n(self) -> int:
        """The number of kv groups the rank computes (0 or more)."""
        return self.g1 - self.g0

    def span(self, width: int) -> tuple:
        """The rank's columns of a weight with ``width`` columns a kv
        group."""
        return self.g0 * width, self.g1 * width


def _share(p: dict, mesh, n_heads: int, n_kv: int,
           head_dim: int) -> _Share:
    """The specs cut columns, not heads, so a rank computes whole heads:
    those its output columns touch (its rows of ``wo``; where ``wo`` is
    whole, a share of whole kv groups, none for a rank past the last
    group), widened to whole kv groups (query head h reads kv head
    h // n_rep). Every rank decides alike: the collectives must match.
    Without a ``model`` cut the share is every group."""
    ms = P.model_split(mesh)
    n_rep = n_heads // n_kv
    nq = n_heads * head_dim
    if ms == 1:
        return _Share(0, n_kv, 0, nq, True, True)
    c = mesh.index("model")

    def out_cols(r):
        if P.sharded(p["wo"].shape[-2], nq):
            return r * nq // ms, (r + 1) * nq // ms
        per = -(-n_kv // ms)
        g0, g1 = min(r * per, n_kv), min((r + 1) * per, n_kv)
        return g0 * n_rep * head_dim, g1 * n_rep * head_dim

    def groups(r):               # the kv groups rank r computes
        lo, hi = out_cols(r)
        h0, h1 = lo // head_dim, -(-hi // head_dim)
        return h0 // n_rep, -(-h1 // n_rep)

    def lines_up(width):         # every rank's groups are its own columns
        full = n_kv * width
        return all(tuple(x * width for x in groups(r)) ==
                   (r * full // ms, (r + 1) * full // ms)
                   for r in range(ms))

    return _Share(*groups(c), *out_cols(c), lines_up(n_rep * head_dim),
                  lines_up(head_dim))


def _attention_tp(p: dict, x: torch.Tensor, mesh, *, n_heads: int,
                  n_kv: int, head_dim: int, positions: torch.Tensor,
                  theta: float, window: Optional[int], causal: bool,
                  mrope_sections: Optional[tuple],
                  positions3: Optional[torch.Tensor], kv: Optional[tuple],
                  packed_gqa: bool):
    """Training attention on a process mesh's ``model`` line, over the
    rank's share of whole kv groups (``_share``). Where ``model`` divides
    the query and kv heads the rank's columns of ``wq``/``wk``/``wv`` are
    exactly those heads (Megatron's split: one ``copy`` in, one
    ``reduce`` out); elsewhere the rank all-gathers the columns its heads
    need. Cross-attention (``kv``) takes K/V of the same groups from
    ``cross_kv``, over a source of its own length: no rotation, no
    mask."""
    b, s, _ = x.shape
    sh = _share(p, mesh, n_heads, n_kv, head_dim)
    n_rep = n_heads // n_kv
    nq, nkv = n_heads * head_dim, n_kv * head_dim
    xc = P.copy(x, mesh)
    q = _columns(xc, p["wq"], nq, *sh.span(n_rep * head_dim), mesh,
                 sh.q_up).reshape(b, s, sh.n * n_rep, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, P.copy(p["q_norm"], mesh))
    if kv is None:
        k, v = (_columns(xc, p[w], nkv, *sh.span(head_dim), mesh,
                         sh.kv_up).reshape(b, s, sh.n, head_dim)
                for w in ("wk", "wv"))
        if "k_norm" in p:
            k = rms_norm(k, P.copy(p["k_norm"], mesh))
        if mrope_sections is not None:
            q = apply_mrope(q, positions3, theta, mrope_sections)
            k = apply_mrope(k, positions3, theta, mrope_sections)
        else:
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
    else:
        k, v = kv
    m = _causal_mask(s, s, window=window, device=x.device) \
        if causal and kv is None else None
    out = _attend(q, k, v, m, packed_gqa=packed_gqa, dtype=x.dtype)
    base, _ = sh.span(n_rep * head_dim)
    out = out[..., sh.lo - base:sh.hi - base]
    wo = p["wo"] if P.sharded(p["wo"].shape[-2], nq) \
        else P.copy(p["wo"], mesh)[..., sh.lo:sh.hi, :]
    return P.reduce(out @ wo, mesh)


def cross_kv(p: dict, enc_out: torch.Tensor, *, n_kv: int, head_dim: int,
             n_heads: Optional[int] = None):
    """Precompute cross-attention K/V from encoder states (reused every
    decode step — the paper's stream-once-reuse-many pattern). On a
    process mesh's ``model`` line, the K/V of the rank's kv groups
    (``_share``, which needs ``n_heads``) for its cross-attention: the
    encoder states, whole on every ``model`` rank, enter through
    ``copy``."""
    mesh = P.rank_mesh()
    if n_heads is None:
        if P.model_split(mesh) > 1:
            raise ValueError("cross_kv over a process mesh's model axis "
                             "needs n_heads (its kv groups' query heads)")
        n_heads = n_kv
    b, s, _ = enc_out.shape
    sh = _share(p, mesh, n_heads, n_kv, head_dim)
    ec = P.copy(enc_out, mesh)
    k, v = (_columns(ec, p[w], n_kv * head_dim, *sh.span(head_dim), mesh,
                     sh.kv_up).reshape(b, s, sh.n, head_dim)
            for w in ("wk", "wv"))
    return k, v


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


def mlp(p: dict, x: torch.Tensor, d_ff: Optional[int] = None
        ) -> torch.Tensor:
    """SwiGLU. On a process mesh whose ``model`` axis cuts the ``d_ff``
    columns (``d_ff`` the full width), Megatron's split: ``copy``, the
    rank's columns of ``w_gate``/``w_up`` and rows of ``w_down``, then
    ``reduce``."""
    mesh = P.rank_mesh()
    if d_ff is not None and P.model_split(mesh) > 1 and \
            P.sharded(p["w_gate"].shape[-1], d_ff):
        xc = P.copy(x, mesh)
        h = F.silu(xc @ p["w_gate"]) * (xc @ p["w_up"])
        return P.reduce(h @ p["w_down"], mesh)
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]

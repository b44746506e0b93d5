"""RWKV-6 "Finch" block: attention-free time-mix with data-dependent decay.

Per head h with head dim n: state S in R^{n x n};
  S_t = diag(w_t) S_{t-1} + k_t^T v_t
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(wbase + ddlerp(x_t))) data-dependent (the Finch change
vs RWKV-5's static decay). Token-shift mixes x_{t-1} into every projection.

Recurrent state is O(1) in sequence length => long_500k runs natively.
The DX100 technique does not apply inside this layer (no indirection) —
embedding lookup/grad is the engine's only site, see DESIGN.md
§Arch-applicability.

The port of the JAX package's ``models.rwkv``: the WKV recurrence, a
``lax.scan`` over time there, is a Python loop of eager ops here. The
projections run in f32 (bf16 with ``bf16_comm``) whatever the weights'
dtype, as in the reference; ``shard_hints`` only keeps the reference's
head-form products, which accumulate in f32 without rounding to bf16.
Float64 activations keep float64 throughout (``_acc``), where the
reference, without JAX's x64 mode, has no such dtype.

On a process mesh's ``model`` line (``models.parallel``) the training
forward is tensor-parallel as the specs cut it. The time-mix computes
whole heads: those its rows of ``wo`` touch (``layers._share`` with one
query head a group), widened where the cut falls mid-head, from its own
columns of ``wr``/``wk``/``wv``/``w_dd`` or all-gathered ones
(``layers._columns``); ``u`` is the rank's heads or a slice of the whole
leaf, ``w_base`` and ``ln_x`` slices of theirs, and ``wo``'s rows end in
``reduce``. The specs cut the channel-mix's ``wv`` on its output
columns, so the rank all-gathers the ``relu²`` activations over
``d_ff`` and then its output columns. The input and every whole leaf
used on a part (the ``mix_*``) enter through ``copy``, so that their
gradients are summed over ``model`` once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import parallel as P
from repro_torch.models.layers import dense_init, rms_norm


def init_rwkv_tmix(gen: torch.Generator, d_model: int, n_heads: int,
                   dtype=torch.float32, layers: tuple = ()):
    hd = d_model // n_heads
    dev = gen.device

    def full(value, shape):
        return torch.full(layers + shape, value, dtype=torch.float32,
                          device=dev)

    return {
        "mix_r": full(0.5, (d_model,)),
        "mix_k": full(0.5, (d_model,)),
        "mix_v": full(0.5, (d_model,)),
        "mix_w": full(0.5, (d_model,)),
        "wr": dense_init(gen, layers + (d_model, d_model), dtype),
        "wk": dense_init(gen, layers + (d_model, d_model), dtype),
        "wv": dense_init(gen, layers + (d_model, d_model), dtype),
        "wo": dense_init(gen, layers + (d_model, d_model), dtype),
        # data-dependent decay: w_t = exp(-exp(w_base + x @ w_dd))
        "w_base": full(0.0, (d_model,)),
        "w_dd": dense_init(gen, layers + (d_model, d_model),
                           torch.float32) * 0.1,
        "u": full(0.0, (n_heads, hd)),             # bonus for current tok
        "ln_x": full(1.0, (d_model,)),
    }


def init_rwkv_cmix(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype=torch.float32, layers: tuple = ()):
    return {
        "mix_k": torch.full(layers + (d_model,), 0.5, dtype=torch.float32,
                            device=gen.device),
        "wk": dense_init(gen, layers + (d_model, d_ff), dtype),
        "wv": dense_init(gen, layers + (d_ff, d_model), dtype),
    }


def _acc(dtype):
    """The recurrence's and the projections' dtype: f32, or f64."""
    return torch.promote_types(dtype, torch.float32)


def _token_shift(x, x_prev_last):
    """shifted[t] = x[t-1]; position 0 takes the carry (B, D). An f32
    carry promotes bf16 activations to f32, as in JAX."""
    return torch.cat([x_prev_last[:, None, :], x[:, :-1, :]], dim=1)


def _tmix_projections(p, x, shifted, n_heads, bf16_comm=False,
                      shard_hints=False, sh=None, mesh=None):
    """r, k, v, w of the heads ``[sh.g0, sh.g1)`` (``layers._share``;
    every head where ``sh`` is None), from ``x`` and ``shifted`` after
    ``copy``. bf16_comm: run the projections in bf16 (the reference's TP
    collectives move half the bytes); the recurrence and decay math stay
    f32. shard_hints: the reference projects straight into head form with
    an einsum that accumulates in f32 and does not round the product to
    the matmul dtype."""
    b, s, d = x.shape
    hd = d // n_heads
    sh = sh or L._share(p, None, n_heads, n_heads, hd)
    lo, hi = sh.g0 * hd, sh.g1 * hd
    acc = _acc(x.dtype)
    mm_dt = torch.bfloat16 if bf16_comm else acc
    xf = x.to(mm_dt)
    sf = shifted.to(mm_dt)

    def mix(m):
        m = P.copy(m, mesh)
        return xf * m.to(mm_dt) + sf * (1 - m).to(mm_dt)

    def mm(mixed, w):
        if shard_hints:
            return mixed.to(acc) @ w.to(mm_dt).to(acc)
        return mixed @ w.to(mm_dt)

    def proj(mixed, w):
        return L._columns(mixed, w, d, lo, hi, mesh, sh.kv_up,
                          mm).to(acc).reshape(b, s, sh.g1 - sh.g0, hd)

    r = proj(mix(p["mix_r"]), p["wr"])
    k = proj(mix(p["mix_k"]), p["wk"])
    v = proj(mix(p["mix_v"]), p["wv"])
    w_base = P.copy(p["w_base"], mesh)[lo:hi]
    w = torch.exp(-torch.exp(
        w_base + proj(mix(p["mix_w"]), p["w_dd"]).reshape(b, s, hi - lo)))
    return r, k, v, w.reshape(b, s, sh.g1 - sh.g0, hd)


def _head_norm(y, scale, n_heads):
    """Per-head RMS norm (RWKV's GroupNorm): normalization stays local to
    the head => no cross-`model` gather before the output projection."""
    b, s, d = y.shape
    hd = d // n_heads
    yh = y.reshape(b, s, n_heads, hd)
    yh = rms_norm(yh, torch.ones((hd,), device=y.device))
    return yh.reshape(b, s, d) * scale.to(yh.dtype)


def _wkv(r_t, k_t, v_t, w_t, state, u):
    """One step of the recurrence over (B, H, hd) inputs: (y_t, S_t)."""
    kv = k_t[..., :, None] * v_t[..., None, :]         # (B,H,hd,hd)
    y = torch.einsum("bhk,bhkv->bhv", r_t, state + u[None, :, :, None] * kv)
    return y, w_t[..., :, None] * state + kv


def _out_proj(p, y, n_heads, bf16_comm, dtype, sh=None, mesh=None):
    """The output of the heads ``[sh.g0, sh.g1)`` (every head where
    ``sh`` is None): their norm, then the rank's output columns (rows of
    ``wo``), summed over ``model``."""
    d = p["ln_x"].shape[-1]
    hd = d // n_heads
    sh = sh or L._share(p, None, n_heads, n_heads, hd)
    base = sh.g0 * hd
    y = _head_norm(y, P.copy(p["ln_x"], mesh)[base:sh.g1 * hd],
                   sh.g1 - sh.g0)[..., sh.lo - base:sh.hi - base]
    wo = p["wo"] if P.sharded(p["wo"].shape[-2], d) \
        else P.copy(p["wo"], mesh)[sh.lo:sh.hi]
    mm_dt = torch.bfloat16 if bf16_comm else _acc(dtype)
    return P.reduce(y.to(mm_dt) @ wo.to(mm_dt), mesh).to(dtype)


def rwkv_tmix_forward(p: dict, x: torch.Tensor, n_heads: int,
                      return_state: bool = False, bf16_comm: bool = False,
                      shard_hints: bool = False):
    """Full-sequence time-mix. x: (B, S, D); on a ``model`` cut, the
    rank's heads (the state of those with ``return_state``)."""
    b, s, d = x.shape
    hd = d // n_heads
    mesh = P.rank_mesh()
    sh = L._share(p, mesh, n_heads, n_heads, hd)
    xc = P.copy(x, mesh)
    shifted = _token_shift(xc, xc.new_zeros((b, d)))
    r, k, v, w = _tmix_projections(p, xc, shifted, n_heads, bf16_comm,
                                   shard_hints, sh, mesh)
    u = p["u"] if P.sharded(p["u"].shape[-2], n_heads) \
        else P.copy(p["u"], mesh)[sh.g0:sh.g1]
    state = torch.zeros((b, sh.g1 - sh.g0, hd, hd), dtype=r.dtype,
                        device=x.device)
    ys = []
    for t in range(s):
        y_t, state = _wkv(r[:, t], k[:, t], v[:, t], w[:, t], state, u)
        ys.append(y_t)
    y = torch.stack(ys, dim=1).reshape(b, s, -1)       # (B,S,heads*hd)
    out = _out_proj(p, y, n_heads, bf16_comm, x.dtype, sh, mesh)
    if return_state:
        return out, {"S": state, "x_prev": x[:, -1, :].to(r.dtype)}
    return out


def rwkv_tmix_step(p: dict, state: dict, x: torch.Tensor, n_heads: int,
                   bf16_comm: bool = False):
    """Single decode step (one device). x: (B, 1, D). state: {"S":
    (B,H,hd,hd), "x_prev": (B, D)}."""
    b, _, d = x.shape
    shifted = state["x_prev"][:, None, :]
    r, k, v, w = _tmix_projections(p, x, shifted, n_heads, bf16_comm)
    y, new_s = _wkv(r[:, 0], k[:, 0], v[:, 0], w[:, 0], state["S"], p["u"])
    out = _out_proj(p, y.reshape(b, 1, d), n_heads, bf16_comm, x.dtype)
    return out, {"S": new_s, "x_prev": x[:, 0, :]}


def rwkv_cmix_forward(p: dict, x: torch.Tensor, x_prev_last=None,
                      bf16_comm: bool = False) -> torch.Tensor:
    """Channel-mix. The reference's ``shard_hints`` only constrains the
    layout here, so the port has no such argument. On a ``model`` cut of
    ``wv``'s output columns every rank needs the ``relu²`` activations
    over all of ``d_ff`` (all-gathered from the rank's columns of ``wk``)
    and all-gathers its output columns; where ``wv`` is whole, Megatron's
    pair over a share of ``d_ff``."""
    b, s, d = x.shape
    mesh = P.rank_mesh()
    xc = P.copy(x, mesh)
    if x_prev_last is None:
        x_prev_last = xc.new_zeros((b, d))
    shifted = _token_shift(xc, x_prev_last)
    mm_dt = torch.bfloat16 if bf16_comm else _acc(x.dtype)
    mix_k = P.copy(p["mix_k"], mesh)
    mixed = xc.to(mm_dt) * mix_k.to(mm_dt) \
        + shifted.to(mm_dt) * (1 - mix_k).to(mm_dt)
    wk, wv = p["wk"], p["wv"]
    d_ff = wv.shape[-2]                # never cut: the spec cuts columns
    wk_cut = P.sharded(wk.shape[-1], d_ff)
    if P.sharded(wv.shape[-1], d):
        h = torch.square(F.relu(
            mixed @ (wk if wk_cut else P.copy(wk, mesh)).to(mm_dt)))
        if wk_cut:
            h = P.gather_last(h, mesh)
        return P.assemble_last(h @ wv.to(mm_dt), mesh).to(x.dtype)
    f0, f1 = P.block(mesh, d_ff)
    if not wk_cut:
        wk = P.copy(wk, mesh)[..., f0:f1]
    h = torch.square(F.relu(mixed @ wk.to(mm_dt)))
    return P.reduce(h @ P.copy(wv, mesh)[f0:f1].to(mm_dt), mesh).to(x.dtype)


def rwkv_init_state(batch: int, d_model: int, n_heads: int, *, device=None):
    hd = d_model // n_heads
    return {
        "S": torch.zeros((batch, n_heads, hd, hd), device=device),
        "x_prev": torch.zeros((batch, d_model), device=device),
        "x_prev_c": torch.zeros((batch, d_model), device=device),
    }

"""Mamba (S6) block — selective state-space layer for the jamba hybrid.

The recurrence is a Python loop over time (exact); decode is the
single-step update with carried (conv_state, ssm_state). State per layer:
  conv_state (B, d_conv-1, d_inner), ssm_state (B, d_inner, d_state) — O(1)
in sequence length, which is what makes jamba long_500k-runnable.

The port of the JAX package's ``models.mamba``: its ``lax.scan`` over time
runs here as a loop of eager ops. JAX promotes ``bf16 @ f32`` to f32 where
``torch.matmul`` refuses mixed dtypes, so every product the reference
promotes goes through ``_mm``. The prefill conv runs in the activation
dtype, the decode conv in f32 on the f32 state, as in the reference.

On a process mesh's ``model`` line (``models.parallel``) the training
forward runs on the rank's block of the ``d_inner`` channels
(``parallel.block``): the specs cut ``conv_w``, ``dt_proj`` on columns and
``x_proj``, ``A_log``, ``D``, ``out_proj`` on rows by that block, or
leave them all whole (``d_inner`` does not divide), when each is used on
the block through ``copy``. ``in_proj``'s column cut does not follow the
channels (at ``model`` 2 one rank holds all of ``u``, the other all of
``z``), so the rank all-gathers the product's columns and takes ``u``
and ``z`` of its block; ``x_proj``'s partial product is summed over
``model`` before ``dt``/``B``/``C``, and ``out_proj``'s rows end in
``reduce``. Decode (``mamba_step``) runs on one device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import parallel as P
from repro_torch.models.layers import acc, dense_init


def init_mamba(gen: torch.Generator, d_model: int, *, expand: int = 2,
               d_state: int = 16, d_conv: int = 4, dt_rank: int = 0,
               dtype=torch.float32, layers: tuple = ()):
    """``layers`` stacks that many layers' weights on leading axes."""
    d_inner = expand * d_model
    dt_rank = dt_rank or max(d_model // 16, 1)
    dev = gen.device
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": dense_init(gen, layers + (d_model, 2 * d_inner), dtype),
        "conv_w": dense_init(gen, layers + (d_conv, d_inner), dtype),
        "x_proj": dense_init(gen, layers + (d_inner, dt_rank + 2 * d_state),
                             dtype),
        "dt_proj": dense_init(gen, layers + (dt_rank, d_inner), dtype),
        "A_log": a_log.expand(layers + (d_inner, d_state)).clone(),
        "D": torch.ones(layers + (d_inner,), device=dev),
        "out_proj": dense_init(gen, layers + (d_inner, d_model), dtype),
    }


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as JAX multiplies mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no linear threshold
    (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(p, x):
    """The decode step's projections (one device: every channel)."""
    d_inner = p["dt_proj"].shape[1]
    dt_rank = p["dt_proj"].shape[0]
    d_state = (p["x_proj"].shape[1] - dt_rank) // 2
    xz = x @ p["in_proj"]
    u, z = torch.chunk(xz, 2, dim=-1)          # (B,S,di) each
    return u, z, d_inner, dt_rank, d_state


def _sel_params(x_proj, dt_proj, uc, dt_rank, d_state, mesh=None):
    """Selective dt/B/C from the conv output. On a ``model`` cut ``uc`` and
    ``x_proj``'s rows are the rank's channels: the partial product is
    summed, then used by the rank's channels alone (``copy``)."""
    proj = P.copy(P.reduce(_mm(uc, x_proj), mesh), mesh)
    dt = softplus(_mm(proj[..., :dt_rank], dt_proj))           # (..., di)
    b_mat = proj[..., dt_rank:dt_rank + d_state]               # (..., st)
    c_mat = proj[..., dt_rank + d_state:]                      # (..., st)
    return dt, b_mat, c_mat


def _part(w: torch.Tensor, dim: int, full: int, c0: int, c1: int, mesh):
    """The channels ``[c0, c1)`` of a leaf along ``dim``: the rank's own
    shard, or its slice of the whole leaf through ``copy``."""
    if P.sharded(w.shape[dim], full):
        return w
    return P.copy(w, mesh).narrow(dim, c0, c1 - c0)


def mamba_forward(p: dict, x: torch.Tensor, return_state: bool = False,
                  d_inner: Optional[int] = None):
    """Full-sequence forward. x: (B, S, D). With return_state, also returns
    {"conv", "ssm"} carry usable by mamba_step (prefill -> decode).
    ``d_inner``: the whole width, which a ``model`` cut needs (the leaves
    hold the rank's part)."""
    b, s, d = x.shape
    mesh = P.rank_mesh()
    if d_inner is None:
        if P.model_split(mesh) > 1:
            raise ValueError("mamba_forward over a process mesh's model "
                             "axis needs d_inner (the whole width)")
        d_inner = p["dt_proj"].shape[1]
    dt_rank = p["dt_proj"].shape[0]
    d_state = p["A_log"].shape[-1]
    c0, c1 = P.block(mesh, d_inner)
    xc = P.copy(x, mesh)
    w = p["in_proj"]
    if P.sharded(w.shape[-1], 2 * d_inner):
        # every rank's columns, then u and z of this rank's channels
        xz = P.gather_last(xc @ w, mesh)
        u, z = xz[..., c0:c1], xz[..., d_inner + c0:d_inner + c1]
    else:
        w = P.copy(w, mesh)
        if c1 - c0 < d_inner:
            w = torch.cat([w[..., c0:c1], w[..., d_inner + c0:d_inner + c1]],
                          dim=-1)
        u, z = torch.chunk(xc @ w, 2, dim=-1)       # (B,S,c1-c0) each
    conv_w = _part(p["conv_w"], -1, d_inner, c0, c1, mesh)
    # causal depthwise conv, in the activation dtype
    d_conv = conv_w.shape[0]
    upad = F.pad(u, (0, 0, d_conv - 1, 0))
    uc = sum(upad[:, i:i + s, :] * conv_w[i][None, None, :]
             for i in range(d_conv))
    uc = acc(F.silu(uc))
    dt, b_mat, c_mat = _sel_params(
        _part(p["x_proj"], -2, d_inner, c0, c1, mesh),
        _part(p["dt_proj"], -1, d_inner, c0, c1, mesh), uc, dt_rank,
        d_state, mesh)
    a = -torch.exp(_part(p["A_log"], -2, d_inner, c0, c1, mesh))  # (di, st)

    h = torch.zeros((b, c1 - c0, d_state), dtype=uc.dtype, device=x.device)
    ys = []
    for t in range(s):
        dt_t = dt[:, t, :, None]                               # (B,di,1)
        d_a = torch.exp(dt_t * a[None])                        # (B,di,st)
        d_bu = dt_t * b_mat[:, t, None, :] * uc[:, t, :, None]
        h = d_a * h + d_bu                                     # (B,di,st)
        ys.append(torch.einsum("bds,bs->bd", h, c_mat[:, t]))
    y = torch.stack(ys, dim=1)                 # (B,S,di)
    y = y + uc * _part(p["D"], -1, d_inner, c0, c1, mesh)[None, None, :]
    out = (y * F.silu(acc(z))).to(x.dtype)
    out = P.reduce(out @ _part(p["out_proj"], -2, d_inner, c0, c1, mesh),
                   mesh)
    if return_state:
        state = {"conv": upad[:, s:s + d_conv - 1, :].float(), "ssm": h}
        return out, state
    return out


def mamba_init_state(p: dict, batch: int):
    d_conv, d_inner = p["conv_w"].shape
    d_state = (p["x_proj"].shape[1] - p["dt_proj"].shape[0]) // 2
    dev = p["conv_w"].device
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), device=dev),
        "ssm": torch.zeros((batch, d_inner, d_state), device=dev),
    }


def mamba_step(p: dict, state: dict, x: torch.Tensor):
    """Single decode step. x: (B, 1, D) -> (out (B,1,D), new_state)."""
    u, z, d_inner, dt_rank, d_state = _ssm_inputs(p, x)
    conv_hist = torch.cat([state["conv"], u[:, :1, :].float()], dim=1)
    uc = torch.einsum("bkd,kd->bd", conv_hist, p["conv_w"].float())
    uc = F.silu(uc)
    dt, b_mat, c_mat = _sel_params(p["x_proj"], p["dt_proj"], uc, dt_rank,
                                   d_state)
    a = -torch.exp(p["A_log"])
    d_a = torch.exp(dt[..., None] * a[None])
    d_bu = dt[..., None] * b_mat[:, None, :] * uc[..., None]
    h = d_a * state["ssm"] + d_bu
    y = torch.einsum("bds,bs->bd", h, c_mat) + uc * p["D"][None]
    out = (y * F.silu(z[:, 0].float())).to(x.dtype)
    new_state = {"conv": conv_hist[:, 1:, :], "ssm": h}
    return (out @ p["out_proj"])[:, None, :], new_state

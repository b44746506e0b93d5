"""Mixture-of-Experts layer built on the DX100 bulk-access pipeline.

Token->expert routing *is* the paper's indirection pattern:

  reorder   : tokens sorted by expert id (sort_indices) so each expert's
              rows form one contiguous run — a "DRAM row" opened once;
  coalesce  : capacity-bounded contiguous expert buffers, one scatter with
              unique destinations (single-writer, no atomics);
  combine   : IRMW ADD — weighted scatter-add back to token order via
              sort+segment-sum (``bulk_rmw``), the RMW microbenchmark
              embedded in a real model.

Experts run as one batched einsum over (n_experts, capacity, d_model).

The port of the JAX package's ``models.moe``. Routing takes the top k in
a stable descending sort, so tied router logits go to the lower expert
index as ``lax.top_k`` sends them; the dispatch scatter drops overflow
lanes on a spare row. The expert-parallel path (``moe_ffn_ep``) runs over
the training launcher's (data, model) mesh (``launch.mesh``), made ambient
by ``launch.mesh.set_mesh``: one expert per model column, tokens split
over the data shards. On a logical mesh the columns and shards are axes
of one batched computation on the mesh's device; on a process mesh
(``launch.mesh.RankMesh``) each rank is one (data shard, column) pair,
and both paths run as GSPMD would run the reference: experts over
``model``, each token's place in its expert's queue in the global token
order, and the combine one all-reduce over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bulk_ops, reorder
from repro_torch.launch.mesh import get_mesh
from repro_torch.models import parallel as P
from repro_torch.models.layers import acc, dense_init


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, layers: tuple = ()):
    return {
        "router": dense_init(gen, layers + (d_model, n_experts),
                             torch.float32),
        "w_gate": dense_init(gen, layers + (n_experts, d_model, d_ff), dtype),
        "w_up": dense_init(gen, layers + (n_experts, d_model, d_ff), dtype),
        "w_down": dense_init(gen, layers + (n_experts, d_ff, d_model), dtype),
    }


def top_k_stable(logits: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25,
            dx100_combine: bool = True):
    """x: (B, S, D) -> ((B, S, D), router logits (B*S, E)).

    On a process mesh (``models.parallel``) x is the rank's block of
    tokens and the expert weights its ``E/m`` experts (all of them where
    ``param_specs`` leaves them whole). The capacity counts the global
    batch's tokens, and a token's place in its expert's queue follows the
    global token order (the reference's stable sort runs over the whole
    batch): the data-parallel ranks before this one add each expert's
    count of their tokens (one small all-gather). The rank runs its
    experts over its tokens at their places, and the ``model`` ranks'
    combined parts are summed (``parallel.reduce``)."""
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    mesh = P.rank_mesh()
    line = P.dp_line(mesh)
    e_loc = p["w_gate"].shape[-3]
    split = P.sharded(e_loc, n_experts)
    e0 = mesh.index("model") * e_loc if split else 0

    # --- routing -----------------------------------------------------------
    logits = acc(xt) @ p["router"]                             # (T, E)
    # the rank's experts use part of the replicated tokens and logits; the
    # aux loss uses them whole
    xr, lr = (P.copy(xt, mesh), P.copy(logits, mesh)) if split \
        else (xt, logits)
    weights, experts = top_k_stable(lr, top_k)                 # (T, K)
    weights = torch.softmax(weights, dim=-1)

    # --- reorder: sort the T*K (token, expert) pairs by expert -------------
    flat_e = experts.reshape(-1).to(torch.int32)               # (T*K,)
    flat_tok = torch.repeat_interleave(
        torch.arange(t, dtype=torch.int32, device=dev), top_k)
    flat_w = weights.reshape(-1)
    sorted_e, perm = reorder.sort_indices(flat_e)
    sorted_tok = flat_tok[perm]
    sorted_w = flat_w[perm]

    # --- coalesce into capacity-bounded contiguous expert buffers ----------
    t_all = t * P.dp_shards(mesh)
    capacity = int(capacity_factor * t_all * top_k / n_experts)
    capacity = max(8, -(-capacity // 8) * 8)                  # sublane align
    # each expert's run in the sorted stream: [bounds[e], bounds[e + 1])
    bounds = torch.searchsorted(sorted_e, torch.arange(
        n_experts + 1, dtype=sorted_e.dtype, device=dev))
    pos_in_e = torch.arange(t * top_k, device=dev) - bounds[sorted_e.long()]
    if line is not None:
        from repro_torch.distributed import exchange
        counts = exchange.all_gather(bounds[1:] - bounds[:-1], line)
        before = counts[:line.rank].sum(0)
        keep = pos_in_e + before[sorted_e.long()] < capacity  # overflow drop
    else:
        keep = pos_in_e < capacity                             # overflow drop
    if split:
        keep &= (sorted_e >= e0) & (sorted_e < e0 + e_loc)
    n_rows = e_loc * capacity
    dest = torch.where(keep, (sorted_e.long() - e0) * capacity + pos_in_e,
                       n_rows)
    # unique destinations; dropped lanes land on spare row n_rows
    buf = x.new_zeros((n_rows + 1, d))
    buf[dest] = xr[sorted_tok.long()]
    buf = buf[:n_rows].reshape(e_loc, capacity, d)

    # --- expert FFN: one batched einsum (each expert = one opened "row") ---
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    y = torch.einsum("ecf,efd->ecd", h, p["w_down"])           # (E, C, D)
    y = y.reshape(n_rows, d)

    # --- combine: IRMW ADD back to token order ------------------------------
    gathered = y[dest.clamp(0, n_rows - 1)]
    contrib = gathered * sorted_w[:, None].to(y.dtype)
    contrib = torch.where(keep[:, None], contrib, 0)
    zeros = y.new_zeros((t, d))
    if dx100_combine:
        out = bulk_ops.bulk_rmw(zeros, sorted_tok, contrib, op="ADD",
                                device=dev)
    else:  # naive duplicate-index scatter (serializing baseline)
        out = zeros.index_add_(0, sorted_tok.long(), contrib)
    if split:
        out = P.reduce(out, mesh)
    return out.reshape(b, s, d).to(x.dtype), logits


def _ep_data_shards(n_experts: int) -> int:
    """The ambient mesh's data shards (the product of its axes other than
    'model') when its 'model' axis has n_experts columns, else 0."""
    mesh = get_mesh()
    if mesh is None or mesh.shape.get("model") != n_experts:
        return 0
    dp = 1
    for a, n in mesh.shape.items():
        if a != "model":
            dp *= int(n)
    return dp


def moe_ffn_ep(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float = 1.25):
    """Expert-parallel MoE over the ambient mesh's ``model`` axis.

    Activations are replicated across the ``model`` axis (they are split
    only over the data axes), so every model column selects the tokens
    routed to ITS expert locally: the dispatch moves nothing. The combine
    sums the columns' (T/dp, D) partial outputs over ``model`` (the
    reference's psum). This is the paper's §6.6 "core multiplexing" on a
    mesh: each column owns one expert's address range and is its single
    writer. Capacity is per data shard: ``int(cf * tl * top_k / E)``,
    rounded up to 8 and at least 8, with ``tl`` the shard's tokens.

    On a logical mesh the columns and data shards are axes of one batched
    computation on the mesh's device. On a process mesh each rank is one
    column (its one expert's weights) and holds its data shard's tokens
    (or, where the batch is whole on every rank, runs every data shard's
    block for its column); the combine is one ``parallel.reduce`` over
    ``model``, and the input (tokens and router logits) enters through
    ``parallel.copy``, ``shard_map``'s transpose of a replicated input.
    Requires n_experts == the model axis size and T % dp == 0;
    ``moe_ffn_auto`` falls back to ``moe_ffn`` otherwise.
    """
    dp = _ep_data_shards(n_experts)
    if not dp:
        raise ValueError(
            f"moe_ffn_ep needs an ambient mesh (launch.mesh.set_mesh) whose "
            f"'model' axis has n_experts={n_experts} columns")
    mesh = P.rank_mesh()
    b, s, d = x.shape
    t = b * s
    dev = x.device
    if mesh is None:
        blocks, cols = dp, torch.arange(n_experts, device=dev)
    else:
        blocks = dp // P.dp_shards(mesh)
        cols = torch.tensor([mesh.index("model")], device=dev)
    n_cols = int(cols.shape[0])
    tl = t // blocks
    cap = int(capacity_factor * tl * top_k / n_experts)
    cap = max(8, -(-cap // 8) * 8)
    xt = x.reshape(blocks, tl, d)                              # per shard

    logits = acc(xt) @ p["router"]                             # (dp,Tl,E)
    xr, lr = P.copy(xt, mesh), P.copy(logits, mesh)
    weights, experts = top_k_stable(lr, top_k)
    weights = torch.softmax(weights, dim=-1)
    flat_e = experts.reshape(blocks, 1, tl * top_k)
    flat_tok = torch.arange(tl, device=dev).repeat_interleave(top_k)
    flat_w = weights.reshape(blocks, 1, tl * top_k)
    cols = cols[None, :, None]
    mine = flat_e == cols                                      # (dp,E,Tl*K)
    pos = torch.cumsum(mine.to(torch.int32), -1) - 1
    keep = mine & (pos < cap)
    # each (shard, column) buffer has a spare row `cap` for dropped lanes
    shard = torch.arange(blocks, device=dev)[:, None, None]
    col = torch.arange(n_cols, device=dev)[None, :, None]
    base = (shard * n_cols + col) * (cap + 1)
    dest = (base + torch.where(keep, pos, cap)).reshape(-1)
    src = xr[shard, flat_tok[None, None, :]].expand(
        blocks, n_cols, tl * top_k, d).reshape(-1, d)
    buf = x.new_zeros((blocks * n_cols * (cap + 1), d))
    buf[dest] = src
    buf = buf.reshape(blocks, n_cols, cap + 1, d)[:, :, :cap]
    h = F.silu(torch.einsum("pecd,edf->pecf", buf, p["w_gate"])) \
        * torch.einsum("pecd,edf->pecf", buf, p["w_up"])
    y = torch.einsum("pecf,efd->pecd", h, p["w_down"])
    y = acc(y)                                                 # (dp,E,C,D)

    # combine: each column scatters its rows back to token order (a
    # token meets a given expert once, so each destination is written
    # once), then the columns sum — the psum over `model`
    srcrow = torch.where(keep, pos, cap - 1)
    val = torch.gather(y, 2, srcrow[..., None].expand(-1, -1, -1, d)) \
        * torch.where(keep, flat_w, 0.0)[..., None].to(y.dtype)
    tok = torch.where(keep, flat_tok[None, None, :], tl)
    tok = ((shard * n_cols + col) * (tl + 1) + tok).reshape(-1)
    contrib = y.new_zeros((blocks * n_cols * (tl + 1), d)).index_add(
        0, tok, val.reshape(-1, d))
    out = contrib.reshape(blocks, n_cols, tl + 1, d)[:, :, :tl].sum(1)
    out = P.reduce(out, mesh)
    return out.reshape(b, s, d).to(x.dtype), logits.reshape(t, n_experts)


def moe_ffn_auto(p, x, *, n_experts, top_k, capacity_factor=1.25,
                 use_ep: bool = False):
    """Dispatch to the EP path when legal (an ambient mesh whose 'model'
    axis has n_experts columns, the global batch's tokens divisible over
    the data axes), else ``moe_ffn``."""
    dp = _ep_data_shards(n_experts) if use_ep else 0
    t = x.shape[0] * x.shape[1] * P.dp_shards(P.rank_mesh())
    if dp and t % dp == 0:
        return moe_ffn_ep(p, x, n_experts=n_experts, top_k=top_k,
                          capacity_factor=capacity_factor)
    return moe_ffn(p, x, n_experts=n_experts, top_k=top_k,
                   capacity_factor=capacity_factor)


def moe_aux_loss(router_logits: torch.Tensor, n_experts: int,
                 top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss over the whole batch (on a process
    mesh, both fractions summed over the data-parallel axes first)."""
    probs = torch.softmax(router_logits, dim=-1)               # (T, E)
    _, top = top_k_stable(router_logits, top_k)
    onehot = F.one_hot(top, n_experts).float().sum(1)
    mesh = P.rank_mesh()
    n = P.all_sum(torch.tensor(float(probs.shape[0]), device=probs.device),
                  mesh, "dp")
    frac_tokens = P.all_sum(onehot.sum(0), mesh, "dp") / n / top_k
    frac_probs = P.reduce(probs.sum(0), mesh, "dp") / n.to(probs.dtype)
    return n_experts * torch.sum(frac_tokens * frac_probs)

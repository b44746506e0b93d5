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

The port of the JAX package's ``models.moe`` on one device. Routing takes
the top k in a stable descending sort, so tied router logits go to the
lower expert index as ``lax.top_k`` sends them; the dispatch scatter drops
overflow lanes on a spare row. The expert-parallel path needs the training
launcher's mesh (ROADMAP A13).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bulk_ops, reorder
from repro_torch.models.layers import dense_init


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
    """x: (B, S, D) -> ((B, S, D), router logits (B*S, E))."""
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)

    # --- routing -----------------------------------------------------------
    logits = xt.float() @ p["router"]                          # (T, E)
    weights, experts = top_k_stable(logits, top_k)             # (T, K)
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
    capacity = int(capacity_factor * t * top_k / n_experts)
    capacity = max(8, -(-capacity // 8) * 8)                  # sublane align
    counts = torch.bincount(sorted_e, minlength=n_experts)
    estart = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    pos_in_e = torch.arange(t * top_k, device=dev) - estart[sorted_e.long()]
    keep = pos_in_e < capacity                                 # overflow drop
    n_rows = n_experts * capacity
    dest = torch.where(keep, sorted_e.long() * capacity + pos_in_e, n_rows)
    # unique destinations; dropped lanes land on spare row n_rows
    buf = x.new_zeros((n_rows + 1, d))
    buf[dest] = xt[sorted_tok.long()]
    buf = buf[:n_rows].reshape(n_experts, capacity, d)

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
    return out.reshape(b, s, d).to(x.dtype), logits


def moe_ffn_ep(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
               capacity_factor: float = 1.25):
    """Expert-parallel MoE over the training launcher's ``model`` mesh
    axis (not the sharded access engine's shards): ROADMAP A13."""
    raise NotImplementedError(
        "moe_ffn_ep needs the training launcher's (data, model) device "
        "mesh, which is ported with training (ROADMAP A13)")


def moe_ffn_auto(p, x, *, n_experts, top_k, capacity_factor=1.25,
                 use_ep: bool = False):
    """The EP path needs a mesh; without one (always, here) the reference
    falls to ``moe_ffn``, and so does the port."""
    return moe_ffn(p, x, n_experts=n_experts, top_k=top_k,
                   capacity_factor=capacity_factor)


def moe_aux_loss(router_logits: torch.Tensor, n_experts: int,
                 top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss over the whole batch."""
    probs = torch.softmax(router_logits, dim=-1)               # (T, E)
    _, top = top_k_stable(router_logits, top_k)
    onehot = F.one_hot(top, n_experts).float().sum(1)
    frac_tokens = onehot.mean(0) / top_k
    frac_probs = probs.mean(0)
    return n_experts * torch.sum(frac_tokens * frac_probs)

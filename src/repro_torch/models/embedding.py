"""DX100-backed embedding: the paper's Gather (fwd) / RMW (bwd) pair as a
first-class model component.

Forward  = ILD   : bulk gather from the vocab table (optionally through the
                   reorder+coalesce path — duplicate tokens in a batch are
                   fetched once).
Backward = IRMW  : the vocab-gradient scatter-add. The engine path
                   segment-combines per-token contributions
                   (``apps.embedding_bag.segment_combine``: sort by token ->
                   segment-sum -> unique scatter) so the dense gradient is
                   built by a single-writer RMW (paper §2.2/§3.2).

The port of the JAX package's ``models.embedding``: the custom VJP is a
``torch.autograd.Function`` with the reference's backward. Out-of-range
tokens follow JAX's indexing: the plain forward (``table[tokens]``) wraps
negatives once and clamps the rest, the engine forward clamps
(``bulk_gather``); the ``dx100_bwd`` gradient drops them, the plain one
(``.at[tok].add``) wraps negatives once and drops the rest. Torch indexing
would instead assert on the device, so every index is fixed up first.

Memory contract of the backward: one dense ``(V, D)`` gradient (plus a
spare row the sentinel lanes land on) and ``O(B*T*D)`` segment work.
"""
from __future__ import annotations

import torch

from repro_torch.core import bulk_ops
from repro_torch.core.interop import jax_gather_index, jax_scatter_index
from repro_torch.models.layers import dense_init


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens, dx100_fwd, dx100_bwd):
        ctx.save_for_backward(tokens)
        ctx.table_shape = tuple(table.shape)
        ctx.dx100_bwd = dx100_bwd
        if dx100_fwd:
            return bulk_ops.bulk_gather(table, tokens, device=table.device)
        return table[jax_gather_index(tokens.long(), table.shape[0])]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        v, d = ctx.table_shape
        flat_tok = tokens.reshape(-1)
        flat_g = g.reshape(-1, d)
        grad = torch.zeros((v + 1, d), dtype=g.dtype, device=g.device)
        if ctx.dx100_bwd:
            from repro_torch.apps.embedding_bag import segment_combine
            # one leader lane per distinct in-range token carries its sum;
            # the rest (and OOB tokens) sit on the sentinel row v
            dest, summed = segment_combine(flat_tok, flat_g, num_rows=v,
                                           device=g.device)
            grad.index_add_(0, dest.long(), summed)
        else:
            grad.index_add_(0, jax_scatter_index(flat_tok.long(), v), flat_g)
        return grad[:v], None, None, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dx100_fwd: bool = False, dx100_bwd: bool = True
                 ) -> torch.Tensor:
    """Embedding lookup with a DX100-shaped custom backward.

    table: (V, D); tokens: int (...); returns (..., D).
    dx100_fwd: route the forward gather through ``bulk_gather``'s
    reorder+coalesce path (duplicate tokens fetched once) instead of plain
    indexing. dx100_bwd: build the table gradient via segment-combine +
    unique scatter instead of the duplicate-index scatter.
    """
    return _EmbedLookup.apply(table, tokens, dx100_fwd, dx100_bwd)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32):
    # 0.02 stddev: keeps tied-head logits O(1) at init
    return dense_init(gen, (vocab, d_model), dtype)


def logits_out(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: (..., D) @ (V, D)^T -> (..., V)."""
    return x @ table.T

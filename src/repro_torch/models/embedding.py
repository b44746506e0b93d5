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

On a process mesh whose ``model`` axis cuts the vocabulary (``embed`` is
``("model", None)``: the paper's address-range partition, §6.6 option 1)
each rank holds rows ``[lo, lo + V/m)``: it looks up the tokens in its
range, writes zeros for the others, and the ranks' rows are summed
(``parallel.reduce``); its backward is the same segment-combine over its
range, every other token on the sentinel row. The tied head gives each
rank its vocabulary columns of the logits.
"""
from __future__ import annotations

import torch

from repro_torch.core import bulk_ops
from repro_torch.core.interop import jax_gather_index, jax_scatter_index
from repro_torch.models import parallel as P
from repro_torch.models.layers import dense_init


class _EmbedLookup(torch.autograd.Function):
    """``table`` holds rows ``[lo, lo + len(table))`` of a ``vocab``-row
    table (the whole table where lo = 0 and vocab = len(table)); tokens
    outside them read zeros and send no gradient."""

    @staticmethod
    def forward(ctx, table, tokens, dx100_fwd, dx100_bwd, lo, vocab):
        ctx.save_for_backward(tokens)
        ctx.table_shape = tuple(table.shape)
        ctx.dx100_bwd = dx100_bwd
        ctx.lo, ctx.vocab = lo, vocab
        if vocab == table.shape[0]:
            if dx100_fwd:
                return bulk_ops.bulk_gather(table, tokens,
                                            device=table.device)
            return table[jax_gather_index(tokens.long(), table.shape[0])]
        # the rank's rows: where the whole table's lookup reads, shifted
        row = jax_gather_index(tokens.long(), vocab) - lo
        own = (row >= 0) & (row < table.shape[0])
        row = row.clamp(0, table.shape[0] - 1)
        if dx100_fwd:
            got = bulk_ops.bulk_gather(table, row, device=table.device)
        else:
            got = table[row]
        return torch.where(own[..., None], got, 0)

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
            # the rest (OOB tokens, and the other ranks' rows) sit on the
            # sentinel row v
            row = flat_tok.long() - ctx.lo
            if ctx.vocab != v:
                row = torch.where((flat_tok >= 0) & (flat_tok < ctx.vocab),
                                  row, v)
            dest, summed = segment_combine(row, flat_g, num_rows=v,
                                           device=g.device)
            grad.index_add_(0, dest.long(), summed)
        else:
            row = jax_scatter_index(flat_tok.long(), ctx.vocab) - ctx.lo
            row = torch.where((row >= 0) & (row < v), row, v)
            grad.index_add_(0, row, flat_g)
        return grad[:v], None, None, None, None, None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dx100_fwd: bool = False, dx100_bwd: bool = True, *,
                 vocab: int | None = None) -> torch.Tensor:
    """Embedding lookup with a DX100-shaped custom backward.

    table: (V, D); tokens: int (...); returns (..., D).
    dx100_fwd: route the forward gather through ``bulk_gather``'s
    reorder+coalesce path (duplicate tokens fetched once) instead of plain
    indexing. dx100_bwd: build the table gradient via segment-combine +
    unique scatter instead of the duplicate-index scatter. ``vocab``: the
    whole table's rows; on a process mesh whose ``model`` axis cuts them,
    ``table`` is the rank's rows and the lookup is summed over ``model``.
    """
    mesh = P.rank_mesh()
    v = table.shape[0]
    if vocab is None or not P.sharded(v, vocab):
        return _EmbedLookup.apply(table, tokens, dx100_fwd, dx100_bwd, 0, v)
    lo = mesh.index("model") * v
    return P.reduce(_EmbedLookup.apply(table, tokens, dx100_fwd, dx100_bwd,
                                       lo, vocab), mesh)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32):
    # 0.02 stddev: keeps tied-head logits O(1) at init
    return dense_init(gen, (vocab, d_model), dtype)


def logits_out(table: torch.Tensor, x: torch.Tensor, *,
               vocab: int | None = None) -> torch.Tensor:
    """Tied output head: (..., D) @ (V, D)^T -> (..., V). On a process
    mesh whose ``model`` axis cuts the ``vocab`` rows, the rank's
    vocabulary columns (``models.model.softmax_xent`` reads them)."""
    mesh = P.rank_mesh()
    if vocab is not None and P.sharded(table.shape[0], vocab):
        x = P.copy(x, mesh)
    return x @ table.T

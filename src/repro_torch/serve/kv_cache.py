"""Paged KV cache — the *in-model* page pool.

A global page pool (pages x page_size tokens) holds K/V for all sequences;
each sequence owns a page list (the page table). The mapping is the
paper's structure:

  page table            = Row Table (which "DRAM rows" a bulk access touches)
  page gather for attn   = ILD: ``gather_pages`` routes through
                           ``bulk_ops.bulk_gather`` (sorted, deduped —
                           pages shared by beam/prefix-cached sequences
                           within this cache are fetched once)
  cache append           = IST with unique destinations (single writer)

Scope: fixed shapes, no scheduler — no flush windows, no cross-tenant
coalescing, no mid-flight pool growth. The scheduler-routed serving path
with those properties is ``apps.kv_serve`` + ``serve.kv_driver.KvPoolServer``.

The port of the JAX package's ``serve.kv_cache``; every function returns a
new ``PagedKVCache`` and leaves its input as it was. Indexing follows
JAX's: ``append_token``'s destinations wrap once when negative (a ``-1``
page writes into the last page) and drop when still out of range, and a
page-table read past the table's end yields ``INT32_MIN``
(``take_along_axis``'s fill); torch indexing would assert instead.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bulk_ops
from repro_torch.core.device import resolve_device
from repro_torch.core.interop import jax_scatter_index

_INT32_MIN = -(2 ** 31)


@dataclasses.dataclass
class PagedKVCache:
    """Single-layer pool. Keep L of them for a full model."""
    k_pool: torch.Tensor       # (num_pages, page_size, n_kv, hd)
    v_pool: torch.Tensor
    page_table: torch.Tensor   # (B, max_pages) int32, -1 = unallocated
    seq_lens: torch.Tensor     # (B,) int32
    free_head: torch.Tensor    # () int32 — bump allocator cursor

    @staticmethod
    def create(num_pages: int, page_size: int, n_kv: int, hd: int,
               batch: int, max_pages: int, dtype=torch.bfloat16, *,
               device=None):
        dev = resolve_device(device)
        return PagedKVCache(
            k_pool=torch.zeros((num_pages, page_size, n_kv, hd),
                               dtype=dtype, device=dev),
            v_pool=torch.zeros((num_pages, page_size, n_kv, hd),
                               dtype=dtype, device=dev),
            page_table=torch.full((batch, max_pages), -1,
                                  dtype=torch.int32, device=dev),
            seq_lens=torch.zeros((batch,), dtype=torch.int32, device=dev),
            free_head=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @property
    def page_size(self):
        return self.k_pool.shape[1]


def alloc_pages(cache: PagedKVCache, n_per_seq) -> PagedKVCache:
    """Bump-allocate pages for each sequence (n_per_seq: (B,) int32)."""
    n = torch.as_tensor(n_per_seq, dtype=torch.int32,
                        device=cache.page_table.device)
    b, mp = cache.page_table.shape
    start = cache.free_head + torch.cat(
        [n.new_zeros(1), torch.cumsum(n, 0, dtype=torch.int32)[:-1]])
    slot = torch.sum(cache.page_table >= 0, dim=1,
                     dtype=torch.int32)                       # next free slot
    col = torch.arange(mp, dtype=torch.int32, device=n.device)[None, :]
    take = (col >= slot[:, None]) & (col < (slot + n)[:, None])
    new_ids = start[:, None] + (col - slot[:, None])
    table = torch.where(take, new_ids, cache.page_table)
    return dataclasses.replace(
        cache, page_table=table,
        free_head=cache.free_head + torch.sum(n, dtype=torch.int32))


def _page_of(page_table: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(page_table, col[:, None], axis=1)[:, 0]`` as JAX
    reads it: negative columns wrap once, columns still outside the table
    read ``INT32_MIN``."""
    mp = page_table.shape[1]
    col = torch.where(col < 0, col + mp, col)
    ok = (col >= 0) & (col < mp)
    got = torch.gather(page_table, 1, col.clamp(0, mp - 1)[:, None].long())
    return torch.where(ok, got[:, 0], _INT32_MIN)


def append_token(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor
                 ) -> PagedKVCache:
    """IST: write one token's K/V per sequence at its current length.
    k, v: (B, n_kv, hd). Pages must already be allocated."""
    ps = cache.page_size
    page_idx = torch.div(cache.seq_lens, ps, rounding_mode="floor")
    offs = cache.seq_lens - page_idx * ps
    pages = _page_of(cache.page_table, page_idx)              # (B,)
    # single writer per (page, offset): destinations are unique; int32
    # arithmetic wraps as XLA's does
    flat_dest = pages * ps + offs
    n = cache.k_pool.shape[0] * ps
    dest = jax_scatter_index(flat_dest.long(), n)             # n = dropped

    def put(pool, val):
        flat = pool.reshape(n, *pool.shape[2:])
        out = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
        out[dest] = val.to(pool.dtype)
        return out[:n].reshape(pool.shape)

    return dataclasses.replace(
        cache, k_pool=put(cache.k_pool, k), v_pool=put(cache.v_pool, v),
        seq_lens=cache.seq_lens + 1)


def gather_pages(cache: PagedKVCache, *, dedup: bool = True):
    """ILD: fetch every sequence's pages from the pool, sorted+coalesced.

    Returns (k, v): (B, max_pages*page_size, n_kv, hd) plus a validity
    length per sequence. Pages shared across sequences (prefix caching,
    beam search) are fetched once.
    """
    b, mp = cache.page_table.shape
    ps = cache.page_size
    num_pages = cache.k_pool.shape[0]
    pages = torch.clamp(cache.page_table, 0, num_pages - 1)
    flat = pages.reshape(-1)
    kflat = cache.k_pool.reshape(num_pages, -1)
    vflat = cache.v_pool.reshape(num_pages, -1)
    dev = kflat.device
    kg = bulk_ops.bulk_gather(kflat, flat, dedup=dedup, device=dev)
    vg = bulk_ops.bulk_gather(vflat, flat, dedup=dedup, device=dev)
    shp = (b, mp * ps) + tuple(cache.k_pool.shape[2:])
    return kg.reshape(shp), vg.reshape(shp), cache.seq_lens


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache, *,
                           n_rep: int) -> torch.Tensor:
    """Decode attention over gathered pages. q: (B, 1, H, hd)."""
    k, v, lens = gather_pages(cache)
    skv = k.shape[1]
    kf = torch.repeat_interleave(k, n_rep, dim=2)
    vf = torch.repeat_interleave(v, n_rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kf.float()) / (q.shape[-1] ** 0.5)
    mask = torch.arange(skv, device=q.device)[None, :] < lens[:, None]
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vf.float())
    return out.to(q.dtype)

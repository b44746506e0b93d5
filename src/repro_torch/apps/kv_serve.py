"""Paged-attention KV serving — the highest-traffic indirection workload.

Multi-tenant decode batches share one physical page pool (the paper's
scratchpad/Row-Table structure mapped onto LLM serving):

  page table             = Row Table: which physical pages a sequence's
                           bulk access touches
  history gather (attn)  = ILD through the page table (``submit_gather``):
                           one fused, coalesced fetch per flush window —
                           prefix pages shared across sequences AND
                           tenants are fetched ONCE (cross-tenant
                           coalescing, the engine's reason to exist); the
                           row-table gather kernel on an
                           ``Engine(use_kernel=True)``
  cache append           = IST-style RMW (``submit_rmw`` op="ADD"): one
                           token per sequence into a never-written zeroed
                           slot — a unique-writer exact "set" (the
                           row-table scatter-RMW kernel); padded and OOB
                           destinations drop (the unified store policy)

Each decode step is the BFS two-window shape (``apps.bfs``): the *access*
window gathers every active sequence's history (reading the pool state
left by step t-1's appends — gathers read the window-initial snapshot),
the *compute* phase scores it and submits the appends, whose tickets
resolve to the end-of-window pool that step t+1 gathers from.

**Growing tables** — what no other app exercises: the pool is
bump-allocated, and when the allocator exhausts physical capacity
*mid-decode* the pool is extended with zero pages (``torch.cat`` on the
in-flight tensor — never a host sync). A grown pool changes
``table_rows``, hence the plan-IR ``window_signature``: the plan cache
takes a miss, the cost model re-decides backends on the new extent, and
the next steady-state windows re-cache. ``run(stats_out=...)`` reports
how often that happened.

Bit-exactness by construction (the ``apps.spmv`` discipline): K/V and
query values are integer-valued f32 in [0, 4), attention is an exact
integer surrogate — ``w = (q . k) mod 8`` then ``out = sum_j w_j * v_j``
— so every product and partial sum stays below 2^24 and is exact and
order-independent in f32. Eager, sequential and pipelined runs all match
the sequential NumPy oracle bit for bit. The host-side page state, the
prefill streams and the oracle are the JAX package's, verbatim, so the
physical page layout is identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.apps import _common
from repro_torch.core import bulk_ops
from repro_torch.core.device import synchronize
from repro_torch.pipeline import DecoupledLoop, run_sequential

_WMOD = 8.0    # attention-weight modulus: w = (q . k) mod 8, exact in f32


@dataclasses.dataclass
class KvProblem:
    """A multi-tenant decode batch over one shared page pool (NumPy).

    All K/V and query values are integer-valued f32 in [0, 4) — see the
    module docstring's exactness invariant. ``prefix_kv`` is the shared
    prompt prefix every sequence maps into its page table (physically
    shared pages — the cross-tenant coalescing fodder); ``prompt_kv`` is
    each sequence's private prompt; ``step_kv``/``queries`` hold the
    decode-time tokens, pre-drawn so every mode replays the same stream.
    """
    page_size: int              # slots per physical page
    d: int                      # head dim (K and V each)
    prefix_kv: np.ndarray       # (prefix_len, 2d) shared prefix, page-aligned
    prompt_kv: np.ndarray       # (n_seqs, max_prompt, 2d) private prompts
    prompt_lens: np.ndarray     # (n_seqs,) int32, 1..max_prompt
    step_kv: np.ndarray         # (max_steps, n_seqs, 2d) decode-token K/V
    queries: np.ndarray         # (max_steps, n_seqs, d)
    tenants: Sequence[str]      # per-seq owning tenant (round-robin)
    init_slack_pages: int = 1   # pool capacity beyond prefill, in pages
    growth_pages: int = 2       # pages added per mid-flight pool growth

    @property
    def n_seqs(self) -> int:
        return self.prompt_kv.shape[0]

    @property
    def prefix_len(self) -> int:
        return self.prefix_kv.shape[0]

    @property
    def max_steps(self) -> int:
        return self.step_kv.shape[0]


def make_problem(seed: int = 0, *, n_seqs: int = 6, n_tenants: int = 3,
                 page_size: int = 4, d: int = 8, prefix_pages: int = 2,
                 max_prompt: int = 8, max_steps: int = 8) -> KvProblem:
    """Random decode batch with the boundedness invariants documented
    above (values in [0, 4), total length per sequence well under 2^24 /
    (7 * 3) so weighted sums stay exact).

    The shared prefix is page-aligned (``prefix_pages * page_size``
    tokens) so prefix pages are never appended to — appends keep the
    unique-writer invariant.
    """
    rng = np.random.default_rng(seed)
    prefix_len = prefix_pages * page_size

    def vals(*shape):
        return rng.integers(0, 4, size=shape).astype(np.float32)

    return KvProblem(
        page_size=page_size, d=d,
        prefix_kv=vals(prefix_len, 2 * d),
        prompt_kv=vals(n_seqs, max_prompt, 2 * d),
        prompt_lens=rng.integers(1, max_prompt + 1,
                                 size=n_seqs).astype(np.int32),
        step_kv=vals(max_steps, n_seqs, 2 * d),
        queries=vals(max_steps, n_seqs, d),
        tenants=tuple(f"tenant{i % n_tenants}" for i in range(n_seqs)))


class _PageState:
    """Host-side page-table / bump-allocator state, shared verbatim by the
    oracle and every run mode so physical layout is identical.

    Page 0..prefix-1 are the shared prefix (every sequence's table starts
    with them); private pages are bump-allocated per sequence on demand.
    ``ensure_capacity`` reports when the *physical pool* must grow —
    the caller extends its pool array (device or NumPy) by
    ``growth_pages`` pages and records the growth.
    """

    def __init__(self, prob: KvProblem):
        self.prob = prob
        p = prob.page_size
        self.n_prefix_pages = prob.prefix_len // p
        assert self.n_prefix_pages * p == prob.prefix_len, \
            "shared prefix must be page-aligned (unique-writer invariant)"
        # logical length per sequence (prefix + private tokens so far)
        self.lens = [prob.prefix_len] * prob.n_seqs
        self.tables: List[List[int]] = [
            list(range(self.n_prefix_pages)) for _ in range(prob.n_seqs)]
        self.free_head = self.n_prefix_pages
        self.cap_pages = self.n_prefix_pages   # grown by ensure_capacity
        self.growths = 0

    # -- allocation ----------------------------------------------------------

    def slot_for_next(self, s: int) -> int:
        """Physical slot of sequence ``s``'s next token, allocating a page
        (and possibly growing the pool — check ``needs_growth`` first)."""
        p = self.prob.page_size
        page_idx, off = divmod(self.lens[s], p)
        if page_idx == len(self.tables[s]):
            self.tables[s].append(self.free_head)
            self.free_head += 1
        return self.tables[s][page_idx] * p + off

    def pages_needed(self, seqs: Sequence[int]) -> int:
        """Physical pages required after appending one token to each of
        ``seqs`` (so growth can happen before the slots are assigned)."""
        p = self.prob.page_size
        need = self.free_head
        for s in seqs:
            if self.lens[s] // p == len(self.tables[s]):
                need += 1
        return need

    def grow_to(self, pages: int) -> Optional[int]:
        """Raise capacity to cover ``pages`` in ``growth_pages`` quanta;
        returns the number of pages added (None if no growth needed)."""
        if pages <= self.cap_pages:
            return None
        added = 0
        g = max(self.prob.growth_pages, 1)
        while self.cap_pages < pages:
            self.cap_pages += g
            added += g
        self.growths += 1
        return added

    # -- gather streams --------------------------------------------------------

    def history_slots(self, s: int, t_cap: int) -> np.ndarray:
        """Physical slots of sequence ``s``'s first ``lens[s]`` tokens,
        padded to the static width ``t_cap`` with slot 0 (in range — the
        padded lanes are masked to zero weight in compute)."""
        p = self.prob.page_size
        n = self.lens[s]
        pages = np.asarray(self.tables[s], np.int32)
        slots = (pages[:, None] * p
                 + np.arange(p, dtype=np.int32)[None, :]).reshape(-1)[:n]
        out = np.zeros(t_cap, np.int32)
        out[:n] = slots
        return out

    def valid_mask(self, s: int, t_cap: int) -> np.ndarray:
        m = np.zeros(t_cap, bool)
        m[:self.lens[s]] = True
        return m


def _prefill_streams(prob: KvProblem, st: _PageState):
    """(dests, values) per tenant writing the shared prefix + each private
    prompt into the zeroed pool — ADD into never-written slots is an exact
    set. The prefix is written once, by the first tenant."""
    per_tenant: Dict[str, list] = {}
    first = prob.tenants[0]
    p = prob.page_size
    prefix_dests = np.arange(prob.prefix_len, dtype=np.int32)
    per_tenant[first] = [(prefix_dests, prob.prefix_kv)]
    for s in range(prob.n_seqs):
        dests = []
        for _ in range(int(prob.prompt_lens[s])):
            st.grow_to(st.pages_needed([s]))
            dests.append(st.slot_for_next(s))
            st.lens[s] += 1
        dests = np.asarray(dests, np.int32)
        vals = prob.prompt_kv[s, :int(prob.prompt_lens[s])]
        per_tenant.setdefault(prob.tenants[s], []).append((dests, vals))
    return {t: (np.concatenate([d for d, _ in parts]),
                np.concatenate([v for _, v in parts]))
            for t, parts in per_tenant.items()}


def _attend(q, k_hist, v_hist, mask, kv_cur):
    """Exact-integer attention surrogate for one tenant's sequences.

    q: (n, d); k_hist/v_hist: (n, T, d); mask: (n, T) bool;
    kv_cur: (n, 2d) — the current token attends to itself locally (its
    K/V is still in registers; it is appended *after* this window).
    All operands are integer-valued, so every sum is exact in f32 and
    order-independent (torch here, np in the oracle — bit-identical).
    """
    d = q.shape[-1]
    scores = torch.einsum("ntd,nd->nt", k_hist, q)
    w = torch.remainder(scores, _WMOD) * mask
    out = torch.einsum("nt,ntd->nd", w, v_hist)
    w_cur = torch.remainder(torch.einsum("nd,nd->n", kv_cur[:, :d], q),
                            _WMOD)
    return out + w_cur[:, None] * kv_cur[:, d:]


def reference(prob: KvProblem, n_steps: int) -> np.ndarray:
    """Sequential NumPy oracle: dense pool, same allocator, per-sequence
    loops. Returns the stacked attention outputs (n_steps, n_seqs, d)."""
    st = _PageState(prob)
    d, p = prob.d, prob.page_size
    streams = _prefill_streams(prob, st)
    pool = np.zeros((st.cap_pages * p, 2 * d), np.float32)
    for dests, vals in streams.values():
        pool[dests] += vals
    outs = np.zeros((n_steps, prob.n_seqs, d), np.float32)
    for t in range(n_steps):
        for s in range(prob.n_seqs):
            n = st.lens[s]
            slots = st.history_slots(s, n)
            hist = pool[slots]
            k_h, v_h = hist[:, :d], hist[:, d:]
            q = prob.queries[t, s]
            w = np.mod(k_h @ q, _WMOD)
            kv_c = prob.step_kv[t, s]
            w_c = np.mod(float(kv_c[:d] @ q), _WMOD)
            outs[t, s] = w @ v_h + w_c * kv_c[d:]
        # append after the whole batch's reads (window-initial semantics)
        added = st.grow_to(st.pages_needed(range(prob.n_seqs)))
        if added:
            pool = np.concatenate(
                [pool, np.zeros((added * p, 2 * d), np.float32)])
        for s in range(prob.n_seqs):
            pool[st.slot_for_next(s)] += prob.step_kv[t, s]
            st.lens[s] += 1
    return outs


def run(prob: KvProblem, n_steps: int, *, mode: str = "pipelined",
        service=None, mesh=None, stats_out: Optional[dict] = None,
        device=None) -> np.ndarray:
    """Decode ``n_steps`` tokens for every sequence; returns the stacked
    attention outputs (n_steps, n_seqs, d) as NumPy.

    mode:
      "eager"      direct ``bulk_ops`` calls, hard barrier per phase
      "sequential" scheduler-submitted access, barrier per phase
      "pipelined"  ``DecoupledLoop.run``: step t+1's history gather is
                   queued while step t's scoring may still run
    service: an ``AccessService`` to share (default: a private one on
    ``device``, ``None`` = CUDA); mesh: must be None (ROADMAP A11).
    stats_out: optional dict, filled with {"growths", "final_pages",
    "t_cap"} — how often the pool grew mid-flight (plan-cache churn).

    Raises ValueError on an unknown ``mode`` or ``n_steps`` exceeding the
    problem's pre-drawn ``max_steps``.
    """
    if n_steps > prob.max_steps:
        raise ValueError(f"n_steps={n_steps} > max_steps={prob.max_steps}")
    service, dev = _common.placement(mode, service, mesh, device)
    d, p = prob.d, prob.page_size
    st = _PageState(prob)
    streams = _prefill_streams(prob, st)
    st.cap_pages += prob.init_slack_pages      # decode starts with slack
    # static gather width: longest possible history over the run
    t_cap = prob.prefix_len + int(prob.prompt_lens.max()) + n_steps
    by_tenant = _common.by_tenant(prob.tenants)
    outs: List = [None] * n_steps
    pool = torch.zeros((st.cap_pages * p, 2 * d), dtype=torch.float32,
                       device=dev)

    def tensor(x):
        return torch.as_tensor(x, device=dev)

    def grown(pool, seqs):
        """Extend the pool (on the device, queued) if this step's appends
        exceed physical capacity — the mid-flight growth path."""
        added = st.grow_to(st.pages_needed(seqs))
        if added:
            pool = torch.cat([pool, pool.new_zeros((added * p, 2 * d))])
        return pool

    def append_streams(t):
        """(dests, vals) per tenant for step ``t``'s one-token appends —
        unique destinations (each slot written exactly once, from zero)."""
        per = {}
        for tname, seqs in by_tenant.items():
            dests = np.asarray([st.slot_for_next(s) for s in seqs],
                               np.int32)
            for s in seqs:
                st.lens[s] += 1
            per[tname] = (dests, tensor(prob.step_kv[t][seqs]))
        return per

    def attend(t, tname, hist, mask):
        seqs = by_tenant[tname]
        return _attend(tensor(prob.queries[t][seqs]), hist[..., :d],
                       hist[..., d:], mask, tensor(prob.step_kv[t][seqs]))

    def history(tname):
        """(slots, mask) of one tenant's sequences, padded to t_cap."""
        seqs = by_tenant[tname]
        return (np.stack([st.history_slots(s, t_cap) for s in seqs]),
                tensor(np.stack([st.valid_mask(s, t_cap) for s in seqs])))

    if mode == "eager":
        for tname, (dests, vals) in streams.items():
            pool = bulk_ops.bulk_rmw(pool, tensor(dests), tensor(vals),
                                     op="ADD", device=dev)
        for t in range(n_steps):
            per_tenant_out = {}
            for tname in by_tenant:
                idx, mask = history(tname)
                hist = bulk_ops.bulk_gather(pool, tensor(idx), device=dev)
                per_tenant_out[tname] = attend(t, tname, hist, mask)
            outs[t] = _common.collate(by_tenant, per_tenant_out)
            pool = grown(pool, range(prob.n_seqs))
            for tname, (dests, vals) in append_streams(t).items():
                pool = bulk_ops.bulk_rmw(pool, tensor(dests), vals,
                                         op="ADD", device=dev)
            synchronize(dev)
        _fill_stats(stats_out, st, t_cap)
        return torch.stack(outs).cpu().numpy()

    sched = service.scheduler

    # prefill through the scheduler: one fused-RMW window on the zero pool
    tickets = [sched.submit_rmw(pool, tensor(dests), tensor(vals),
                                op="ADD", tenant=tname)
               for tname, (dests, vals) in streams.items()]
    sched.flush(inflight_ok=True)
    # every ticket is redeemed (one pool): a long-lived service would
    # otherwise keep each window's pool alive through the others
    pool = [sched.result(tk) for tk in tickets][0]

    aux: Dict[int, dict] = {}   # step -> per-tenant masks (host-built)

    def access(loop, t, pool):
        masks, tix = {}, {}
        for tname in by_tenant:
            idx, masks[tname] = history(tname)
            tix[tname] = loop.submit_gather(pool, idx, tenant=tname)
        aux[t] = masks
        return tix

    def compute(t, pool, results):
        masks = aux.pop(t)
        per_tenant_out = {}
        for tname, seqs in by_tenant.items():
            hist = results[tname].reshape(len(seqs), t_cap, 2 * d)
            per_tenant_out[tname] = attend(t, tname, hist, masks[tname])
        outs[t] = _common.collate(by_tenant, per_tenant_out)
        pool = grown(pool, range(prob.n_seqs))
        ts = [sched.submit_rmw(pool, tensor(dests), vals, op="ADD",
                               tenant=tname)
              for tname, (dests, vals) in append_streams(t).items()]
        # second window of the step: the appends. inflight_ok — this
        # window deliberately overlaps the loop's already-dispatched
        # access window (exactly the BFS pattern)
        sched.flush_async(inflight_ok=True)
        # the end-of-window pool, still queued
        return [sched.result(tk) for tk in ts][0]

    if mode == "sequential":
        run_sequential(service, pool, n_steps, access, compute)
    else:
        DecoupledLoop(service).run(pool, n_steps, access, compute)
    _fill_stats(stats_out, st, t_cap)
    return torch.stack(outs).cpu().numpy()


def _fill_stats(stats_out: Optional[dict], st: _PageState, t_cap: int):
    if stats_out is not None:
        stats_out.update(growths=st.growths, final_pages=st.cap_pages,
                         t_cap=t_cap)


def demo(seed: int = 0, *, mode: str = "pipelined", mesh=None,
         n_steps: int = 6, service=None, device=None,
         stats_out: Optional[dict] = None) -> np.ndarray:
    """Seeded end-to-end decode batch (the parity checks' entry)."""
    return run(make_problem(seed), n_steps, mode=mode, mesh=mesh,
               service=service, device=device, stats_out=stats_out)


def demo_reference(seed: int = 0, *, n_steps: int = 6) -> np.ndarray:
    """NumPy-oracle counterpart of ``demo`` (identical seeding)."""
    return reference(make_problem(seed), n_steps)

"""Decode-batch KV serving driver: multi-tenant paged attention on one
``AccessService``.

``apps.kv_serve`` proves the decode loop bit-exact; this module is the
*serving* wrapper around the same access shape — the piece a model server
talks to. One ``KvPoolServer`` owns one physical page pool (the shared
scratchpad) and any number of tenant sequences:

  admit()         prefill: the sequence's prompt K/V lands in
                  bump-allocated pages through one unique-writer ADD-RMW
                  window; sequences may reference a shared prefix whose
                  pages are mapped (not copied) into their page tables
  decode_batch()  one decode step for a batch of sequences in ONE flush
                  window: every sequence's page-table history gather is
                  submitted (fused + coalesced across tenants — shared
                  prefix pages fetched once), then every sequence's
                  new-token append rides the same window as RMWs
  stats()         pool occupancy, growths, and the service's telemetry

The pool grows mid-flight: when the allocator runs out of physical pages
the device array is extended with zero pages between windows — a new
``window_signature`` for the plan cache and a fresh cost-model decision,
exactly the dynamic-table churn ``apps.kv_serve`` stress-tests.

The driver never blocks the host: appends resolve through RMW tickets
(end-of-window pool state), and gathers are handed back as futures.

This is the port of the JAX package's ``serve.kv_driver``: the pool is a
float32 tensor on the service's device, and every destination stream and
K/V block goes there before it is submitted.

Over a process mesh (a service over ``ShardedEngine(ProcessMesh)``, SPMD:
every rank makes the same calls) each rank holds only its rows
``rank_rows`` of the pool, submitted with the whole pool's ``n_rows``; a
growth re-cuts the slice (``ShardedEngine.regrow``: only the rows whose
owner changes move, and no rank ever holds the whole pool). Histories
come back whole on every rank; ``stats()`` reports the whole pool, as on
one device, and adds the rank's rows and what its growths moved.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class KvSequence:
    """One admitted sequence: its page table and logical length.

    ``pages`` lists physical page ids (the Row Table); the first
    ``n_shared`` of them belong to a shared prefix group and are never
    appended to (the unique-writer invariant).
    """

    def __init__(self, name: str, tenant: str, pages: List[int],
                 n_shared: int, length: int):
        self.name = name
        self.tenant = tenant
        self.pages = pages
        self.n_shared = n_shared
        self.length = length


class KvPoolServer:
    """Multi-tenant paged-KV pool on one ``AccessService``.

    page_size: slots per physical page; d: K/V row width (a pool row
    holds K and V concatenated: ``2 * d`` floats); service: the shared
    ``AccessService`` (one is created when omitted); init_pages /
    growth_pages: starting capacity and the growth quantum.

    All values fed through ``admit``/``decode_batch`` should follow the
    engine's exactness discipline (integer-valued, bounded) if bit-exact
    replay matters; the driver itself is value-agnostic.
    """

    def __init__(self, *, page_size: int = 4, d: int = 8, service=None,
                 init_pages: int = 8, growth_pages: int = 4):
        if service is None:
            from repro_torch.serve.access_service import AccessService
            service = AccessService(auto_flush=0)
        self.service = service
        self.device = service.scheduler.engine.device
        # over a process mesh: the sharded engine that cuts the pool
        self._mesh = service.scheduler.engine \
            if getattr(service.scheduler, "process", False) else None
        self.page_size = int(page_size)
        self.d = int(d)
        self.growth_pages = max(1, int(growth_pages))
        self.cap_pages = max(1, int(init_pages))
        self.free_head = 0
        self.growths = 0
        self.pool_rows = self.cap_pages * self.page_size   # the whole pool
        lo, hi = self._rows()
        # this rank's rows of the pool (all of them on one device)
        self.pool = torch.zeros((hi - lo, 2 * self.d), dtype=torch.float32,
                                device=self.device)
        self.moved_rows = [0, 0]            # growths' rows sent, received
        self.growth_collectives = 0
        self.seqs: Dict[str, KvSequence] = {}
        self.prefixes: Dict[str, Tuple[List[int], int]] = {}

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def _rows(self) -> Tuple[int, int]:
        """The pool rows this rank holds: ``rank_rows`` over a process
        mesh, else all of them."""
        if self._mesh is None:
            return 0, self.pool_rows
        return self._mesh.rank_rows(self.pool_rows)

    # -- allocation ----------------------------------------------------------

    def _alloc_pages(self, n: int) -> List[int]:
        pages = list(range(self.free_head, self.free_head + n))
        self.free_head += n
        if self.free_head > self.cap_pages:
            while self.cap_pages < self.free_head:
                self.cap_pages += self.growth_pages
            self.growths += 1
            rows = self.cap_pages * self.page_size
            # device-side extension — never a host sync; next window's
            # plan signature changes and the cost model re-decides. A new
            # tensor either way: a gather already submitted in this
            # window keeps reading the old one
            if self._mesh is None:
                self.pool = torch.cat([self.pool, self.pool.new_zeros(
                    (rows - self.pool_rows, 2 * self.d))])
            else:
                c0 = self._mesh.collectives
                self.pool, (sent, got) = self._mesh.regrow(
                    self.pool, self.pool_rows, rows)
                self.moved_rows[0] += sent
                self.moved_rows[1] += got
                self.growth_collectives += self._mesh.collectives - c0
            self.pool_rows = rows
        return pages

    def _slots(self, pages: Sequence[int], start: int,
               count: int) -> np.ndarray:
        """Physical slots for logical positions [start, start+count)."""
        p = self.page_size
        pages = np.asarray(pages, np.int32)
        flat = (pages[:, None] * p
                + np.arange(p, dtype=np.int32)[None, :]).reshape(-1)
        return flat[start:start + count]

    # -- admission -----------------------------------------------------------

    def create_prefix(self, name: str, kv: np.ndarray) -> None:
        """Register a shared prefix (page-aligned): its K/V is written
        once; every sequence admitted with ``prefix=name`` maps the same
        physical pages. Raises ValueError if ``kv`` is not page-aligned
        or ``name`` is already registered."""
        if name in self.prefixes:
            raise ValueError(f"prefix {name!r} already registered")
        length = kv.shape[0]
        if length % self.page_size:
            raise ValueError(
                f"prefix length {length} not page-aligned "
                f"(page_size={self.page_size})")
        pages = self._alloc_pages(length // self.page_size)
        dests = self._slots(pages, 0, length)
        # windows are driver-managed: submit on the scheduler directly so
        # a service-level auto_flush can never split a prefill window
        sched = self.service.scheduler
        t = sched.submit_rmw(self.pool, self._tensor(dests),
                             self._tensor(kv, torch.float32), op="ADD",
                             tenant="__prefix__", n_rows=self.pool_rows)
        sched.flush(inflight_ok=True)
        self.pool = sched.result(t)
        self.prefixes[name] = (pages, length)

    def admit(self, name: str, tenant: str, prompt_kv: np.ndarray, *,
              prefix: Optional[str] = None) -> KvSequence:
        """Admit a sequence: map the (optional) shared prefix pages, then
        prefill its prompt K/V through one RMW window. Returns the live
        ``KvSequence``. Raises KeyError on an unknown prefix and
        ValueError on a duplicate sequence name."""
        if name in self.seqs:
            raise ValueError(f"sequence {name!r} already admitted")
        shared_pages: List[int] = []
        base_len = 0
        if prefix is not None:
            shared_pages, base_len = self.prefixes[prefix]
        n_prompt = prompt_kv.shape[0]
        total = base_len + n_prompt
        n_private = -(-total // self.page_size) - len(shared_pages)
        pages = list(shared_pages) + self._alloc_pages(max(n_private, 0))
        seq = KvSequence(name, tenant, pages, len(shared_pages), total)
        if n_prompt:
            dests = self._slots(pages, base_len, n_prompt)
            sched = self.service.scheduler
            t = sched.submit_rmw(
                self.pool, self._tensor(dests),
                self._tensor(prompt_kv, torch.float32), op="ADD",
                tenant=tenant, n_rows=self.pool_rows)
            sched.flush(inflight_ok=True)
            self.pool = sched.result(t)
        self.seqs[name] = seq
        return seq

    # -- decode --------------------------------------------------------------

    def decode_batch(self, new_kv: Dict[str, np.ndarray]):
        """One decode step for ``new_kv``'s sequences ({name: (2d,) K/V}).

        Submits every sequence's full-history gather (per-tenant streams
        against the one pool — fused and cross-tenant coalesced in this
        window), then allocates each sequence's next slot (growing the
        pool mid-flight if needed) and submits the appends as ADD RMWs
        into the same window; one ``flush_async`` dispatches it all.

        Returns ``(histories, report)``: ``histories`` maps sequence name
        to its gathered (length, 2d) history *future* (the window-initial
        pool — this step's appends are visible to the NEXT decode step,
        the paper's window-ordering semantic), and ``report`` is the
        window's ``FlushReport`` (``gather_coalescing`` shows the shared-
        page gain). Raises KeyError on an unadmitted sequence name.
        """
        sched = self.service.scheduler
        tickets = {}
        for name in new_kv:
            seq = self.seqs[name]
            idx = self._slots(seq.pages, 0, seq.length)
            tickets[name] = sched.submit_gather(self.pool,
                                                self._tensor(idx),
                                                tenant=seq.tenant,
                                                n_rows=self.pool_rows)
        # allocate every destination BEFORE submitting any append: growth
        # swaps self.pool for a longer array, and all of one window's
        # appends must target the same table object to fuse (and to make
        # any append ticket resolve to the whole window's end state). The
        # gathers above keep the old pool (and its n_rows); every rank
        # grows at the same point, the allocator being deterministic
        dests = {}
        for name in new_kv:
            seq = self.seqs[name]
            if seq.length // self.page_size == len(seq.pages):
                seq.pages.extend(self._alloc_pages(1))
            dests[name] = self._slots(seq.pages, seq.length, 1)
            seq.length += 1
        append_t = [
            sched.submit_rmw(
                self.pool, self._tensor(dests[name]),
                self._tensor(kv, torch.float32).reshape(1, 2 * self.d),
                op="ADD", tenant=self.seqs[name].tenant,
                n_rows=self.pool_rows)
            for name, kv in new_kv.items()]
        handle = sched.flush_async(inflight_ok=True)
        # every append ticket resolves to the same end-of-window pool;
        # redeem them all, or the scheduler keeps each step's pool alive
        pools = [sched.result(t) for t in append_t]
        if pools:
            self.pool = pools[0]
        histories = {name: sched.result(t) for name, t in tickets.items()}
        return histories, handle.report

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Pool occupancy and growth counters (plus live sequence count);
        service-level latency/window telemetry stays on
        ``self.service.stats()``. Over a process mesh the counters are the
        whole pool's, and ``rank_rows`` (this rank's rows), ``moved_rows``
        (the rows its growths sent and received) and
        ``growth_collectives`` are added."""
        out = {"cap_pages": self.cap_pages, "used_pages": self.free_head,
               "growths": self.growths, "n_seqs": len(self.seqs),
               "pool_rows": self.pool_rows}
        if self._mesh is not None:
            out.update(rank_rows=self._rows(),
                       moved_rows=tuple(self.moved_rows),
                       growth_collectives=self.growth_collectives)
        return out

"""Decoupled access/execute pipeline: double-buffered flush windows.

DX100's deployment (paper Fig. 2) decouples *access* (the accelerator
streams indexed data into scratchpads) from *execute* (cores compute on
tiles already resident): while the cores chew on iteration k, the
accelerator is already fetching iteration k+1's working set. Every
blocking ``Scheduler.flush()`` is a barrier — compute waits for access and
access waits for compute.

``DecoupledLoop`` removes the barriers, built on two mechanisms:

  * ``Scheduler.flush_async`` queues a flush *window* on the current CUDA
    stream without waiting for it (``FlushHandle`` carries an event);
  * redeeming a ticket hands back tensors that the next queued work can
    consume without the host ever waiting for them.

So the host plans and queues window k+1 while the device still runs
window k and its compute. (Planning does wait where it must size a tensor
on the host: the dedup's ``torch.unique``.)

Two drivers cover the two dependence shapes of Table-1 workloads:

  * ``run``: iteration k+1's access window depends on iteration k's
    compute output (SpMV power iteration gathers the new vector; BFS
    expands the new frontier).
  * ``run_windows``: windows are mutually independent (hash-join probe
    tiles, embedding lookups): up to ``depth`` access windows are kept in
    flight ahead of the compute consuming them — double buffering at
    ``depth=2``.

``run_sequential`` is the strictly-coupled baseline: a barrier after
every phase (the window's ``result()``, then the device stream for the
compute's state).

Over a process mesh (one scheduler per rank) every rank runs the same
loop: no branch here depends on what only one rank can observe (an
event query, the clock), so every rank flushes the same windows in the
same order; ``ready`` may be read but decides nothing.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Sequence

from repro_torch.core.device import synchronize
from repro_torch.core.scheduler import FlushHandle, Scheduler


def tree_map(fn: Callable, tree, is_leaf: Callable):
    """``fn`` over the leaves of nested dicts, tuples and lists (the
    structures an access callback returns its tickets in)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return tree


def _is_ticket(x) -> bool:
    return hasattr(x, "tid")


class AccessWindow:
    """One iteration's access phase: the tickets submitted for it plus the
    ``FlushHandle`` of the flush window that dispatched them.

    ``redeem()`` hands back the retired results (it never blocks: the
    tensors may still be being computed on the stream); ``ready`` polls
    retirement without blocking; ``wait()`` is the explicit barrier (the
    sequential baseline's phase boundary).
    """

    def __init__(self, scheduler: Scheduler, tickets, handle: FlushHandle):
        self.scheduler = scheduler
        self.tickets = tickets
        self.handle = handle

    def redeem(self):
        """Results for this window's tickets, in submission structure.
        Non-blocking."""
        return tree_map(self.scheduler.result, self.tickets, _is_ticket)

    @property
    def ready(self) -> bool:
        return self.handle.poll()

    def wait(self):
        self.handle.result()
        return self


class DecoupledLoop:
    """Double-buffered access/execute driver over one scheduler.

    ``target``: a ``Scheduler`` or anything scheduler-shaped exposing
    ``submit_gather``/``submit_rmw``/``submit``/``flush_async``/``result``
    (and, where it wraps one, the scheduler as ``.scheduler``).

    The access callback receives this loop and submits through it (so app
    code is agnostic to the target); the loop flushes one window per
    access phase.
    """

    def __init__(self, target, *, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.target = target
        self.depth = int(depth)
        self.stats = {"windows": 0, "iterations": 0}

    # -- submission forwarding (app code talks to the loop) -----------------

    def submit_gather(self, table, idx, **kw):
        return self.target.submit_gather(table, idx, **kw)

    def submit_rmw(self, table, idx, values, **kw):
        return self.target.submit_rmw(table, idx, values, **kw)

    def submit(self, program, env, regs=None, **kw):
        return self.target.submit(program, env, regs, **kw)

    def _scheduler(self) -> Scheduler:
        return getattr(self.target, "scheduler", self.target)

    def _dispatch_window(self, access: Callable, k: int,
                         state) -> Optional[AccessWindow]:
        tickets = access(self, k, state)
        # inflight_ok: keeping several access windows in flight is this
        # loop's entire purpose — the scheduler's in-flight guard exists
        # for callers that overlap windows by accident, not by design
        handle = self.target.flush_async(inflight_ok=True)
        self.stats["windows"] += 1
        if tickets is None:
            return None
        return AccessWindow(self._scheduler(), tickets, handle)

    # -- dependent iterations (access k+1 consumes compute k's output) ------

    def run(self, state, n_iters: int, access: Callable, compute: Callable):
        """Drive ``n_iters`` dependent iterations with one-window lookahead.

        ``access(loop, k, state) -> tickets``: submit iteration ``k``'s
        bulk accesses through ``loop`` (tickets in dicts, tuples or lists,
        or None). ``compute(k, state, results) -> state``: consume the
        redeemed results and produce the next state.

        Iteration k's results are redeemed *without blocking* and compute
        k is queued; access k+1 is submitted immediately after. The host
        waits only where planning sizes a tensor, or when the caller
        finally reads the returned state.
        """
        if n_iters <= 0:
            return state
        window = self._dispatch_window(access, 0, state)
        for k in range(n_iters):
            results = window.redeem() if window is not None else None
            state = compute(k, state, results)
            self.stats["iterations"] += 1
            if k + 1 < n_iters:
                window = self._dispatch_window(access, k + 1, state)
        return state

    # -- independent windows (hash-join probe tiles, lookup batches) --------

    def run_windows(self, items: Sequence, access: Callable,
                    compute: Callable) -> List:
        """Pipeline independent work items with ``depth`` windows in flight.

        ``access(loop, k, item) -> tickets`` submits item ``k``'s accesses;
        ``compute(k, item, results)`` consumes the redeemed results and
        returns the item's output. Access windows run up to ``depth``
        items ahead of the compute that consumes them.
        """
        items = list(items)
        out: List = []
        inflight: deque = deque()
        for k in range(min(self.depth, len(items))):
            inflight.append((k, self._dispatch_window(access, k, items[k])))
        next_k = len(inflight)
        while inflight:
            k, window = inflight.popleft()
            results = window.redeem() if window is not None else None
            out.append(compute(k, items[k], results))
            self.stats["iterations"] += 1
            if next_k < len(items):
                inflight.append(
                    (next_k, self._dispatch_window(access, next_k,
                                                   items[next_k])))
                next_k += 1
        return out


def run_sequential(target, state, n_iters: int, access: Callable,
                   compute: Callable):
    """Strictly-coupled baseline: access, BARRIER, compute, BARRIER.

    Same callbacks as ``DecoupledLoop.run``, but every phase ends in a
    barrier — the window's ``result()`` after access, the device stream
    after compute — so compute never overlaps access, the
    pre-accelerator behaviour the paper's Fig. 2 contrasts against.
    """
    loop = DecoupledLoop(target, depth=1)
    for k in range(n_iters):
        tickets = access(loop, k, state)
        # nothing is in flight here by construction (the last iteration
        # ended in both barriers), so the in-flight guard has nothing to
        # catch; over a process mesh it would test whether every earlier
        # handle was resolved, and a compute phase may flush windows whose
        # handles it drops (bfs's relaxation, the apps' appends)
        handle = target.flush_async(inflight_ok=True)
        handle.result()                      # access barrier
        results = None
        if tickets is not None:
            results = AccessWindow(loop._scheduler(), tickets,
                                   handle).redeem()
        state = compute(k, state, results)
        synchronize(loop._scheduler().engine.device)   # compute barrier
    return state

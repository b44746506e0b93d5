"""Backend registry + the emit stage: plan tree -> execution.

A *backend* names a pass table (the six ``repro_torch.plan.passes`` slots,
overridable per backend) plus an emitter table mapping
``(node kind, node backend)`` to the function that executes that node.
Backends are **registered, not probed**: ``repro_torch.core.scheduler``
registers "local" (its thin ``_execute_*`` emitters) at import, and a
mesh engine will register its own the same way. An engine declares its
backend via the ``plan_backend`` class attribute.

``execute`` walks a lowered plan's roots in order with per-node error
isolation: a node that raises resolves its members' tickets to the
scheduler's ``FailedResult`` (via the context's factory) and poisons any
RMW table it touched — every other node still executes, exactly the
per-group isolation contract ``flush`` always had.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.plan import nodes, passes


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    passes: Dict[str, Callable]            # pipeline slot -> pass fn
    emitters: Dict[tuple, Callable]        # (kind, backend tag) -> fn
    sharded: bool = False                  # mesh-capable placement


_REGISTRY: Dict[str, Backend] = {}


def register_backend(name: str, *, passes_override=None, emitters=None,
                     base: Optional[str] = None,
                     sharded: bool = False) -> Backend:
    """Register (or re-register) a backend. ``base`` inherits another
    backend's pass and emitter tables before applying the overrides."""
    ptable = dict(passes.DEFAULT_PASSES)
    etable: Dict[tuple, Callable] = {}
    if base is not None:
        b = get_backend(base)
        ptable.update(b.passes)
        etable.update(b.emitters)
        sharded = sharded or b.sharded
    ptable.update(passes_override or {})
    etable.update(emitters or {})
    backend = Backend(name=name, passes=ptable, emitters=etable,
                      sharded=sharded)
    _REGISTRY[name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no plan backend {name!r} registered (have "
            f"{sorted(_REGISTRY)}); backends register at import time — "
            "import the package that provides this engine") from None


def backend_for(engine) -> Backend:
    return get_backend(getattr(engine, "plan_backend", "local"))


# ---------------------------------------------------------------------------
# emit context + walker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EmitContext:
    """Mutable execution state of one flush window's emit stage."""
    scheduler: object = None
    engine: object = None
    results: Dict = dataclasses.field(default_factory=dict)
    stats: Dict = dataclasses.field(default_factory=dict)
    # RMW end-of-window threading: table_id -> current table state
    tables: Dict = dataclasses.field(default_factory=dict)
    rmw_members: Dict = dataclasses.field(default_factory=dict)
    failed_tables: Dict = dataclasses.field(default_factory=dict)
    group_reports: list = dataclasses.field(default_factory=list)
    # scheduler-provided factories (keeps this module core-type free)
    make_failed: Callable = None           # Exception -> FailedResult
    make_group_error: Callable = None      # (node, Exception) -> report


def execute(plan: nodes.Plan, ctx: EmitContext, backend: Backend):
    """Emit every root node; resolve RMW tickets to end-of-window
    state. Per-node failures isolate (see module docstring)."""
    for node in plan.roots:
        inner = nodes.unwrap(node)
        err = getattr(inner, "error", None)
        if err is not None:
            # lowering already failed this node (malformed submission):
            # resolve its tickets without executing anything
            _fail_node(node, inner, err, ctx)
            continue
        fn = backend.emitters.get((inner.kind, inner.backend))
        if fn is None:
            _fail_node(node, inner, KeyError(
                f"no emitter for ({inner.kind!r}, {inner.backend!r}) "
                f"in backend {backend.name!r}"), ctx)
            continue
        try:
            fn(node, ctx)
        except Exception as e:          # per-node error isolation
            _fail_node(node, inner, e, ctx)

    # RMW tickets resolve to the table's state after EVERY fused update
    # that touched it; a failed update poisons the whole table's window.
    for table_id, members in ctx.rmw_members.items():
        err = ctx.failed_tables.get(table_id)
        out = ctx.make_failed(err) if err is not None \
            else ctx.tables[table_id]
        for m in members:
            ctx.results.setdefault(m.ticket.tid, out)
    plan.executed = True
    return ctx


def _fail_node(node, inner, e: Exception, ctx: EmitContext):
    ctx.stats["group_errors"] = ctx.stats.get("group_errors", 0) + 1
    failed = ctx.make_failed(e)
    for t in inner.tickets():
        # keep results of members that did retire (fallback path)
        ctx.results.setdefault(t.tid, failed)
    if inner.kind == "program_group" and ctx.make_group_error is not None:
        ctx.group_reports.append(ctx.make_group_error(inner, e))
    elif inner.kind == "rmw":
        ctx.failed_tables.setdefault(inner.table_id, e)

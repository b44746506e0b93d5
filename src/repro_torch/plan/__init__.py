"""repro_torch.plan — the AccessPlan IR and its lowering pipeline.

``Scheduler.flush`` and the decoupled pipeline lower one flush window
through the same deterministic pass pipeline

    normalize -> group -> fuse -> coalesce -> shard -> batch -> emit

over a typed plan tree (``nodes``), with backend selection made by a
small cost model (``cost``) and execution dispatched through registered
per-backend emitters (``emit``). ``explain`` renders any lowered plan with
per-pass deltas; the plan a pre-flush ``Scheduler.explain()`` reports is
exactly the plan the flush executes (node ids round-trip into the
``FlushReport``).

This package imports nothing from ``repro_torch.core`` at module scope:
core registers the "local" backend here, ``repro_torch.distributed``
registers "sharded", and the registry — not duck-typing — routes every
window.
"""
from repro_torch.plan import cost, emit, nodes, passes
from repro_torch.plan.cost import CostModel, ExchangePlan
from repro_torch.plan.emit import (Backend, EmitContext, backend_for,
                                   execute, get_backend, register_backend)
from repro_torch.plan.explain import Explanation
from repro_torch.plan.explain import explain as explain_plan
from repro_torch.plan.nodes import (BatchedGroup, FusedGather, FusedRmw,
                                    GatherNode, PassDelta, Plan, PlanNode,
                                    ProgramNode, RmwNode, ShardedNode, unwrap)
from repro_torch.plan.passes import (PIPELINE, LowerContext, Skeleton, lower,
                                     skeleton_of, window_signature)

# ``plan.explain(flush)`` is the documented spelling: the package
# attribute is the function (the module itself stays importable as
# ``repro_torch.plan.explain`` through sys.modules).
explain = explain_plan

__all__ = [
    "cost", "emit", "explain", "nodes", "passes",
    "CostModel", "ExchangePlan", "Backend", "EmitContext", "backend_for",
    "execute",
    "get_backend", "register_backend", "Explanation", "explain_plan",
    "BatchedGroup", "FusedGather", "FusedRmw", "GatherNode", "PassDelta",
    "Plan", "PlanNode", "ProgramNode", "RmwNode", "ShardedNode", "unwrap",
    "PIPELINE", "LowerContext", "Skeleton", "lower", "skeleton_of",
    "window_signature",
]

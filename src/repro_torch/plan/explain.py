"""``explain()``: render a lowered plan — the runtime's answer to the
paper's MLIR pass dump (§4.2). Shows, per pass, what the lowering did
(node deltas, coalescing decisions, backend picks, compile-cache state)
and, per node, the tree that will be — or was — executed. The plan an
explanation reports is *exactly* the plan the flush executes: the
scheduler caches the lowering, and node ids round-trip into the
``FlushReport``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.plan import nodes


def explain(obj, *, diagnostics: bool = True) -> "Explanation":
    """Explanation for a ``Plan``, ``FlushReport`` (``.plan``), or
    ``FlushHandle`` (``.report.plan``). ``diagnostics=False`` omits the
    window hazard section from ``render()``."""
    plan = obj
    if hasattr(plan, "report"):            # FlushHandle
        plan = plan.report
    if hasattr(plan, "plan"):              # FlushReport
        plan = plan.plan
    if not isinstance(plan, nodes.Plan):
        raise TypeError(f"cannot explain {type(obj).__name__}: expected "
                        "a Plan, FlushReport or FlushHandle")
    return Explanation(plan, show_diagnostics=diagnostics)


def _leaf_line(leaf: nodes.PlanNode) -> str:
    t = leaf.ticket
    who = f"tid={t.tid} tenant={t.tenant}"
    if isinstance(leaf, nodes.ProgramNode):
        return f"program#{leaf.nid} {who} prog={leaf.program.name}"
    if isinstance(leaf, nodes.GatherNode):
        return (f"gather_leaf#{leaf.nid} {who} lanes={leaf.n_lanes} "
                f"rows={leaf.table_rows}")
    return (f"rmw_leaf#{leaf.nid} {who} op={leaf.op} "
            f"lanes={leaf.n_lanes} rows={leaf.table_rows}")


def _root_lines(root: nodes.PlanNode) -> list:
    lines = []
    mesh = ""
    if isinstance(root, nodes.ShardedNode):
        lf = ("?" if root.est_local_fraction is None
              else f"{root.est_local_fraction:.2f}")
        mesh = (f" mesh={root.num_shards} (sharded#{root.nid} "
                f"place={root.placement} codec={root.codec} local~{lf})")
        root = root.inner
    if isinstance(root, nodes.BatchedGroup):
        lines.append(
            f"program_group#{root.nid} backend={root.backend} "
            f"n={len(root.members)} wave={root.wave} "
            f"shared={sorted(root.shared) if root.shared else '[]'} "
            f"trace={'cached' if root.cache_hit else 'cold'}{mesh}")
    elif isinstance(root, nodes.FusedGather):
        est = "?" if root.est_factor is None else f"{root.est_factor:.2f}"
        lines.append(
            f"gather#{root.nid} backend={root.backend} "
            f"lanes={root.n_lanes} streams={len(root.members)} "
            f"rows={root.table_rows} factor~{est}{mesh}")
    elif isinstance(root, nodes.FusedRmw):
        lines.append(
            f"rmw#{root.nid} backend={root.backend} op={root.op} "
            f"lanes={root.n_lanes} streams={len(root.members)} "
            f"rows={root.table_rows}{mesh}")
    err = getattr(root, "error", None)
    if err is not None and lines:
        lines[0] += f" ERROR={type(err).__name__}"
    for m in getattr(root, "members", ()):
        lines.append("  " + _leaf_line(m))
    return lines


@dataclasses.dataclass
class Explanation:
    """Renderable view of one lowered flush window."""
    plan: nodes.Plan
    show_diagnostics: bool = True

    @property
    def passes(self):
        return self.plan.trace

    @property
    def node_ids(self) -> tuple:
        return self.plan.node_ids()

    @property
    def diagnostics(self) -> tuple:
        return tuple(self.plan.diagnostics)

    def render(self, diagnostics: bool = None) -> str:
        p = self.plan
        c = p.counts()
        head = (f"AccessPlan[backend={p.backend} "
                f"plan-cache={'hit' if p.cache_hit else 'miss'} "
                f"executed={'yes' if p.executed else 'no'}]")
        lines = [head,
                 f"window: {c['programs']} programs, {c['gathers']} "
                 f"gathers, {c['rmws']} rmws "
                 f"({len(p.roots)} plan roots)"]
        for d in p.trace:
            lines.append(f"pass {d.name}: {d.nodes_before} -> "
                         f"{d.nodes_after} nodes")
            for note in d.notes:
                lines.append(f"  | {note}")
        lines.append("plan:")
        for root in p.roots:
            lines.extend("  " + ln for ln in _root_lines(root))
        show = self.show_diagnostics if diagnostics is None else diagnostics
        if show and p.diagnostics:
            lines.append("diagnostics:")
            for d in p.diagnostics:
                lines.append("  " + d.render())
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()

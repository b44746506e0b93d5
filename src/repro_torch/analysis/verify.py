"""Inter-pass structural verifier for the AccessPlan IR.

Run under ``LowerContext(verify=True)`` after every pass of
``normalize -> group -> fuse -> coalesce -> shard -> batch``. Each pass
is a pure rewrite, so each has a crisp contract; the verifier asserts
the cumulative invariants that must hold from a given stage onward:

  always      node ids unique across the plan; leaf tickets unique and
              exactly the fair-order multiset; leaf nids assigned
  group+      every program leaf belongs to exactly one BatchedGroup
  fuse+       every gather/rmw leaf belongs to exactly one fused node
              (error leaves ride their own single-member error node);
              non-error fused nodes share one table and their n_lanes
              is the member sum; roots now cover every ticket once
  coalesce+   coalesced gathers carry one inverse per member, each the
              member's lane count, and a pad mask matching unique_idx
  shard+      backends legal per node kind; error nodes stay unplaced;
              ShardedNode wraps a fused node marked "sharded"
  batch       group waves are ≤ max_batch, sequential per key, with a
              concrete "vmap"/"eager" backend

All checks are shape-only: they read static metadata (``shape[0]``,
lengths, ids) and never read a tensor's values (that would copy from the
device and synchronise with it).
A violation raises ``VerificationError`` naming the stage and every
broken invariant; the scheduler's flush path converts that into a failed
window, never a crashed scheduler.

Cost discipline: the verifier rides every lowering when
``DX100_PLAN_VERIFY`` is set, so the six calls per window must stay cheap
beside a flush. Two levers keep it there:

  * the "always" facts (leaf ticket multiset == fair order, leaf nids
    assigned) are derived once per lowering and cached on the
    ``LowerContext``; the cache is keyed by the identity of
    ``plan.leaves``/``plan.order``, so any pass that *replaces* either
    tuple forces a recompute, and the final ``batch`` stage always
    re-runs the full derivation so an in-place mutation smuggled past
    the cache is still caught before emit. On cached intermediate
    calls only the block the pass just established runs; standalone
    calls (``ctx=None`` — the test path) never cache and always check
    cumulatively.
  * the clean path compares lengths and sets; ``Counter`` multisets
    are built only on the failure path, to name what went missing.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.plan import nodes

STAGE_INDEX = {"normalize": 0, "group": 1, "fuse": 2,
               "coalesce": 3, "shard": 4, "batch": 5}


class VerificationError(AssertionError):
    """A lowering pass broke a plan-IR structural invariant."""

    def __init__(self, stage: str, problems):
        self.stage = stage
        self.problems = tuple(problems)
        super().__init__(
            f"plan verification failed after pass {stage!r}: "
            + "; ".join(self.problems))


def _ticket_key(t):
    return (t.tenant, t.tid)


class _LeafFacts:
    """Once-per-lowering derivation of the leaf-side invariants.

    Valid for a plan only while the *same* ``leaves``/``order`` tuples
    flow through the passes — checked by identity in ``check_pass``.
    """

    __slots__ = ("leaves_id", "order_id", "keys", "key_set",
                 "want_keys", "want_counts")

    def __init__(self, plan, problems):
        self.leaves_id = id(plan.leaves)
        self.order_id = id(plan.order)
        keys = [_ticket_key(t)
                for leaf in plan.leaves for t in leaf.tickets()]
        self.keys = keys
        self.key_set = frozenset(keys)
        if len(self.key_set) != len(keys):
            dup = [k for k, c in Counter(keys).items() if c > 1]
            problems.append(f"duplicate leaf tickets {sorted(dup)}")
        if len(plan.order) != len(keys) or \
                self.key_set.symmetric_difference(plan.order):
            problems.append(
                f"fair order carries {len(plan.order)} tickets but "
                f"leaves carry {len(keys)} (sets differ)")
        if any(leaf.nid < 0 for leaf in plan.leaves):
            problems.append(
                "leaf without an assigned nid (normalize skipped?)")
        # per-kind ticket coverage targets for the partition checks
        self.want_keys: dict = {}
        self.want_counts: dict = {}
        for leaf in plan.leaves:
            self.want_keys.setdefault(leaf.kind, set()).add(
                _ticket_key(leaf.ticket))
            self.want_counts[leaf.kind] = \
                self.want_counts.get(leaf.kind, 0) + 1


def check_pass(plan: nodes.Plan, stage: str, ctx) -> None:
    """Assert the invariants that hold after ``stage``; raise
    ``VerificationError`` listing every violation otherwise."""
    idx = STAGE_INDEX.get(stage)
    if idx is None:
        raise VerificationError(stage, [f"unknown pass {stage!r}"])
    problems: list = []

    # leaf facts: cached on the LowerContext across the six in-pipeline
    # calls (leaves/order are carried by identity through the passes);
    # re-derived for standalone calls and always at the final stage.
    # ``cumulative`` marks the full-recheck calls: on those, every block
    # up to ``stage`` runs; on cached intermediate calls only the block
    # the pass just established runs (the earlier ones were checked at
    # their own stage and are re-checked at batch before emit).
    facts = getattr(ctx, "_verify_facts", None) if ctx is not None else None
    cumulative = facts is None or stage == "batch" or \
        facts.leaves_id != id(plan.leaves) or \
        facts.order_id != id(plan.order)
    if cumulative:
        facts = _LeafFacts(plan, problems)
        if ctx is not None:
            ctx._verify_facts = facts

    # -- always: node ids --------------------------------------------------
    if cumulative:
        nids = [n.nid for n in plan.nodes()]
        if len(set(nids)) != len(nids):
            dup_nids = [n for n, c in Counter(nids).items() if c > 1]
            problems.append(f"duplicate node ids {sorted(dup_nids)}")

    def covered_once(kind: str, member_keys, what: str):
        want_set = facts.want_keys.get(kind, frozenset())
        if len(member_keys) == facts.want_counts.get(kind, 0) and \
                not want_set.symmetric_difference(member_keys):
            return
        want = Counter(want_set)
        got = Counter(member_keys)
        missing = sorted((want - got).keys())
        extra = sorted((got - want).keys())
        problems.append(
            f"{what} do not partition the {kind} leaves "
            f"(missing={missing[:4]}, duplicated/extra={extra[:4]})")

    unwrapped = [r.inner if r.kind == "sharded" else r for r in plan.roots]

    # -- group+: program coverage ------------------------------------------
    if idx >= 1 and (cumulative or idx == 1):
        covered_once("program",
                     [_ticket_key(m.ticket)
                      for g in unwrapped if g.kind == "program_group"
                      for m in g.members],
                     "BatchedGroup members")

    # -- fuse+: gather/rmw coverage and fused-node consistency -------------
    if idx >= 2 and (cumulative or idx == 2):
        fused = [n for n in unwrapped if n.kind in ("gather", "rmw")]
        covered_once("gather_leaf",
                     [_ticket_key(m.ticket)
                      for n in fused if n.kind == "gather"
                      for m in n.members],
                     "FusedGather members")
        covered_once("rmw_leaf",
                     [_ticket_key(m.ticket)
                      for n in fused if n.kind == "rmw"
                      for m in n.members],
                     "FusedRmw members")
        for n in fused:
            if n.error is not None:
                continue
            if any(m.table_id != n.table_id for m in n.members):
                problems.append(
                    f"{n.kind}#{n.nid} fuses members of different tables")
            member_lanes = sum(m.n_lanes for m in n.members)
            if n.n_lanes != member_lanes:
                problems.append(
                    f"{n.kind}#{n.nid} n_lanes={n.n_lanes} != member sum "
                    f"{member_lanes}")
            if n.kind == "rmw" and any(m.op != n.op for m in n.members):
                problems.append(
                    f"rmw#{n.nid} fuses members of different ops")
        # from fuse on, the roots retire every ticket exactly once
        root_keys = [_ticket_key(t)
                     for r in plan.roots for t in r.tickets()]
        if len(root_keys) != len(facts.keys) or \
                facts.key_set.symmetric_difference(root_keys):
            leaf_tickets = Counter(facts.keys)
            root_tickets = Counter(root_keys)
            missing = sorted((leaf_tickets - root_tickets).keys())
            extra = sorted((root_tickets - leaf_tickets).keys())
            problems.append(
                f"roots do not retire the leaf tickets exactly once "
                f"(missing={missing[:4]}, duplicated={extra[:4]})")

    # -- coalesce+: dedup artifacts ----------------------------------------
    if idx >= 3 and (cumulative or idx == 3):
        for n in unwrapped:
            if n.kind != "gather" or n.error is not None:
                continue
            if idx == 3 and n.backend not in ("", "eager"):
                problems.append(
                    f"gather#{n.nid} backend {n.backend!r} set before the "
                    f"shard pass")
            if n.unique_idx is None:
                continue
            if len(n.inverses) != len(n.members):
                problems.append(
                    f"gather#{n.nid} carries {len(n.inverses)} inverses "
                    f"for {len(n.members)} members")
            for m, inv in zip(n.members, n.inverses):
                got = getattr(inv, "shape", (None,))[0]
                if got != m.n_lanes:
                    problems.append(
                        f"gather#{n.nid} inverse length {got} != member "
                        f"lane count {m.n_lanes}")
            ushape = getattr(n.unique_idx, "shape", (None,))[0]
            pshape = getattr(n.pad_valid, "shape", (None,))[0]
            if pshape != ushape:
                problems.append(
                    f"gather#{n.nid} pad_valid length {pshape} != "
                    f"unique_idx length {ushape}")

    # -- shard+: backend legality and mesh wrappers ------------------------
    if idx >= 4 and (cumulative or idx == 4):
        for r, n in zip(plan.roots, unwrapped):
            if r.kind == "sharded":
                if n.kind not in ("gather", "rmw"):
                    problems.append(
                        f"sharded#{r.nid} wraps non-fused {n.kind} node")
                elif n.backend != "sharded":
                    problems.append(
                        f"sharded#{r.nid} wraps {n.kind}#{n.nid} with "
                        f"backend {n.backend!r}")
                if r.num_shards < 1:
                    problems.append(
                        f"sharded#{r.nid} num_shards={r.num_shards}")
            if getattr(n, "error", None) is not None:
                if n.backend != "":
                    problems.append(
                        f"error node {n.kind}#{n.nid} was placed "
                        f"(backend={n.backend!r})")
                continue
            if n.kind == "gather" and \
                    n.backend not in ("eager", "bulk", "sharded"):
                problems.append(
                    f"gather#{n.nid} illegal backend {n.backend!r}")
            if n.kind == "rmw" and n.backend not in ("bulk", "sharded"):
                problems.append(
                    f"rmw#{n.nid} illegal backend {n.backend!r}")

    # -- batch: wave structure ---------------------------------------------
    if idx >= 5:
        waves: dict = {}
        max_batch = getattr(ctx, "max_batch", None)
        for n in unwrapped:
            if n.kind != "program_group":
                continue
            if n.backend not in ("vmap", "eager"):
                problems.append(
                    f"group#{n.nid} illegal backend {n.backend!r}")
            if max_batch and len(n.members) > max_batch:
                problems.append(
                    f"group#{n.nid} has {len(n.members)} members > "
                    f"max_batch {max_batch}")
            waves.setdefault(n.key, []).append(n.wave)
        for key, ws in waves.items():
            if sorted(ws) != list(range(len(ws))):
                problems.append(
                    f"group key {key!r} waves {sorted(ws)} not "
                    f"sequential from 0")

    if problems:
        raise VerificationError(stage, problems)

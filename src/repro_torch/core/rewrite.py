"""Query rewriting (paper §4.4).

Each input query that consumes a selected CE gets its shared sub-tree
replaced by an *extraction plan*: the CachedRelation leaf plus, when the
SE members were merely similar (not syntactically equal), the member's
own filter predicates / projection columns re-applied on the cached
covering relation.  Extraction-plan construction is plan-type specific
and is delegated to a :class:`Rewriter`.

Selected CE trees themselves become *cache plans* (the covering tree
with a terminal Cache operator).  Cache plans are optionally chained:
a larger selected CE whose tree contains a smaller selected CE will
itself read from the smaller one's cached output.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Protocol, Sequence

from .covering import CoveringExpression
from .plan import PlanNode, tree_size


class Rewriter(Protocol):
    def make_cache_plan(self, ce: CoveringExpression) -> PlanNode:
        """Wrap the covering tree so its output is materialized in RAM."""
        ...

    def make_extraction(self, ce: CoveringExpression, member: PlanNode) -> PlanNode:
        """Plan producing ``member``'s output from the cached CE output."""
        ...

    # Optional: concrete rewriters may also provide
    #   cache_key(ce) -> bytes
    # the runtime cache identity of a CE's materialized output.  The
    # default is the loose structural psi; the relational rewriter uses
    # the STRICT content fingerprint so same-structure CEs with
    # different merged predicates (recurring micro-batch windows over a
    # template family) can stay resident side by side.


@dataclass
class RewrittenBatch:
    plans: List[PlanNode]                   # rewritten input set
    cache_plans: Dict[bytes, PlanNode]      # psi -> cache plan
    ces: List[CoveringExpression]
    stats: dict = field(default_factory=dict)


def _replace_nodes(root: PlanNode, repl: Dict[int, PlanNode]) -> PlanNode:
    """Rebuild ``root`` with node-identity replacements applied."""
    if id(root) in repl:
        return repl[id(root)]
    if not root.children:
        return root
    new_children = tuple(_replace_nodes(c, repl) for c in root.children)
    if all(nc is c for nc, c in zip(new_children, root.children)):
        return root
    return root.with_children(new_children)


def rewrite_batch(
    plans: Sequence[PlanNode],
    selected: Sequence[CoveringExpression],
    rewriter: Rewriter,
    *,
    chain_cache_plans: bool = True,
) -> RewrittenBatch:
    # Build per-plan replacement maps: occurrence node -> extraction plan.
    repl: Dict[int, PlanNode] = {}
    for ce in selected:
        for occ in ce.se.occurrences:
            repl[id(occ.node)] = rewriter.make_extraction(ce, occ.node)

    new_plans = [_replace_nodes(p, repl) for p in plans]

    # Cache plans; larger CEs may consume smaller selected CEs' caches.
    # Keys come from the rewriter's cache identity (loose psi by
    # default; see Rewriter.cache_key) and must be computed on the
    # ORIGINAL covering tree, before any chaining substitution below.
    key_fn = getattr(rewriter, "cache_key", None) or (lambda ce: ce.psi)
    cache_plans: Dict[bytes, PlanNode] = {}
    ordered = sorted(selected, key=lambda ce: tree_size(ce.tree))
    built: List[CoveringExpression] = []
    for ce in ordered:
        cache_key = key_fn(ce)
        tree = ce.tree
        if chain_cache_plans and built:
            from .fingerprint import all_fingerprints

            fps = all_fingerprints(tree)
            inner_repl: Dict[int, PlanNode] = {}
            for node_id_, fp in fps.items():
                for small in built:
                    if fp == small.psi and node_id_ != id(tree):
                        # locate the node instance by id within the tree
                        node = _find_by_id(tree, node_id_)
                        if node is not None:
                            inner_repl[node_id_] = rewriter.make_extraction(
                                small, node)
            if inner_repl:
                tree = _replace_nodes(tree, inner_repl)
        cache_plans[cache_key] = rewriter.make_cache_plan(
            ce if tree is ce.tree else _with_tree(ce, tree))
        built.append(ce)

    return RewrittenBatch(
        plans=new_plans,
        cache_plans=cache_plans,
        ces=list(selected),
        stats={"n_rewritten_occurrences": len(repl)},
    )


def attach_recompute_plan(batch: RewrittenBatch, cache_key: bytes,
                          plan: PlanNode) -> None:
    """Register a cache plan built OUTSIDE this batch's CE selection —
    e.g. a subsumption-resumed query reading a CE retained by an
    *earlier* window: the entry lets the executor recompute that CE
    from its covering tree if the hierarchy evicts it mid-window,
    instead of failing the consumer.  Never overwrites a plan this
    batch selected itself (an intra-window plan is already
    chain-consistent)."""
    batch.cache_plans.setdefault(cache_key, plan)


def _find_by_id(root: PlanNode, node_id_: int) -> PlanNode | None:
    from .plan import walk

    for n in walk(root):
        if id(n) == node_id_:
            return n
    return None


def _with_tree(ce: CoveringExpression, tree: PlanNode) -> CoveringExpression:
    clone = CoveringExpression(se=ce.se, tree=tree, psi=ce.psi)
    clone.value, clone.weight, clone.est_rows = ce.value, ce.weight, ce.est_rows
    clone.cost_detail = ce.cost_detail
    # the chained tree computes the SAME relation (inner CachedScan
    # substitutions are output-preserving), so it keeps the original
    # tree's content identity — recomputing it on the substituted tree
    # would diverge from the consumers' cache keys
    clone._strict_psi = ce.strict_psi()
    return clone

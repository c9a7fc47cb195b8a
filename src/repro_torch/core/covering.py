"""Covering-expression construction (paper §4.2, Definition 4).

Given an SE ω = {τ_1 … τ_m} (sub-trees with identical fingerprints,
hence identical operator structure), build the covering sub-tree
τ* = f(ω): walk the members in lock-step and merge node-by-node.
Loose operators merge their attributes (OR of filter predicates, union
of projection columns — delegated to ``node.merge``); strict operators
are syntactically equal by construction and are copied.

The resulting τ* has the same fingerprint as every member (checked),
and every member's output can be derived from τ*'s output by a cheap
extraction plan (per-member filter/project re-applied).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .fingerprint import Fingerprint, fingerprint, fingerprint_set
from .identify import SimilarSubexpression
from .plan import PlanNode


@dataclass
class CoveringExpression:
    """A CE Ω = f(ω): the sharing plan whose output gets cached."""

    se: SimilarSubexpression
    tree: PlanNode                      # covering sub-tree τ*
    psi: Fingerprint                    # == se.psi
    # Filled in by the cost model (repro_torch.core.costmodel.price_ce):
    value: float = 0.0                  # v(Ω) = C(ω) − C(Ω), Eq. 3
    weight: int = 0                     # w(Ω) = |Ω| in bytes
    est_rows: int = 0                   # estimated output cardinality
    cost_detail: dict = field(default_factory=dict)
    # memoized strict content fingerprint of the covering tree (filled
    # lazily by strict_psi(); cross-batch retention identity)
    _strict_psi: Optional[Fingerprint] = None
    # Partition-grained admission (see repro_torch.relational.partition): a
    # plan-type-specific partitioner may split this CE into independent
    # per-partition MCKP items; the solver then fills the subset it
    # admitted.  None for unpartitioned CEs.
    partition_detail: Optional[object] = None    # (plan record, slices)
    admitted_partitions: Optional[frozenset] = None

    def strict_psi(self) -> Fingerprint:
        if self._strict_psi is None:
            from .fingerprint import strict_fingerprint

            self._strict_psi = strict_fingerprint(self.tree)
        return self._strict_psi

    @property
    def m(self) -> int:
        return self.se.m

    @property
    def fp_set(self) -> frozenset:
        return fingerprint_set(self.tree)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"CE({self.tree.label}, m={self.m}, v={self.value:.3g}, "
                f"w={self.weight})")


def _merge_trees(members: Sequence[PlanNode]) -> PlanNode:
    """Lock-step structural merge of fingerprint-identical sub-trees."""
    first = members[0]
    n_children = len(first.children)
    if any(len(m.children) != n_children for m in members[1:]):
        raise ValueError("SE members disagree on arity — fingerprint bug")
    if n_children == 0:
        return first.merge(members[1:])
    # NOTE on commutative binaries: members share a fingerprint computed
    # with sorted child fingerprints, so lock-step children may be
    # swapped between members.  Align children by fingerprint first.
    if n_children == 2 and first.commutative:
        ref = [fingerprint(c) for c in first.children]
        aligned: List[List[PlanNode]] = [list(first.children)]
        for m in members[1:]:
            fps = [fingerprint(c) for c in m.children]
            if fps == ref:
                aligned.append(list(m.children))
            elif fps == ref[::-1]:
                aligned.append(list(m.children[::-1]))
            else:
                # identical sorted multiset but ambiguous (fp0 == fp1)
                aligned.append(list(m.children))
        merged_children = tuple(
            _merge_trees([a[i] for a in aligned]) for i in range(2)
        )
    else:
        merged_children = tuple(
            _merge_trees([m.children[i] for m in members])
            for i in range(n_children)
        )
    return first.merge(members[1:]).with_children(merged_children)


def build_covering_expression(se: SimilarSubexpression) -> CoveringExpression:
    members = [o.node for o in se.occurrences]
    tree = _merge_trees(members)
    psi = fingerprint(tree)
    if psi != se.psi:
        raise AssertionError(
            "covering tree fingerprint differs from SE fingerprint — "
            "merge must preserve loose/strict identity")
    return CoveringExpression(se=se, tree=tree, psi=psi)


def build_covering_expressions(
    ses: Sequence[SimilarSubexpression],
) -> List[CoveringExpression]:
    return [build_covering_expression(se) for se in ses]

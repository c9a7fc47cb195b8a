"""Similar-subexpression identification (paper §4.1, Algorithm 1).

Top-down exploration of each input plan.  A sub-tree is recorded in the
fingerprint table only when its root is cache-friendly; exploration
descends into children only when the root is cache-unfriendly OR the
sub-tree still contains a cache-unfriendly operator somewhere below —
i.e. the lookup stops "as early and as high as possible", preferring a
small number of large (high-in-the-plan) SE candidates with small
expected memory footprints.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .fingerprint import Fingerprint, fingerprint
from .plan import PlanNode, contains_unfriendly


@dataclass(frozen=True)
class Occurrence:
    """One sub-tree occurrence of an SE inside an input plan."""

    query_index: int      # which plan of the input set
    node: PlanNode        # the sub-tree root (identity matters for rewriting)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Occurrence(q={self.query_index}, {self.node.label})"


@dataclass
class SimilarSubexpression:
    """An SE ω = set of sub-trees sharing fingerprint ψ (Definition 3)."""

    psi: Fingerprint
    occurrences: List[Occurrence] = field(default_factory=list)

    @property
    def m(self) -> int:
        """Number of consumer sub-trees (paper's m in Eq. 2)."""
        return len(self.occurrences)

    @property
    def query_indices(self) -> frozenset:
        return frozenset(o.query_index for o in self.occurrences)


def identify_similar_subexpressions(
    plans: Sequence[PlanNode],
    k: int = 2,
    *,
    require_distinct_queries: bool = False,
) -> List[SimilarSubexpression]:
    """Algorithm 1: IdentifySEs.

    Args:
      plans: the input set of (locally optimized) logical plans.
      k: keep only SEs with at least ``k`` member sub-trees.
      require_distinct_queries: additionally require members from >=2
        distinct queries (an SE repeated inside a single query still
        offers sharing, so this defaults to False, matching the paper's
        ``|FT.GetValue(ψ)| ≥ k`` test).

    Returns:
      The list of SEs, ordered by (tree height of first member desc,
      member count desc) for deterministic downstream processing.
    """
    table: Dict[Fingerprint, SimilarSubexpression] = {}
    memo: Dict[int, Fingerprint] = {}

    for qi, root in enumerate(plans):
        to_visit: List[PlanNode] = [root]
        while to_visit:
            cur = to_visit.pop()
            psi = fingerprint(cur, memo)
            friendly = cur.cache_friendly
            if friendly:
                se = table.get(psi)
                if se is None:
                    se = table[psi] = SimilarSubexpression(psi=psi)
                se.occurrences.append(Occurrence(qi, cur))
            if (not friendly) or contains_unfriendly(cur):
                to_visit.extend(cur.children)

    out: List[SimilarSubexpression] = []
    for se in table.values():
        if se.m < k:
            continue
        if require_distinct_queries and len(se.query_indices) < 2:
            continue
        # Leaf-only SEs (bare scans) are kept: sharing a scan is the
        # paper's "simple approach" baseline and is still a valid CE.
        out.append(se)

    from .plan import tree_size

    out.sort(key=lambda s: (-tree_size(s.occurrences[0].node), -s.m,
                            s.psi))
    return out

"""Knapsack-candidate generation (paper §4.2, Algorithm 2).

Nested CEs cannot be priced independently (value/weight are only
additive for *disjoint* CEs), so the optimizer is fed **groups of
mutually-exclusive options**: for each maximal CE, the group holds the
CE itself, each of its descendant CEs, and every compound of pairwise
disjoint descendants.  The MCKP then picks at most one option per
group.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import List, Sequence, Tuple

from .covering import CoveringExpression
from .plan import tree_size


@dataclass(frozen=True)
class KnapsackItem:
    """One selectable option: a single CE or a compound of disjoint CEs."""

    ces: Tuple[CoveringExpression, ...]
    group: int

    @property
    def value(self) -> float:
        return sum(ce.value for ce in self.ces)

    @property
    def weight(self) -> int:
        return sum(ce.weight for ce in self.ces)

    def __repr__(self) -> str:  # pragma: no cover
        labels = ",".join(ce.tree.label for ce in self.ces)
        return f"Item(g={self.group}, [{labels}], v={self.value:.3g}, w={self.weight})"


@dataclass(frozen=True)
class PartitionKnapsackItem:
    """One PARTITION of a partition-grained CE as its own knapsack
    option (its own group — partitions of a CE are independently
    admissible, which is what lets the solver keep the hot fraction of
    a CE when the whole CE does not fit).  Duck-types KnapsackItem for
    the solver: value/weight are the partition's slice prices, ``ces``
    exposes the parent CE for MCKPSolution bookkeeping."""

    ce: CoveringExpression
    pid: int
    value: float
    weight: int
    group: int

    @property
    def ces(self) -> Tuple[CoveringExpression, ...]:
        return (self.ce,)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PartItem(g={self.group}, {self.ce.tree.label}#p{self.pid}, "
                f"v={self.value:.3g}, w={self.weight})")


def _is_descendant(child: CoveringExpression, parent: CoveringExpression) -> bool:
    """child ⊂ parent: child's fingerprint appears as a proper sub-tree
    fingerprint of the parent's covering tree."""
    if child is parent:
        return False
    sub_fps = parent.fp_set
    return child.psi in sub_fps and child.psi != parent.psi


def _disjoint(a: CoveringExpression, b: CoveringExpression) -> bool:
    """No common sub-trees (paper: compounds must be of disjoint CEs so
    that value and weight stay additive)."""
    return not (a.fp_set & b.fp_set)


def generate_knapsack_items(
    ces: Sequence[CoveringExpression],
    *,
    max_compound_size: int = 4,
    max_options_per_group: int = 64,
) -> List[KnapsackItem]:
    """Algorithm 2: GenerateKPItems.

    ``max_compound_size`` / ``max_options_per_group`` bound the
    combinatorial expansion of compounds (the paper's DescSets are small;
    these caps only matter for adversarial inputs).
    """
    remaining: List[CoveringExpression] = sorted(
        ces, key=lambda ce: (tree_size(ce.tree), ce.weight, ce.psi))
    items: List[KnapsackItem] = []
    group = 0

    while remaining:
        top = remaining.pop()  # PopLargest
        desc = [ce for ce in remaining if _is_descendant(ce, top)]
        options: List[Tuple[CoveringExpression, ...]] = [(top,)]
        options.extend((d,) for d in desc)
        # Compounds of pairwise disjoint descendants.
        for size in range(2, min(max_compound_size, len(desc)) + 1):
            for combo in combinations(desc, size):
                if all(_disjoint(a, b) for a, b in combinations(combo, 2)):
                    options.append(tuple(combo))
                if len(options) >= max_options_per_group:
                    break
            if len(options) >= max_options_per_group:
                break
        for opt in options:
            item = KnapsackItem(ces=opt, group=group)
            # Options that can never help the objective are dropped here
            # (selecting nothing from a group is always allowed).
            if item.value > 0:
                items.append(item)
        for d in desc:
            remaining.remove(d)
        group += 1

    return items

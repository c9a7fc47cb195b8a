"""Abstract plan-node protocol shared by every MQO instantiation.

The paper's MQO machinery (fingerprints, SE identification, covering
expressions, cost model, MCKP, rewriting) is generic over the *kind* of
plan being optimized.  Two instantiations live in this repo:

  * ``repro_torch.relational`` — SparkSQL-analog logical plans (the faithful
    reproduction of the paper), and
  * ``repro_torch.serving``    — token-block prefix plans for LLM serving
    (the beyond-paper integration).

A plan node is an immutable tree.  Every node exposes:

  ``children``        tuple of child nodes (0 = leaf, 1 = unary, 2 = binary)
  ``label``           operator label (string).  For leaves the label must
                      identify the input relation (e.g. ``scan:employees``).
  ``loose``           True for operators fingerprinted by label only
                      (paper Def. 1: filter / project / input relation);
                      False for strict operators (label + attributes).
  ``strict_attrs``    hashable canonical attributes, used when ``loose``
                      is False.
  ``cache_friendly``  False for join / cartesian / union — the paper's
                      "cache unfriendly" operators (§4.1).
  ``commutative``     True when child order must not affect the
                      fingerprint (isomorphism property, Def. 2 remark).
  ``merge(others)``   build the covering node for this node merged with
                      the structurally-identical nodes of other SE members
                      (OR of predicates, union of projections, identity
                      for strict operators).
"""
from __future__ import annotations

from typing import Iterator, Protocol, Sequence, runtime_checkable


@runtime_checkable
class PlanNode(Protocol):
    @property
    def children(self) -> tuple["PlanNode", ...]: ...

    @property
    def label(self) -> str: ...

    @property
    def loose(self) -> bool: ...

    @property
    def strict_attrs(self) -> object: ...

    @property
    def cache_friendly(self) -> bool: ...

    @property
    def commutative(self) -> bool: ...

    def merge(self, others: Sequence["PlanNode"]) -> "PlanNode": ...

    def with_children(self, children: tuple["PlanNode", ...]) -> "PlanNode": ...


def walk(node: PlanNode) -> Iterator[PlanNode]:
    """Pre-order traversal of a plan tree."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        stack.extend(reversed(cur.children))


def tree_size(node: PlanNode) -> int:
    """Number of operators in the sub-tree rooted at ``node``."""
    return sum(1 for _ in walk(node))


def contains_unfriendly(node: PlanNode) -> bool:
    """True when any descendant (or the node itself) is cache-unfriendly."""
    return any(not n.cache_friendly for n in walk(node))


def tree_depth(node: PlanNode) -> int:
    if not node.children:
        return 1
    return 1 + max(tree_depth(c) for c in node.children)

"""Single-query (Catalyst-analog) optimizer rules.

The MQO input set consists of *locally optimized* plans (paper §3):
early filtering, predicate push-down, plan collapse.  These rules are
applied per-query before the multi-query optimizer ever sees the plans
— which also canonicalizes them so equivalent queries produce equal
fingerprints more often.
"""
from __future__ import annotations

from dataclasses import replace
from typing import FrozenSet

from . import expr as E
from . import logical as L


def _push_filter(node: L.Node) -> L.Node:
    """Push filters below projects and into join sides where possible."""
    if isinstance(node, L.Filter):
        child = node.child
        if isinstance(child, L.Filter):
            # merge adjacent filters into one conjunction
            return _push_filter(
                L.Filter(child=child.child,
                         pred=E.and_(node.pred, child.pred)))
        if isinstance(child, L.Project):
            pred_cols = E.columns_of(node.pred)
            if pred_cols <= set(child.cols):
                pushed = L.Filter(child=child.child, pred=node.pred)
                return L.Project(child=_push_filter(pushed),
                                 cols=child.cols)
        if isinstance(child, L.Join):
            lnames = frozenset(child.left.schema.names)
            rnames = frozenset(child.right.schema.names)
            parts = (node.pred.parts if isinstance(node.pred, E.And)
                     else (node.pred,))
            l_parts, r_parts, keep = [], [], []
            for p in parts:
                cols = E.columns_of(p)
                if cols <= lnames:
                    l_parts.append(p)
                elif cols <= rnames:
                    r_parts.append(p)
                else:
                    keep.append(p)
            if l_parts or r_parts:
                left = child.left
                right = child.right
                if l_parts:
                    left = L.Filter(child=left, pred=E.and_(*l_parts))
                if r_parts:
                    right = L.Filter(child=right, pred=E.and_(*r_parts))
                new_join = child.with_children(
                    (_push_filter(left), _push_filter(right)))
                if keep:
                    return L.Filter(child=new_join, pred=E.and_(*keep))
                return new_join
    if not node.children:
        return node
    return node.with_children(tuple(_push_filter(c) for c in node.children))


def _collapse_projects(node: L.Node) -> L.Node:
    if isinstance(node, L.Project) and isinstance(node.child, L.Project):
        inner = node.child
        return _collapse_projects(
            L.Project(child=inner.child, cols=node.cols))
    if not node.children:
        return node
    return node.with_children(
        tuple(_collapse_projects(c) for c in node.children))


def _prune_columns(node: L.Node, needed: FrozenSet[str]) -> L.Node:
    """Insert a Project directly above each Scan keeping only needed
    columns (the Parquet/columnar pruning the paper relies on)."""
    if isinstance(node, L.Scan):
        names = node.schema.names
        keep = tuple(n for n in names if n in needed)
        if keep != names and keep:
            return L.Project(child=node, cols=keep)
        return node
    if isinstance(node, L.Project):
        child_needed = frozenset(node.cols)
        return replace(node, child=_prune_columns(node.child, child_needed))
    if isinstance(node, L.Filter):
        child_needed = needed | E.columns_of(node.pred)
        new_child = _prune_columns(node.child, child_needed)
        return node.with_children((new_child,))
    if isinstance(node, L.Join):
        lnames = frozenset(node.left.schema.names)
        rnames = frozenset(node.right.schema.names)
        keys_l = frozenset(lc for lc, _ in node.on)
        keys_r = frozenset(rc for _, rc in node.on)
        left = _prune_columns(node.left, (needed & lnames) | keys_l)
        right = _prune_columns(node.right, (needed & rnames) | keys_r)
        return node.with_children((left, right))
    if isinstance(node, L.Aggregate):
        need = frozenset(node.group_by) | frozenset(
            c for _, fn, c in node.aggs if c)
        return node.with_children((_prune_columns(node.child, need),))
    if isinstance(node, L.Sort):
        return node.with_children(
            (_prune_columns(node.child, needed | {node.by}),))
    if isinstance(node, (L.Limit, L.Cache)):
        return node.with_children(
            tuple(_prune_columns(c, needed) for c in node.children))
    if isinstance(node, L.Union):
        return node.with_children(
            tuple(_prune_columns(c, needed) for c in node.children))
    return node


def optimize_single(plan: L.Node) -> L.Node:
    """Catalyst-analog local optimization to a (bounded) fixpoint."""
    plan = L.as_node(plan)
    for _ in range(3):
        new = _push_filter(plan)
        new = _collapse_projects(new)
        new = _prune_columns(new, frozenset(new.schema.names))
        new = _collapse_projects(new)
        if L.explain(new) == L.explain(plan):
            break
        plan = new
    return plan

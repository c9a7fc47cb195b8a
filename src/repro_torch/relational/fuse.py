"""Pipeline fusion: collapse linear Scan→Filter*→Project chains.

The layer between the logical plan and the physical executor.  The
eager executor materializes a full padded relation per operator and
synchronizes with the host (``int(count)``) after every filter — so a
CE consumer's residual plan (CachedScan → Filter → Project, the
dominant shape after MQO rewriting, and the shape of most TPC-DS leaf
subtrees) pays three dispatches and an intermediate relation for what
is one mask+gather.  ``fuse_plan`` rewrites every maximal such chain
into a single :class:`FusedPipeline` physical node that the executor
runs as ONE jitted call (mask → count → compact → project), routed
through the Pallas filter-scan kernel when the predicate compiles and
through a fused XLA function otherwise.

Fusion is semantics-preserving by construction:

  * filters compose by conjunction — rows surviving ``Filter(p2)`` over
    ``Filter(p1)``'s output are exactly the source rows satisfying
    ``p1 & p2`` (compaction is order-stable, so row order matches the
    eager pipeline too);
  * projections only narrow the column set, and column names are never
    renamed, so the topmost schema fully determines the output;
  * a chain is only fused when every referenced column exists on the
    source leaf (always true for plans built by this engine; checked
    anyway so hand-built plans degrade to the eager path instead of
    miscompiling).

An already-fused node composes: a Filter/Project stacked *above* a
FusedPipeline (e.g. by a later rewrite) folds into it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

from . import expr as E
from . import logical as L
from .schema import Schema


@dataclass(frozen=True)
class FusedPipeline(L.Node):
    """Physical node: leaf → Filter* → Project* chain, one jitted call.

    ``source`` is the Scan or CachedScan leaf, ``pred`` the conjunction
    of every filter predicate in the chain (TRUE when the chain was
    projection-only), ``cols`` the output columns in output order.
    """

    source: L.Node = None  # type: ignore[assignment]
    pred: E.Expr = E.TRUE
    cols: Tuple[str, ...] = ()
    n_filters: int = 0     # chain length metadata (cost model / explain)

    @property
    def children(self):
        return (self.source,)

    @property
    def label(self) -> str:
        return "fused"

    @property
    def strict_attrs(self):
        return (E.canonical(self.pred), self.cols)

    @property
    def schema(self) -> Schema:
        return self.source.schema.select(self.cols)

    def with_children(self, children):
        (c,) = children
        cols = tuple(x for x in self.cols if c.schema.has(x))
        return replace(self, source=c, cols=cols)


def _collapse_chain(node: L.Node) -> Optional[FusedPipeline]:
    """Walk Filter/Project links down to a leaf; None when not a chain."""
    out_cols = node.schema.names
    preds = []
    n_filters = 0
    cur = node
    while isinstance(cur, (L.Filter, L.Project)):
        if isinstance(cur, L.Filter):
            # scope check: the predicate must be valid where it stands
            # (a filter on a projected-away column would crash eagerly;
            # fusing it would silently "resolve" against the leaf)
            if not (E.columns_of(cur.pred)
                    <= set(cur.child.schema.names)):
                return None
            if not isinstance(cur.pred, E.TrueExpr):
                preds.append(cur.pred)
            n_filters += 1
        cur = cur.child
    if isinstance(cur, FusedPipeline):
        # absorb: outer filters apply to the fused output, which is an
        # order-preserving subset of the source rows — conjunction over
        # the source is equivalent
        if not isinstance(cur.pred, E.TrueExpr):
            preds.append(cur.pred)
        n_filters += cur.n_filters
        cur = cur.source
    if not isinstance(cur, (L.Scan, L.CachedScan)):
        return None
    if n_filters == 0:
        return None  # pure projection: the eager scan path is already minimal
    pred = E.and_(*preds)
    src_names = set(cur.schema.names)
    if not (set(out_cols) <= src_names
            and E.columns_of(pred) <= src_names):
        return None
    return FusedPipeline(source=cur, pred=pred, cols=tuple(out_cols),
                         n_filters=n_filters)


def fuse_plan(root: L.Node) -> L.Node:
    """Rewrite every maximal fusable chain in ``root`` (top-down)."""
    root = L.as_node(root)
    if isinstance(root, FusedPipeline):
        return root
    if isinstance(root, (L.Filter, L.Project)):
        fused = _collapse_chain(root)
        if fused is not None:
            return fused
    if not root.children:
        return root
    new_children = tuple(fuse_plan(c) for c in root.children)
    if all(nc is c for nc, c in zip(new_children, root.children)):
        return root
    return root.with_children(new_children)


def unfuse_plan(root: L.Node) -> L.Node:
    """Inverse of :func:`fuse_plan`: expand every FusedPipeline back
    into the equivalent eager Filter→Project chain.  The degradation
    ladder's bottom rung (``relational.executor``) runs pre-fused plans
    through this so single-dispatch kernel launches are genuinely off
    the path, not just disabled for future fusion."""
    root = L.as_node(root)
    if isinstance(root, FusedPipeline):
        node: L.Node = unfuse_plan(root.source)
        if not isinstance(root.pred, E.TrueExpr):
            node = L.Filter(child=node, pred=root.pred)
        return L.Project(child=node, cols=root.cols)
    if not root.children:
        return root
    new_children = tuple(unfuse_plan(c) for c in root.children)
    if all(nc is c for nc, c in zip(new_children, root.children)):
        return root
    return root.with_children(new_children)

"""Relational Rewriter: extraction plans, CE validation, augmentation.

Three plan-type-specific pieces the generic core delegates to:

1. **CE transform** (`make_ce_transform`): (a) reject CEs that cannot be
   re-extracted — a *divergent* merged filter sitting below a
   non-refilter-safe operator (Aggregate / Limit) would change that
   operator's semantics; (b) *augment* covering Project nodes with the
   columns each member's extraction filter will need (the paper's
   "several other optimizations … omitted for readability", §4.2 fn 2).

2. **Extraction plans** (`RelationalRewriter.make_extraction`): the
   member's own filter predicates re-applied to the cached covering
   relation, then the member's output columns projected (identity when
   the SE members were syntactically equal, §4.4).

3. **Cache plans**: the covering tree terminated by a Cache operator.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

from ..core.covering import CoveringExpression
from ..core.fingerprint import fingerprint
from . import expr as E
from . import logical as L


# ---------------------------------------------------------------------------
# CE validation + augmentation
# ---------------------------------------------------------------------------
def _divergent_filter_below_unsafe(node: L.Node,
                                   unsafe_above: bool = False) -> bool:
    if isinstance(node, L.Filter) and node.divergent and unsafe_above:
        return True
    unsafe_here = unsafe_above or not node.refilter_safe
    return any(_divergent_filter_below_unsafe(c, unsafe_here)
               for c in node.children)


def _augment_projects(node: L.Node) -> Tuple[L.Node, frozenset]:
    """Bottom-up: make divergent-variant predicate columns survive every
    Project above them so extraction filters can evaluate."""
    if not node.children:
        return node, frozenset()
    new_children: List[L.Node] = []
    needs: frozenset = frozenset()
    for c in node.children:
        nc, n = _augment_projects(c)
        new_children.append(nc)
        needs |= n
    out: L.Node = node.with_children(tuple(new_children))
    if isinstance(out, L.Filter) and out.divergent:
        for p in out.variant_preds:
            needs |= E.columns_of(p)
    if isinstance(out, L.Project) and needs:
        child_names = out.child.schema.names
        extra = [c for c in child_names
                 if c in needs and c not in out.cols]
        if extra:
            cols = tuple(c for c in child_names
                         if c in set(out.cols) | set(extra))
            out = replace(out, cols=cols)
    return out, needs


def make_ce_transform():
    def transform(ce: CoveringExpression) -> Optional[CoveringExpression]:
        if _divergent_filter_below_unsafe(ce.tree):
            return None
        tree, _ = _augment_projects(ce.tree)
        if tree is not ce.tree:
            if fingerprint(tree) != ce.psi:  # augmentation is loose-only
                return None
            ce = CoveringExpression(se=ce.se, tree=tree, psi=ce.psi)
        return ce

    return transform


# ---------------------------------------------------------------------------
# lock-step divergence collection (member vs covering)
# ---------------------------------------------------------------------------
def _collect_divergent(covering: L.Node, member: L.Node,
                       preds: List[E.Expr]) -> bool:
    """Collect member filter predicates where the covering pred is wider.
    Returns True if member differs anywhere from the covering tree
    (so the extraction is not an identity)."""
    differs = False
    if isinstance(covering, L.Filter):
        if E.canonical(member.pred) != E.canonical(covering.pred):
            preds.append(member.pred)
            differs = True
    elif isinstance(covering, L.Project):
        if tuple(member.cols) != tuple(covering.cols):
            differs = True
    cc, mc = covering.children, member.children
    if len(cc) == 2 and covering.commutative:
        # align member children to covering children by fingerprint
        cf = [fingerprint(x) for x in cc]
        mf = [fingerprint(x) for x in mc]
        if cf != mf and cf == mf[::-1]:
            mc = mc[::-1]
    for c, m in zip(cc, mc):
        differs |= _collect_divergent(c, m, preds)
    return differs


class RelationalRewriter:
    """Implements repro_torch.core.rewrite.Rewriter for relational plans.

    With ``fuse_residuals`` the extraction plan (CachedScan → Filter →
    Project, the CE-consumer hot path) is emitted pre-collapsed into a
    single FusedPipeline physical node, so every consumer re-reads the
    cached covering relation with ONE dispatch instead of one per
    residual operator.  Rewriting happens after fingerprinting, so the
    physical node never perturbs ψ identities.
    """

    def __init__(self, fuse_residuals: bool = False):
        self.fuse_residuals = fuse_residuals

    @staticmethod
    def cache_key(ce: CoveringExpression) -> bytes:
        """Runtime cache identity: the STRICT content fingerprint, so
        same-structure CEs with different merged predicates (recurring
        windows over a template family) coexist in the cache instead of
        colliding on the loose psi and evicting one another."""
        return ce.strict_psi()

    def make_cache_plan(self, ce: CoveringExpression) -> L.Node:
        return L.Cache(child=ce.tree, psi=self.cache_key(ce))

    def make_extraction(self, ce: CoveringExpression,
                        member: L.Node) -> L.Node:
        cached = L.CachedScan(psi=self.cache_key(ce),
                              _schema=ce.tree.schema,
                              source_label=ce.tree.label)
        preds: List[E.Expr] = []
        _collect_divergent(ce.tree, member, preds)
        plan: L.Node = cached
        if preds:
            plan = L.Filter(child=plan, pred=E.and_(*preds))
        if tuple(plan.schema.names) != tuple(member.schema.names):
            plan = L.Project(child=plan, cols=tuple(member.schema.names))
        if self.fuse_residuals:
            from .fuse import fuse_plan

            plan = fuse_plan(plan)
        return plan

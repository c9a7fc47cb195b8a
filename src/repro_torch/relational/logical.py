"""Relational logical plans (the SparkSQL/Catalyst analog).

Nodes conform to :class:`repro_torch.core.plan.PlanNode`:

  * loose operators (fingerprint = label only): ``Scan``, ``Filter``,
    ``Project``, ``CachedScan`` — the ones a *shared operator* can
    subsume across similar subexpressions;
  * strict operators (label + canonical attributes): ``Join``,
    ``Aggregate``, ``Sort``, ``Limit``, ``Union``;
  * cache-unfriendly (never the root of an SE, shared only when
    syntactically equal): ``Join``, ``Union`` (+ implicit cartesian).

Merged (covering) Filter/Project nodes carry the member ``variants`` so
the rewriter can build extraction plans and validity can be checked
(a divergent filter below an Aggregate/Limit cannot be re-extracted).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

from . import expr as E
from .schema import ColType, Schema


@dataclass(frozen=True)
class Node:
    """Base class; subclasses are immutable dataclasses."""

    # --- PlanNode protocol defaults ---------------------------------------
    @property
    def children(self) -> Tuple["Node", ...]:
        return ()

    @property
    def label(self) -> str:
        raise NotImplementedError

    loose: bool = field(default=False, init=False, repr=False)
    cache_friendly: bool = field(default=True, init=False, repr=False)
    commutative: bool = field(default=False, init=False, repr=False)
    # Can a member's filter be re-applied on top of this operator's output?
    refilter_safe: bool = field(default=True, init=False, repr=False)

    @property
    def strict_attrs(self) -> object:
        return None

    @property
    def content_attrs(self) -> object:
        """Full attribute content for cross-batch strict fingerprints
        (loose nodes override; strict nodes are covered by
        ``strict_attrs``)."""
        return self.strict_attrs

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def merge(self, others: Sequence["Node"]) -> "Node":
        return self  # strict nodes: syntactically equal by fingerprint

    def with_children(self, children: Tuple["Node", ...]) -> "Node":
        raise NotImplementedError

    # convenience builder API (DataFrame-style)
    def filter(self, pred: E.Expr) -> "Filter":
        return Filter(self, pred)

    def project(self, *cols: str) -> "Project":
        return Project(self, tuple(cols))

    def join(self, other: "Node", left_on: str, right_on: str) -> "Join":
        return Join(self, other, ((left_on, right_on),))

    def groupby(self, *keys: str):
        return _GroupBy(self, tuple(keys))

    def sort(self, by: str, desc: bool = False) -> "Sort":
        return Sort(self, by, desc)

    def limit(self, n: int) -> "Limit":
        return Limit(self, n)

    def union(self, other: "Node") -> "Union":
        return Union(self, other)


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Scan(Node):
    table: str = ""
    fmt: str = "columnar"          # "columnar" (Parquet analog) | "csv"
    _schema: Schema = None         # type: ignore[assignment]
    # Partition restriction (relational.partition): None scans the whole
    # table; a tuple of partition ids scans only those contiguous row
    # ranges (set by partition pruning and by per-partition CE
    # materialization).  Loose fingerprints ignore it (label only);
    # strict content fingerprints include it so a restricted scan never
    # aliases the full relation.
    parts: Optional[Tuple[int, ...]] = None

    loose = True

    @property
    def label(self) -> str:
        return f"scan:{self.table}:{self.fmt}"

    @property
    def content_attrs(self) -> object:
        return self.parts

    @property
    def schema(self) -> Schema:
        return self._schema

    def with_children(self, children):
        assert not children
        return self

    def merge(self, others):
        return self


@dataclass(frozen=True)
class CachedScan(Node):
    """Leaf reading a relation materialized in the cache (by ψ)."""

    psi: bytes = b""
    _schema: Schema = None  # type: ignore[assignment]
    source_label: str = ""

    loose = True

    @property
    def content_attrs(self) -> object:
        return self.psi

    @property
    def label(self) -> str:
        return f"cached:{self.psi.hex()[:12]}"

    @property
    def schema(self) -> Schema:
        return self._schema

    def with_children(self, children):
        assert not children
        return self


@dataclass(frozen=True)
class Filter(Node):
    child: Node = None  # type: ignore[assignment]
    pred: E.Expr = E.TRUE
    # covering-node metadata: each SE member's original predicate
    variants: Tuple[tuple, ...] = ()   # canonical forms, for divergence test
    variant_preds: Tuple[E.Expr, ...] = ()

    loose = True

    @property
    def children(self):
        return (self.child,)

    @property
    def label(self) -> str:
        return "filter"

    @property
    def schema(self) -> Schema:
        return self.child.schema

    @property
    def divergent(self) -> bool:
        return len(set(self.variants)) > 1

    @property
    def content_attrs(self) -> object:
        return E.canonical(self.pred)

    def with_children(self, children):
        (c,) = children
        return replace(self, child=c)

    def merge(self, others: Sequence["Filter"]) -> "Filter":
        all_nodes = (self, *others)
        merged = E.or_(*(n.pred for n in all_nodes))
        return Filter(
            child=self.child,
            pred=merged,
            variants=tuple(E.canonical(n.pred) for n in all_nodes),
            variant_preds=tuple(n.pred for n in all_nodes),
        )


@dataclass(frozen=True)
class Project(Node):
    child: Node = None  # type: ignore[assignment]
    cols: Tuple[str, ...] = ()
    variants: Tuple[Tuple[str, ...], ...] = ()

    loose = True

    @property
    def children(self):
        return (self.child,)

    @property
    def label(self) -> str:
        return "project"

    @property
    def schema(self) -> Schema:
        return self.child.schema.select(self.cols)

    @property
    def divergent(self) -> bool:
        return len(set(self.variants)) > 1

    @property
    def content_attrs(self) -> object:
        return self.cols

    def with_children(self, children):
        (c,) = children
        # keep only columns the new child still provides (augmentation /
        # extraction rewrites may swap children)
        cols = tuple(c_ for c_ in self.cols if c.schema.has(c_))
        return replace(self, child=c, cols=cols)

    def merge(self, others: Sequence["Project"]) -> "Project":
        all_nodes = (self, *others)
        union_cols, seen = [], set()
        for n in all_nodes:
            for c in n.cols:
                if c not in seen:
                    seen.add(c)
                    union_cols.append(c)
        # deterministic order: child schema order
        child_order = {n: i for i, n in enumerate(self.child.schema.names)}
        union_cols.sort(key=lambda c: child_order.get(c, 1 << 30))
        return Project(
            child=self.child,
            cols=tuple(union_cols),
            variants=tuple(n.cols for n in all_nodes),
        )


@dataclass(frozen=True)
class Join(Node):
    left: Node = None   # type: ignore[assignment]
    right: Node = None  # type: ignore[assignment]
    on: Tuple[Tuple[str, str], ...] = ()   # ((left_col, right_col),)

    cache_friendly = False
    commutative = True

    @property
    def children(self):
        return (self.left, self.right)

    @property
    def label(self) -> str:
        return "join"

    @property
    def strict_attrs(self):
        # side-order independent: {{lcol, rcol}, ...}
        return frozenset(frozenset(p) for p in self.on)

    @property
    def schema(self) -> Schema:
        return self.left.schema.concat(self.right.schema)

    def with_children(self, children):
        l, r = children
        on = self.on
        # keep key orientation consistent if children were swapped
        if not all(l.schema.has(lc) for lc, _ in on):
            on = tuple((rc, lc) for lc, rc in on)
        return replace(self, left=l, right=r, on=on)


@dataclass(frozen=True)
class Aggregate(Node):
    child: Node = None  # type: ignore[assignment]
    group_by: Tuple[str, ...] = ()
    # (output_name, fn, input_col); fn in sum|min|max|count|mean
    aggs: Tuple[Tuple[str, str, str], ...] = ()

    refilter_safe = False   # re-filtering after aggregation is wrong

    @property
    def children(self):
        return (self.child,)

    @property
    def label(self) -> str:
        return "agg"

    @property
    def strict_attrs(self):
        return (tuple(self.group_by), tuple(self.aggs))

    @property
    def schema(self) -> Schema:
        fields = [(g, self.child.schema.coltype(g)) for g in self.group_by]
        for out, fn, col in self.aggs:
            if fn == "count":
                t: ColType = ColType("i32")
            elif fn == "mean":
                t = ColType("f32")
            else:
                t = self.child.schema.coltype(col)
            fields.append((out, t))
        return Schema(tuple(fields))

    def with_children(self, children):
        (c,) = children
        return replace(self, child=c)


@dataclass(frozen=True)
class Sort(Node):
    child: Node = None  # type: ignore[assignment]
    by: str = ""
    desc: bool = False

    @property
    def children(self):
        return (self.child,)

    @property
    def label(self) -> str:
        return "sort"

    @property
    def strict_attrs(self):
        return (self.by, self.desc)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def with_children(self, children):
        (c,) = children
        return replace(self, child=c)


@dataclass(frozen=True)
class Limit(Node):
    child: Node = None  # type: ignore[assignment]
    n: int = 0

    refilter_safe = False

    @property
    def children(self):
        return (self.child,)

    @property
    def label(self) -> str:
        return "limit"

    @property
    def strict_attrs(self):
        return (self.n,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def with_children(self, children):
        (c,) = children
        return replace(self, child=c)


@dataclass(frozen=True)
class Union(Node):
    left: Node = None   # type: ignore[assignment]
    right: Node = None  # type: ignore[assignment]

    cache_friendly = False
    commutative = True

    @property
    def children(self):
        return (self.left, self.right)

    @property
    def label(self) -> str:
        return "union"

    @property
    def strict_attrs(self):
        return ()

    @property
    def schema(self) -> Schema:
        assert self.left.schema.names == self.right.schema.names
        return self.left.schema

    def with_children(self, children):
        l, r = children
        return replace(self, left=l, right=r)


@dataclass(frozen=True)
class Cache(Node):
    """Terminal materialization marker of a sharing (cache) plan."""

    child: Node = None  # type: ignore[assignment]
    psi: bytes = b""

    @property
    def children(self):
        return (self.child,)

    @property
    def label(self) -> str:
        return "cache"

    @property
    def strict_attrs(self):
        return (self.psi,)

    @property
    def schema(self) -> Schema:
        return self.child.schema

    def with_children(self, children):
        (c,) = children
        return replace(self, child=c)


# ---------------------------------------------------------------------------
class _GroupBy:
    def __init__(self, child: Node, keys: Tuple[str, ...]):
        self.child, self.keys = child, keys

    def agg(self, *aggs: Tuple[str, str, str]) -> Aggregate:
        return Aggregate(self.child, self.keys, tuple(aggs))


def scan(table: str, schema: Schema, fmt: str = "columnar") -> Scan:
    return Scan(table=table, fmt=fmt, _schema=schema)


def as_node(obj) -> Node:
    """Coerce a plan-like object to a raw logical Node.

    The fluent :class:`~repro_torch.relational.api.Relation` (and anything
    else wrapping a plan) exposes ``__plan_node__``; raw Nodes pass
    through.  Every plan *sink* (execute, optimize_single, fuse_plan,
    the service/session entry points) funnels through this, so the two
    frontends meet one code path."""
    hook = getattr(obj, "__plan_node__", None)
    if hook is not None:
        return hook()
    if not isinstance(obj, Node):
        raise TypeError(f"not a logical plan: {type(obj).__name__}")
    return obj


def explain(node: Node, indent: int = 0) -> str:
    node = as_node(node)
    pad = "  " * indent
    extra = ""
    if isinstance(node, Filter):
        extra = f" [{E.pretty(node.pred)}]"
    elif isinstance(node, Project):
        extra = f" [{','.join(node.cols)}]"
    elif isinstance(node, Join):
        extra = f" [{node.on}]"
    elif isinstance(node, Aggregate):
        extra = f" [by={node.group_by} aggs={node.aggs}]"
    lines = [f"{pad}{node.label}{extra}"]
    for c in node.children:
        lines.append(explain(c, indent + 1))
    return "\n".join(lines)

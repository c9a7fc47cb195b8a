"""Fluent lazy Relation frontend (the user-facing query API).

Clients no longer hand-assemble ``logical.Node`` / ``expr`` trees.
They compose immutable, lazy :class:`Relation` builders with
operator-overloaded column expressions:

    from repro_torch.relational import c

    top = (session.table("sales")
           .where((c.price > 5) & (c.region == "EU"))
           .select("price", "qty")
           .group_by("qty").agg(("rev", "sum", "price")))
    handle = service.submit(top)

``c.price > 5`` builds a :class:`Pred` over the expression IR; ``&``,
``|`` and ``~`` compose predicates; a literal on either side works
(``5 < c.price`` and ``c.price > 5`` are the same predicate after
canonicalization).  Nothing executes until the Relation reaches a
session/service sink — submission compiles the built tree through
:mod:`relational.canonical`, so every syntactic spelling of a query
maps to one ψ and one strict fingerprint and the MQO can share its
work.  Raw ``logical.Node`` trees remain accepted at every sink as a
deprecation shim (they are canonicalized identically).

The legacy DataFrame-style methods (``filter(E.cmp(...))``,
``project``, ``groupby``) are kept as aliases so existing call sites
migrate incrementally.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from . import expr as E
from . import logical as L
from .canonical import canonicalize_plan, format_plan

Literal = Union[int, float, str, bytes]


# ---------------------------------------------------------------------------
# operator-overloaded expressions
# ---------------------------------------------------------------------------
class Pred:
    """A boolean predicate: wraps an ``expr`` tree, composable with
    ``&`` (and), ``|`` (or) and ``~`` (not)."""

    __slots__ = ("expr",)

    def __init__(self, expr: E.Expr):
        self.expr = expr

    def __and__(self, other: "Pred") -> "Pred":
        return Pred(E.and_(self.expr, as_expr(other)))

    def __rand__(self, other: "Pred") -> "Pred":
        return Pred(E.and_(as_expr(other), self.expr))

    def __or__(self, other: "Pred") -> "Pred":
        return Pred(E.or_(self.expr, as_expr(other)))

    def __ror__(self, other: "Pred") -> "Pred":
        return Pred(E.or_(as_expr(other), self.expr))

    def __invert__(self) -> "Pred":
        return Pred(E.not_(self.expr))

    def __bool__(self):
        raise TypeError(
            "use & | ~ to compose predicates (not and/or/not, which "
            "coerce to bool)")

    def __repr__(self) -> str:
        return f"Pred({E.pretty(self.expr)})"


class ColExpr:
    """A named column; comparisons against literals or other columns
    build :class:`Pred`.  Python's reflected dispatch makes the
    literal-on-left spelling (``5 < c.price``) arrive here too."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _cmp(self, op: str, other) -> Pred:
        if isinstance(other, ColExpr):
            return Pred(E.Cmp(op, E.Col(self.name), other.node))
        if isinstance(other, E.Col):
            return Pred(E.Cmp(op, E.Col(self.name), other))
        # numpy scalars coerce so each value has ONE canonical literal
        if isinstance(other, np.integer):
            other = int(other)
        elif isinstance(other, np.floating):
            other = float(other)
        if not isinstance(other, (int, float, str, bytes)):
            # fail at the call site, not later inside fingerprinting
            raise TypeError(
                f"cannot compare column {self.name!r} {op} "
                f"{type(other).__name__} — expected a column or an "
                f"int/float/str/bytes literal")
        if isinstance(other, float) and not np.isfinite(other):
            # NaN satisfies no ordered compare; letting it through
            # would also poison the canonical complement fold
            raise ValueError(
                f"non-finite literal in compare against column "
                f"{self.name!r} — NaN/inf predicates are unsupported")
        return Pred(E.Cmp(op, E.Col(self.name), E.Lit(other)))

    def __lt__(self, other) -> Pred:
        return self._cmp("<", other)

    def __le__(self, other) -> Pred:
        return self._cmp("<=", other)

    def __gt__(self, other) -> Pred:
        return self._cmp(">", other)

    def __ge__(self, other) -> Pred:
        return self._cmp(">=", other)

    def __eq__(self, other) -> Pred:  # type: ignore[override]
        return self._cmp("==", other)

    def __ne__(self, other) -> Pred:  # type: ignore[override]
        return self._cmp("!=", other)

    __hash__ = None  # type: ignore[assignment]

    @property
    def node(self) -> E.Col:
        return E.Col(self.name)

    def isin(self, values: Sequence[Literal]) -> Pred:
        # each value routes through _cmp so the literal coercion +
        # non-finite guard apply exactly as for direct compares; the
        # validated literals then form ONE first-class membership node
        # (the kernel evaluates it as a single opcode)
        lits = []
        for v in values:
            e = self._cmp("==", v).expr
            if not isinstance(e.rhs, E.Lit):
                raise TypeError(
                    f"isin over column {self.name!r} expects literal "
                    f"values, got {type(v).__name__}")
            lits.append(e.rhs.value)
        return Pred(E.In(E.Col(self.name), tuple(lits)))

    def between(self, lo: Literal, hi: Literal) -> Pred:
        return Pred(E.and_(self._cmp(">=", lo).expr,
                           self._cmp("<=", hi).expr))

    def __repr__(self) -> str:
        return f"c.{self.name}"


class _ColNamespace:
    """``c.price`` / ``c["net profit"]`` → :class:`ColExpr`."""

    def __getattr__(self, name: str) -> ColExpr:
        if name.startswith("__"):
            raise AttributeError(name)
        return ColExpr(name)

    def __getitem__(self, name: str) -> ColExpr:
        return ColExpr(name)


#: The column namespace: ``from repro_torch.relational import c``.
c = _ColNamespace()


def col(name: str) -> ColExpr:
    return ColExpr(name)


def as_expr(obj) -> E.Expr:
    """Coerce a predicate-like object (Pred, ColExpr comparison result,
    or raw expr tree) to the expression IR."""
    if isinstance(obj, Pred):
        return obj.expr
    if isinstance(obj, (E.Cmp, E.In, E.And, E.Or, E.Not, E.TrueExpr)):
        return obj
    if isinstance(obj, bool):
        return E.TRUE if obj else E.Not(E.TRUE)
    raise TypeError(f"not a predicate: {type(obj).__name__}")


# ---------------------------------------------------------------------------
# the lazy Relation builder
# ---------------------------------------------------------------------------
class Relation:
    """An immutable, lazy relational expression.

    Every method returns a NEW Relation over an extended logical tree;
    nothing executes until the Relation reaches a session or service
    sink (``collect`` / ``submit`` / ``run_batch``), where the tree is
    compiled through the canonicalization pass.  Mirrors the legacy
    ``logical.Node`` builder surface (filter/project/groupby/...) so it
    is a drop-in replacement for ``Session.table`` results.
    """

    __slots__ = ("_node", "_session", "_hint_cache")

    def __init__(self, node: L.Node, session=None, hint_cache: bool = False):
        self._node = node
        self._session = session
        self._hint_cache = hint_cache

    # -- plumbing ----------------------------------------------------------
    def __plan_node__(self) -> L.Node:
        return self._node

    def _wrap(self, node: L.Node) -> "Relation":
        return Relation(node, self._session, self._hint_cache)

    @property
    def plan(self) -> L.Node:
        """The raw logical tree as built (un-canonicalized)."""
        return self._node

    @property
    def schema(self):
        return self._node.schema

    @property
    def columns(self) -> Tuple[str, ...]:
        return self._node.schema.names

    @property
    def session(self):
        return self._session

    @property
    def hint_cache(self) -> bool:
        return self._hint_cache

    def logical_plan(self) -> L.Node:
        """The canonical logical tree — what fingerprinting sees."""
        return canonicalize_plan(self._node)

    # -- relational operators ----------------------------------------------
    def where(self, pred) -> "Relation":
        """Keep rows satisfying ``pred`` (a :class:`Pred` from the
        ``c`` namespace, or a raw expr tree)."""
        return self._wrap(L.Filter(child=self._node, pred=as_expr(pred)))

    filter = where                      # legacy alias

    def select(self, *cols: str) -> "Relation":
        if len(set(cols)) != len(cols):
            # columnar Tables are keyed by name, so a duplicate output
            # column cannot be represented — fail at the call site
            dupes = sorted({x for x in cols if cols.count(x) > 1})
            raise ValueError(f"duplicate projection columns: {dupes}")
        return self._wrap(L.Project(child=self._node, cols=tuple(cols)))

    project = select                    # legacy alias

    def join(self, other: Union["Relation", L.Node], left_on: str,
             right_on: str) -> "Relation":
        return self._wrap(L.Join(left=self._node, right=L.as_node(other),
                                 on=((left_on, right_on),)))

    def group_by(self, *keys: str) -> "RelationGroupBy":
        return RelationGroupBy(self, tuple(keys))

    groupby = group_by                  # legacy alias

    def sort(self, by: str, desc: bool = False) -> "Relation":
        return self._wrap(L.Sort(child=self._node, by=by, desc=desc))

    def limit(self, n: int) -> "Relation":
        return self._wrap(L.Limit(child=self._node, n=int(n)))

    def union(self, other: Union["Relation", L.Node]) -> "Relation":
        return self._wrap(L.Union(left=self._node, right=L.as_node(other)))

    def cache_hint(self) -> "Relation":
        """Mark this relation as worth caching: in the window that
        executes it, the MQO considers single-consumer subexpressions
        as covering candidates too (k=1), so a hinted one-off query can
        materialize covering state that later windows resume from.
        Admission is still priced by the cost model and budget."""
        return Relation(self._node, self._session, hint_cache=True)

    # -- execution / introspection ------------------------------------------
    def explain_str(self, *, canonical: bool = True,
                    show_schema: bool = False) -> str:
        """Pretty-printed plan (the canonical form by default — what
        the optimizer fingerprints)."""
        node = self.logical_plan() if canonical else self._node
        return format_plan(node, show_schema=show_schema)

    def collect(self):
        """Execute this relation on its bound session (one-query batch
        through the full service path) and return the result Table."""
        if self._session is None:
            raise RuntimeError(
                "Relation is not bound to a Session — build it via "
                "session.table(...) or pass it to run_batch/submit")
        return self._session.run_batch([self]).results[0].table

    def __repr__(self) -> str:
        root = type(self._node).__name__
        return (f"Relation({root}, cols={list(self.columns)}, "
                f"bound={self._session is not None})")


class RelationGroupBy:
    """Intermediate ``group_by`` state; ``agg`` closes it."""

    __slots__ = ("_rel", "_keys")

    def __init__(self, rel: Relation, keys: Tuple[str, ...]):
        self._rel = rel
        self._keys = keys

    def agg(self, *aggs: Tuple[str, str, str]) -> Relation:
        """Each agg is ``(output_name, fn, input_col)`` with fn in
        sum|min|max|count|mean (count ignores input_col)."""
        node = L.Aggregate(child=self._rel._node, group_by=self._keys,
                           aggs=tuple(aggs))
        return self._rel._wrap(node)

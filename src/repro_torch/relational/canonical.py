"""Canonical plan IR: the normalization pass in front of fingerprinting.

The paper's sharing machinery (loose ψ for structure, strict content
fingerprints for cache identity) only pays off when *semantically*
equivalent queries reach it as *syntactically* equal trees.  Clients —
and the fluent :mod:`relational.api` builder — produce many spellings
of the same query: reordered conjuncts, ``Not(x >= 5)`` instead of
``x < 5``, literal-on-left compares, stacked filters, redundant
projections.  This module rewrites every plan into one normal form, so
all those spellings map to ONE ψ and ONE strict fingerprint — and the
MQO can actually share their work.

Expression normal form (:func:`canonicalize_expr`):

  * **negation normal form** — ``Not`` is pushed through ``And``/``Or``
    (De Morgan), double negations cancel, and ``Not(Cmp)`` folds into
    the complementary operator; the only surviving ``Not`` is
    ``Not(TRUE)`` (the engine's FALSE).
  * **orientation** — literal-on-left compares flip to column-on-left
    (``5 < price`` ⇒ ``price > 5``).
  * **constant folding** — Lit-Lit compares evaluate; a false conjunct
    collapses the ``And``, a true disjunct collapses the ``Or``;
    ``TRUE`` conjuncts / ``FALSE`` disjuncts are pruned.
  * **flatten + sort + dedup** — nested ``And``/``Or`` flatten into one
    n-ary node whose parts are deduplicated and sorted by their
    canonical key (commutativity).

Plan normal form (:func:`canonicalize_plan`):

  * every ``Filter`` predicate is canonicalized; ``Filter(TRUE)``
    disappears; adjacent Filters merge into one conjunction.
  * **interval normal form** (schema-aware — it needs the child's
    column types, so it lives in the plan pass, not
    :func:`canonicalize_expr`): conjunctive compares over one numeric
    column range-merge to the tightest bounds (``a > 5 & a > 3`` →
    ``a > 5``), fractional thresholds on integer columns fold through
    the exact :func:`expr.fold_int_cmp` semantics partition pruning
    uses (``qty > 10.5`` ≡ ``qty >= 11``), strict integer bounds
    normalize to inclusive ones (``a > 5`` ≡ ``a >= 6``), and a
    contradictory conjunction (``a > 5 & a < 3``) collapses to
    ``FALSE``.
  * **projection normal form** — duplicate columns are dropped,
    ``Project(Project(x))`` collapses, and an identity projection
    (exactly the child's schema, in order) disappears.

:func:`subsumes` / :func:`subsumption_residual` decide — conservatively,
over the normalized conjunct sets — whether one predicate's rows are a
superset of another's, so the service can resume a query from a
resident covering expression whose predicate is merely *weaker* and
apply only the residual conjuncts (semantic reuse).

The pass is applied by the service layer to *every* submitted plan —
builder-made or hand-made — before local optimization and
fingerprinting, so legacy ``logical.Node`` trees get the same identity
as their :class:`~repro_torch.relational.api.Relation` equivalents.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np

from . import expr as E
from . import logical as L

#: The engine's FALSE: ``Not(TRUE)`` — representable everywhere ``Not``
#: and ``TrueExpr`` are (eval, pruning, stats), without a new IR node.
FALSE = E.Not(E.TRUE)


def is_true(e: E.Expr) -> bool:
    return isinstance(e, E.TrueExpr)


def is_false(e: E.Expr) -> bool:
    return isinstance(e, E.Not) and isinstance(e.part, E.TrueExpr)


# ---------------------------------------------------------------------------
# expression canonicalization
# ---------------------------------------------------------------------------
def canonicalize_expr(e: E.Expr) -> E.Expr:
    """Rewrite ``e`` into the canonical normal form described above.

    Semantics-preserving on every value the engine can hold: the
    canonical expression evaluates to the same row mask as the
    original (property-tested in tests/test_canonical.py).  The
    ordered-complement fold (``¬(x <= v)`` → ``x > v``) additionally
    assumes totally ordered column domains — IEEE NaN would satisfy
    neither side — which holds because ``build_table_stats`` rejects
    non-finite float columns at registration, the only catalog entry
    point."""
    return _canon(e, negate=False)


def _canon(e: E.Expr, negate: bool) -> E.Expr:
    if isinstance(e, E.TrueExpr):
        return FALSE if negate else E.TRUE
    if isinstance(e, E.Not):
        return _canon(e.part, not negate)      # ¬¬x = x
    if isinstance(e, E.Cmp):
        c = E.oriented(e)
        if negate:
            if _nonfinite_lit(c):
                # IEEE NaN/inf literal: the operator complement is NOT
                # the negation (NaN satisfies neither x>v nor x<=v), so
                # keep the Not node — correctness over normalization
                return E.Not(c)
            c = E.Cmp(E.NEGATE[c.op], c.col, c.rhs)
        if isinstance(c.col, E.Lit) and isinstance(c.rhs, E.Lit):
            return E.TRUE if E.const_cmp(c) else FALSE
        return c
    if isinstance(e, E.In):
        # dedup + sort values by literal key; empty membership is FALSE,
        # a singleton folds to the equivalent ``==`` compare.  There is
        # no complement operator, so a negated multi-value In keeps its
        # Not node (like the non-finite Cmp case above).
        keyed = {E._lit_key(v): v for v in e.values}
        vals = tuple(keyed[k] for k in sorted(keyed))
        if not vals:
            return E.TRUE if negate else FALSE
        if len(vals) == 1:
            return _canon(E.Cmp("==", e.col, E.Lit(vals[0])), negate)
        c = E.In(e.col, vals)
        return E.Not(c) if negate else c
    if isinstance(e, (E.And, E.Or)):
        # De Morgan: ¬(a ∧ b) = ¬a ∨ ¬b  (and dually)
        conj = isinstance(e, E.And) ^ negate
        parts = [_canon(p, negate) for p in e.parts]
        return _normal_nary(parts, conj)
    raise TypeError(type(e))


def _nonfinite_lit(e: E.Cmp) -> bool:
    return any(isinstance(s, E.Lit) and isinstance(s.value, float)
               and not math.isfinite(s.value)
               for s in (e.col, e.rhs))


def _normal_nary(parts: List[E.Expr], conj: bool) -> E.Expr:
    """Flatten / constant-fold / dedup / sort an n-ary And (conj=True)
    or Or (conj=False) over already-canonical parts."""
    absorb, neutral = (is_false, is_true) if conj else (is_true, is_false)
    flat: List[E.Expr] = []
    stack = list(reversed(parts))
    while stack:
        p = stack.pop()
        if isinstance(p, E.And if conj else E.Or):
            stack.extend(reversed(p.parts))
            continue
        if absorb(p):                  # FALSE ∧ … / TRUE ∨ …
            return FALSE if conj else E.TRUE
        if not neutral(p):             # drop TRUE ∧ … / FALSE ∨ …
            flat.append(p)
    keyed = {E.canonical(p): p for p in flat}
    ordered = [keyed[k] for k in sorted(keyed)]
    if not ordered:
        return E.TRUE if conj else FALSE
    if len(ordered) == 1:
        return ordered[0]
    return E.And(tuple(ordered)) if conj else E.Or(tuple(ordered))


# ---------------------------------------------------------------------------
# interval normal form + subsumption
# ---------------------------------------------------------------------------
#: signed integer bit widths per schema column kind
_INT_BITS = {"i32": 32, "i64": 64}


def conjuncts_of(e: E.Expr) -> List[E.Expr]:
    """Top-level conjunct list of a canonical expression (TRUE → [])."""
    if is_true(e):
        return []
    if isinstance(e, E.And):
        return list(e.parts)
    return [e]


def _num_key(kind: str, v):
    """Comparison-space key of a literal against a numeric column, or
    None when exact interval reasoning is unsound for it.

    Integer columns get the exact Python int — but ONLY in the column's
    representable range: ``eval_expr`` casts literals with
    ``jnp.asarray(v, dtype)``, which WRAPS out-of-range ints, so those
    atoms must stay verbatim.  f32 columns key on ``float(np.float32(v))``
    (the value execution actually compares against): two thresholds that
    round to one f32 are the same predicate, and bound tightness must be
    decided post-rounding or merging could drop a strict bound that
    still excludes rows."""
    if isinstance(v, bool):
        v = int(v)
    if not isinstance(v, (int, float)):
        return None
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if kind in _INT_BITS:
        if isinstance(v, float):
            if not v.is_integer():
                return None            # caller folds via fold_int_cmp
            v = int(v)
        half = 1 << (_INT_BITS[kind] - 1)
        if not -half <= v <= half - 1:
            return None
        return v
    if kind == "f32":
        return float(np.float32(v))
    return None


def _numeric_atom(c: E.Expr, schema):
    """Classify one canonical conjunct for interval reasoning.

    Returns ``(col_name, op, key)`` for an exactly-reasoned numeric
    ``Col op Lit`` compare, the string ``"true"``/``"false"`` when the
    atom folds to a constant (fractional threshold off the integer
    range), or None for everything the machinery must keep verbatim
    (strings, col-col, Or/Not/In, out-of-range ints, NaN)."""
    if not (isinstance(c, E.Cmp) and isinstance(c.col, E.Col)
            and isinstance(c.rhs, E.Lit)):
        return None
    name = c.col.name
    if not schema.has(name):
        return None
    kind = schema.coltype(name).kind
    if kind not in _INT_BITS and kind != "f32":
        return None
    v = c.rhs.value
    if isinstance(v, bool):
        v = int(v)
    if not isinstance(v, (int, float)):
        return None
    if (kind in _INT_BITS and isinstance(v, float)
            and math.isfinite(v) and not v.is_integer()):
        # the ONE shared folding helper (also used by eval_expr and
        # partition._part_maybe; drift is pinned by the shared case
        # table in tests/test_subsumption.py)
        folded = E.fold_int_cmp(c.op, v, bits=_INT_BITS[kind])
        if folded[0] == "all":
            return "true" if folded[1] else "false"
        _, op, b = folded
        key = _num_key(kind, b)
        return None if key is None else (name, op, key)
    key = _num_key(kind, v)
    return None if key is None else (name, c.op, key)


def _add_bound(iv: dict, kind: str, op: str, key) -> None:
    """Fold one atom into the per-column interval state ``iv``
    (keys: lo/hi = (key, strict), eq, neq, ins, false)."""
    if kind in _INT_BITS:
        # integer domains: strict bounds have an exact inclusive form
        # (a > 5 ⟺ a >= 6) — normalizing here makes merging, emission,
        # and implication all operate on one spelling
        half = 1 << (_INT_BITS[kind] - 1)
        if op == ">":
            if key == half - 1:
                iv["false"] = True
                return
            op, key = ">=", key + 1
        elif op == "<":
            if key == -half:
                iv["false"] = True
                return
            op, key = "<=", key - 1
    strict = op in (">", "<")
    if op in (">", ">="):
        cur = iv.get("lo")
        if (cur is None or key > cur[0]
                or (key == cur[0] and strict and not cur[1])):
            iv["lo"] = (key, strict)
    elif op in ("<", "<="):
        cur = iv.get("hi")
        if (cur is None or key < cur[0]
                or (key == cur[0] and strict and not cur[1])):
            iv["hi"] = (key, strict)
    elif op == "==":
        cur = iv.get("eq")
        if cur is not None and cur != key:
            iv["false"] = True
        iv["eq"] = key
    elif op == "!=":
        iv.setdefault("neq", set()).add(key)


def _iv_contradicts(iv: dict) -> bool:
    if iv.get("false"):
        return True
    eq, lo, hi = iv.get("eq"), iv.get("lo"), iv.get("hi")
    neq = iv.get("neq", set())
    if eq is not None:
        if lo and (eq < lo[0] or (eq == lo[0] and lo[1])):
            return True
        if hi and (eq > hi[0] or (eq == hi[0] and hi[1])):
            return True
        return eq in neq
    if lo and hi:
        if lo[0] > hi[0]:
            return True
        if lo[0] == hi[0] and (lo[1] or hi[1] or lo[0] in neq):
            return True
    return False


def _in_keys(e: E.In, kind: str) -> Optional[frozenset]:
    keys = [_num_key(kind, v) for v in e.values]
    if any(k is None for k in keys):
        return None
    return frozenset(keys)


def _summarize(parts: List[E.Expr], schema):
    """Decompose canonical conjuncts into per-column interval state
    plus the verbatim residual.  Returns (ivs, residual, keys, false):
    ``ivs`` maps column → interval dict, ``residual`` holds the atoms
    kept as-is (which still includes In atoms whose keys also land in
    ``ivs[..]["ins"]`` for implication checks), ``keys`` the canonical
    key of every conjunct, ``false`` whether the conjunction is
    unsatisfiable."""
    ivs: Dict[str, dict] = {}
    residual: List[E.Expr] = []
    keys = set()
    false = False
    for p in parts:
        keys.add(E.canonical(p))
        a = _numeric_atom(p, schema)
        if a == "false":
            false = True
            continue
        if a == "true":
            continue
        if a is None:
            if (isinstance(p, E.In) and schema.has(p.col.name)):
                kind = schema.coltype(p.col.name).kind
                if kind in _INT_BITS or kind == "f32":
                    ks = _in_keys(p, kind)
                    if ks is not None:
                        iv = ivs.setdefault(p.col.name, {"kind": kind})
                        iv.setdefault("ins", []).append(ks)
            residual.append(p)
            continue
        name, op, key = a
        iv = ivs.setdefault(name, {"kind": schema.coltype(name).kind})
        _add_bound(iv, iv["kind"], op, key)
    for iv in ivs.values():
        if _iv_contradicts(iv):
            false = True
    return ivs, residual, keys, false


def _emit_atoms(name: str, iv: dict) -> List[E.Expr]:
    """Re-emit one column's merged interval as canonical atoms."""
    col = E.Col(name)
    eq, lo, hi = iv.get("eq"), iv.get("lo"), iv.get("hi")
    neq = iv.get("neq", set())
    if eq is not None:                 # == implies every other bound
        return [E.Cmp("==", col, E.Lit(eq))]
    if (lo and hi and lo[0] == hi[0] and not lo[1] and not hi[1]):
        return [E.Cmp("==", col, E.Lit(lo[0]))]   # degenerate [v, v]
    out: List[E.Expr] = []
    if lo:
        out.append(E.Cmp(">" if lo[1] else ">=", col, E.Lit(lo[0])))
    if hi:
        out.append(E.Cmp("<" if hi[1] else "<=", col, E.Lit(hi[0])))
    for k in sorted(neq):
        inside = not ((lo and (k < lo[0] or (k == lo[0] and lo[1])))
                      or (hi and (k > hi[0] or (k == hi[0] and hi[1]))))
        if inside:                     # outside the interval ⇒ implied
            out.append(E.Cmp("!=", col, E.Lit(k)))
    return out


def normalize_intervals(pred: E.Expr, schema) -> E.Expr:
    """Interval normal form of an already-canonical predicate over the
    given schema: per-column range-merge of its top-level conjuncts,
    schema-aware integer-threshold folding, contradiction → FALSE.
    Bit-identical to ``pred`` on every value the engine can hold
    (property-tested in tests/test_subsumption.py)."""
    parts = conjuncts_of(pred)
    if not parts:
        return pred
    ivs, residual, _, false = _summarize(parts, schema)
    if false:
        return FALSE
    out = list(residual)
    for name in sorted(ivs):
        out.extend(_emit_atoms(name, ivs[name]))
    norm = _normal_nary(out, conj=True)
    return pred if E.canonical(norm) == E.canonical(pred) else norm


def _implied(ivs: dict, keys: set, atom: E.Expr, schema) -> bool:
    """Does the conjunct set summarized as (ivs, keys) imply ``atom``?
    Conservative: False means "could not prove", never "disproved"."""
    if E.canonical(atom) in keys:
        return True
    a = _numeric_atom(atom, schema)
    if a == "true":
        return True
    if a is None or a == "false":
        if (isinstance(atom, E.In) and schema.has(atom.col.name)):
            kind = schema.coltype(atom.col.name).kind
            if kind in _INT_BITS or kind == "f32":
                want = _in_keys(atom, kind)
                iv = ivs.get(atom.col.name)
                if want is not None and iv is not None:
                    if iv.get("eq") is not None and iv["eq"] in want:
                        return True
                    return any(s <= want for s in iv.get("ins", []))
        return False
    name, op, key = a
    iv = ivs.get(name)
    if iv is None:
        return False
    if iv["kind"] in _INT_BITS:
        # same inclusive normalization the summary side applied
        if op == ">":
            op, key = ">=", key + 1
        elif op == "<":
            op, key = "<=", key - 1

    def sat(x) -> bool:
        return {"<": x < key, "<=": x <= key, ">": x > key,
                ">=": x >= key, "==": x == key, "!=": x != key}[op]

    eq = iv.get("eq")
    if eq is not None:
        return sat(eq)
    if any(all(sat(x) for x in s) for s in iv.get("ins", [])):
        return True
    lo, hi = iv.get("lo"), iv.get("hi")
    if op in (">", ">="):
        return lo is not None and (
            lo[0] > key or (lo[0] == key and (lo[1] or op == ">=")))
    if op in ("<", "<="):
        return hi is not None and (
            hi[0] < key or (hi[0] == key and (hi[1] or op == "<=")))
    if op == "==":
        return (lo is not None and hi is not None
                and lo[0] == hi[0] == key and not lo[1] and not hi[1])
    # op == "!=": implied when the interval (or an explicit !=) excludes it
    if key in iv.get("neq", set()):
        return True
    if lo and (key < lo[0] or (key == lo[0] and lo[1])):
        return True
    return bool(hi and (key > hi[0] or (key == hi[0] and hi[1])))


def subsumption_residual(p: E.Expr, q: E.Expr,
                         schema) -> Optional[E.Expr]:
    """If ``p`` subsumes ``q`` — every row satisfying ``q`` satisfies
    ``p`` — return the residual predicate to apply on top of ``p``'s
    rows so that ``p ∧ residual ⟺ q`` (TRUE when q ⟺ p); else None.

    Decision is conservative over the interval-normalized conjunct
    sets: each conjunct of ``p`` must be provably implied by ``q``'s
    conjuncts (exact canonical match, interval containment, ==/In
    membership).  The residual keeps exactly the conjuncts of ``q``
    not already implied by ``p``."""
    p = normalize_intervals(canonicalize_expr(p), schema)
    q = normalize_intervals(canonicalize_expr(q), schema)
    if is_false(q):
        return FALSE                   # vacuous: q selects nothing
    q_parts = conjuncts_of(q)
    q_ivs, _, q_keys, q_false = _summarize(q_parts, schema)
    if q_false:
        return FALSE
    for conj in conjuncts_of(p):
        if not _implied(q_ivs, q_keys, conj, schema):
            return None
    p_ivs, _, p_keys, _ = _summarize(conjuncts_of(p), schema)
    resid = [cq for cq in q_parts
             if not _implied(p_ivs, p_keys, cq, schema)]
    return _normal_nary(resid, conj=True)


def subsumes(p: E.Expr, q: E.Expr, schema) -> bool:
    """True iff rows(q) ⊆ rows(p) is provable (``p`` weaker/equal)."""
    return subsumption_residual(p, q, schema) is not None


# ---------------------------------------------------------------------------
# plan canonicalization
# ---------------------------------------------------------------------------
def canonicalize_plan(node: L.Node) -> L.Node:
    """Rewrite ``node`` (bottom-up) into the plan normal form.

    Accepts anything :func:`logical.as_node` accepts (a Relation or a
    raw Node) and always returns a raw ``logical.Node``."""
    node = L.as_node(node)
    if node.children:
        node = node.with_children(
            tuple(canonicalize_plan(c) for c in node.children))
    if isinstance(node, L.Filter):
        pred = canonicalize_expr(node.pred)
        if is_true(pred):
            return node.child
        if isinstance(node.child, L.Filter):
            # merge stacked filters into one conjunction (their masks
            # compose by ∧ regardless of stacking order)
            merged = _normal_nary([pred, node.child.pred], conj=True)
            if is_true(merged):
                return node.child.child
            out: L.Node = replace(node.child, pred=merged)
        else:
            out = replace(node, pred=pred)
        # interval normal form needs column types — available here
        # (the child's schema), not in the schema-free expression pass
        pred = normalize_intervals(out.pred, out.child.schema)
        if is_true(pred):
            return out.child
        return out if pred is out.pred else replace(out, pred=pred)
    if isinstance(node, L.Project):
        # duplicate columns in a legacy hand-built Project denote the
        # same physical relation (executed Tables are dicts keyed by
        # column name, so duplicates collapse anyway); normalizing them
        # away here makes the fingerprint match the bytes actually
        # materialized.  The builder rejects duplicates outright.
        cols, seen = [], set()
        for c in node.cols:
            if c not in seen:
                seen.add(c)
                cols.append(c)
        child = node.child
        if isinstance(child, L.Project):
            child = child.child            # Project∘Project collapses
        if tuple(cols) == tuple(child.schema.names):
            return child                   # identity projection
        return replace(node, child=child, cols=tuple(cols))
    return node


# ---------------------------------------------------------------------------
# plan pretty-printer (Relation.explain_str / QueryHandle.explain)
# ---------------------------------------------------------------------------
def format_plan(node: L.Node, *, show_schema: bool = False) -> str:
    """Human-oriented plan rendering: one node per line, box-drawing
    tree rails, operator attributes inline, optionally each node's
    output schema."""
    node = L.as_node(node)
    lines: List[str] = []

    def detail(n: L.Node) -> str:
        if isinstance(n, L.Scan):
            parts = "" if n.parts is None else f" parts={list(n.parts)}"
            return f"Scan {n.table} [{n.fmt}]{parts}"
        if isinstance(n, L.CachedScan):
            return f"CachedScan ψ={n.psi.hex()[:12]}"
        if isinstance(n, L.Filter):
            return f"Filter {E.pretty(n.pred)}"
        if isinstance(n, L.Project):
            return f"Project {', '.join(n.cols)}"
        if isinstance(n, L.Join):
            keys = ", ".join(f"{a}={b}" for a, b in n.on)
            return f"Join [{keys}]"
        if isinstance(n, L.Aggregate):
            aggs = ", ".join(f"{o}={f}({c or '*'})" for o, f, c in n.aggs)
            by = ", ".join(n.group_by) or "()"
            return f"Aggregate by {by}: {aggs}"
        if isinstance(n, L.Sort):
            return f"Sort {n.by}{' desc' if n.desc else ''}"
        if isinstance(n, L.Limit):
            return f"Limit {n.n}"
        if isinstance(n, L.Union):
            return "Union"
        if isinstance(n, L.Cache):
            return f"Cache ψ={n.psi.hex()[:12]}"
        extra = ""
        if n.label == "fused":   # FusedPipeline without importing fuse
            extra = (f" {E.pretty(n.pred)} → {', '.join(n.cols)}"
                     if n.cols else f" {E.pretty(n.pred)}")
        return f"{type(n).__name__}{extra}"

    def walk(n: L.Node, prefix: str, tail: str) -> None:
        text = detail(n)
        if show_schema:
            text += f"   ⟨{', '.join(n.schema.names)}⟩"
        lines.append(prefix + text)
        kids = n.children
        for i, c in enumerate(kids):
            last = i == len(kids) - 1
            branch = tail + ("└─ " if last else "├─ ")
            walk(c, branch, tail + ("   " if last else "│  "))

    walk(node, "", "")
    return "\n".join(lines)

"""Scalar predicate / expression trees over columns.

Expressions are immutable, canonicalizable (for strict fingerprints and
OR-merge dedup), evaluable against a dict of torch column tensors, and
introspectable (column references) for projection augmentation and
selectivity estimation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, Tuple, Union

import numpy as np
import torch

Value = Union[int, float, str, bytes]

_OPS = ("<", "<=", ">", ">=", "==", "!=")


@dataclass(frozen=True)
class Col:
    name: str


@dataclass(frozen=True)
class Lit:
    value: Value


@dataclass(frozen=True)
class Cmp:
    """Binary comparison.  ``col`` is normally a :class:`Col`, but a
    reversed literal compare (``Lit op Col`` — "literal on the left",
    e.g. ``5 < price``) is representable too: canonicalization
    (relational.canonical) flips it to the column-on-left normal form,
    and every consumer that predates the flip (eval, kernel compile)
    normalizes on the fly via :func:`oriented`."""

    op: str
    col: Union[Col, Lit]
    rhs: Union[Lit, Col]

    def __post_init__(self):
        assert self.op in _OPS, self.op


# mirror the comparison when its operands are swapped (a < b ⟺ b > a)
MIRROR = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
          "==": "==", "!=": "!="}
# negate the comparison (¬(a < b) ⟺ a >= b)
NEGATE = {"<": ">=", "<=": ">", ">": "<=", ">=": "<",
          "==": "!=", "!=": "=="}


def oriented(e: Cmp) -> Cmp:
    """Normal orientation of a single compare: column-on-left for
    Lit/Col operands, and name-ordered sides for Col-Col compares (so
    ``a < b`` and ``b > a`` share one canonical form).  Identity for
    already-oriented compares; Lit-Lit compares are returned unchanged
    — constant folding handles them."""
    if isinstance(e.col, Lit) and isinstance(e.rhs, Col):
        return Cmp(MIRROR[e.op], e.rhs, e.col)
    if (isinstance(e.col, Col) and isinstance(e.rhs, Col)
            and e.rhs.name < e.col.name):
        return Cmp(MIRROR[e.op], e.rhs, e.col)
    return e


@dataclass(frozen=True)
class And:
    parts: Tuple["Expr", ...]


@dataclass(frozen=True)
class Or:
    parts: Tuple["Expr", ...]


@dataclass(frozen=True)
class Not:
    part: "Expr"


@dataclass(frozen=True)
class TrueExpr:
    pass


@dataclass(frozen=True)
class In:
    """List membership: ``col IN values`` (OR of equalities).

    A first-class node rather than a sugar expansion so the kernel
    compiler can emit one membership opcode instead of a (2k-1)-op
    OR chain, and so selectivity can price it as k/ndv directly.
    ``values`` is an ordered tuple of literals; canonicalization
    dedups and sorts it (empty → FALSE, singleton → ``==``)."""

    col: Col
    values: Tuple[Value, ...]


Expr = Union[Cmp, In, And, Or, Not, TrueExpr]
TRUE = TrueExpr()


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------
def col(name: str) -> Col:
    return Col(name)


def cmp(name: str, op: str, value: Value) -> Cmp:
    return Cmp(op, Col(name), Lit(value))


def col_cmp(left: str, op: str, right: str) -> Cmp:
    return Cmp(op, Col(left), Col(right))


def isin(name: str, values) -> In:
    return In(Col(name), tuple(values))


def and_(*parts: Expr) -> Expr:
    flat = []
    for p in parts:
        if isinstance(p, TrueExpr):
            continue
        flat.extend(p.parts if isinstance(p, And) else (p,))
    if not flat:
        return TRUE
    return flat[0] if len(flat) == 1 else And(tuple(flat))


def or_(*parts: Expr) -> Expr:
    flat = []
    for p in parts:
        if isinstance(p, TrueExpr):
            return TRUE
        flat.extend(p.parts if isinstance(p, Or) else (p,))
    # dedup by canonical form, preserving first-seen order
    seen, uniq = set(), []
    for p in flat:
        key = canonical(p)
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    if not uniq:
        return Not(TRUE)   # empty disjunction is FALSE (canonical.FALSE)
    return uniq[0] if len(uniq) == 1 else Or(tuple(uniq))


def not_(part: Expr) -> Expr:
    return Not(part)


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------
def canonical(e: Expr) -> tuple:
    """Deterministic hashable form (commutative parts sorted)."""
    if isinstance(e, TrueExpr):
        return ("true",)
    if isinstance(e, Cmp):
        e = oriented(e)
        if isinstance(e.col, Lit):   # Lit-Lit: constant, key on values
            return ("cmp2", e.op, _lit_key(e.col.value),
                    _lit_key(e.rhs.value))
        rhs = (("col", e.rhs.name) if isinstance(e.rhs, Col)
               else ("lit", _lit_key(e.rhs.value)))
        return ("cmp", e.op, e.col.name, rhs)
    if isinstance(e, In):
        return ("in", e.col.name,
                tuple(sorted({_lit_key(v) for v in e.values})))
    if isinstance(e, And):
        return ("and",) + tuple(sorted(canonical(p) for p in e.parts))
    if isinstance(e, Or):
        return ("or",) + tuple(sorted(canonical(p) for p in e.parts))
    if isinstance(e, Not):
        return ("not", canonical(e.part))
    raise TypeError(type(e))


def _lit_key(v: Value):
    if isinstance(v, bytes):
        return ("b", v)
    if isinstance(v, str):
        return ("b", v.encode("utf-8"))
    if isinstance(v, bool):
        return ("i", int(v))
    if isinstance(v, int):
        return ("i", v)
    return ("f", float(v))


def columns_of(e: Expr) -> FrozenSet[str]:
    if isinstance(e, TrueExpr):
        return frozenset()
    if isinstance(e, Cmp):
        cols = set()
        if isinstance(e.col, Col):
            cols.add(e.col.name)
        if isinstance(e.rhs, Col):
            cols.add(e.rhs.name)
        return frozenset(cols)
    if isinstance(e, In):
        return frozenset((e.col.name,))
    if isinstance(e, (And, Or)):
        out: FrozenSet[str] = frozenset()
        for p in e.parts:
            out |= columns_of(p)
        return out
    if isinstance(e, Not):
        return columns_of(e.part)
    raise TypeError(type(e))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------
def _encode_str(v: Value, width: int) -> np.ndarray:
    raw = v if isinstance(v, bytes) else str(v).encode("utf-8")
    buf = np.zeros((width,), np.uint8)
    raw = raw[:width]
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    return buf


_NP_DTYPES = {torch.int32: np.int32, torch.int64: np.int64,
              torch.float32: np.float32, torch.uint8: np.uint8}


def is_int_dtype(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and dtype != torch.bool


def as_lit(v: Value, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A literal as a 0-dim tensor of the column's dtype, cast the way
    ``jnp.asarray(v, dtype)`` casts it: an int outside the dtype's range
    raises OverflowError (never wraps), a float rounds through numpy."""
    if is_int_dtype(dtype):
        iv = int(v)
        info = torch.iinfo(dtype)
        if not info.min <= iv <= info.max:
            raise OverflowError(
                f"Python integer {iv} out of bounds for {dtype}")
        return torch.tensor(iv, dtype=dtype, device=device)
    with np.errstate(over="ignore"):
        fv = float(np.asarray(v, _NP_DTYPES[dtype]))
    return torch.tensor(fv, dtype=dtype, device=device)


def _full(columns: Dict[str, torch.Tensor], value: bool) -> torch.Tensor:
    first = next(iter(columns.values()))
    fill = torch.ones if value else torch.zeros
    return fill((first.shape[0],), dtype=torch.bool, device=first.device)


def eval_expr(e: Expr, columns: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Evaluate a predicate to a boolean row mask."""
    if isinstance(e, TrueExpr):
        return _full(columns, True)
    if isinstance(e, Cmp):
        e = oriented(e)
        if isinstance(e.col, Lit):   # Lit-Lit: constant boolean
            return _full(columns, const_cmp(e))
        lhs = columns[e.col.name]
        if isinstance(e.rhs, Col):
            rhs = columns[e.rhs.name]
        elif lhs.ndim == 2:  # string column: fixed-width byte compare
            rhs = torch.from_numpy(
                _encode_str(e.rhs.value, lhs.shape[1])).to(lhs.device)
            eq = (lhs == rhs[None, :]).all(dim=1)
            if e.op == "==":
                return eq
            if e.op == "!=":
                return ~eq
            raise ValueError(f"op {e.op} unsupported for string columns")
        else:
            v = e.rhs.value
            if (isinstance(v, float) and not v.is_integer()
                    and is_int_dtype(lhs.dtype)):
                # fractional threshold on an integer column: fold to an
                # exact integer compare (truncating the const would flip
                # <=/> at the edge; promoting to f32 is inexact > 2^24)
                folded = fold_int_cmp(
                    e.op, v, bits=torch.iinfo(lhs.dtype).bits)
                if folded[0] == "all":
                    return _full(columns, folded[1])
                _, op2, b = folded
                e = Cmp(op2, e.col, Lit(b))
                rhs = as_lit(b, lhs.dtype, lhs.device)
            else:
                rhs = as_lit(v, lhs.dtype, lhs.device)
        if lhs.ndim == 2 and isinstance(e.rhs, Col):
            eq = (lhs == rhs).all(dim=1)
            return eq if e.op == "==" else ~eq
        return {
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
            "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
        }[e.op](lhs, rhs)
    if isinstance(e, In):
        # OR of equalities, routed through the Cmp path per value so
        # string encoding / fractional-on-int folding stay identical;
        # values unrepresentable in an integer column never match
        lhs = columns[e.col.name]
        m = _full(columns, False)
        is_int = lhs.ndim == 1 and is_int_dtype(lhs.dtype)
        for v in e.values:
            if (is_int and isinstance(v, (int, float))
                    and not (isinstance(v, float) and not v.is_integer())):
                info = torch.iinfo(lhs.dtype)
                if not info.min <= int(v) <= info.max:
                    continue
            m = m | eval_expr(Cmp("==", e.col, Lit(v)), columns)
        return m
    if isinstance(e, And):
        m = eval_expr(e.parts[0], columns)
        for p in e.parts[1:]:
            m = m & eval_expr(p, columns)
        return m
    if isinstance(e, Or):
        m = eval_expr(e.parts[0], columns)
        for p in e.parts[1:]:
            m = m | eval_expr(p, columns)
        return m
    if isinstance(e, Not):
        return ~eval_expr(e.part, columns)
    raise TypeError(type(e))


def const_cmp(e: Cmp) -> bool:
    """Evaluate a Lit-Lit compare to its constant truth value.

    Cross-category operands (a number vs a string/bytes) are ordered
    by a fixed category rank (numbers before byte strings) rather than
    special-cased per operator: a mere "incomparables are unequal"
    fallback would NOT be closed under the operator complement — both
    ``<`` and its negation ``>=`` would fold to False — and the
    canonicalization pass (which folds ``Not(Cmp)`` via NEGATE) would
    then disagree with the un-canonicalized eval path."""
    a, b = e.col.value, e.rhs.value
    if isinstance(a, str):
        a = a.encode("utf-8")
    if isinstance(b, str):
        b = b.encode("utf-8")
    a_num, b_num = isinstance(a, (int, float)), isinstance(b, (int, float))
    if a_num != b_num:
        a, b = (0, 1) if a_num else (1, 0)
    return {
        "<": lambda: a < b, "<=": lambda: a <= b,
        ">": lambda: a > b, ">=": lambda: a >= b,
        "==": lambda: a == b, "!=": lambda: a != b,
    }[e.op]()


def fold_int_cmp(op: str, v: float, bits: int = 32):
    """Fold a fractional-threshold compare over an INTEGER column into
    an exact integer compare (promoting the column to f32 would be
    wrong beyond 2^24, where f32 cannot represent every int).

    Returns ("all", bool) when the result is constant, else
    ("cmp", op, int_bound) with the bound saturated to the column's
    ``bits``-wide signed integer range.

    This is the ONE shared fold: :func:`eval_expr`'s compare lowering,
    partition pruning (``partition._part_maybe``), and interval
    normalization (``canonical._numeric_atom``) all route through it,
    so the three sites cannot drift apart — the shared case table in
    ``tests/test_subsumption.py`` pins each call site to this helper's
    semantics.
    """
    if op == "==":
        return ("all", False)   # an integer never equals a fraction
    if op == "!=":
        return ("all", True)
    # c < 10.5 ⟺ c < 11;  c <= 10.5 ⟺ c <= 10;  etc.
    b = math.ceil(v) if op in ("<", ">=") else math.floor(v)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    if b < lo:
        return ("all", op in (">", ">="))
    if b > hi:
        return ("all", op in ("<", "<="))
    return ("cmp", op, int(b))


def pretty(e: Expr) -> str:
    if isinstance(e, TrueExpr):
        return "true"
    if isinstance(e, Cmp):
        lhs = e.col.name if isinstance(e.col, Col) else repr(e.col.value)
        rhs = e.rhs.name if isinstance(e.rhs, Col) else repr(e.rhs.value)
        return f"{lhs}{e.op}{rhs}"
    if isinstance(e, In):
        vals = ",".join(repr(v) for v in e.values)
        return f"{e.col.name} in [{vals}]"
    if isinstance(e, And):
        return "(" + " & ".join(pretty(p) for p in e.parts) + ")"
    if isinstance(e, Or):
        return "(" + " | ".join(pretty(p) for p in e.parts) + ")"
    if isinstance(e, Not):
        return f"!{pretty(e.part)}"
    raise TypeError(type(e))

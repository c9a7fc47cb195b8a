"""Merkle-tree plan fingerprints (paper §4.1, Definitions 1–3).

The fingerprint of a sub-tree is a cryptographic hash combining the
operator identifier of the root with the fingerprints of its children
(a modified Merkle / hash tree).  Two kinds of operator identifiers:

  * **loose**  — ``ID(u) = (u.label)`` for filter / project / input
    relation.  Different predicates or column lists therefore produce
    the SAME fingerprint, which is what later lets a *shared operator*
    subsume the variants (covering expression).
  * **strict** — ``ID(u) = (u.label, u.attributes)`` for every other
    operator (joins, unions, aggregates, sorts).  Those can only be
    shared when syntactically equal.

For commutative binary operators the child fingerprints are sorted
before hashing so that ``A join B`` and ``B join A`` are isomorphic
(same fingerprint), per the paper's remark under Definition 2.
"""
from __future__ import annotations

import hashlib
from typing import Dict

from .plan import PlanNode

Fingerprint = bytes  # 16-byte digest (truncated sha256)

_DIGEST_BYTES = 16


def _canon(obj: object) -> bytes:
    """Deterministic byte encoding of canonical attribute structures."""
    if obj is None:
        return b"\x00N"
    if isinstance(obj, bytes):
        return b"\x00B" + obj
    if isinstance(obj, str):
        return b"\x00S" + obj.encode("utf-8")
    if isinstance(obj, bool):
        return b"\x00b" + (b"1" if obj else b"0")
    if isinstance(obj, int):
        return b"\x00I" + str(obj).encode()
    if isinstance(obj, float):
        return b"\x00F" + repr(obj).encode()
    if isinstance(obj, (tuple, list)):
        return b"\x00T" + b"".join(_canon(x) for x in obj) + b"\x00t"
    if isinstance(obj, frozenset):
        parts = sorted(_canon(x) for x in obj)
        return b"\x00Z" + b"".join(parts) + b"\x00z"
    raise TypeError(f"unsupported canonical attr type: {type(obj)!r}")


def node_id(node: PlanNode) -> bytes:
    """Operator identifier ID(u) per Definition 1."""
    if node.loose:
        return _canon(node.label)
    return _canon(node.label) + _canon(node.strict_attrs)


def _h(data: bytes) -> Fingerprint:
    return hashlib.sha256(data).digest()[:_DIGEST_BYTES]


def _merkle(node: PlanNode, memo: Dict[int, Fingerprint],
            id_fn, salt: bytes) -> Fingerprint:
    """Shared iterative post-order Merkle walk (no recursion limits);
    ``id_fn`` picks the operator-identifier flavor (loose vs content)."""
    stack = [(node, False)]
    while stack:
        cur, expanded = stack.pop()
        if id(cur) in memo:
            continue
        if not expanded:
            stack.append((cur, True))
            for c in cur.children:
                if id(c) not in memo:
                    stack.append((c, False))
        else:
            child_fps = [memo[id(c)] for c in cur.children]
            if cur.commutative and len(child_fps) > 1:
                child_fps = sorted(child_fps)
            memo[id(cur)] = _h(salt + id_fn(cur) + b"|"
                               + b"|".join(child_fps))
    return memo[id(node)]


def fingerprint(node: PlanNode, memo: Dict[int, Fingerprint] | None = None) -> Fingerprint:
    """F(τ) per Definition 2."""
    if memo is None:
        memo = {}
    return _merkle(node, memo, node_id, b"")


def _content_id(node: PlanNode) -> bytes:
    """Operator identifier INCLUDING loose attributes.

    ψ is deliberately loose (Def. 1) so similar subexpressions share
    it — but that means ψ identifies a covering *structure*, not the
    covering *content*: two batches can produce the same ψ with
    different merged predicates / column sets.  Cross-batch reuse of a
    materialized CE therefore needs this stricter identity.  Loose
    nodes contribute ``content_attrs`` (e.g. a Filter's canonical
    predicate) when they define it; everything else falls back to
    ``strict_attrs``.
    """
    attrs = getattr(node, "content_attrs", None)
    if attrs is None:
        attrs = node.strict_attrs
    return _canon(node.label) + _canon(attrs)


def strict_fingerprint(node: PlanNode) -> Fingerprint:
    """Merkle fingerprint over full operator content (see _content_id).

    Same ψ + same strict fingerprint ⇒ the materialized bytes of one
    tree are a valid covering relation for the other.
    """
    return _merkle(node, {}, _content_id, b"strict|")


def all_fingerprints(node: PlanNode) -> Dict[int, Fingerprint]:
    """Fingerprints of every sub-tree of ``node``, keyed by ``id(sub)``."""
    memo: Dict[int, Fingerprint] = {}
    fingerprint(node, memo)
    return memo


def fingerprint_set(node: PlanNode) -> frozenset:
    """The set of fingerprints of all sub-trees (used for CE disjointness)."""
    return frozenset(all_fingerprints(node).values())

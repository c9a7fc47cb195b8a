"""Pure numpy/python reference interpreter for logical plans.

The port tests' ground truth: executes the same logical plans as the
port's engine with plain row-wise semantics.  Returns sorted row
multisets.  The same interpreter as ``oracle.py``, dispatching on the
port's logical classes.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.relational import expr as E, logical as L


def _pad_bytes(v, width: int) -> bytes:
    raw = v if isinstance(v, bytes) else str(v).encode()
    return raw[:width] + b"\x00" * max(0, width - len(raw))


def eval_pred(e: E.Expr, row: dict, schema) -> bool:
    if isinstance(e, E.TrueExpr):
        return True
    if isinstance(e, E.Cmp):
        lhs = row[e.col.name]
        rhs = (row[e.rhs.name] if isinstance(e.rhs, E.Col)
               else e.rhs.value)
        if isinstance(lhs, bytes):
            rhs = _pad_bytes(rhs, len(lhs))
            return lhs == rhs if e.op == "==" else lhs != rhs
        import operator as op

        return {"<": op.lt, "<=": op.le, ">": op.gt, ">=": op.ge,
                "==": op.eq, "!=": op.ne}[e.op](lhs, rhs)
    if isinstance(e, E.And):
        return all(eval_pred(p, row, schema) for p in e.parts)
    if isinstance(e, E.Or):
        return any(eval_pred(p, row, schema) for p in e.parts)
    if isinstance(e, E.Not):
        return not eval_pred(e.part, row, schema)
    raise TypeError(type(e))


def _rows_of(columns: Dict[str, np.ndarray], nrows: int, schema) -> List[dict]:
    out = []
    for i in range(nrows):
        row = {}
        for name, t in schema.fields:
            v = columns[name][i]
            if t.kind == "str":
                row[name] = bytes(np.asarray(v).tobytes())
            elif t.kind == "f32":
                row[name] = float(v)
            else:
                row[name] = int(v)
        out.append(row)
    return out


def execute_oracle(node: L.Node, catalog: Dict[str, tuple]) -> List[dict]:
    """catalog: table name -> (schema, nrows, typed numpy columns)."""
    if isinstance(node, (L.Scan,)):
        schema, nrows, cols = catalog[node.table]
        return _rows_of(cols, nrows, schema)
    if isinstance(node, L.Filter):
        rows = execute_oracle(node.child, catalog)
        return [r for r in rows
                if eval_pred(node.pred, r, node.child.schema)]
    if isinstance(node, L.Project):
        rows = execute_oracle(node.child, catalog)
        return [{c: r[c] for c in node.cols} for r in rows]
    if isinstance(node, L.Join):
        lrows = execute_oracle(node.left, catalog)
        rrows = execute_oracle(node.right, catalog)
        (lc, rc), = node.on
        if lrows and lc not in lrows[0]:
            lc, rc = rc, lc
        index: Dict[object, List[dict]] = {}
        for r in rrows:
            index.setdefault(r[rc], []).append(r)
        out = []
        for l in lrows:
            for r in index.get(l[lc], ()):  # inner equi-join
                out.append({**l, **r})
        return out
    if isinstance(node, L.Aggregate):
        rows = execute_oracle(node.child, catalog)
        groups: Dict[tuple, List[dict]] = {}
        for r in rows:
            groups.setdefault(tuple(r[g] for g in node.group_by),
                              []).append(r)
        out = []
        for key, members in groups.items():
            row = dict(zip(node.group_by, key))
            for out_name, fn, c in node.aggs:
                vals = [m[c] for m in members] if c else []
                if fn == "count":
                    row[out_name] = len(members)
                elif fn == "sum":
                    row[out_name] = sum(vals)
                elif fn == "min":
                    row[out_name] = min(vals)
                elif fn == "max":
                    row[out_name] = max(vals)
                elif fn == "mean":
                    row[out_name] = float(sum(vals)) / len(vals)
            out.append(row)
        return out
    if isinstance(node, L.Sort):
        rows = execute_oracle(node.child, catalog)
        return sorted(rows, key=lambda r: r[node.by], reverse=node.desc)
    if isinstance(node, L.Limit):
        return execute_oracle(node.child, catalog)[: node.n]
    if isinstance(node, L.Union):
        return (execute_oracle(node.left, catalog)
                + execute_oracle(node.right, catalog))
    raise TypeError(type(node))


def multiset(rows: List[dict], schema) -> List[tuple]:
    out = []
    for r in rows:
        t = []
        for name, ct in schema.fields:
            v = r[name]
            if ct.kind == "f32":
                v = round(float(v), 4)
            t.append(v)
        out.append(tuple(t))
    out.sort()
    return out

"""Public wrappers for the fused filter-scan kernels.

``compile_predicate`` lowers a relational Expr into the kernel's static
postfix program, ``compile_predicate_slots`` into its slotted plan-shape
form, and ``filter_mask`` / ``filter_mask_batch`` pad the columns to a
block multiple and run the kernel (CUDA tensors) or its plain torch
version (CPU tensors).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...relational import expr as E
from .kernel import (DEFAULT_BLOCK, EncodedProgram, filter_scan,
                     filter_scan_batch)
from .ref import PredProgram

_OPMAP = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "==": "eq",
          "!=": "ne"}


def compile_predicate(pred: E.Expr, col_names: Sequence[str]
                      ) -> PredProgram:
    """Relational Expr -> static postfix program over numeric columns.

    Supports col-const and col-col compares over i32/f32 columns (the
    program IR promotes mixed dtypes to f32 — see ref.PredProgram).
    String predicates raise ValueError; referencing a column outside
    ``col_names`` (e.g. a string column in a col-col compare) raises
    KeyError — callers pass the *numeric* column set so both cases fall
    back to the torch expression path.
    """
    idx = {n: i for i, n in enumerate(col_names)}
    prog: List[tuple] = []

    def walk(e: E.Expr):
        if isinstance(e, E.Cmp):
            e = E.oriented(e)
            if isinstance(e.col, E.Lit):
                raise ValueError("constant compare unsupported in kernel")
            if isinstance(e.rhs, E.Col):
                prog.append((_OPMAP[e.op] + "c", idx[e.col.name],
                             idx[e.rhs.name]))
                return
            v = e.rhs.value
            if isinstance(v, (bytes, str)):
                raise ValueError("string predicates unsupported in kernel")
            prog.append((_OPMAP[e.op], idx[e.col.name], v))
        elif isinstance(e, E.In):
            if any(isinstance(v, (bytes, str)) for v in e.values):
                raise ValueError("string membership unsupported in kernel")
            prog.append(("in", idx[e.col.name], tuple(e.values)))
        elif isinstance(e, E.And):
            walk(e.parts[0])
            for p in e.parts[1:]:
                walk(p)
                prog.append(("and",))
        elif isinstance(e, E.Or):
            walk(e.parts[0])
            for p in e.parts[1:]:
                walk(p)
                prog.append(("or",))
        elif isinstance(e, E.Not):
            walk(e.part)
            prog.append(("not",))
        else:
            raise ValueError(type(e))

    walk(pred)
    return tuple(prog)


def compile_predicate_slots(pred: E.Expr, col_names: Sequence[str],
                            kinds: Dict[str, str]
                            ) -> Tuple[PredProgram, tuple, tuple]:
    """Relational Expr -> SLOTTED postfix program + hoisted literals.

    The program is the predicate's *shape*: i32/f32 compare constants
    are replaced by ``("$i", j)`` / ``("$f", j)`` slot references and
    returned separately as ``(ivals, fvals)``, so every literal variant
    of one template compiles to the SAME static program (one trace, one
    plan-shape cache key) and a window of variants can evaluate as one
    batch.  Fractional-on-int folding runs here, against the column
    ``kinds`` ({name: "i32"|"i64"|"f32"}), so the slotted result is
    bit-identical to the literal program's trace-time fold.  ``In``
    values and i64 constants stay embedded (no 64-bit slot lane);
    unsupported predicates raise ValueError/KeyError like
    :func:`compile_predicate`.
    """
    idx = {n: i for i, n in enumerate(col_names)}
    prog: List[tuple] = []
    ivals: List[int] = []
    fvals: List[float] = []

    def walk(e: E.Expr):
        if isinstance(e, E.TrueExpr):
            prog.append(("const", True))
        elif isinstance(e, E.Cmp):
            e = E.oriented(e)
            if isinstance(e.col, E.Lit):
                raise ValueError("constant compare unsupported in kernel")
            if isinstance(e.rhs, E.Col):
                prog.append((_OPMAP[e.op] + "c", idx[e.col.name],
                             idx[e.rhs.name]))
                return
            v = e.rhs.value
            if isinstance(v, (bytes, str)):
                raise ValueError("string predicates unsupported in kernel")
            kind = kinds[e.col.name]
            ci = idx[e.col.name]
            opn = _OPMAP[e.op]
            if kind in ("i32", "i64"):
                if isinstance(v, float) and not v.is_integer():
                    folded = E.fold_int_cmp(
                        e.op, v, bits=64 if kind == "i64" else 32)
                    if folded[0] == "all":
                        prog.append(("const", folded[1]))
                        return
                    _, opsym, v = folded
                    opn = _OPMAP[opsym]
                v = int(v)
                if kind == "i64":
                    # i64 consts stay literal in the (static) program
                    prog.append((opn, ci, v))
                    return
                if not -(2 ** 31) <= v <= 2 ** 31 - 1:
                    raise ValueError("const exceeds int32 slot range")
                prog.append((opn, ci, ("$i", len(ivals))))
                ivals.append(v)
            else:
                prog.append((opn, ci, ("$f", len(fvals))))
                fvals.append(float(v))
        elif isinstance(e, E.In):
            if any(isinstance(v, (bytes, str)) for v in e.values):
                raise ValueError("string membership unsupported in kernel")
            kinds[e.col.name]   # KeyError for non-numeric columns
            prog.append(("in", idx[e.col.name], tuple(e.values)))
        elif isinstance(e, E.And):
            walk(e.parts[0])
            for p in e.parts[1:]:
                walk(p)
                prog.append(("and",))
        elif isinstance(e, E.Or):
            walk(e.parts[0])
            for p in e.parts[1:]:
                walk(p)
                prog.append(("or",))
        elif isinstance(e, E.Not):
            walk(e.part)
            prog.append(("not",))
        else:
            raise ValueError(type(e))

    walk(pred)
    return tuple(prog), tuple(ivals), tuple(fvals)


def pack_consts(ival_rows: Sequence[tuple], fval_rows: Sequence[tuple]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-query hoisted literals into the kernel's ``(n_q, k)``
    operand arrays (k >= 1 so an unused const class still has a lane)."""
    n_q = len(ival_rows)
    ki = max(max((len(r) for r in ival_rows), default=0), 1)
    kf = max(max((len(r) for r in fval_rows), default=0), 1)
    ic = np.zeros((n_q, ki), np.int32)
    fc = np.zeros((n_q, kf), np.float32)
    for q, row in enumerate(ival_rows):
        ic[q, : len(row)] = row
    for q, row in enumerate(fval_rows):
        fc[q, : len(row)] = row
    return ic, fc


def kernel_supports(pred: E.Expr,
                    numeric_cols: Sequence[str] | None = None) -> bool:
    """Can this predicate run through the fused kernel?

    Pass ``numeric_cols`` (the schema's i32/f32 column names) whenever
    a schema is at hand: without it, a col-col compare over *string*
    columns is indistinguishable from a numeric one (names carry no
    dtype) and would be reported as supported.
    """
    cols = (list(numeric_cols) if numeric_cols is not None
            else list(E.columns_of(pred)))
    try:
        compile_predicate(pred, cols)
        return True
    except (ValueError, KeyError):
        return False


def _pad_rows(columns: Sequence[torch.Tensor], block: int):
    """Columns zero-padded (and made contiguous) to a block multiple."""
    n = columns[0].shape[0]
    padded_n = ((n + block - 1) // block) * block
    out = []
    for c in columns:
        if padded_n != n:
            c = torch.cat([c, c.new_zeros((padded_n - n,) + c.shape[1:])])
        out.append(c.contiguous())
    return tuple(out), n


def filter_mask(columns: Sequence[torch.Tensor], program: PredProgram,
                nrows: int, *, block: int = DEFAULT_BLOCK,
                use_pallas: bool = True,
                encoded: Optional[EncodedProgram] = None):
    """mask+counts of a literal program (padding columns to a block
    multiple): the ``filter_scan`` kernel on CUDA tensors.

    ``use_pallas`` keeps the JAX package's signature: there it picks
    the Pallas kernel or the XLA oracle, which compute the same
    function; here both values launch the kernel on CUDA tensors (and
    run the plain version on CPU tensors)."""
    columns, n = _pad_rows(columns, block)
    mask, counts = filter_scan(columns, program, nrows, block=block,
                               encoded=encoded)
    return mask[:n], counts


def filter_mask_batch(columns: Sequence[torch.Tensor],
                      program: PredProgram, nrows: int,
                      iconsts, fconsts, *, block: int = DEFAULT_BLOCK,
                      use_pallas: bool = True,
                      encoded: Optional[EncodedProgram] = None):
    """n-query masks+counts in ONE launch over shared columns: the
    ``filter_scan_batch`` kernel on CUDA tensors, whatever
    ``use_pallas`` says (see :func:`filter_mask`).  ``iconsts`` /
    ``fconsts`` may be numpy arrays (``pack_consts``) or tensors."""
    columns, n = _pad_rows(columns, block)
    dev = columns[0].device
    iconsts = torch.as_tensor(np.asarray(iconsts, np.int32)).to(dev)
    fconsts = torch.as_tensor(np.asarray(fconsts, np.float32)).to(dev)
    mask, counts = filter_scan_batch(columns, program, nrows, iconsts,
                                     fconsts, block=block, encoded=encoded)
    return mask[:, :n], counts

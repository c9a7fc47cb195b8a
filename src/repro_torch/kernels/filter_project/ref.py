"""Plain torch versions of the fused filter-scan kernels.

These are what the kernel wrappers run for a CPU tensor, and what
``chip_smoke.py`` holds the CUDA kernels against on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ...relational.expr import as_lit, fold_int_cmp, is_int_dtype

# Predicate program IR (static): postfix ops over a stack.
#   ("lt"|"le"|"gt"|"ge"|"eq"|"ne", col_idx, const)    -> push col OP const
#   ("ltc"|"lec"|"gtc"|"gec"|"eqc"|"nec", ia, ib)      -> push col_a OP col_b
#   ("in", col_idx, values)                            -> push membership
#   ("const", bool)                                    -> push constant mask
#   ("and",) / ("or",)                                 -> pop 2, push
#   ("not",)                                           -> pop 1, push
# A float const with a fractional part against an integer column folds
# into an exact integer compare (f32 promotion would be inexact beyond
# 2^24); col-col compares over mixed dtypes promote both sides to f32.
#
# SLOTTED programs (the plan-shape form): the const position of a
# compare may instead be ``("$i", j)`` / ``("$f", j)`` — a reference
# into the runtime ``iconsts`` / ``fconsts`` operand tensors, ``(n_q, k)``
# for a window of n_q queries evaluated in one pass over the columns.
PredProgram = Tuple[tuple, ...]

_CMP = {
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
}

# col-col variants -> base compare op
_CMP_CC = {k + "c": k for k in _CMP}

# kernel opcode <-> relational op symbol (for constant folding)
_CMP_OPSYM = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
              "eq": "==", "ne": "!="}
_SYM_CMP = {v: k for k, v in _CMP_OPSYM.items()}


def eval_program(program: PredProgram, cols: Sequence[torch.Tensor],
                 iconsts: Optional[torch.Tensor] = None,
                 fconsts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluate a postfix program to a bool mask: ``(N,)`` for a literal
    program, ``(n_q, N)`` when slot operand tensors are given."""
    n = cols[0].shape[0]
    device = cols[0].device
    bshape = (n,) if iconsts is None else (iconsts.shape[0], n)

    def full(value: bool) -> torch.Tensor:
        fill = torch.ones if value else torch.zeros
        return fill(bshape, dtype=torch.bool, device=device)

    stack = []
    for op in program:
        if op[0] in _CMP:
            _, idx, const = op
            c = cols[idx]
            if isinstance(const, tuple):   # slot reference
                arr = iconsts if const[0] == "$i" else fconsts
                v = arr[:, const[1]][:, None]   # (n_q, 1) row consts
                stack.append(_CMP[op[0]](c, v))
                continue
            if (isinstance(const, float) and not float(const).is_integer()
                    and is_int_dtype(c.dtype)):
                folded = fold_int_cmp(_CMP_OPSYM[op[0]], float(const),
                                      bits=torch.iinfo(c.dtype).bits)
                if folded[0] == "all":
                    stack.append(full(folded[1]))
                    continue
                _, opsym, b = folded
                stack.append(_CMP[_SYM_CMP[opsym]](
                    c, as_lit(b, c.dtype, device)))
                continue
            stack.append(_CMP[op[0]](c, as_lit(const, c.dtype, device)))
        elif op[0] == "in":
            _, idx, values = op
            c = cols[idx]
            m = torch.zeros(c.shape, dtype=torch.bool, device=device)
            is_int = is_int_dtype(c.dtype)
            info = torch.iinfo(c.dtype) if is_int else None
            for v in values:
                if is_int and isinstance(v, float):
                    if not float(v).is_integer():
                        continue            # an int never equals a fraction
                    v = int(v)
                if is_int and not (info.min <= int(v) <= info.max):
                    continue                # out of range: never equal
                m = m | (c == as_lit(v, c.dtype, device))
            stack.append(m)
        elif op[0] == "const":
            stack.append(full(bool(op[1])))
        elif op[0] in _CMP_CC:
            _, ia, ib = op
            a, b = cols[ia], cols[ib]
            if a.dtype != b.dtype:
                a, b = a.to(torch.float32), b.to(torch.float32)
            stack.append(_CMP[_CMP_CC[op[0]]](a, b))
        elif op[0] == "and":
            b, a = stack.pop(), stack.pop()
            stack.append(a & b)
        elif op[0] == "or":
            b, a = stack.pop(), stack.pop()
            stack.append(a | b)
        elif op[0] == "not":
            stack.append(~stack.pop())
        else:
            raise ValueError(op)
    (mask,) = stack
    return mask.expand(bshape)


def filter_scan_ref(columns: Sequence[torch.Tensor], program: PredProgram,
                    nrows: int, block: int = 1024
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (mask bool (N,), per-block selected counts (N//block,))."""
    n = columns[0].shape[0]
    mask = eval_program(program, columns)
    live = torch.arange(n, device=mask.device) < nrows
    mask = mask & live
    counts = mask.reshape(n // block, block).sum(dim=1, dtype=torch.int32)
    return mask, counts


def filter_scan_batch_ref(columns: Sequence[torch.Tensor],
                          program: PredProgram, nrows: int,
                          iconsts: torch.Tensor, fconsts: torch.Tensor,
                          block: int = 1024
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched version: one pass over the columns evaluates a SLOTTED
    program for every row of the const tensors at once.

    Returns (mask bool (n_q, N), per-block counts (n_q, N//block)).
    """
    n = columns[0].shape[0]
    n_q = iconsts.shape[0]
    mask = eval_program(program, columns, iconsts=iconsts, fconsts=fconsts)
    live = torch.arange(n, device=mask.device)[None, :] < nrows
    mask = mask & live
    counts = mask.reshape(n_q, n // block, block).sum(dim=2,
                                                      dtype=torch.int32)
    return mask, counts


def parse_i32_ref(digits: torch.Tensor) -> torch.Tensor:
    """(n, 10) uint8 zero-padded decimal digits -> int32."""
    pows = torch.tensor([10**k for k in range(9, -1, -1)],
                        dtype=torch.int64, device=digits.device)
    return ((digits.to(torch.int64) - 48) * pows).sum(dim=1).to(torch.int32)

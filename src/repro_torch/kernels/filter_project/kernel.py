"""Fused columnar filter-scan and CSV-decode kernels for Hopper (CUDA
C++, ``csrc/``).

The predicate program is encoded on the host into a small bytecode
(:func:`encode_program`) that one compiled kernel interprets, R rows a
thread, so ``nvcc`` runs once for every program the engine produces;
the host picks the compiled variant whose register stack holds the
program's depth, and how many queries of a window a thread evaluates
at once (:func:`kernel_variant`).  The wrappers
:func:`filter_scan` and :func:`filter_scan_batch` launch that kernel for
CUDA tensors, and :func:`parse_fields` (with its one-field forms
:func:`parse_i32` / :func:`parse_f32`) the fixed-width field decoder of
``csrc/csv_parse.cu``, which decodes every field it is given in one
pass over the rows; each takes the plain torch version in ``ref.py``
only for CPU tensors.  Each launch adds one to its wrapper's entry in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...relational.expr import fold_int_cmp
from .. import _build
from .ref import (_CMP_OPSYM, _SYM_CMP, PredProgram, filter_scan_batch_ref,
                  filter_scan_ref, parse_f32_ref, parse_fields_ref,
                  parse_i32_ref)

DEFAULT_BLOCK = 2048   # rows per count-block
MAX_COLS = 16          # predicate columns one launch can read
MAX_STACK = 64         # boolean stack depth
ROWS_PER_THREAD = 16   # rows a thread interprets at once (compiled in)
QUERIES_PER_PASS = 4   # queries of a window a thread evaluates at once
MAX_FIELDS = 32        # CSV fields one decoder launch takes

_SOURCE = Path(__file__).resolve().parent / "csrc" / "filter_scan.cu"
_CSV_SOURCE = Path(__file__).resolve().parent / "csrc" / "csv_parse.cu"

# opcodes: keep in step with enum Op in csrc/filter_scan.cu
OP_CMP_INT_LIT, OP_CMP_F32_LIT, OP_CMP_SLOT_I, OP_CMP_SLOT_F = 0, 1, 2, 3
OP_CMP_CC_INT, OP_CMP_CC_F32, OP_IN_INT, OP_IN_F32 = 4, 5, 6, 7
OP_CONST, OP_AND, OP_OR, OP_NOT = 8, 9, 10, 11
_CMP_CODE = {"lt": 0, "le": 1, "gt": 2, "ge": 3, "eq": 4, "ne": 5}
_CMP_NAME = {v: k for k, v in _CMP_CODE.items()}
_TYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2}

LAUNCHES = {"filter_scan": 0, "filter_scan_batch": 0, "parse_fields": 0,
            "parse_i32": 0, "parse_f32": 0}
# the same launches by (wrapper name, device): a row-sharded scan
# launches on every shard's card
LAUNCHES_BY_DEVICE: Dict[Tuple[str, str], int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_DEVICE.clear()


def _count(name: str, dev: torch.device) -> None:
    LAUNCHES[name] += 1
    key = (name, str(dev))
    LAUNCHES_BY_DEVICE[key] = LAUNCHES_BY_DEVICE.get(key, 0) + 1


@dataclass(frozen=True)
class EncodedProgram:
    """A predicate program as the kernel reads it: ``words`` is an
    ``(n_ins, 4)`` int32 ``[op, cmp, a, b]`` table, ``lit_i`` / ``lit_f``
    hold the int64 / f32 literals (compare constants and In-list values),
    all on ``device``."""

    words: torch.Tensor
    lit_i: torch.Tensor
    lit_f: torch.Tensor
    col_types: Tuple[int, ...]
    # slot lanes the program reads: iconsts / fconsts need this many
    # columns (0 for a literal program)
    n_islots: int
    n_fslots: int
    # the most entries the program's boolean stack holds at once
    max_depth: int = 1

    @property
    def has_slots(self) -> bool:
        return bool(self.n_islots or self.n_fslots)


def _f32(v) -> float:
    with np.errstate(over="ignore"):
        return float(np.float32(v))


def encode_program(program: PredProgram, dtypes: Sequence[torch.dtype],
                   device: torch.device) -> EncodedProgram:
    """Encode ``program`` over columns of ``dtypes`` for the kernel.

    Every fold the plain version makes is made here, on the host, so
    the kernel only runs exact compares: fractional thresholds on int
    columns fold through ``fold_int_cmp`` (a constant outcome becomes
    ``const``), int literals must fit the column's dtype (OverflowError
    otherwise, as the plain version's cast raises), f32 literals round
    to f32, and In-lists on int columns drop fractional and out-of-range
    values.  Raises RuntimeError for what the kernel cannot run (too
    many columns, a stack deeper than 64, a malformed program).
    """
    if len(dtypes) > MAX_COLS:
        raise RuntimeError(f"{len(dtypes)} predicate columns exceed the "
                           f"kernel's {MAX_COLS}")
    types = []
    for dt in dtypes:
        if dt not in _TYPE_CODE:
            raise RuntimeError(f"column dtype {dt} unsupported by kernel")
        types.append(_TYPE_CODE[dt])
    words, lit_i, lit_f = [], [], []
    depth = max_depth = 0
    n_slots = {"$i": 0, "$f": 0}

    def col(a) -> int:
        if not 0 <= a < len(types):
            raise RuntimeError(f"column index {a} out of range")
        return a

    def push(word):
        nonlocal depth, max_depth
        words.append(word)
        depth += 1
        max_depth = max(max_depth, depth)

    for op in program:
        name = op[0]
        if name in _CMP_CODE:
            _, a, const = op
            is_int = types[col(a)] != 2
            if isinstance(const, tuple):
                n_slots[const[0]] = max(n_slots[const[0]], const[1] + 1)
                code = OP_CMP_SLOT_I if const[0] == "$i" else OP_CMP_SLOT_F
                push((code, _CMP_CODE[name], a, const[1]))
                continue
            if is_int:
                if isinstance(const, float) and not const.is_integer():
                    bits = 32 if types[a] == 0 else 64
                    folded = fold_int_cmp(_CMP_OPSYM[name], const, bits=bits)
                    if folded[0] == "all":
                        push((OP_CONST, int(folded[1]), 0, 0))
                        continue
                    _, opsym, const = folded
                    name = _SYM_CMP[opsym]
                info = torch.iinfo(dtypes[a])
                iv = int(const)
                if not info.min <= iv <= info.max:
                    raise OverflowError(
                        f"Python integer {iv} out of bounds for {dtypes[a]}")
                push((OP_CMP_INT_LIT, _CMP_CODE[name], a, len(lit_i)))
                lit_i.append(iv)
            else:
                push((OP_CMP_F32_LIT, _CMP_CODE[name], a, len(lit_f)))
                lit_f.append(_f32(const))
        elif name in ("ltc", "lec", "gtc", "gec", "eqc", "nec"):
            _, a, b = op
            col(a), col(b)
            both_int = types[a] != 2 and types[b] != 2
            code = (OP_CMP_CC_INT if both_int and types[a] == types[b]
                    else OP_CMP_CC_F32)
            push((code, _CMP_CODE[name[:-1]], a, b))
        elif name == "in":
            _, a, values = op
            if types[col(a)] != 2:
                info = torch.iinfo(dtypes[a])
                vals = []
                for v in values:
                    if isinstance(v, float):
                        if not v.is_integer():
                            continue      # an int never equals a fraction
                        v = int(v)
                    if info.min <= int(v) <= info.max:
                        vals.append(int(v))
                push((OP_IN_INT, len(vals), a, len(lit_i)))
                lit_i.extend(vals)
            else:
                vals = [_f32(v) for v in values]
                push((OP_IN_F32, len(vals), a, len(lit_f)))
                lit_f.extend(vals)
        elif name == "const":
            push((OP_CONST, int(bool(op[1])), 0, 0))
        elif name in ("and", "or"):
            if depth < 2:
                raise RuntimeError(f"malformed program at {op}")
            words.append((OP_AND if name == "and" else OP_OR, 0, 0, 0))
            depth -= 1
        elif name == "not":
            if depth < 1:
                raise RuntimeError(f"malformed program at {op}")
            words.append((OP_NOT, 0, 0, 0))
        else:
            raise RuntimeError(f"unknown opcode {op}")
    if depth != 1:
        raise RuntimeError(f"malformed program: final stack depth {depth}")
    if max_depth > MAX_STACK:
        raise RuntimeError(f"predicate stack depth {max_depth} exceeds the "
                           f"kernel's {MAX_STACK}")
    # tables are never empty, so every pointer the kernel gets is valid
    return EncodedProgram(
        words=torch.tensor(words, dtype=torch.int32, device=device),
        lit_i=torch.tensor(lit_i or [0], dtype=torch.int64, device=device),
        lit_f=torch.tensor(lit_f or [0.0], dtype=torch.float32,
                           device=device),
        col_types=tuple(types), n_islots=n_slots["$i"],
        n_fslots=n_slots["$f"], max_depth=max_depth)


def kernel_variant(max_depth: int, n_q: int = 1) -> Tuple[int, int]:
    """The compiled variant ``(W, G)`` that runs a program of stack depth
    ``max_depth`` for ``n_q`` queries.  A stack entry is a lane mask of
    ROWS_PER_THREAD bits; W is the number of 64-bit words below the
    stack's top (the kernel pushes one empty entry under the first leaf,
    so they hold ``max_depth`` entries), the least power of two that
    holds them; G is the number of queries a thread evaluates at once,
    each with its own stack (QUERIES_PER_PASS when there are that many
    and W is 1 or 2, else 1)."""
    if not 1 <= max_depth <= MAX_STACK:
        raise ValueError(f"stack depth {max_depth} outside 1..{MAX_STACK}")
    words = 1
    while 64 * words < max_depth * ROWS_PER_THREAD:
        words *= 2
    queries = QUERIES_PER_PASS if n_q >= QUERIES_PER_PASS and words <= 2 \
        else 1
    return words, queries


def decode_program(enc: EncodedProgram) -> PredProgram:
    """The program an encoding runs, in the postfix IR (after folding)."""
    lit_i = enc.lit_i.cpu().tolist()
    lit_f = enc.lit_f.cpu().tolist()
    prog = []
    for op, c, a, b in enc.words.cpu().tolist():
        if op == OP_CMP_INT_LIT:
            prog.append((_CMP_NAME[c], a, lit_i[b]))
        elif op == OP_CMP_F32_LIT:
            prog.append((_CMP_NAME[c], a, lit_f[b]))
        elif op in (OP_CMP_SLOT_I, OP_CMP_SLOT_F):
            slot = "$i" if op == OP_CMP_SLOT_I else "$f"
            prog.append((_CMP_NAME[c], a, (slot, b)))
        elif op in (OP_CMP_CC_INT, OP_CMP_CC_F32):
            prog.append((_CMP_NAME[c] + "c", a, b))
        elif op == OP_IN_INT:
            prog.append(("in", a, tuple(lit_i[b:b + c])))
        elif op == OP_IN_F32:
            prog.append(("in", a, tuple(lit_f[b:b + c])))
        elif op == OP_CONST:
            prog.append(("const", bool(c)))
        else:
            prog.append(({OP_AND: "and", OP_OR: "or", OP_NOT: "not"}[op],))
    return tuple(prog)


_LIB: Optional[ctypes.CDLL] = None
_CSV_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ptrs = ctypes.POINTER(ctypes.c_longlong)
        types = ctypes.POINTER(ctypes.c_int)
        lib.filter_scan_launch.argtypes = [
            ptrs, types, i, p, i, p, i, p, i, ll, ll, i, i, p, p, p]
        lib.filter_scan_launch.restype = i
        lib.filter_scan_batch_launch.argtypes = [
            ptrs, types, i, p, i, p, i, p, i, p, i, p, i, i, ll, ll, i, i, i,
            p, p, p]
        lib.filter_scan_batch_launch.restype = i
        _LIB = lib
    return _LIB


def _csv_lib() -> ctypes.CDLL:
    global _CSV_LIB
    if _CSV_LIB is None:
        lib = _build.load(_CSV_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ints = ctypes.POINTER(ctypes.c_int)
        lib.parse_fields_launch.argtypes = [
            p, ll, ll, p, p, i, ints, ints, ctypes.POINTER(p), i, p, i, i,
            ll, p]
        lib.parse_fields_launch.restype = i
        _CSV_LIB = lib
    return _CSV_LIB


def _check_columns(columns: Sequence[torch.Tensor], block: int) -> int:
    dev = columns[0].device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev.type}")
    n = columns[0].shape[0]
    for c in columns:
        if c.device != dev or c.ndim != 1 or c.shape[0] != n:
            raise ValueError("columns must be 1-D, of one length, on one "
                             "device")
        if not c.is_contiguous():
            raise ValueError("kernel columns must be contiguous")
        if c.dtype not in _TYPE_CODE:
            raise ValueError(f"column dtype {c.dtype} unsupported")
    if n % block:
        raise ValueError(f"N={n} is not a multiple of block={block}")
    return n


def _col_args(columns, enc: EncodedProgram):
    n_cols = len(columns)
    ptrs = (ctypes.c_longlong * n_cols)(*[c.data_ptr() for c in columns])
    types = (ctypes.c_int * n_cols)(*enc.col_types)
    return ptrs, types, n_cols


def _check_launch(rc: int, name: str) -> None:
    if rc == -1:
        raise RuntimeError("program and query count exceed the kernel's "
                           "shared memory")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def filter_scan(columns: Sequence[torch.Tensor], program: PredProgram,
                nrows: int, *, block: int = DEFAULT_BLOCK,
                encoded: Optional[EncodedProgram] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked fused predicate scan of a LITERAL program.

    Args:
      columns: (N,) int32/int64/float32 columns, N % block == 0.
      program: postfix predicate program (see ref.PredProgram).
      nrows: live row count (rows beyond it never match).
      encoded: the program's encoding for these columns, when cached.
    Returns:
      (mask bool (N,), per-block counts int32 (N//block,)).
    """
    if columns[0].device.type == "cpu":
        return filter_scan_ref(columns, program, nrows, block)
    _check_columns(columns, block)
    dev = columns[0].device
    enc = encoded or encode_program(program, [c.dtype for c in columns], dev)
    if enc.has_slots:
        raise ValueError("filter_scan takes a literal program; slotted "
                         "programs go through filter_scan_batch")
    mask, counts = _launch(columns, enc, nrows, block, None)
    return mask[0], counts[0]


def filter_scan_batch(columns: Sequence[torch.Tensor],
                      program: PredProgram, nrows: int,
                      iconsts: torch.Tensor, fconsts: torch.Tensor, *,
                      block: int = DEFAULT_BLOCK,
                      encoded: Optional[EncodedProgram] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-batched fused predicate scan: n queries, ONE launch.

    Args:
      columns: (N,) numeric columns, N % block == 0.
      program: SLOTTED postfix program (see ref.PredProgram).
      nrows: live row count (rows beyond it never match).
      iconsts / fconsts: (n_q, k_i) int32 / (n_q, k_f) float32 operand
        tensors on the columns' device (k >= 1).
      encoded: the program's encoding for these columns, when cached.
    Returns:
      (mask bool (n_q, N), per-block counts int32 (n_q, N//block)).
    """
    if columns[0].device.type == "cpu":
        return filter_scan_batch_ref(columns, program, nrows, iconsts,
                                     fconsts, block)
    _check_columns(columns, block)
    dev = columns[0].device
    if (iconsts.dtype != torch.int32 or fconsts.dtype != torch.float32
            or iconsts.ndim != 2 or fconsts.ndim != 2
            or iconsts.shape[0] != fconsts.shape[0]
            or iconsts.device != dev or fconsts.device != dev):
        raise ValueError("iconsts/fconsts must be (n_q, k) int32/float32 "
                         "tensors on the columns' device")
    iconsts, fconsts = iconsts.contiguous(), fconsts.contiguous()
    enc = encoded or encode_program(program, [c.dtype for c in columns], dev)
    if (iconsts.shape[1] < enc.n_islots or fconsts.shape[1] < enc.n_fslots):
        raise ValueError("operand tensors have fewer lanes than the "
                         "program's slots")
    return _launch(columns, enc, nrows, block, (iconsts, fconsts))


def _launch(columns, enc: EncodedProgram, nrows: int, block: int,
            consts: Optional[Tuple[torch.Tensor, torch.Tensor]]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the filter kernel on checked inputs: the literal
    program (``consts`` None, counted as ``filter_scan``) or the slotted
    one for the ``(iconsts, fconsts)`` operand rows
    (``filter_scan_batch``).  Returns (mask bool (n_q, N), counts int32
    (n_q, N // block)), n_q = 1 for a literal program."""
    dev = columns[0].device
    n = columns[0].shape[0]
    n_q = 1 if consts is None else consts[0].shape[0]
    mask = torch.empty((n_q, n), dtype=torch.bool, device=dev)
    counts = torch.empty((n_q, n // block), dtype=torch.int32, device=dev)
    ptrs, types, n_cols = _col_args(columns, enc)
    words, queries = kernel_variant(enc.max_depth, n_q)
    program = (ptrs, types, n_cols, enc.words.data_ptr(), enc.words.shape[0],
               enc.lit_i.data_ptr(), enc.lit_i.numel(), enc.lit_f.data_ptr(),
               enc.lit_f.numel())
    shape = (n, int(nrows), block, words)
    out = (mask.data_ptr(), counts.data_ptr())
    if consts is None:
        name = "filter_scan"
        rc = _build.launch_on(dev, _lib().filter_scan_launch,
                              program + shape + out)
    else:
        name = "filter_scan_batch"
        ic, fc = consts
        rc = _build.launch_on(dev, _lib().filter_scan_batch_launch, program + (
            ic.data_ptr(), ic.shape[1], fc.data_ptr(), fc.shape[1], n_q)
            + shape + (queries,) + out)
    _check_launch(rc, name)
    _count(name, dev)
    return mask, counts


_FIELD_DTYPE = {10: torch.int32, 8: torch.float32}
_MAX_PLAN_WORDS = 4096    # words of a period one decoder launch stages
_PLANS: Dict[tuple, tuple] = {}


@dataclass(frozen=True)
class FieldPlan:
    """Where the decoder finds fields ``(byte offset, width)`` of rows
    ``stride`` bytes apart from a 16-byte aligned base.  The layout
    repeats on 16-byte word boundaries every ``period_rows`` rows
    (``16 / gcd(stride, 16)``), ``period_words`` words apart; ``words``
    are the words of a period (counted from its first byte, ascending)
    that hold a field byte, which the kernel stages packed, in this
    order; ``at[j * n_fields + f]`` is where field f of the period's row
    j starts in the packed words, in bytes.  A field's bytes are
    contiguous there: its two words are consecutive in ``words``."""

    period_rows: int
    period_words: int
    words: Tuple[int, ...]
    at: Tuple[int, ...]


def field_word_plan(stride: int, fields: Sequence[Tuple[int, int]]
                    ) -> FieldPlan:
    """The decoder's plan for ``fields`` of rows ``stride`` bytes apart
    (see :class:`FieldPlan`)."""
    rows = 16 // math.gcd(stride, 16)
    starts = [r * stride + off for r in range(rows) for off, _ in fields]
    ends = [r * stride + off + w for r in range(rows) for off, w in fields]
    words = sorted({w for a, b in zip(starts, ends)
                    for w in range(a // 16, (b - 1) // 16 + 1)})
    index = {w: k for k, w in enumerate(words)}
    return FieldPlan(rows, rows * stride // 16, tuple(words),
                     tuple(16 * index[a // 16] + a % 16 for a in starts))


@functools.lru_cache(maxsize=256)
def _field_groups(stride: int, fields: Tuple[Tuple[int, int], ...]):
    """``fields`` cut into runs of at most MAX_FIELDS fields whose plans
    stage at most _MAX_PLAN_WORDS words a period (one field stages at
    most 32), each with its plan: one launch each."""
    groups, start = [], 0
    while start < len(fields):
        stop = min(start + MAX_FIELDS, len(fields))
        while True:
            plan = field_word_plan(stride, fields[start:stop])
            if len(plan.words) <= _MAX_PLAN_WORDS or stop == start + 1:
                break
            stop -= 1
        groups.append((start, stop, plan))
        start = stop
    return groups


def _plan_tensor(plan: FieldPlan, device: torch.device) -> torch.Tensor:
    """The plan as the kernel reads it, on ``device``, uploaded once per
    layout and device."""
    key = (plan, str(device))
    t = _PLANS.get(key)
    if t is None:
        t = _PLANS[key] = torch.tensor(plan.words + plan.at,
                                       dtype=torch.int32, device=device)
    return t


def _check_rows(raw: torch.Tensor, what: str) -> None:
    if raw.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not "
                         f"{raw.device.type}")
    if raw.dtype != torch.uint8 or raw.ndim != 2:
        raise ValueError(f"{what} takes (n, w) uint8 rows, not "
                         f"{tuple(raw.shape)} {raw.dtype}")
    # a raw row matrix or a field of one: bytes adjacent, rows
    # row_stride apart
    if raw.stride(1) != 1 or raw.stride(0) < 0:
        raise ValueError(f"{what} takes rows of adjacent bytes at a "
                         f"non-negative row stride")


def _decode(raw: torch.Tensor, fields: Sequence[Tuple[int, int]],
            name: str, direct: Optional[bool] = None
            ) -> List[torch.Tensor]:
    """The decoder's launches over ``fields`` of ``raw`` (checked): one
    for up to MAX_FIELDS fields (more only for rows so wide that a
    period's words overflow a launch); each adds one to
    ``LAUNCHES[name]``.  A launch of one field runs the kernel's direct
    mode, of more its staged mode (``direct`` forces one)."""
    dev, n = raw.device, raw.shape[0]
    outs = [torch.empty((n,), dtype=_FIELD_DTYPE[w], device=dev)
            for _, w in fields]
    if n == 0:
        return outs
    # the kernel reads 16-byte words from an aligned base, and only
    # inside the allocation the rows lie in
    ptr = raw.data_ptr()
    base, shift = ptr & ~15, ptr & 15
    storage = raw.untyped_storage()
    lo = storage.data_ptr()
    hi = lo + storage.nbytes()
    stride = raw.stride(0)
    shifted = tuple((off + shift, w) for off, w in fields)
    for start, stop, plan in _field_groups(stride, shifted):
        k = stop - start
        offs = (ctypes.c_int * k)(*[off for off, _ in shifted[start:stop]])
        widths = (ctypes.c_int * k)(*[w for _, w in shifted[start:stop]])
        ptrs = (ctypes.c_void_p * k)(*[o.data_ptr()
                                       for o in outs[start:stop]])
        one = k == 1 if direct is None else direct
        rc = _build.launch_on(dev, _csv_lib().parse_fields_launch, (
            base, stride, n, lo, hi, k, offs, widths, ptrs, int(one),
            _plan_tensor(plan, dev).data_ptr(), len(plan.words),
            plan.period_rows, plan.period_words))
        _check_launch(rc, name)
        _count(name, dev)
    return outs


def parse_fields(raw: torch.Tensor, fields: Sequence[Tuple[int, int]]
                 ) -> List[torch.Tensor]:
    """Every numeric field of a fixed-width CSV row matrix in one pass.

    Args:
      raw: ``(n, w)`` uint8 rows (bytes adjacent, any row stride), read
        in place.
      fields: ``(byte offset, width)`` of each field in a row: width 10
        decodes zero-padded ASCII digits to int32 (as :func:`parse_i32`),
        width 8 fractional digits to float32 (as :func:`parse_f32`).
    Returns:
      One ``(n,)`` tensor per field, in order, bitwise equal to the
      one-field decoders.  On the card one launch decodes up to
      MAX_FIELDS fields.
    """
    fields = tuple((int(off), int(w)) for off, w in fields)
    for off, w in fields:
        if w not in _FIELD_DTYPE or off < 0 or off + w > raw.shape[-1]:
            raise ValueError(f"field (offset {off}, width {w}) is not a "
                             f"10- or 8-byte field of a {raw.shape[-1]}-byte "
                             f"row")
    if raw.device.type == "cpu":
        return parse_fields_ref(raw, fields)
    _check_rows(raw, "parse_fields")
    if not fields:
        return []
    return _decode(raw, fields, "parse_fields")


def _parse_one(digits: torch.Tensor, width: int, name: str) -> torch.Tensor:
    """``digits`` as the one field of its rows: one decoder launch."""
    _check_rows(digits, name)
    if digits.shape[1] != width:
        raise ValueError(f"{name} takes (n, {width}) uint8 digits, not "
                         f"{tuple(digits.shape)} {digits.dtype}")
    return _decode(digits, ((0, width),), name)[0]


def parse_i32(digits: torch.Tensor) -> torch.Tensor:
    """Fixed-width decimal parse: ``(n, 10)`` uint8 zero-padded ASCII
    digits -> int32 ``(n,)``, wrapping modulo 2^32 as the plain version
    does.  ``digits`` may be a field of a raw CSV row matrix
    (``raw[:, off:off + 10]``): the kernel reads it in place."""
    if digits.device.type == "cpu":
        return parse_i32_ref(digits)
    return _parse_one(digits, 10, "parse_i32")


def parse_f32(digits: torch.Tensor) -> torch.Tensor:
    """Fractional parse: ``(n, 8)`` uint8 ASCII digits -> float32 in
    [0, 1), bitwise equal to the plain version; ``digits`` as for
    :func:`parse_i32`."""
    if digits.device.type == "cpu":
        return parse_f32_ref(digits)
    return _parse_one(digits, 8, "parse_f32")

"""Fused columnar filter-scan kernels for Hopper (CUDA C++, ``csrc/``).

The predicate program is encoded on the host into a small bytecode
(:func:`encode_program`) that one compiled kernel interprets per row, so
``nvcc`` runs once for every program the engine produces.  The
wrappers :func:`filter_scan` and :func:`filter_scan_batch` launch that
kernel for CUDA tensors and take the plain torch versions in ``ref.py``
only for CPU tensors.  Each launch adds one to its wrapper's entry in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...relational.expr import fold_int_cmp
from .. import _build
from .ref import (_CMP_OPSYM, _SYM_CMP, PredProgram, filter_scan_batch_ref,
                  filter_scan_ref)

DEFAULT_BLOCK = 2048   # rows per count-block (one CUDA block each)
MAX_COLS = 16          # predicate columns one launch can read
MAX_STACK = 64         # boolean stack depth (bits of a 64-bit register)
_MAX_SMEM = 48 * 1024  # static-launch shared memory limit, bytes

_SOURCE = Path(__file__).resolve().parent / "csrc" / "filter_scan.cu"

# opcodes: keep in step with enum Op in csrc/filter_scan.cu
OP_CMP_INT_LIT, OP_CMP_F32_LIT, OP_CMP_SLOT_I, OP_CMP_SLOT_F = 0, 1, 2, 3
OP_CMP_CC_INT, OP_CMP_CC_F32, OP_IN_INT, OP_IN_F32 = 4, 5, 6, 7
OP_CONST, OP_AND, OP_OR, OP_NOT = 8, 9, 10, 11
_CMP_CODE = {"lt": 0, "le": 1, "gt": 2, "ge": 3, "eq": 4, "ne": 5}
_CMP_NAME = {v: k for k, v in _CMP_CODE.items()}
_TYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.float32: 2}

LAUNCHES = {"filter_scan": 0, "filter_scan_batch": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        n_fslots=n_slots["$f"])


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


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ptrs = ctypes.POINTER(ctypes.c_longlong)
        types = ctypes.POINTER(ctypes.c_int)
        lib.filter_scan_launch.argtypes = [
            ptrs, types, i, p, i, p, p, ll, ll, i, p, p, p]
        lib.filter_scan_launch.restype = i
        lib.filter_scan_batch_launch.argtypes = [
            ptrs, types, i, p, i, p, p, p, i, p, i, i, ll, ll, i, p, p, p]
        lib.filter_scan_batch_launch.restype = i
        _LIB = lib
    return _LIB


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
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _smem_ok(enc: EncodedProgram, n_q: int) -> None:
    if (4 * enc.words.shape[0] + n_q) * 4 > _MAX_SMEM:
        raise RuntimeError("program and query count exceed the kernel's "
                           "shared memory")


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
    n = _check_columns(columns, block)
    dev = columns[0].device
    enc = encoded or encode_program(program, [c.dtype for c in columns], dev)
    if enc.has_slots:
        raise ValueError("filter_scan takes a literal program; slotted "
                         "programs go through filter_scan_batch")
    _smem_ok(enc, 1)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    counts = torch.empty((n // block,), dtype=torch.int32, device=dev)
    ptrs, types, n_cols = _col_args(columns, enc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().filter_scan_launch(
            ptrs, types, n_cols, enc.words.data_ptr(), enc.words.shape[0],
            enc.lit_i.data_ptr(), enc.lit_f.data_ptr(), n, int(nrows),
            block, mask.data_ptr(), counts.data_ptr(), stream)
    _check_launch(rc, "filter_scan")
    LAUNCHES["filter_scan"] += 1
    return mask, counts


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
    n = _check_columns(columns, block)
    dev = columns[0].device
    if (iconsts.dtype != torch.int32 or fconsts.dtype != torch.float32
            or iconsts.ndim != 2 or fconsts.ndim != 2
            or iconsts.shape[0] != fconsts.shape[0]
            or iconsts.device != dev or fconsts.device != dev):
        raise ValueError("iconsts/fconsts must be (n_q, k) int32/float32 "
                         "tensors on the columns' device")
    iconsts, fconsts = iconsts.contiguous(), fconsts.contiguous()
    n_q = iconsts.shape[0]
    enc = encoded or encode_program(program, [c.dtype for c in columns], dev)
    if (iconsts.shape[1] < enc.n_islots or fconsts.shape[1] < enc.n_fslots):
        raise ValueError("operand tensors have fewer lanes than the "
                         "program's slots")
    _smem_ok(enc, n_q)
    mask = torch.empty((n_q, n), dtype=torch.bool, device=dev)
    counts = torch.empty((n_q, n // block), dtype=torch.int32, device=dev)
    ptrs, types, n_cols = _col_args(columns, enc)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().filter_scan_batch_launch(
            ptrs, types, n_cols, enc.words.data_ptr(), enc.words.shape[0],
            enc.lit_i.data_ptr(), enc.lit_f.data_ptr(),
            iconsts.data_ptr(), iconsts.shape[1], fconsts.data_ptr(),
            fconsts.shape[1], n_q, n, int(nrows), block, mask.data_ptr(),
            counts.data_ptr(), stream)
    _check_launch(rc, "filter_scan_batch")
    LAUNCHES["filter_scan_batch"] += 1
    return mask, counts

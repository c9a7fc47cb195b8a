"""Columnar schema / table representation for the relational substrate.

Tables are structs-of-arrays (one torch tensor per column) with an explicit
``nrows`` — arrays are padded to a power-of-two capacity so that eager
per-operator jit compilation caches aggressively (the Spark-stage
analog: each operator materializes a fixed-shape distributed relation).

Column types:
  * ``i32``  — int32 scalar column, shape (capacity,)
  * ``i64``  — int64 scalar column, shape (capacity,); columnar-only
    (the fixed-width CSV parser is 10-digit/i32)
  * ``f32``  — float32 scalar column, shape (capacity,)
  * ``str``  — fixed-width UTF-8 bytes, shape (capacity, width) uint8
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ColType:
    kind: str            # "i32" | "i64" | "f32" | "str"
    width: int = 0       # for "str": fixed byte width

    def __post_init__(self):
        assert self.kind in ("i32", "i64", "f32", "str")
        if self.kind == "str":
            assert self.width > 0

    @property
    def mem_bytes(self) -> int:
        """In-memory bytes per value (the cache-weight unit)."""
        return {"i32": 4, "i64": 8, "f32": 4,
                "str": self.width}[self.kind]

    @property
    def csv_width(self) -> int:
        """Fixed-width CSV-analog serialized byte width per value."""
        # i32: 10 zero-padded digits (values < 1e9); f32 in [0,1):
        # "0." + 8 digits -> we store just the 8 fractional digits.
        # i64 has no CSV encoding — int64 columns are columnar-only.
        if self.kind == "i64":
            raise ValueError("i64 columns have no CSV encoding")
        return {"i32": 10, "f32": 8, "str": self.width}[self.kind]


I32 = ColType("i32")
I64 = ColType("i64")
F32 = ColType("f32")


def STR(width: int) -> ColType:
    return ColType("str", width)


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Tuple[str, ColType], ...]

    @staticmethod
    def of(*fields: Tuple[str, ColType]) -> "Schema":
        names = [n for n, _ in fields]
        assert len(set(names)) == len(names), "duplicate column names"
        return Schema(tuple(fields))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.fields)

    def coltype(self, name: str) -> ColType:
        for n, t in self.fields:
            if n == name:
                return t
        raise KeyError(name)

    def has(self, name: str) -> bool:
        return any(n == name for n, _ in self.fields)

    def select(self, names: Iterable[str]) -> "Schema":
        names = tuple(names)
        return Schema(tuple((n, self.coltype(n)) for n in names))

    def concat(self, other: "Schema") -> "Schema":
        overlap = set(self.names) & set(other.names)
        assert not overlap, f"join column-name collision: {overlap}"
        return Schema(self.fields + other.fields)

    @property
    def row_mem_bytes(self) -> int:
        return sum(t.mem_bytes for _, t in self.fields)

    @property
    def row_csv_bytes(self) -> int:
        return sum(t.csv_width for _, t in self.fields)

    def csv_offsets(self) -> Dict[str, Tuple[int, int]]:
        """name -> (byte offset, byte width) in a fixed-width CSV row."""
        out, off = {}, 0
        for n, t in self.fields:
            out[n] = (off, t.csv_width)
            off += t.csv_width
        return out


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


@dataclass
class Table:
    """A (possibly distributed) relation: struct of arrays + row count."""

    schema: Schema
    columns: Dict[str, torch.Tensor]
    nrows: int

    def __post_init__(self):
        for n, t in self.schema.fields:
            arr = self.columns[n]
            if t.kind == "str":
                assert arr.ndim == 2 and arr.shape[1] == t.width, \
                    (n, arr.shape)
            else:
                assert arr.ndim == 1, (n, arr.shape)

    @property
    def capacity(self) -> int:
        first = next(iter(self.columns.values()))
        return int(first.shape[0])

    @property
    def nbytes(self) -> int:
        """Actual device bytes held (capacity-based, what the cache pays)."""
        return int(sum(a.numel() * a.element_size()
                       for a in self.columns.values()))

    @property
    def logical_nbytes(self) -> int:
        """Bytes of live rows only (what the cost model estimates)."""
        return self.nrows * self.schema.row_mem_bytes

    def select(self, names: Iterable[str]) -> "Table":
        names = tuple(names)
        return Table(self.schema.select(names),
                     {n: self.columns[n] for n in names}, self.nrows)

    # ---- host-side helpers (tests / benchmarks) --------------------------
    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {n: self.columns[n][: self.nrows].cpu().numpy()
                for n in self.schema.names}

    def row_multiset(self) -> List[tuple]:
        """Sorted list of row tuples — the relational-semantics equality
        view (SQL results are multisets; tie order is unspecified)."""
        cols = self.to_numpy()
        rows = []
        for i in range(self.nrows):
            row = []
            for n, t in self.schema.fields:
                v = cols[n][i]
                if t.kind == "str":
                    row.append(bytes(v.tobytes()))
                elif t.kind == "f32":
                    row.append(round(float(v), 4))
                else:
                    row.append(int(v))
            rows.append(tuple(row))
        rows.sort()
        return rows


_TORCH_DTYPES = {"i32": torch.int32, "i64": torch.int64,
                 "f32": torch.float32}


def torch_dtype(t: ColType) -> torch.dtype:
    """The tensor dtype of a column type (``str`` columns are uint8)."""
    return _TORCH_DTYPES.get(t.kind, torch.uint8)


def empty_like(schema: Schema, capacity: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    cols: Dict[str, torch.Tensor] = {}
    for n, t in schema.fields:
        shape = (capacity, t.width) if t.kind == "str" else (capacity,)
        cols[n] = torch.zeros(shape, dtype=torch_dtype(t), device=device)
    return cols

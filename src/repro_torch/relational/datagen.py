"""Synthetic dataset generation (paper §6.1 micro-benchmark data).

The paper's table: 30 columns — n1..n10 int uniform in [1, 10^{i+2}],
d1..d10 double in [0,1], s1..s10 strings of length 20.  Deviations for
the engine (shared with the JAX package): ints are clipped to < 1e9 so
int32 + 10-digit fixed-width CSV fields hold them exactly.

Also provides the "people" aliasing used in the paper's figures
(n1 -> age, s1 -> name, ...), and CSV/columnar serialization.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .physical import TableStorage
from .schema import F32, I32, STR, Schema


def synthetic_schema(n_int: int = 10, n_dbl: int = 10, n_str: int = 10,
                     str_width: int = 20,
                     names: Optional[Tuple[str, ...]] = None) -> Schema:
    fields = []
    for i in range(1, n_int + 1):
        fields.append((f"n{i}", I32))
    for i in range(1, n_dbl + 1):
        fields.append((f"d{i}", F32))
    for i in range(1, n_str + 1):
        fields.append((f"s{i}", STR(str_width)))
    if names:
        fields = [(names[i] if i < len(names) and names[i] else f[0], f[1])
                  for i, f in enumerate(fields)]
    return Schema.of(*fields)


def generate_columns(schema: Schema, nrows: int,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    cols: Dict[str, np.ndarray] = {}
    int_idx = dbl_idx = 0
    for name, t in schema.fields:
        if t.kind == "i32":
            int_idx += 1
            hi = min(10 ** (int_idx + 2), 999_999_999)
            cols[name] = rng.integers(1, hi + 1, nrows, dtype=np.int64
                                      ).astype(np.int32)
        elif t.kind == "i64":
            # wide ints: beyond both int32 and exact-f32 range, so only
            # a true 64-bit lane holds them
            cols[name] = rng.integers(1, 2 ** 40, nrows, dtype=np.int64)
        elif t.kind == "f32":
            dbl_idx += 1
            cols[name] = rng.random(nrows, dtype=np.float64
                                    ).astype(np.float32)
        else:
            letters = rng.integers(97, 123, (nrows, t.width),
                                   dtype=np.int64).astype(np.uint8)
            # limit NDV so string-equality predicates are selective:
            # draw from 1000 distinct prefixes
            prefix_pool = rng.integers(97, 123, (1000, 4),
                                       dtype=np.int64).astype(np.uint8)
            which = rng.integers(0, 1000, nrows)
            letters[:, :4] = prefix_pool[which]
            cols[name] = letters
    return cols


def to_csv_bytes(schema: Schema, cols: Dict[str, np.ndarray],
                 nrows: int) -> np.ndarray:
    """Fixed-width UTF-8 serialization (the CSV-analog 'disk' format)."""
    row_w = schema.row_csv_bytes
    out = np.zeros((nrows, row_w), np.uint8)
    off = 0
    for name, t in schema.fields:
        w = t.csv_width
        arr = cols[name]
        if t.kind == "i32":
            digits = np.zeros((nrows, 10), np.uint8)
            v = arr.astype(np.int64)
            for k in range(9, -1, -1):
                digits[:, k] = (v % 10) + 48
                v //= 10
            out[:, off:off + w] = digits
        elif t.kind == "f32":
            frac = np.clip((arr.astype(np.float64) * 1e8), 0,
                           99_999_999).astype(np.int64)
            digits = np.zeros((nrows, 8), np.uint8)
            for k in range(7, -1, -1):
                digits[:, k] = (frac % 10) + 48
                frac //= 10
            out[:, off:off + w] = digits
        else:
            out[:, off:off + w] = arr
        off += w
    return out


def make_storage(name: str, schema: Schema, nrows: int, fmt: str,
                 seed: int = 0,
                 cols: Optional[Dict[str, np.ndarray]] = None
                 ) -> Tuple[TableStorage, Dict[str, np.ndarray]]:
    """Build host-side storage in the requested format + typed columns
    (the latter are needed for the stats pre-processing phase)."""
    if cols is None:
        cols = generate_columns(schema, nrows, seed)
    if any(t.kind == "i64" for _, t in schema.fields):
        if fmt == "csv":
            raise ValueError("i64 columns are columnar-only (no fixed-"
                             "width CSV encoding)")
    if fmt == "csv":
        st = TableStorage(name=name, schema=schema, nrows=nrows, fmt="csv",
                          csv_bytes=to_csv_bytes(schema, cols, nrows))
    else:
        st = TableStorage(name=name, schema=schema, nrows=nrows,
                          fmt="columnar", columnar=cols)
    return st, cols


# The paper's illustrative aliasing: a 'people' relation over the same
# synthetic data, with n1=age, n3=salary, s1=name, s2=dept.
PEOPLE_ALIASES = ("age", "n2", "salary", "n4", "n5", "n6", "n7", "n8",
                  "n9", "n10",
                  "d1", "d2", "d3", "d4", "d5", "d6", "d7", "d8",
                  "d9", "d10",
                  "name", "dept", "s3", "s4", "s5", "s6", "s7", "s8",
                  "s9", "s10")


def people_schema() -> Schema:
    return synthetic_schema(names=PEOPLE_ALIASES)

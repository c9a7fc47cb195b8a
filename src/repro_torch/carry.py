"""Carry a table's stored bytes over from the JAX package's storage.

For this system data takes the place of weights: to run both packages
on the same input, a ``TableStorage`` built by the JAX package (or
anything shaped like one) is read duck-typed — its name, schema fields,
row count, format, numpy columns or CSV bytes, and partition layout —
and rebuilt as the port's storage.  Nothing here imports the JAX
package; the arrays are copied, so the two storages share no memory.
"""
from __future__ import annotations

import numpy as np

from .relational.partition import (PartColStats, PartitionInfo,
                                   Partitioning)
from .relational.physical import TableStorage
from .relational.schema import ColType, Schema


def schema_from_reference(schema) -> Schema:
    return Schema(tuple((name, ColType(t.kind, t.width))
                        for name, t in schema.fields))


def _partitions_from_reference(info):
    if info is None:
        return None
    spec = Partitioning(column=info.spec.column, scheme=info.spec.scheme,
                        n_partitions=info.spec.n_partitions)
    stats = [{name: PartColStats(count=s.count, vmin=s.vmin, vmax=s.vmax,
                                 ndv=s.ndv, is_int=s.is_int,
                                 has_nan=s.has_nan)
              for name, s in part.items()} for part in info.col_stats]
    return PartitionInfo(spec=spec, offsets=np.array(info.offsets),
                         col_stats=stats)


def storage_from_reference(st) -> TableStorage:
    """The port's ``TableStorage`` holding the same bytes as ``st``."""
    columnar = None
    if st.columnar is not None:
        columnar = {name: np.array(arr) for name, arr in st.columnar.items()}
    csv_bytes = np.array(st.csv_bytes) if st.csv_bytes is not None else None
    return TableStorage(name=st.name, schema=schema_from_reference(st.schema),
                        nrows=int(st.nrows), fmt=st.fmt, columnar=columnar,
                        csv_bytes=csv_bytes,
                        partitions=_partitions_from_reference(st.partitions))

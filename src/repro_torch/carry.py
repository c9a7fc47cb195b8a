"""Carry inputs over from the JAX package: stored tables and weights.

To run both packages on the same input, a ``TableStorage`` built by the
JAX package (or anything shaped like one) is read duck-typed — its
name, schema fields, row count, format, numpy columns or CSV bytes, and
partition layout — and rebuilt as the port's storage; a model's
parameter tree, as numpy arrays, becomes the port's parameters
(:func:`params_from_reference`).  Nothing here imports the JAX package;
the arrays are copied, so the two packages share no memory.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.common import ParamSpec, ParamTree, storage_dtype
from .models.config import ArchConfig
from .models.model import compute_dtype, model_specs

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


def _unstack_scan(tree, repeats: int):
    """The JAX package stacks the pattern repeats of ``layers.scan`` on
    a leading axis; the port keeps a list over repeats."""
    layers = dict(tree["layers"])
    if "scan" in layers:
        def take(node, r):
            if isinstance(node, dict):
                return {k: take(v, r) for k, v in node.items()}
            return np.asarray(node)[r]

        layers["scan"] = [take(layers["scan"], r) for r in range(repeats)]
    return dict(tree, layers=layers)


def params_from_reference(params, cfg: ArchConfig,
                          device: DeviceLike = None) -> ParamTree:
    """The port's parameters holding the JAX package's ``params`` (a
    tree of numpy arrays, stacked ``layers.scan`` leaves included), in
    the port's storage dtypes, on ``device`` (``cuda`` unless asked
    otherwise).  Raises ValueError on a missing leaf or a shape that
    disagrees with ``model_specs(cfg)``."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg)
    src = _unstack_scan(params, cfg.full_repeats)

    def build(spec_node, src_node, path):
        if isinstance(spec_node, ParamSpec):
            arr = np.asarray(src_node)
            if tuple(arr.shape) != tuple(spec_node.shape):
                raise ValueError(f"{path}: shape {arr.shape} != "
                                 f"{spec_node.shape}")
            return torch.from_numpy(np.array(arr, np.float32)).to(
                device=dev, dtype=storage_dtype(spec_node, dtype))
        if isinstance(spec_node, dict):
            missing = set(spec_node) - set(src_node)
            if missing:
                raise ValueError(f"{path}: missing {sorted(missing)}")
            return {k: build(v, src_node[k], f"{path}.{k}")
                    for k, v in spec_node.items()}
        if len(spec_node) != len(src_node):
            raise ValueError(f"{path}: {len(src_node)} entries, expected "
                             f"{len(spec_node)}")
        return [build(v, s, f"{path}.{i}")
                for i, (v, s) in enumerate(zip(spec_node, src_node))]

    return ParamTree(build(model_specs(cfg), src, "params"))

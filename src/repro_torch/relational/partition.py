"""Horizontal partitioning: declaration, statistics, pruning, CE slicing.

The paper's worksharing caches whole covering-expression outputs; this
module makes both caching and scanning *partition-grained* (cf.
PartitionCache's partition-keyed query cache, and the reuse/work-sharing
coordination of Sioulas et al. 2023):

  * **Declaration** — ``Session.register(storage, partitioning=
    Partitioning(column="n1", scheme="range", n_partitions=8))``
    physically re-clusters the table so each partition is a contiguous
    row range, and records per-partition min/max/NDV statistics.
  * **Pruning** — :func:`prune_parts` evaluates a filter predicate
    against the per-partition statistics and returns the partitions
    that MAY contain qualifying rows (conservative by construction:
    interval reasoning can only over-approximate the satisfying set).
    The executor scans only those ranges; the cost model scales scan
    cost by the pruned fraction.
  * **CE slicing** — :func:`make_ce_partitioner` splits a covering
    expression over a single partitioned table into per-partition
    knapsack items, so the MCKP can admit the *hot fraction* of a CE
    instead of rejecting it whole; :class:`PartitionedCePlan` is the
    execution-side record the executor uses to compose resident and
    recomputed partitions at read time.

Partition order is ascending partition id everywhere, and partitions
are contiguous row ranges of the (re-clustered) table — so a pruned
scan's live rows are exactly the unpruned scan's live rows with the
non-qualifying partitions' rows deleted, in the same relative order.
That is what makes pruned execution bit-identical on live rows
(property-tested in ``tests/test_partition.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import expr as E
from . import logical as L

# Knuth multiplicative hash (mod 2^32) — deterministic across runs and
# processes (Python's hash() is salted), cheap to mirror in tests.
_HASH_MULT = np.uint64(2654435761)
_HASH_MOD = np.uint64(1 << 32)


@dataclass(frozen=True)
class Partitioning:
    """Declared at ``register_table`` time.

    * ``range`` — split points at quantiles of ``column`` (numeric),
      partition p holds rows with ``bounds[p-1] < v <= bounds[p]``;
    * ``hash``  — ``knuth_hash(v) % n_partitions`` over an int32
      ``column`` (value clustering is irrelevant; equality predicates
      on the partition column prune to a single bucket).
    """

    column: str
    scheme: str = "range"          # "range" | "hash"
    n_partitions: int = 8

    def __post_init__(self):
        assert self.scheme in ("range", "hash"), self.scheme
        assert self.n_partitions >= 1


@dataclass
class PartColStats:
    """Per-partition, per-column summary used by the pruner."""

    count: int
    vmin: float
    vmax: float
    ndv: int
    is_int: bool = True     # column dtype (drives literal-cast semantics)
    has_nan: bool = False   # NaN poisons interval reasoning: unprunable


@dataclass
class PartitionInfo:
    """Partition layout + statistics of one re-clustered table."""

    spec: Partitioning
    offsets: np.ndarray                 # (n_partitions + 1,) row offsets
    col_stats: List[Dict[str, PartColStats]] = field(default_factory=list)

    @property
    def n_partitions(self) -> int:
        return len(self.offsets) - 1

    def part_rows(self, pid: int) -> int:
        return int(self.offsets[pid + 1] - self.offsets[pid])

    def part_range(self, pid: int) -> Tuple[int, int]:
        return int(self.offsets[pid]), int(self.offsets[pid + 1])

    def all_parts(self) -> Tuple[int, ...]:
        return tuple(range(self.n_partitions))

    def rows_of(self, parts) -> int:
        return sum(self.part_rows(p) for p in parts)


def hash_bucket(values: np.ndarray, n: int) -> np.ndarray:
    v = values.astype(np.int64).view(np.uint64) * _HASH_MULT
    return ((v % _HASH_MOD) % np.uint64(n)).astype(np.int64)


def assign_partitions(values: np.ndarray,
                      spec: Partitioning) -> np.ndarray:
    """Row -> partition id under ``spec`` (host-side, registration)."""
    n = spec.n_partitions
    if spec.scheme == "hash":
        assert np.issubdtype(values.dtype, np.integer), \
            "hash partitioning requires an integer column"
        return hash_bucket(values, n)
    qs = np.quantile(values.astype(np.float64),
                     np.linspace(0, 1, n + 1)[1:-1])
    return np.searchsorted(qs, values.astype(np.float64),
                           side="left").astype(np.int64)


def build_partition_info(spec: Partitioning, nrows: int,
                         cols: Dict[str, np.ndarray],
                         pids_sorted: np.ndarray) -> PartitionInfo:
    """Statistics over ALREADY RE-CLUSTERED columns (``pids_sorted`` is
    the per-row partition id of the reordered table, non-decreasing)."""
    n = spec.n_partitions
    counts = np.bincount(pids_sorted, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    stats: List[Dict[str, PartColStats]] = []
    for pid in range(n):
        lo, hi = int(offsets[pid]), int(offsets[pid + 1])
        per_col: Dict[str, PartColStats] = {}
        for name, arr in cols.items():
            if arr.ndim != 1:        # str columns: pruner treats unknown
                continue
            part = arr[lo:hi]
            is_int = bool(np.issubdtype(arr.dtype, np.integer))
            if part.size == 0:
                per_col[name] = PartColStats(0, 0.0, 0.0, 0, is_int)
            else:
                # NaN makes min/max (and every interval compare) NaN —
                # i.e. False — which would UNSOUNDLY prune a partition
                # that still holds qualifying non-NaN rows (and NaN
                # rows themselves satisfy !=).  Flag it; the pruner
                # treats such partitions as unprunable.
                has_nan = (not is_int
                           and bool(np.isnan(part).any()))
                finite = part[~np.isnan(part)] if has_nan else part
                if finite.size == 0:
                    per_col[name] = PartColStats(
                        count=int(part.size), vmin=0.0, vmax=0.0,
                        ndv=1, is_int=is_int, has_nan=True)
                else:
                    per_col[name] = PartColStats(
                        count=int(part.size),
                        vmin=float(finite.min()),
                        vmax=float(finite.max()),
                        ndv=int(len(np.unique(finite))),
                        is_int=is_int, has_nan=has_nan)
        stats.append(per_col)
    return PartitionInfo(spec=spec, offsets=offsets, col_stats=stats)


def partition_table(spec: Partitioning, nrows: int,
                    cols: Dict[str, np.ndarray]
                    ) -> Tuple[np.ndarray, Dict[str, np.ndarray],
                               PartitionInfo]:
    """Compute the re-clustering permutation + reordered columns + info.

    Applying ``perm`` to every column (and to the CSV byte matrix)
    groups each partition into one contiguous row range, ascending by
    partition id, ORDER-STABLE within a partition.
    """
    assert spec.column in cols, f"unknown partition column {spec.column}"
    pids = assign_partitions(np.asarray(cols[spec.column])[:nrows], spec)
    perm = np.argsort(pids, kind="stable")
    reordered = {n: np.ascontiguousarray(np.asarray(a)[:nrows][perm])
                 for n, a in cols.items()}
    info = build_partition_info(spec, nrows, reordered, pids[perm])
    return perm, reordered, info


# ---------------------------------------------------------------------------
# partition pruning
# ---------------------------------------------------------------------------
def _cast_lit(v, is_int: bool):
    """Literal under the EXECUTION's comparison semantics: frac consts
    on int columns are folded by expr.fold_int_cmp (handled by the
    caller); everything else is cast to the column dtype before the
    compare, which the interval test must mirror exactly."""
    if is_int:
        return float(int(v))
    return float(np.float32(v))


def _interval_cmp(op: str, vmin: float, vmax: float, v: float,
                  want_all: bool) -> bool:
    """``want_all=False``: may ANY value in [vmin, vmax] satisfy
    ``x op v``?  ``want_all=True``: do ALL values in the interval
    satisfy it?  (The ``all`` dual is what makes Not(...) prunable
    soundly: ANY over the interval over-approximates ANY over the
    actual value set, ALL under-approximates it.)"""
    if want_all:
        if op == "<":
            return vmax < v
        if op == "<=":
            return vmax <= v
        if op == ">":
            return vmin > v
        if op == ">=":
            return vmin >= v
        if op == "==":
            return vmin == v == vmax
        if op == "!=":
            return v < vmin or v > vmax
    else:
        if op == "<":
            return vmin < v
        if op == "<=":
            return vmin <= v
        if op == ">":
            return vmax > v
        if op == ">=":
            return vmax >= v
        if op == "==":
            return vmin <= v <= vmax
        if op == "!=":
            return not (vmin == v == vmax)
    raise ValueError(op)


def _part_maybe(e: E.Expr, stats: Dict[str, PartColStats],
                info: PartitionInfo, pid: int, want_all: bool) -> bool:
    """Conservative satisfiability of ``e`` over partition ``pid``.

    ``want_all=False`` OVER-approximates "some row satisfies e";
    ``want_all=True`` UNDER-approximates "every row satisfies e".
    Unknown sub-expressions (string compares, col-col compares, missing
    stats) return the safe default for the mode.
    """
    unknown = want_all is False   # maybe-mode default True, all-mode False
    if isinstance(e, E.TrueExpr):
        return True
    if isinstance(e, E.Cmp):
        e = E.oriented(e)
        if isinstance(e.col, E.Lit):       # Lit-Lit: exact constant
            return E.const_cmp(e)
        if isinstance(e.rhs, E.Col):
            return unknown
        cs = stats.get(e.col.name)
        if cs is None or cs.count == 0:
            # no stats (string column) — unprunable; empty partition —
            # vacuously prunable in maybe-mode, satisfiable in all-mode
            return unknown if cs is None else want_all
        if cs.has_nan:
            # NaN rows defeat interval reasoning (they satisfy != and
            # fail everything else, outside [vmin, vmax] semantics)
            return unknown
        v = e.rhs.value
        if isinstance(v, (str, bytes)):
            return unknown
        is_int = cs.is_int
        op = e.op
        spec = info.spec
        if (spec.scheme == "hash" and e.col.name == spec.column
                and op == "==" and not want_all
                and float(v).is_integer()):
            # hash partitioning: equality on the partition column lands
            # in exactly one bucket
            want = int(hash_bucket(np.asarray([int(v)], np.int64),
                                   spec.n_partitions)[0])
            if want != pid:
                return False
            # fall through: the bucket may still lack the exact value
        if is_int and isinstance(v, float) and not v.is_integer():
            folded = E.fold_int_cmp(op, v)
            if folded[0] == "all":
                return folded[1]
            _, op, v = folded
        return _interval_cmp(op, cs.vmin, cs.vmax,
                             _cast_lit(v, is_int), want_all)
    if isinstance(e, E.In):
        # membership = disjunction of equalities over the value list
        # (empty lists canonicalize away, but stay safe here anyway)
        if not e.values:
            return False    # no row can satisfy membership in ()
        ors = E.Or(tuple(E.Cmp("==", e.col, E.Lit(v)) for v in e.values)) \
            if len(e.values) > 1 else E.Cmp("==", e.col, E.Lit(e.values[0]))
        return _part_maybe(ors, stats, info, pid, want_all)
    if isinstance(e, E.And):
        # both modes distribute conjunction as ∀/∃-safe `all` / the
        # over-approximation "every conjunct may hold somewhere"
        return all(_part_maybe(p, stats, info, pid, want_all)
                   for p in e.parts)
    if isinstance(e, E.Or):
        return any(_part_maybe(p, stats, info, pid, want_all)
                   for p in e.parts)
    if isinstance(e, E.Not):
        # some row satisfies ¬p  ⟸  not (every row satisfies p)
        # every row satisfies ¬p ⟸  not (some row may satisfy p)
        return not _part_maybe(e.part, stats, info, pid, not want_all)
    raise TypeError(type(e))


def prune_parts(pred: E.Expr, info: PartitionInfo) -> Tuple[int, ...]:
    """Partition ids that may contain rows satisfying ``pred``
    (ascending; conservative — never drops a qualifying partition)."""
    return tuple(
        pid for pid in range(info.n_partitions)
        if info.part_rows(pid) > 0
        and _part_maybe(pred, info.col_stats[pid], info, pid, False))


def pid_presence_from_mask(mask: np.ndarray, info: PartitionInfo,
                           parts: Tuple[int, ...]) -> Tuple[int, ...]:
    """Partition ids among ``parts`` whose scanned rows contain any
    qualifying row, given the host-side boolean ``mask`` over the rows
    actually scanned (the concatenation of ``parts`` ranges, in order).

    This is the recording half of the pid bitset pool: partitions NOT
    in ``parts`` were pruned, and pruning is conservative, so they are
    exactly empty for the predicate — the returned presence set is a
    full-table fact whenever the scan started from ``parts = None``
    (i.e. pruning itself chose ``parts``)."""
    present: List[int] = []
    off = 0
    for pid in parts:
        n = info.part_rows(pid)
        if n and bool(np.any(mask[off:off + n])):
            present.append(int(pid))
        off += n
    return tuple(present)


# ---------------------------------------------------------------------------
# plan helpers
# ---------------------------------------------------------------------------
def linear_scan_chain(tree: L.Node
                      ) -> Optional[Tuple[L.Scan, E.Expr]]:
    """(scan leaf, conjunction of chain filters) for a Filter*/Project*
    chain over ONE Scan; None for any other shape (joins, aggregates,
    cached leaves).  This is the partitionable-CE eligibility test —
    the dominant CE shape after MQO rewriting (ROADMAP)."""
    preds: List[E.Expr] = []
    cur = L.as_node(tree)
    while isinstance(cur, (L.Filter, L.Project)):
        if isinstance(cur, L.Filter):
            preds.append(cur.pred)
        cur = cur.child
    if not isinstance(cur, L.Scan):
        return None
    return cur, E.and_(*preds)


def restrict_to_parts(tree: L.Node, parts: Tuple[int, ...]) -> L.Node:
    """The same plan with its Scan leaf restricted to ``parts``."""
    tree = L.as_node(tree)
    if isinstance(tree, L.Scan):
        from dataclasses import replace

        return replace(tree, parts=tuple(parts))
    if not tree.children:
        return tree
    return tree.with_children(tuple(restrict_to_parts(c, parts)
                                    for c in tree.children))


# ---------------------------------------------------------------------------
# CE partition slicing (MCKP group items)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CePartition:
    """One partition's slice of a covering expression, priced.

    ``value`` / ``weight`` are the row-proportional shares of the CE's
    Eq. 3 value and byte weight (scan-dominated chains scale linearly
    with input rows, which is exactly the partitionable-CE shape);
    ``resident_value`` re-prices the slice when its bytes are already
    materialized from an earlier window (C_E and C_W sunk, only reads
    and extraction remain — the per-partition analog of
    ``core.costmodel.price_resident_ce``)."""

    pid: int
    rows: int
    weight: int
    value: float
    resident_value: float


@dataclass
class PartitionedCePlan:
    """Execution-side record of one partition-grained CE: which
    partitions are live (survive the covering predicate's pruning),
    which the MCKP admitted to the cache this window, and the covering
    plan to run per-partition for the rest."""

    plan: L.Node                      # covering tree (cache-plan child)
    table: str
    info: PartitionInfo
    live: Tuple[int, ...]
    admitted: frozenset = frozenset()
    benefits: Dict[int, float] = field(default_factory=dict)


def make_ce_partitioner(catalog, min_partitions: int = 2):
    """``partitioner`` hook for :class:`repro_torch.core.optimizer
    .MultiQueryOptimizer`: split an eligible CE into per-partition
    MCKP items.

    Eligible: the covering tree is a Filter*/Project* chain over one
    Scan of a partitioned table (``catalog[name].partitions`` set) with
    at least ``min_partitions`` live partitions after pruning with the
    covering predicate.  Must run AFTER ``price_ce`` (consumes the
    ``cost_detail`` breakdown).
    """

    def partition_ce(ce) -> Optional[Tuple[PartitionedCePlan,
                                           List[CePartition]]]:
        chain = linear_scan_chain(ce.tree)
        if chain is None:
            return None
        scan, pred = chain
        st = catalog.get(scan.table)
        info = getattr(st, "partitions", None)
        if info is None or scan.parts is not None:
            return None
        live = prune_parts(pred, info)
        if len(live) < min_partitions:
            return None
        d = ce.cost_detail
        sunk_free = d.get("C_omega", 0.0) - (
            ce.m * d.get("C_R", 0.0) + d.get("C_X", 0.0))
        total_rows = max(1, info.rows_of(live))
        slices = []
        for pid in live:
            f = info.part_rows(pid) / total_rows
            slices.append(CePartition(
                pid=pid,
                rows=info.part_rows(pid),
                weight=max(1, int(ce.weight * f)),
                value=ce.value * f,
                resident_value=sunk_free * f,
            ))
        plan = PartitionedCePlan(plan=ce.tree, table=scan.table,
                                 info=info, live=live)
        return plan, slices

    return partition_ce

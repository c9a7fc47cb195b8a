"""Cardinality estimation and the relational cost model (paper §4.2).

Statistics are collected in a pre-processing phase (as in the paper's
prototype): per column — row count, min/max, approximate NDV, and an
equi-width histogram.  Column names are unique across the catalog and
are never renamed by operators, so a single column-stats registry
serves predicates at any plan depth.

The cost model prices a sub-tree as CPU + I/O + network (Eq. 1–3
inputs).  Constants are per-byte / per-row weights representative of
the compute cluster; §6.3 of the paper notes results are robust to the
exact constants (we verify the same in tests).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np

from . import expr as E
from . import logical as L
from .fuse import FusedPipeline
from .partition import PartitionInfo, prune_parts
from .schema import Schema


@dataclass
class ColumnStats:
    count: int
    ndv: int
    vmin: float = 0.0
    vmax: float = 0.0
    hist_counts: Optional[np.ndarray] = None   # equi-width histogram
    hist_edges: Optional[np.ndarray] = None


@dataclass
class TableStats:
    nrows: int
    columns: Dict[str, ColumnStats] = field(default_factory=dict)


def build_table_stats(columns: Dict[str, np.ndarray], nrows: int,
                      schema: Schema, bins: int = 32,
                      sample: int = 200_000) -> TableStats:
    ts = TableStats(nrows=nrows)
    for name, ctype in schema.fields:
        arr = np.asarray(columns[name])[:nrows]
        if nrows > sample:
            idx = np.random.default_rng(0).choice(nrows, sample, replace=False)
            arr_s = arr[idx]
        else:
            arr_s = arr
        if ctype.kind == "str":
            # hash rows to estimate NDV
            flat = np.ascontiguousarray(arr_s).view(
                [("", arr_s.dtype)] * arr_s.shape[1]).ravel()
            ndv = len(np.unique(flat))
            ts.columns[name] = ColumnStats(count=nrows, ndv=max(1, ndv))
        else:
            if (np.issubdtype(arr.dtype, np.floating)
                    and not np.isfinite(arr).all()):
                # checked over the FULL column, not the stats sample —
                # a sampled check would let NaN slip into large tables.
                # Load-bearing invariant, not just hygiene: expression
                # canonicalization (relational.canonical) folds
                # ¬(x <= v) into x > v, which is only sound over
                # totally ordered domains — NaN satisfies neither side.
                # Rejecting NaN/inf here (the only catalog entry point)
                # is what makes that rewrite semantics-preserving for
                # every executable query.
                raise ValueError(
                    f"column {name!r} contains NaN/inf — non-finite "
                    f"float data is unsupported (breaks ordered-"
                    f"compare canonicalization and min/max statistics)")
            ndv = len(np.unique(arr_s))
            cs = ColumnStats(count=nrows, ndv=max(1, ndv),
                             vmin=float(arr_s.min()) if nrows else 0.0,
                             vmax=float(arr_s.max()) if nrows else 0.0)
            if nrows:
                counts, edges = np.histogram(arr_s.astype(np.float64),
                                             bins=bins)
                scale = nrows / max(1, arr_s.shape[0])
                cs.hist_counts = counts.astype(np.float64) * scale
                cs.hist_edges = edges
            ts.columns[name] = cs
    return ts


class StatsRegistry:
    """column name -> ColumnStats across the whole catalog (plus, for
    partitioned tables, the per-partition layout/statistics that drive
    pruning-aware cardinality and cost estimates)."""

    def __init__(self):
        self.tables: Dict[str, TableStats] = {}
        self.columns: Dict[str, ColumnStats] = {}
        self.partitions: Dict[str, PartitionInfo] = {}
        # selectivity memo keyed by predicate identity (the entry keeps
        # a strong ref, so the id stays valid).  A window prices the
        # SAME shared covering predicate once per member — per-window
        # cost was quadratic in batch size without this.  Any stats
        # (re-)registration invalidates.
        self._sel_memo: Dict[int, Tuple[E.Expr, float]] = {}

    def register(self, table: str, stats: TableStats,
                 partitions: Optional[PartitionInfo] = None):
        self.tables[table] = stats
        self.columns.update(stats.columns)
        self._sel_memo.clear()
        # re-registration must REPLACE partition metadata, including
        # dropping it when the new registration is unpartitioned —
        # stale per-partition statistics would mis-prune the new data
        if partitions is not None:
            self.partitions[table] = partitions
        else:
            self.partitions.pop(table, None)

    def col(self, name: str) -> Optional[ColumnStats]:
        return self.columns.get(name)

    def scan_rows(self, node: L.Scan) -> int:
        """Rows a (possibly partition-restricted) Scan produces."""
        ts = self.tables.get(node.table)
        total = int(ts.nrows) if ts else 1000
        info = self.partitions.get(node.table)
        if node.parts is not None and info is not None:
            return int(info.rows_of(node.parts))
        return total

    def pruned_rows(self, table: str, pred: E.Expr) -> Optional[int]:
        """Rows surviving partition pruning of ``pred`` over ``table``
        (None when the table is unpartitioned)."""
        info = self.partitions.get(table)
        if info is None:
            return None
        return int(info.rows_of(prune_parts(pred, info)))


# ---------------------------------------------------------------------------
# selectivity estimation
# ---------------------------------------------------------------------------
def _range_fraction(cs: ColumnStats, op: str, v: float) -> float:
    if cs.hist_counts is None or cs.count == 0:
        return 1.0 / 3.0
    total = float(cs.hist_counts.sum())
    if total <= 0:
        return 0.0
    edges, counts = cs.hist_edges, cs.hist_counts
    # mass strictly below v (linear interpolation within the bucket)
    below = 0.0
    for i in range(len(counts)):
        lo, hi = edges[i], edges[i + 1]
        if v >= hi:
            below += counts[i]
        elif v > lo:
            below += counts[i] * (v - lo) / max(hi - lo, 1e-12)
    frac_lt = below / total
    eq = (1.0 / max(cs.ndv, 1)) if cs.vmin <= v <= cs.vmax else 0.0
    if op == "<":
        return frac_lt
    if op == "<=":
        return min(1.0, frac_lt + eq)
    if op == ">":
        return max(0.0, 1.0 - frac_lt - eq)
    if op == ">=":
        return max(0.0, 1.0 - frac_lt)
    raise ValueError(op)


def selectivity(e: E.Expr, reg: StatsRegistry) -> float:
    memo = getattr(reg, "_sel_memo", None)
    if memo is not None:
        hit = memo.get(id(e))
        if hit is not None and hit[0] is e:
            return hit[1]
    s = _selectivity(e, reg)
    if memo is not None and not isinstance(e, E.TrueExpr):
        if len(memo) > 8192:      # serving streams see fresh predicates
            memo.clear()          # forever; bound the strong refs
        memo[id(e)] = (e, s)
    return s


def _selectivity(e: E.Expr, reg: StatsRegistry) -> float:
    if isinstance(e, E.TrueExpr):
        return 1.0
    if isinstance(e, E.Cmp):
        e = E.oriented(e)
        if isinstance(e.col, E.Lit):       # Lit-Lit constant compare
            return 1.0 if E.const_cmp(e) else 0.0
        cs = reg.col(e.col.name)
        if isinstance(e.rhs, E.Col):
            cs2 = reg.col(e.rhs.name)
            ndv = max(cs.ndv if cs else 100, cs2.ndv if cs2 else 100)
            return 1.0 / ndv if e.op == "==" else 1.0 / 3.0
        if cs is None:
            return 1.0 / 3.0
        if e.op == "==":
            return 1.0 / max(cs.ndv, 1)
        if e.op == "!=":
            return 1.0 - 1.0 / max(cs.ndv, 1)
        v = e.rhs.value
        if isinstance(v, (bytes, str)):
            return 1.0 / 3.0
        return float(np.clip(_range_fraction(cs, e.op, float(v)), 0.0, 1.0))
    if isinstance(e, E.In):
        # membership over k values ~ k distinct-value equality probes
        cs = reg.col(e.col.name)
        ndv = max(cs.ndv, 1) if cs is not None else 100
        return min(1.0, len(e.values) / ndv)
    if isinstance(e, E.And):
        s = 1.0
        for p in e.parts:
            s *= selectivity(p, reg)
        return s
    if isinstance(e, E.Or):
        s = 1.0
        for p in e.parts:
            s *= 1.0 - selectivity(p, reg)
        return 1.0 - s
    if isinstance(e, E.Not):
        return 1.0 - selectivity(e.part, reg)
    raise TypeError(type(e))


# ---------------------------------------------------------------------------
# required-column analysis (projection pruning / scan cost)
# ---------------------------------------------------------------------------
def required_columns(root: L.Node) -> Dict[int, FrozenSet[str]]:
    """id(node) -> columns of that node's OUTPUT needed by its consumers."""
    req: Dict[int, FrozenSet[str]] = {}

    def down(node: L.Node, needed: FrozenSet[str]):
        needed = needed & frozenset(node.schema.names)
        req[id(node)] = req.get(id(node), frozenset()) | needed
        if isinstance(node, L.Project):
            down(node.child, frozenset(node.cols))
        elif isinstance(node, L.Filter):
            down(node.child, needed | E.columns_of(node.pred))
        elif isinstance(node, L.Join):
            keys_l = frozenset(lc for lc, _ in node.on)
            keys_r = frozenset(rc for _, rc in node.on)
            lnames = frozenset(node.left.schema.names)
            rnames = frozenset(node.right.schema.names)
            down(node.left, (needed & lnames) | keys_l)
            down(node.right, (needed & rnames) | keys_r)
        elif isinstance(node, L.Aggregate):
            need = frozenset(node.group_by) | frozenset(
                c for _, fn, c in node.aggs if fn != "count" and c)
            down(node.child, need)
        elif isinstance(node, L.Sort):
            down(node.child, needed | frozenset((node.by,)))
        elif isinstance(node, (L.Limit, L.Cache)):
            down(node.child, needed)
        elif isinstance(node, L.Union):
            down(node.left, needed)
            down(node.right, needed)
        elif isinstance(node, FusedPipeline):
            down(node.source,
                 frozenset(node.cols) | E.columns_of(node.pred))
        # Scan / CachedScan: leaves

    down(root, frozenset(root.schema.names))
    return req


# ---------------------------------------------------------------------------
# the cost model (implements repro_torch.core.costmodel.CostModel)
# ---------------------------------------------------------------------------
@dataclass
class CostConstants:
    """Per-byte / per-row weights (arbitrary time units, calibratable)."""

    io_csv: float = 2.0e-9       # read a CSV byte from storage
    parse: float = 6.0e-9        # parse a CSV byte into a typed value
    io_col: float = 1.0e-9       # read a columnar (Parquet-analog) byte
    cpu_cmp: float = 1.5e-9      # one predicate term on one row
    cpu_copy: float = 0.3e-9     # copy/gather one byte
    sort: float = 2.0e-9         # one row-swap unit in a sort (x log n)
    net: float = 3.0e-9          # shuffle one byte across the interconnect
    cache_w: float = 1.2e-9      # write one byte into the RAM cache
    cache_r: float = 0.4e-9      # read one byte from the RAM cache
    # fused-pipeline predicate term on one row: the fused path skips the
    # per-operator intermediate relation and host sync, so a residual
    # term is cheaper than an eager one (calibratable like the rest)
    fused_cmp: float = 0.6e-9
    # fixed per-kernel-launch overhead (host->device trip + program
    # setup), used to price a window's shared batched dispatch against
    # per-query dispatches
    dispatch: float = 3.0e-6


class RelationalCostModel:
    """CostModel over relational plans using the stats registry.

    ``prune`` mirrors ``ExecutionConfig.prune``: pruning-aware scan
    pricing must only apply when the executor actually prunes —
    otherwise the no-pruning baseline would be priced for an execution
    path it never takes."""

    def __init__(self, reg: StatsRegistry,
                 consts: CostConstants | None = None,
                 prune: bool = True):
        self.reg = reg
        self.c = consts or CostConstants()
        self.prune = prune
        # predicted-vs-measured accuracy log, attached by the session's
        # telemetry (core.costmodel.CalibrationLog); None until then
        self.calibration_log = None

    def calibration(self) -> dict:
        """Predicted-vs-measured accuracy report (CE materializations
        and cached reads recorded by the executor)."""
        from ..core.costmodel import model_calibration

        return model_calibration(self)

    # ---- cardinalities ----------------------------------------------------
    def output_rows(self, node: L.Node) -> int:
        return max(1, int(self._rows(node)))

    def _rows(self, node: L.Node) -> float:
        if isinstance(node, L.Scan):
            return float(self.reg.scan_rows(node))
        if isinstance(node, L.CachedScan):
            return 1000.0  # post-rewrite leaf; not priced
        if isinstance(node, FusedPipeline):
            return (self._rows(node.source)
                    * selectivity(node.pred, self.reg))
        if isinstance(node, L.Filter):
            return self._rows(node.child) * selectivity(node.pred, self.reg)
        if isinstance(node, (L.Project, L.Sort, L.Cache)):
            return self._rows(node.child)
        if isinstance(node, L.Limit):
            return min(float(node.n), self._rows(node.child))
        if isinstance(node, L.Join):
            rl, rr = self._rows(node.left), self._rows(node.right)
            denom = 1.0
            for lc, rc in node.on:
                ndv_l = self.reg.col(lc).ndv if self.reg.col(lc) else 100
                ndv_r = self.reg.col(rc).ndv if self.reg.col(rc) else 100
                denom *= max(ndv_l, ndv_r)
            return max(1.0, rl * rr / max(denom, 1.0))
        if isinstance(node, L.Aggregate):
            child = self._rows(node.child)
            groups = 1.0
            for g in node.group_by:
                cs = self.reg.col(g)
                groups *= cs.ndv if cs else 100
            return max(1.0, min(child, groups))
        if isinstance(node, L.Union):
            return self._rows(node.left) + self._rows(node.right)
        raise TypeError(type(node))

    def output_bytes(self, node: L.Node) -> int:
        return int(self.output_rows(node) * node.schema.row_mem_bytes)

    # ---- execution cost C_E ------------------------------------------------
    def execution_cost(self, node: L.Node) -> float:
        req = required_columns(node)
        return self._cost(node, req)

    def _cost(self, node: L.Node, req: Dict[int, FrozenSet[str]]) -> float:
        c = self.c
        rows = self._rows(node)
        if isinstance(node, L.Scan):
            n = float(self.reg.scan_rows(node))
            needed = req.get(id(node), frozenset(node.schema.names))
            if node.fmt == "csv":
                # CSV must read whole rows, then parse the needed fields.
                read = n * node.schema.row_csv_bytes * c.io_csv
                parse = n * sum(node.schema.coltype(x).csv_width
                                for x in needed) * c.parse
                return read + parse
            col_bytes = n * sum(node.schema.coltype(x).mem_bytes
                                for x in needed)
            return col_bytes * c.io_col
        if isinstance(node, L.CachedScan):
            return 0.0
        if isinstance(node, FusedPipeline):
            # one pass over the source: every residual term is priced at
            # the fused rate, plus the gather of the projected output.
            # Partition pruning shrinks both the scan and the per-row
            # predicate work to the surviving partitions' rows (the
            # executor scans only those ranges), which is what gives
            # selective fused pipelines over partitioned tables their
            # tighter C_E — the OUTPUT estimate (`rows`) is unchanged,
            # since pruning only removes rows the predicate rejects.
            terms = max(_n_terms(node.pred), 1)
            src_cost = self._cost(node.source, req)
            src_rows = self._rows(node.source)
            if (self.prune and isinstance(node.source, L.Scan)
                    and node.source.parts is None):
                pruned = self.reg.pruned_rows(node.source.table, node.pred)
                if pruned is not None and src_rows > 0:
                    frac = min(1.0, pruned / src_rows)
                    src_cost *= frac
                    src_rows = float(pruned)
            return (src_cost
                    + src_rows * terms * c.fused_cmp
                    + rows * node.schema.row_mem_bytes * c.cpu_copy)
        if isinstance(node, L.Filter):
            terms = _n_terms(node.pred)
            return (self._cost(node.child, req)
                    + self._rows(node.child) * terms * c.cpu_cmp)
        if isinstance(node, L.Project):
            return self._cost(node.child, req)  # metadata-only in our engine
        if isinstance(node, L.Join):
            rl, rr = self._rows(node.left), self._rows(node.right)
            lb = rl * node.left.schema.row_mem_bytes
            rb = rr * node.right.schema.row_mem_bytes
            sort_cost = (rl * math.log2(max(rl, 2))
                         + rr * math.log2(max(rr, 2))) * c.sort
            shuffle = (lb + rb) * c.net
            build_out = rows * node.schema.row_mem_bytes * c.cpu_copy
            return (self._cost(node.left, req) + self._cost(node.right, req)
                    + sort_cost + shuffle + build_out)
        if isinstance(node, L.Aggregate):
            rc = self._rows(node.child)
            return (self._cost(node.child, req)
                    + rc * math.log2(max(rc, 2)) * c.sort
                    + rows * node.schema.row_mem_bytes * c.net)
        if isinstance(node, L.Sort):
            rc = self._rows(node.child)
            bytes_ = rc * node.schema.row_mem_bytes
            return (self._cost(node.child, req)
                    + rc * math.log2(max(rc, 2)) * c.sort + bytes_ * c.net)
        if isinstance(node, (L.Limit, L.Cache)):
            return self._cost(node.child, req)
        if isinstance(node, L.Union):
            return (self._cost(node.left, req) + self._cost(node.right, req)
                    + rows * node.schema.row_mem_bytes * c.cpu_copy)
        raise TypeError(type(node))

    # ---- cache costs C_W / C_R ----------------------------------------------
    def write_cost(self, node: L.Node) -> float:
        return self.output_bytes(node) * self.c.cache_w

    def read_cost(self, node: L.Node) -> float:
        return self.output_bytes(node) * self.c.cache_r

    def extraction_cost(self, tree: L.Node, member: L.Node) -> float:
        """Per-consumer residual cost of deriving ``member`` from the
        cached covering relation (paper Eq. 2's C_R prices only the raw
        byte read; a *divergent* consumer also re-applies its own
        predicates — one fused pass over the CE output under the fused
        executor).  Syntactically equal members extract by identity and
        cost nothing."""
        terms = _residual_terms(tree, member)
        if terms == 0:
            return 0.0
        ce_rows = self._rows(tree)
        gather = self.output_bytes(member) * self.c.cpu_copy
        return ce_rows * terms * self.c.fused_cmp + gather

    # ---- operator cardinality estimates (deferred-sync capacities) -------
    def filter_estimate(self, pred: E.Expr, in_rows: int) -> int:
        return max(0, int(in_rows * selectivity(pred, self.reg)))

    def plan_selectivity(self, plan: L.Node) -> float:
        """Combined selectivity of every filter in a plan — used to
        CONDITION residual estimates over a cached covering relation:
        base-table selectivities applied to CE-output rows would
        systematically undershoot (the CE already filtered by the OR of
        member predicates), forcing the overflow re-dispatch on exactly
        the consumer hot path."""
        s = 1.0
        if isinstance(plan, (L.Filter, FusedPipeline)):
            s *= selectivity(plan.pred, self.reg)
        for c in plan.children:
            s *= self.plan_selectivity(c)
        return min(max(s, 1e-6), 1.0)

    def join_estimate(self, on: Tuple[str, str], l_rows: int,
                      r_rows: int) -> int:
        lc, rc = on
        ndv_l = self.reg.col(lc).ndv if self.reg.col(lc) else 100
        ndv_r = self.reg.col(rc).ndv if self.reg.col(rc) else 100
        denom = max(ndv_l, ndv_r, 1)
        return max(1, int(l_rows * r_rows / denom))

    def union_estimate(self, l_rows: int, r_rows: int) -> int:
        """Union output capacity = sum of the input cardinality
        estimates (exact — union is append-only), letting the operator
        dispatch one fused compaction instead of per-column eager
        sizing (ROADMAP open item: deferred sync for Union)."""
        return max(1, int(l_rows) + int(r_rows))

    def window_dispatch_cost(self, n_queries: int, batched: bool) -> float:
        """Dispatch-overhead price of executing ``n_queries`` same-shape
        fused pipelines: batched = one shared mask launch + one
        compaction per query; per-query = a mask launch AND a compaction
        per query.  Data movement is identical either way (same scan,
        same output rows), so only launch overheads differ."""
        if batched:
            return (1 + n_queries) * self.c.dispatch
        return 2 * n_queries * self.c.dispatch

    def sort_estimate(self, in_rows: int) -> int:
        """Sort preserves cardinality, so the estimate is exact; it
        exists so the fused sort path sizes its output from the input
        cardinality (like filter/join/aggregate/union) instead of
        carrying the child's full padded capacity forward."""
        return max(1, int(in_rows))

    def group_estimate(self, group_by: Tuple[str, ...],
                       in_rows: int) -> int:
        groups = 1.0
        for g in group_by:
            cs = self.reg.col(g)
            groups *= cs.ndv if cs else 100
        return max(1, int(min(in_rows, groups)))


def _n_terms(e: E.Expr) -> int:
    if isinstance(e, E.Cmp):
        return 1
    if isinstance(e, E.In):
        return max(1, len(e.values))
    if isinstance(e, (E.And, E.Or)):
        return sum(_n_terms(p) for p in e.parts)
    if isinstance(e, E.Not):
        return _n_terms(e.part)
    return 0


def _residual_terms(tree: L.Node, member: L.Node) -> int:
    """Predicate terms the member must re-apply over the CE output:
    lock-step walk counting member filters whose predicate is wider in
    the covering tree (cf. rewriter._collect_divergent; commutative
    child alignment is skipped — this is an estimate, not a rewrite)."""
    total = 0
    if (isinstance(tree, L.Filter) and isinstance(member, L.Filter)
            and E.canonical(member.pred) != E.canonical(tree.pred)):
        total += _n_terms(member.pred)
    for tc, mc in zip(tree.children, member.children):
        total += _residual_terms(tc, mc)
    return total

"""Physical execution of logical plans.

The Spark analog: every operator materializes a fixed-shape columnar
relation (padded to a power-of-two capacity, as in the JAX package, so
plan-shape caches and capacities agree between the two).  Orchestration
is host-side Python — exactly like Spark's coordinator launching stages —
while each operator body is torch code on the session's device, and
every fused scan+filter mask comes from the CUDA ``filter_scan_batch``
kernel (``kernels.filter_project``) when the columns live on the card.

Two execution paths (see ROADMAP.md "Execution paths"):

  * **eager** — one torch call per operator, host-synchronized row
    counts after every data-dependent-shape operator (seed behavior;
    ``ExecContext(fuse=False, defer_sync=False, scan_cache=None)``);
  * **fused** (default) — ``relational.fuse`` collapses leaf→Filter*→
    Project chains into single-dispatch :class:`FusedPipeline` nodes, a
    device scan cache memoizes padded device columns across queries,
    and cardinality-estimate-driven output capacities defer the host
    sync (``int(count)``) until after the pipeline has dispatched,
    recompacting only on estimate overflow.  Compaction is sync-free
    (a cumsum + scatter in place of ``jnp.nonzero(size=...)``), so the
    count read stays the pipeline's one host sync.

Row sharding (the JAX package's ``shard_map`` route, one controller):
with ``sharding`` a port ``NamedSharding`` over one mesh axis, a scan's
padded capacity splits evenly over the axis's devices (shard ``j`` of
``n`` holds rows ``[j·cap/n, (j+1)·cap/n)`` on its device, a
:class:`RowShards`), CSV shards are decoded on their own devices, each
shard computes its own predicate mask through the filter kernels, and
the compacted shards are concatenated in shard order on the first
device, where every downstream operator runs.  A capacity the shard
count does not divide takes the single-device path.  The mask routes
and the compaction take a list of shards, and a relation on one device
is one shard, so both paths run the same code.

Storage formats (the paper's CSV vs Parquet axis):
  * ``csv``      — the table lives on "disk" (host memory) as one
    fixed-width UTF-8 byte matrix; a scan must move the WHOLE row bytes
    to the device and parse the needed fields with vectorized digit
    arithmetic (reproducing CSV parse/typecast cost).
  * ``columnar`` — typed host arrays per column; a scan moves only the
    needed columns (Parquet-analog column pruning).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.cache import CacheManager
from ..core.costmodel import CalibrationSample
from ..core.faults import DegradationEvent, InjectedFault
from ..core.memory import MemoryPool
from ..core.telemetry import NOOP_SPAN
from ..device import on_card, resolve_device, synchronize
from . import expr as E
from . import logical as L
from .canonical import subsumes as _subsumes
from .fuse import FusedPipeline, fuse_plan
from .partition import (PartitionInfo, PartitionedCePlan,
                        pid_presence_from_mask, prune_parts,
                        restrict_to_parts)
from .schema import Schema, Table, empty_like, next_pow2, torch_dtype

I32_SENTINEL = 2**31 - 1


class CEMaterializationError(RuntimeError):
    """A shared covering relation failed to materialize.  Raised to
    every consumer of the poisoned ψ (the first failure marks it in
    ``ctx.failed_ces``) so the service can rerun each consumer on its
    unshared residual plan instead of letting one bad CE take down the
    whole window."""

    def __init__(self, psi: bytes, cause: Optional[BaseException] = None):
        self.psi = psi
        self.cause = cause
        why = f": {cause!r}" if cause is not None else ""
        super().__init__(
            f"covering relation ψ={psi.hex()[:12]} failed to "
            f"materialize{why}")


class GroupDiverged(RuntimeError):
    """A planned window-batch group's members scanned inputs of
    different sizes, so one shared mask dispatch cannot serve them; its
    members run on the per-query path instead."""

# deferred-sync capacity estimates get this much slack before the
# overflow-recompact path triggers (estimation error is one-sided cheap:
# undershoot costs a recompact, overshoot only pads the output)
EST_HEADROOM = 1.25


# ---------------------------------------------------------------------------
# host-side storage ("disk")
# ---------------------------------------------------------------------------
@dataclass
class TableStorage:
    name: str
    schema: Schema
    nrows: int
    fmt: str                      # "csv" | "columnar"
    columnar: Optional[Dict[str, np.ndarray]] = None
    csv_bytes: Optional[np.ndarray] = None        # (nrows, row_csv_bytes) u8
    # horizontal partition layout (relational.partition): when set, rows
    # are re-clustered so each partition is a contiguous range, scans go
    # through per-partition device cache entries, and filter predicates
    # prune partitions before scanning
    partitions: Optional[PartitionInfo] = None

    @property
    def disk_bytes(self) -> int:
        if self.fmt == "csv":
            return int(self.csv_bytes.size)
        return int(sum(a.nbytes for a in self.columnar.values()))


@dataclass
class ExecMetrics:
    bytes_read_disk: int = 0
    bytes_parsed: int = 0
    bytes_cached_read: int = 0
    bytes_scan_cache_read: int = 0
    rows_processed: int = 0
    # plan-shape compile cache: hits reuse a jitted fused pipeline keyed
    # by canonical plan shape (literals slotted out); misses traced one
    trace_hits: int = 0
    trace_misses: int = 0
    # window batching: shared dispatches and the queries they covered
    batched_dispatches: int = 0
    batched_queries: int = 0
    # pid bitset pool: resident bitsets used by lookups, the
    # partitions they pruned beyond statistics, and new recordings
    pid_hits: int = 0
    pid_pruned_parts: int = 0
    pid_records: int = 0
    op_seconds: Dict[str, float] = field(default_factory=dict)

    def add_time(self, op: str, dt: float):
        self.op_seconds[op] = self.op_seconds.get(op, 0.0) + dt


@dataclass
class ExecContext:
    catalog: Dict[str, TableStorage]
    cache: Optional[CacheManager] = None
    cache_plans: Dict[bytes, L.Node] = field(default_factory=dict)
    # psi -> cost-model savings estimate (Eq. 3 value), forwarded to the
    # memory manager at materialization time so benefit-per-byte
    # eviction can rank CE entries
    cache_values: Dict[bytes, float] = field(default_factory=dict)
    metrics: ExecMetrics = field(default_factory=ExecMetrics)
    # the device every scan puts its columns on (None -> cuda)
    device: Optional[torch.device] = None
    # multi-device row sharding: a port NamedSharding over one mesh axis
    # (see shard_devices); ``shards`` is the resolved device list
    sharding: Optional[object] = None
    shards: Optional[List[torch.device]] = None
    # emulate slow disk: per-byte sleep (used by benchmarks to model I/O)
    disk_latency_per_byte: float = 0.0
    # also route predicates that fall off the slotted program through
    # the literal-program ``filter_scan`` kernel (the slotted route
    # launches ``filter_scan_batch`` on CUDA tensors either way)
    use_pallas_filter: bool = False
    # collapse Scan→Filter*→Project chains into single-dispatch
    # FusedPipeline nodes (see relational.fuse)
    fuse: bool = True
    # device scan cache: (table, column, capacity, sharding) -> padded
    # device array, shared across queries/batches.  Either a budgeted
    # MemoryPool (Session default — evictable under the session-wide
    # device budget) or a raw dict (unbounded; kept for tests and
    # standalone ExecContexts).
    scan_cache: Optional[object] = None
    # cardinality estimator (duck-typed RelationalCostModel) enabling
    # deferred host synchronization: output capacities are picked from
    # estimates so operator pipelines dispatch without a blocking
    # int(count) per operator; the count validates afterwards and a
    # recompact runs only on estimate overflow
    cost_model: Optional[object] = None
    defer_sync: bool = True
    # partition pruning: fused pipelines over partitioned tables skip
    # partitions whose statistics refute the predicate (conservative —
    # disable to force the unpruned path, e.g. for bit-identity tests)
    prune: bool = True
    # plan-shape compile cache: route fused filters through SLOTTED
    # predicate programs (literals hoisted into operand arrays) so
    # recurring templates with fresh constants never re-trace; disable
    # to force the legacy literal-keyed jit path
    shape_cache: bool = True
    # strict cache key -> PartitionedCePlan for every partition-grained
    # CE this window selected: reads compose resident partitions from
    # the cache with per-partition recomputation of the cold ones
    partitioned_ces: Dict[bytes, PartitionedCePlan] = \
        field(default_factory=dict)
    # window-scoped memo of recomputed NON-admitted partitions: like a
    # whole-CE materialization, a cold partition is computed once per
    # window and shared by every consumer — but unlike admitted
    # entries it dies with the window's context instead of occupying
    # the budgeted cache.  Pinning is bounded by ONE device budget
    # (see _memo_put) — the same order as any operator's transient
    # output; beyond that the memo degrades to recompute-per-read
    # instead of holding unbounded device bytes the MCKP rejected.
    ce_part_memo: Dict[tuple, "Table"] = field(default_factory=dict)
    ce_part_memo_bytes: int = 0
    # optional core.faults.FaultInjector — the scan_h2d / kernel_launch /
    # ce_admission points fire through ctx.check_fault(...)
    faults: Optional[object] = None
    # strict keys of CEs whose materialization failed this window:
    # consumers of a poisoned CE fail fast (CEMaterializationError) so
    # the service can rerun them on their unshared residual plans
    failed_ces: set = field(default_factory=set)
    # core.memory.PidPool (or None): partition-ID bitsets recorded as a
    # side effect of fused execution and intersected on later lookups
    # to prune by observed history on top of the stats pruner
    pid_cache: Optional[object] = None
    # (table, canonical pred) -> partitions the pid intersection pruned
    # BEYOND statistics this window (read by service explain())
    pid_prune_log: Dict[tuple, int] = field(default_factory=dict)
    # DegradationEvents raised below the service layer (a failed pid
    # bitset read degrades to stats-only pruning here instead of
    # surfacing — a pid hit is an optimization, never a failure domain)
    degradations: list = field(default_factory=list)
    # optional relational.observe.Telemetry: calibration samples
    # on CE materializations / cached reads, spans on H2D + dispatch
    # when tracing is enabled.  None for standalone contexts.
    telemetry: Optional[object] = None

    def __post_init__(self):
        self.shards = shard_devices(self.sharding)
        if self.device is None and self.sharding is not None:
            self.device = first_shard_device(self.sharding)
        self.device = resolve_device(self.device)
        if self.sharding is not None and \
                self.device != first_shard_device(self.sharding):
            raise ValueError(
                f"a sharded context runs on its mesh's first device "
                f"{first_shard_device(self.sharding)}, not {self.device}")

    def check_fault(self, point: str, key=None) -> None:
        if self.faults is not None:
            self.faults.check(point, key=key)

    def span(self, name: str, **attrs):
        """A lifecycle span when tracing is on; the shared no-op
        context manager otherwise (zero allocations)."""
        tel = self.telemetry
        if tel is not None and tel.tracer.enabled:
            return tel.tracer.span(name, **attrs)
        return NOOP_SPAN

    def _memo_put(self, key: tuple, table: "Table") -> bool:
        allowance = float("inf")
        manager = getattr(self.cache, "manager", None) \
            if self.cache is not None else None
        if manager is not None:
            allowance = manager.device_budget
        if self.ce_part_memo_bytes + table.nbytes <= allowance:
            self.ce_part_memo[key] = table
            self.ce_part_memo_bytes += table.nbytes
            return True
        return False

    def _memo_drop(self, key: tuple) -> None:
        t = self.ce_part_memo.pop(key, None)
        if t is not None:
            self.ce_part_memo_bytes -= t.nbytes

    def estimate(self, kind: str, *args) -> Optional[int]:
        """Cardinality estimate for deferred sync; None -> eager sync."""
        if not self.defer_sync or self.cost_model is None:
            return None
        fn = getattr(self.cost_model, f"{kind}_estimate", None)
        if fn is None:
            return None
        return int(fn(*args))

    @classmethod
    def from_exec_config(cls, catalog: Dict[str, "TableStorage"], cfg,
                         *, cache: Optional[CacheManager] = None,
                         cost_model: Optional[object] = None,
                         scan_cache: Optional[object] = None,
                         pid_cache: Optional[object] = None
                         ) -> "ExecContext":
        """Build a context from anything shaped like an
        ``relational.service.ExecutionConfig`` (a Session mirrors the
        same attributes) — the single place execution-path knobs are
        translated into a context."""
        return cls(
            catalog=catalog, cache=cache,
            device=getattr(cfg, "device", None),
            sharding=getattr(cfg, "sharding", None),
            disk_latency_per_byte=getattr(cfg, "disk_latency_per_byte",
                                          0.0),
            use_pallas_filter=getattr(cfg, "use_pallas_filter", False),
            fuse=cfg.fuse,
            defer_sync=cfg.defer_sync,
            prune=getattr(cfg, "prune", True),
            shape_cache=getattr(cfg, "shape_cache", True),
            cost_model=cost_model,
            scan_cache=scan_cache,
            pid_cache=pid_cache,
            faults=getattr(cfg, "fault_injector", None),
            telemetry=getattr(cfg, "_telemetry", None))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def _axis_devices(sharding) -> List[torch.device]:
    """The devices along the sharding's one spec axis, in shard order
    (the first position of every other mesh axis)."""
    from ..launch.sharding import NamedSharding

    spec = sharding.spec if isinstance(sharding, NamedSharding) else None
    if spec is not None and len(spec) == 1 and isinstance(spec[0], tuple) \
            and len(spec[0]) == 1:
        spec = (spec[0][0],)
    if spec is None or len(spec) != 1 or not isinstance(spec[0], str) \
            or spec[0] not in sharding.mesh.axis_names:
        raise TypeError(
            f"ExecutionConfig.sharding takes a repro_torch.launch.sharding."
            f"NamedSharding over one mesh axis, e.g. NamedSharding(mesh, "
            f"('data',)); got {sharding!r}")
    mesh = sharding.mesh
    devs = np.moveaxis(mesh.devices, mesh.axis_names.index(spec[0]), 0)
    return list(devs.reshape(devs.shape[0], -1)[:, 0])


def shard_devices(sharding) -> Optional[List[torch.device]]:
    """The shard devices of a row sharding, or None for the single-
    device path (no sharding, or one shard).  Raises TypeError for
    anything but a port NamedSharding with a one-axis spec."""
    if sharding is None:
        return None
    devs = _axis_devices(sharding)
    return devs if len(devs) > 1 else None


def first_shard_device(sharding) -> torch.device:
    """The device a sharded session's downstream operators run on."""
    return _axis_devices(sharding)[0]


class RowShards:
    """A column split by rows over a mesh axis: ``shards[j]`` holds rows
    ``[j·n_local, (j+1)·n_local)`` on its own device.  Shape, dtype and
    byte counts are the GLOBAL column's, as a sharded ``jax.Array``'s
    are, so pool books and MQO decisions equal the single-device
    session's."""

    __slots__ = ("shards",)

    def __init__(self, shards: List[torch.Tensor]):
        self.shards = list(shards)

    @property
    def shape(self) -> Tuple[int, ...]:
        first = self.shards[0]
        return (first.shape[0] * len(self.shards),) + tuple(first.shape[1:])

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def numel(self) -> int:
        return sum(s.numel() for s in self.shards)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def map(self, fn) -> "RowShards":
        return RowShards([fn(s) for s in self.shards])

    def gather(self) -> torch.Tensor:
        """The whole column on the first shard's device."""
        dev = self.device
        return torch.cat([s.to(dev) for s in self.shards], 0)


def _is_sharded(table: "Table") -> bool:
    return any(isinstance(c, RowShards) for c in table.columns.values())


def _gathered(table: "Table") -> "Table":
    """``table`` with every RowShards column concatenated on the first
    shard's device (the operators past a scan take whole columns)."""
    if not _is_sharded(table):
        return table
    return Table(table.schema, {n: c.gather()
                                for n, c in table.columns.items()},
                 table.nrows)


def _parse_fields(raw: torch.Tensor, fields) -> List[torch.Tensor]:
    """Fields ``(byte offset, width)`` of the raw CSV rows, decoded in
    one pass (width 10 -> int32, width 8 -> float32): one launch of the
    CUDA ``parse_fields`` kernel on the card, the plain versions on the
    CPU."""
    from ..kernels.filter_project.ops import parse_fields
    return parse_fields(raw, fields)


def _csv_columns(raw: torch.Tensor, schema, needed: Tuple[str, ...],
                 nrows: int, ctx: "ExecContext") -> Dict[str, torch.Tensor]:
    """The ``needed`` columns of a CSV scan's raw rows: every numeric
    field decoded by ONE ``_parse_fields`` call, string fields the raw
    byte slice.  Row-sharded raw bytes are decoded shard by shard, each
    by one call on its own device."""
    offsets = schema.csv_offsets()
    numeric = [n for n in needed
               if schema.coltype(n).kind in ("i32", "f32")]
    fields = [offsets[n] for n in numeric]
    if isinstance(raw, RowShards):
        per_shard = [_parse_fields(r, fields) for r in raw.shards] \
            if numeric else []
        decoded = {n: RowShards([d[i] for d in per_shard])
                   for i, n in enumerate(numeric)}
    else:
        decoded = dict(zip(numeric, _parse_fields(raw, fields))) \
            if numeric else {}
    cols: Dict[str, torch.Tensor] = {}
    for name in needed:
        off, w = offsets[name]
        ctx.metrics.bytes_parsed += nrows * w
        if name in decoded:
            cols[name] = decoded[name]
        elif isinstance(raw, RowShards):
            cols[name] = raw.map(lambda r, a=off, b=off + w: r[:, a:b])
        else:
            cols[name] = raw[:, off:off + w]
    return cols


def _pred_mask(pred: E.Expr, names: Tuple[str, ...], nrows: int, cols):
    columns = dict(zip(names, cols))
    mask = E.eval_expr(pred, columns)
    mask = mask & (_arange(cols[0].shape[0], mask.device) < nrows)
    return mask, mask.sum(dtype=torch.int32)


# plan-shape cache: (program, pred cols, n_queries, capacity, block,
# dtypes, device) -> the program encoded for the kernel.  Keyed like the
# JAX package's jit cache, so trace_hits / trace_misses keep their
# meaning: a miss encodes (and uploads) a program, a hit reuses it.
_FN_CACHE: Dict[tuple, object] = {}


def _shape_cached(ctx: "ExecContext", key, builder):
    """Fetch a plan-SHAPE keyed entry (literals slotted out), with
    hit/miss accounting: a miss here is a fresh program encoding; a hit
    means a recurring template reused it."""
    fn = _FN_CACHE.get(key)
    if fn is None:
        ctx.metrics.trace_misses += 1
        fn = _FN_CACHE[key] = builder()
    else:
        ctx.metrics.trace_hits += 1
    return fn


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _take(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return c.index_select(0, idx)


def _nonzero_static(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the set entries in ascending order, the first ``size``
    of them, padded with index 0 — ``jnp.nonzero(mask, size=size,
    fill_value=0)`` — without a host sync (``torch.nonzero`` must read
    the count).  Each kept row writes its own slot; rows past ``size``
    all write one spare slot that is cut off."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.zeros(size + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, _arange(n, mask.device))
    return out[:size]


def _compact(mask: torch.Tensor, new_cap: int, *cols):
    """Bring mask-selected rows to the front; slice to new_cap."""
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    sel = order[:new_cap]
    return tuple(_take(c, sel) for c in cols)


def _compact_nz(mask: torch.Tensor, new_cap: int, *cols):
    """O(n) compaction (vs the sort in ``_compact``).

    Selected row indices come in ascending order — the same live rows,
    in the same order, as the stable sort of ~mask; fill rows (beyond
    the selected count) simply repeat row 0, which is compaction slack
    every operator already tolerates.  Used on the fused/deferred
    paths; the plain ``_compact`` is kept as the seed eager behavior.
    """
    sel = _nonzero_static(mask, new_cap)
    return tuple(_take(c, sel) for c in cols)


def _sort_sentinel(k: torch.Tensor):
    """Dtype-matched +inf analog for masking padding rows before a sort
    (int32 AND int64 keys get their exact integer max, not a float)."""
    if E.is_int_dtype(k.dtype):
        return torch.tensor(torch.iinfo(k.dtype).max, dtype=k.dtype,
                            device=k.device)
    return torch.tensor(float("inf"), dtype=k.dtype, device=k.device)


def _argsort(k: torch.Tensor) -> torch.Tensor:
    return torch.sort(k, stable=True).indices


def _join_build(rk: torch.Tensor, r_nrows: int):
    valid = _arange(rk.shape[0], rk.device) < r_nrows
    masked = torch.where(valid, rk, _sort_sentinel(rk))
    order = _argsort(masked)
    return order, _take(masked, order)


def _join_probe(lk: torch.Tensor, rk_sorted: torch.Tensor, l_nrows: int):
    valid = _arange(lk.shape[0], lk.device) < l_nrows
    keys = torch.where(valid, lk, _sort_sentinel(lk))
    lo = torch.searchsorted(rk_sorted, keys, side="left")
    hi = torch.searchsorted(rk_sorted, keys, side="right")
    m = torch.where(valid & (keys != I32_SENTINEL), hi - lo, 0)
    return lo, m, m.sum()


def _join_expand(lo: torch.Tensor, m: torch.Tensor, out_cap: int,
                 r_cap: int):
    """Left/right row indices of the first ``out_cap`` join outputs
    (left rows in order, each repeated by its match count).  Output
    positions past the true total get clamped in-range indices: their
    rows are padding and never read as live."""
    ends = torch.cumsum(m, 0)
    starts = ends - m
    p = _arange(out_cap, m.device)
    li = torch.searchsorted(ends, p, right=True).clamp_(max=m.shape[0] - 1)
    ri = (_take(lo, li) + p - _take(starts, li)).clamp_(0, r_cap - 1)
    return li, ri


def _agg_seg_ids(nrows: int, *keys):
    """Sort rows by the group keys (lexicographic, stable, padding last)
    and number the groups.  Returns (order, gid, sorted_valid, newgrp,
    n_groups); every group is a contiguous run of the sorted order."""
    n = keys[0].shape[0]
    dev = keys[0].device
    valid = _arange(n, dev) < nrows
    sk = [torch.where(valid, k, _sort_sentinel(k)) for k in keys]
    # stable sorts from the least significant key up compose into the
    # lexicographic order (jnp.lexsort with sk[0] as the primary key)
    order = _arange(n, dev)
    for k in reversed(sk):
        order = _take(order, _argsort(_take(k, order)))
    sorted_valid = _take(valid, order)
    newgrp = torch.zeros(n, dtype=torch.bool, device=dev)
    newgrp[0] = True
    for k in sk:
        k = _take(k, order)
        newgrp = newgrp | (k != torch.roll(k, 1))
    newgrp = newgrp & sorted_valid
    gid = torch.cumsum(newgrp, 0) - 1
    return order, gid, sorted_valid, newgrp, newgrp.sum()


def _segment_reduce(fns, vals, order, gid, sorted_valid, newgrp,
                    n_groups, cap: int):
    """Per-group reductions over the sorted rows into ``cap`` slots
    (groups at or beyond ``cap`` are dropped, as a JAX segment op drops
    out-of-range ids).  Deterministic on every device: sums are prefix
    sums read at each group's first and last row (ints exact mod 2^w,
    f32 through f64), min/max an order-free scatter-reduce — no float
    atomics, whose order changes from run to run.  Returns
    (outputs, first sorted row of each group)."""
    n = order.shape[0]
    dev = order.device
    rows = _arange(n, dev)
    in_cap = sorted_valid & (gid < cap)
    is_last = sorted_valid.clone()
    is_last[:-1] &= ~sorted_valid[1:] | newgrp[1:]
    first = torch.full((cap + 1,), n - 1, dtype=torch.int64, device=dev)
    first.scatter_(0, torch.where(newgrp & in_cap, gid, cap), rows)
    last = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_(0, torch.where(is_last & in_cap, gid, cap), rows)
    first, last = first[:cap], last[:cap]
    live = _arange(cap, dev) < n_groups

    def seg_sum(v: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
        cs = torch.cumsum(torch.where(sorted_valid, v.to(acc),
                                      torch.zeros((), dtype=acc,
                                                  device=dev)), 0)
        cs = torch.cat([torch.zeros(1, dtype=acc, device=dev), cs])
        s = _take(cs, (last + 1).clamp_(min=0)) - _take(cs, first)
        return torch.where(live, s, torch.zeros((), dtype=acc, device=dev))

    count = torch.where(live, last - first + 1, 0)
    slot = torch.where(in_cap, gid, cap)
    outs = []
    for fn_name, v in zip(fns, vals):
        sv = _take(v, order)
        if fn_name == "count":
            o = count.to(torch.int32)
        elif fn_name == "mean":
            s = seg_sum(sv, torch.float64).to(torch.float32)
            o = s / torch.clamp(count.to(torch.float32), min=1.0)
        elif fn_name in ("min", "max"):
            if E.is_int_dtype(sv.dtype):
                info = torch.iinfo(sv.dtype)
                fill = info.max if fn_name == "min" else info.min
            else:
                fill = float("inf") if fn_name == "min" else float("-inf")
            src_ = torch.where(sorted_valid, sv,
                               torch.tensor(fill, dtype=sv.dtype,
                                            device=dev))
            o = torch.full((cap + 1,), fill, dtype=sv.dtype, device=dev)
            o.scatter_reduce_(0, slot, src_, reduce="a" + fn_name)
            o = o[:cap]
        elif E.is_int_dtype(sv.dtype):
            o = seg_sum(sv, torch.int64).to(sv.dtype)
        else:
            o = seg_sum(sv, torch.float64).to(sv.dtype)
        outs.append(o)
    return tuple(outs), first


# ---------------------------------------------------------------------------
# operator implementations
# ---------------------------------------------------------------------------
def _device_put(arr: np.ndarray, ctx: ExecContext,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of a host array on the context's device, cast to the
    column's ``dtype`` (host arrays may be wider, e.g. f64 for an f32
    column, which ``jnp.asarray`` narrows the same way).  A sharded
    context splits the rows evenly over its shard devices (a
    :class:`RowShards`, one ``scan_h2d`` fault point and span per
    shard) when the shard count divides them, as ``jax.device_put``
    onto a NamedSharding does; otherwise the copy goes to the first
    device."""
    shards = ctx.shards
    if shards and arr.ndim >= 1 and arr.shape[0] % len(shards) == 0:
        n_local = arr.shape[0] // len(shards)
        return RowShards([
            _put_one(arr[j * n_local:(j + 1) * n_local], ctx, dtype, dev)
            for j, dev in enumerate(shards)])
    return _put_one(arr, ctx, dtype, ctx.device)


def _put_one(arr: np.ndarray, ctx: ExecContext,
             dtype: Optional[torch.dtype],
             device: torch.device) -> torch.Tensor:
    ctx.check_fault("scan_h2d")
    with ctx.span("scan.h2d", nbytes=int(arr.nbytes)):
        if ctx.disk_latency_per_byte:
            time.sleep(arr.nbytes * ctx.disk_latency_per_byte)
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype is not None and host.dtype != dtype:
            host = host.to(dtype)
        elif device.type == "cpu":
            return host.clone()
        return host.to(device)


def _pad_rows(arr: np.ndarray, cap: int) -> np.ndarray:
    """Zero-pad the row dim to ``cap`` (no copy when already there)."""
    if cap == arr.shape[0]:
        return arr
    pad_shape = (cap - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, arr.dtype)], 0)


def _scan_pool_put(ctx: ExecContext, key: tuple, dev: torch.Tensor,
                   benefit: float) -> None:
    """Single admission point for the scan pool (whole-table,
    per-partition, and assembled entries all rank under one benefit
    unit system); raw-dict caches (tests) just store."""
    sc = ctx.scan_cache
    if isinstance(sc, MemoryPool):
        nbytes = dev.numel() * dev.element_size()
        sc.put(key, dev, nbytes=nbytes, benefit=benefit)
    elif sc is not None:
        sc[key] = dev


def _reread_benefit(ctx: ExecContext, host_nbytes: int) -> float:
    """Benefit of a scan entry: the re-read cost it saves per hit, in
    the SAME units as the CostModel's Eq. 3 values that CE entries
    carry (per-byte columnar io + modeled disk latency), so
    benefit-per-byte eviction ranks the two pools consistently."""
    io = getattr(getattr(ctx.cost_model, "c", None), "io_col", 1e-9)
    return host_nbytes * (io + ctx.disk_latency_per_byte)


def _scan_cached(ctx: ExecContext, key: tuple, host, cap: int,
                 host_nbytes: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Padded device column, memoized per (table, col, cap, sharding).

    Repeated scans across a batch (and across batches of the same
    Session) skip both the host-side pad copy and the host→device
    transfer — the dominant per-scan cost once plans are compiled.
    ``host`` may be a zero-arg callable building the host array lazily
    (with ``host_nbytes`` supplied for metrics): an expensive host-side
    assembly then only runs on a cache miss.
    """
    sc = ctx.scan_cache
    lazy = callable(host)
    nbytes = host_nbytes if lazy else host.nbytes
    if sc is not None:
        key = key + (cap, str(ctx.sharding))
        hit = sc.get(key)
        if hit is not None:
            ctx.metrics.bytes_scan_cache_read += nbytes
            return hit
    host_arr = host() if lazy else host
    dev = _device_put(_pad_rows(host_arr, cap), ctx, dtype)
    ctx.metrics.bytes_read_disk += host_arr.nbytes
    _scan_pool_put(ctx, key, dev, _reread_benefit(ctx, host_arr.nbytes))
    return dev


def _scan_part_cached(ctx: ExecContext, key: tuple,
                      host_slice: np.ndarray,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """UNPADDED device copy of one partition's rows, memoized per
    (table, column/"__csv__", "part", pid).  Partition-grained entries
    are what different prune sets share: a scan pruned to {1, 3} and a
    later one pruned to {3, 5} both reuse partition 3's bytes."""
    sc = ctx.scan_cache
    if sc is not None:
        hit = sc.get(key)
        if hit is not None:
            ctx.metrics.bytes_scan_cache_read += host_slice.nbytes
            return hit
    dev = _device_put(host_slice, ctx, dtype)
    ctx.metrics.bytes_read_disk += host_slice.nbytes
    _scan_pool_put(ctx, key, dev, _reread_benefit(ctx, host_slice.nbytes))
    return dev


def _assemble(pieces: list, cap: int, like: torch.Tensor) -> torch.Tensor:
    """Concatenate partition arrays and zero-pad the row dim to cap."""
    total = sum(int(p.shape[0]) for p in pieces)
    pad = cap - total
    if pad:
        pieces = pieces + [like.new_zeros((pad,) + tuple(like.shape[1:]))]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, 0)


def _parts_assembled(ctx: ExecContext, st: "TableStorage", colname: str,
                     host_arr: np.ndarray, parts, ranges,
                     cap: int,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Padded device column assembled from per-partition cache entries,
    with the ASSEMBLY itself memoized per (table, col, parts, cap) —
    repeat scans with the same prune set skip the device concat (the
    warm-scan fast path), while the per-partition entries remain
    the shareable source tier for other prune sets.  Assembled entries
    carry a low benefit (rebuilding one is just a concat over resident
    pieces), so benefit-ranked eviction drops them before the pieces."""
    sc = ctx.scan_cache
    akey = (st.name, colname, "asm", tuple(parts), cap)
    if sc is not None:
        hit = sc.get(akey)
        if hit is not None:
            row_bytes = host_arr.nbytes // max(host_arr.shape[0], 1)
            live = sum(hi - lo for lo, hi in ranges)
            ctx.metrics.bytes_scan_cache_read += row_bytes * live
            return hit
    pieces = [_scan_part_cached(ctx, (st.name, colname, "part", p),
                                host_arr[lo:hi], dtype)
              for p, (lo, hi) in zip(parts, ranges) if hi > lo]
    arr = _assemble(pieces, cap, pieces[0])
    if pieces and arr is pieces[0]:
        return arr      # identity assembly: already cached per-part
    # low benefit: rebuilding is one device concat over resident pieces
    nbytes = arr.numel() * arr.element_size()
    _scan_pool_put(ctx, akey, arr, benefit=nbytes * 3e-10)
    return arr


def _exec_scan_partitioned(node: L.Scan, st: TableStorage,
                           info: PartitionInfo, ctx: ExecContext,
                           needed: Tuple[str, ...]) -> Table:
    """Scan a partitioned table: only the selected contiguous partition
    ranges are read, through per-partition device cache entries
    (ascending partition id, so the result is the unpruned relation
    with non-selected partitions' rows deleted, order preserved).

    With a sharded context the selected ranges are assembled host-side
    and placed split over the shard devices; the assembled array is
    memoized per partition SET, trading cross-prune-set reuse for
    single-placement scans (the JAX package's sharded-scan caveat).
    """
    parts = node.parts if node.parts is not None else info.all_parts()
    nrows = info.rows_of(parts)
    cap = next_pow2(max(nrows, 1))
    schema = st.schema.select(needed)
    if nrows == 0:       # every partition pruned (or restricted) away
        return Table(schema, empty_like(schema, cap, ctx.device), 0)
    ranges = [info.part_range(p) for p in parts]
    cols: Dict[str, torch.Tensor] = {}

    def host_assembly(arr: np.ndarray):
        """Lazy host-side concat of the selected ranges (runs only on
        a scan-cache miss — warm sharded scans skip the memcpy) plus
        the live byte count for hit metrics."""
        if len(parts) == info.n_partitions:
            return (lambda: arr), arr.nbytes
        row_bytes = arr.nbytes // max(arr.shape[0], 1)
        live = sum(hi - lo for lo, hi in ranges)
        return (lambda: np.concatenate(
            [arr[lo:hi] for lo, hi in ranges if hi > lo], 0)), \
            row_bytes * live

    sharded = ctx.shards is not None
    if st.fmt == "csv":
        if sharded:
            build, live_bytes = host_assembly(st.csv_bytes)
            raw = _scan_cached(ctx, (st.name, "__csv__", parts), build,
                               cap, host_nbytes=live_bytes)
        else:
            raw = _parts_assembled(ctx, st, "__csv__", st.csv_bytes,
                                   parts, ranges, cap)
        cols = _csv_columns(raw, st.schema, needed, nrows, ctx)
    else:
        for name in needed:
            dtype = torch_dtype(st.schema.coltype(name))
            if sharded:
                build, live_bytes = host_assembly(st.columnar[name])
                cols[name] = _scan_cached(
                    ctx, (st.name, name, parts), build, cap,
                    host_nbytes=live_bytes, dtype=dtype)
            else:
                cols[name] = _parts_assembled(
                    ctx, st, name, st.columnar[name], parts, ranges, cap,
                    dtype)
    return Table(schema, cols, nrows)


def _exec_scan(node: L.Scan, ctx: ExecContext,
               needed: Tuple[str, ...]) -> Table:
    st = ctx.catalog[node.table]
    if st.partitions is not None and st.partitions.n_partitions > 1:
        return _exec_scan_partitioned(node, st, st.partitions, ctx, needed)
    cap = next_pow2(st.nrows)
    cols: Dict[str, torch.Tensor] = {}
    if st.fmt == "csv":
        # must read the WHOLE row bytes (CSV is row-oriented); only the
        # raw byte matrix is memoized — the parse/typecast still runs
        # per scan (it is the CSV format's intrinsic cost, and what the
        # paper's covering-expression cache exists to avoid)
        raw = _scan_cached(ctx, (st.name, "__csv__"), st.csv_bytes, cap)
        cols = _csv_columns(raw, st.schema, needed, st.nrows, ctx)
    else:
        for name in needed:
            cols[name] = _scan_cached(
                ctx, (st.name, name), st.columnar[name], cap,
                dtype=torch_dtype(st.schema.coltype(name)))
    schema = st.schema.select(needed)
    return Table(schema, cols, st.nrows)


def _est_cap(est: int, upper: int) -> int:
    """Power-of-two output capacity from a cardinality estimate."""
    cap = next_pow2(max(int(est * EST_HEADROOM), 1))
    return max(1, min(cap, next_pow2(max(upper, 1))))


def _deferred_dispatch(dispatch, est: int, upper: int, count):
    """The deferred-sync pattern, shared by filter/join/aggregate and
    the fused pipeline: dispatch at the estimate-sized capacity BEFORE
    the host reads the true count, validate, and re-dispatch at the
    exact size only on estimate overflow.  ``upper`` bounds the
    *speculative* allocation (an overestimate must never allocate more
    than the operator could legitimately produce — or, for joins, a
    sane multiple of its inputs); the overflow re-dispatch uses the
    true count, which by then is known to be a real requirement.

    A large OVERestimate is also re-dispatched at the tight size (one
    pow2 step of slack is tolerated): the padded buffer would otherwise
    outlive the operator — returned as a query result or, worse,
    admitted to the CE cache at its padded nbytes, evicting entries the
    knapsack believed would fit.

    Returns (dispatch result, int count).
    """
    cap = _est_cap(est, upper)
    out = dispatch(cap)
    n = int(count)
    tight = next_pow2(max(n, 1))
    if n > cap or cap > 2 * tight:
        out = dispatch(tight)
    return out, n


def _exec_filter(pred: E.Expr, child: Table, ctx: ExecContext) -> Table:
    names = child.schema.names
    mask = count = None
    if ctx.use_pallas_filter or on_card(ctx.device):
        # on the card the literal-program kernel, whatever
        # use_pallas_filter says
        mask, count = _try_pallas_filter(pred, child)
    if mask is None:
        mask, count = _pred_mask(pred, names, child.nrows,
                                 [child.columns[n] for n in names])
    cols = [child.columns[n] for n in names]
    est = ctx.estimate("filter", pred, child.nrows)
    if est is not None:
        out, count = _deferred_dispatch(
            lambda cap: _compact_nz(mask, cap, *cols),
            est, child.capacity, count)
    else:
        count = int(count)
        out = _compact(mask, next_pow2(max(count, 1)), *cols)
    ctx.metrics.rows_processed += child.nrows
    return Table(child.schema, dict(zip(names, out)), count)


def _exec_join(node: L.Join, left: Table, right: Table,
               ctx: ExecContext) -> Table:
    assert len(node.on) == 1, "single-key equi-joins (engine restriction)"
    lc, rc = node.on[0]
    if not left.schema.has(lc):
        lc, rc = rc, lc
    lk, rk = left.columns[lc], right.columns[rc]
    assert lk.dtype == torch.int32, "join keys must be int32"

    # build side = right (sorted); probe = left.  Padding rows beyond
    # nrows hold stale values (compaction slack) — mask them to the
    # sentinel BEFORE sorting so rk_sorted is genuinely ascending and
    # searchsorted never matches padding.
    order, rk_sorted = _join_build(rk, right.nrows)
    lo, m, total = _join_probe(lk, rk_sorted, left.nrows)

    def gather(out_cap: int) -> Dict[str, torch.Tensor]:
        li, ri = _join_expand(lo, m, out_cap, right.capacity)
        out: Dict[str, torch.Tensor] = {}
        for n in left.schema.names:
            out[n] = _take(left.columns[n], li)
        for n in right.schema.names:
            out[n] = _take(_take(right.columns[n], order), ri)
        return out

    est = ctx.estimate("join", (lc, rc), left.nrows, right.nrows)
    if est is not None:
        # bound the speculative gather at a small multiple of the
        # larger input — a runaway NDV-based estimate (e.g. join keys
        # with no stats) must not allocate |L|x|R|-sized arrays; a true
        # output beyond the bound just takes the overflow re-gather
        upper = 4 * max(left.nrows, right.nrows, 1)
        cols, total = _deferred_dispatch(gather, est, upper, total)
    else:
        total = int(total)
        cols = gather(next_pow2(max(total, 1)))
    ctx.metrics.rows_processed += left.nrows + right.nrows
    return Table(left.schema.concat(right.schema), cols, total)


def _exec_aggregate(node: L.Aggregate, child: Table,
                    ctx: ExecContext) -> Table:
    n = child.capacity
    keys = [child.columns[g] for g in node.group_by]
    assert all(k.ndim == 1 for k in keys), "group keys must be scalar cols"

    order, gid, sorted_valid, newgrp, n_groups = _agg_seg_ids(
        child.nrows, *keys)

    est = ctx.estimate("group", node.group_by, child.nrows)
    fns = tuple(fn for _, fn, _ in node.aggs)
    vals = tuple(child.columns[c if c else node.group_by[0]]
                 for _, fn, c in node.aggs)

    def run_reduce(cap: int):
        return _segment_reduce(fns, vals, order, gid, sorted_valid, newgrp,
                               n_groups, cap)

    if est is not None:
        # deferred sync: size the segment reduction from the NDV
        # estimate and dispatch it before reading the true group count;
        # group ids beyond the capacity are dropped, so an
        # underestimate only triggers the overflow re-reduce
        (outs, first), n_groups = _deferred_dispatch(
            run_reduce, est, child.nrows, n_groups)
    else:
        n_groups = int(n_groups)
        outs, first = run_reduce(next_pow2(max(n_groups, 1)))

    cols: Dict[str, torch.Tensor] = {}
    safe_first = torch.clamp(first, max=n - 1)
    for g in node.group_by:
        sorted_col = _take(child.columns[g], order)
        cols[g] = _take(sorted_col, safe_first)
    for (out_name, fn, c), o in zip(node.aggs, outs):
        cols[out_name] = o
    ctx.metrics.rows_processed += child.nrows
    return Table(node.schema, cols, n_groups)


def _sort_select(cols, by_idx: int, nrows: int, new_cap: int,
                 desc: bool):
    """All sort output columns through one order: sentinel-mask the
    key, stable argsort, gather every column, slice to ``new_cap``.
    Valid rows sort ahead of the sentinel padding, so a slice of
    ``new_cap >= nrows`` keeps every live row (matching the eager
    path's live-row order bit for bit)."""
    k = cols[by_idx]
    valid = _arange(k.shape[0], k.device) < nrows
    if desc:
        k = -k
    k = torch.where(valid, k, _sort_sentinel(k))
    sel = _argsort(k)[:new_cap]
    return tuple(_take(c, sel) for c in cols)


def _exec_sort(node: L.Sort, child: Table, ctx: ExecContext) -> Table:
    names = child.schema.names
    est = ctx.estimate("sort", child.nrows)
    if est is not None:
        # deferred-sync path: the output capacity comes from the cost
        # model's cardinality estimate (exact for sort — cardinality is
        # preserved) instead of carrying the child's full padded
        # capacity forward, and every column is gathered through one
        # order; the usual overflow guard recompacts if the estimate
        # ever lied
        by_idx = names.index(node.by)

        def dispatch(new_cap: int):
            return _sort_select([child.columns[n] for n in names], by_idx,
                                child.nrows, new_cap, bool(node.desc))

        outs, _ = _deferred_dispatch(dispatch, est, child.capacity,
                                     child.nrows)
        return Table(child.schema, dict(zip(names, outs)), child.nrows)

    # seed eager path: full-capacity order, one gather per column
    key = child.columns[node.by]
    valid = _arange(child.capacity, key.device) < child.nrows
    if node.desc:
        key = -key
    order = _argsort(torch.where(valid, key, _sort_sentinel(key)))
    cols = {n: _take(child.columns[n], order) for n in child.schema.names}
    return Table(child.schema, cols, child.nrows)


def _union_select(names: Tuple[str, ...], left: Table, right: Table,
                  new_cap: int):
    """All union output columns through one selection: concat live-row
    masks, O(n) compaction, every column gathered through the same
    indices (vs the seed's per-column sort compactions)."""
    dev = next(iter(left.columns.values())).device
    mask = torch.cat([_arange(left.capacity, dev) < left.nrows,
                      _arange(right.capacity, dev) < right.nrows])
    sel = _nonzero_static(mask, new_cap)
    return tuple(_take(torch.cat([left.columns[n], right.columns[n]], 0),
                       sel) for n in names)


def _exec_union(left: Table, right: Table, ctx: ExecContext) -> Table:
    total = left.nrows + right.nrows
    names = left.schema.names
    est = ctx.estimate("union", left.nrows, right.nrows)
    if est is not None:
        # deferred-sync path: output capacity from the sum of the input
        # cardinality estimates, one fused dispatch for every column;
        # the usual overflow guard recompacts if the estimate lied
        def dispatch(new_cap: int):
            return _union_select(names, left, right, new_cap)

        outs, total = _deferred_dispatch(
            dispatch, est, left.capacity + right.capacity, total)
        return Table(left.schema, dict(zip(names, outs)), total)

    # seed eager path: exact-sized per-column argsort compaction
    cap = next_pow2(max(total, 1))
    cols = {}
    for name in names:
        a = left.columns[name][: left.capacity]
        b = right.columns[name][: right.capacity]
        mask = torch.cat([_arange(left.capacity, a.device) < left.nrows,
                          _arange(right.capacity, b.device) < right.nrows])
        merged = torch.cat([a, b], 0)
        (compacted,) = _compact(mask, cap, merged)
        cols[name] = compacted
    return Table(left.schema, cols, total)


def _try_pallas_filter(pred: E.Expr, child: Table):
    """Route a numeric predicate through the LITERAL-program
    ``filter_scan`` kernel.  Returns (mask, count) or (None, None) when
    unsupported (string predicates stay on the torch expression path;
    numeric col-col compares and fractional thresholds on integer
    columns compile — see kernels.filter_project.ops.compile_predicate).
    Only the predicate's own columns go to the kernel."""
    compiled = _literal_compile(pred, child.schema)
    if compiled is None:
        return None, None
    program, numeric = compiled
    return _literal_mask(program, [child.columns[n] for n in numeric],
                         child.nrows)


def _literal_compile(pred: E.Expr, schema):
    """(literal program, its numeric columns) or None when the kernel
    program cannot express ``pred``."""
    from ..kernels.filter_project.ops import compile_predicate

    pcols = E.columns_of(pred)
    numeric = tuple(n for n, t in schema.fields
                    if n in pcols and t.kind in ("i32", "i64", "f32"))
    try:
        program = compile_predicate(pred, numeric)
    except (ValueError, KeyError):
        return None
    if not numeric:
        return None
    return program, numeric


def _literal_mask(program, cols, nrows: int):
    """(mask, count) of one ``filter_scan`` launch over ``cols``."""
    from ..kernels.filter_project.ops import filter_mask

    block = min(2048, int(cols[0].shape[0]))
    mask, counts = filter_mask(tuple(cols), program, nrows, block=block)
    return mask, counts.sum()


# ---------------------------------------------------------------------------
# predicate masks, per shard: a single-device relation is one shard
# ---------------------------------------------------------------------------
class _ShardMask:
    """Per-shard predicate masks and counts: each shard's mask covers
    its own rows and lives on its device.  A relation on one device is
    one shard."""

    __slots__ = ("masks", "counts")

    def __init__(self, masks, counts):
        self.masks, self.counts = list(masks), list(counts)

    def count(self) -> torch.Tensor:
        """The total count on the first shard's device (no host read)."""
        if len(self.counts) == 1:
            return self.counts[0]
        dev = self.masks[0].device
        return torch.stack([c.to(dev, torch.int64)
                            for c in self.counts]).sum()

    def gather(self) -> torch.Tensor:
        if len(self.masks) == 1:
            return self.masks[0]
        dev = self.masks[0].device
        return torch.cat([m.to(dev) for m in self.masks], 0)


def _n_shards(child: "Table") -> int:
    for c in child.columns.values():
        if isinstance(c, RowShards):
            return len(c.shards)
    return 1


def _shard_live(child: "Table") -> List[int]:
    """Live rows of each shard: global row ``< nrows``."""
    n = _n_shards(child)
    n_local = child.capacity // n
    return [min(max(child.nrows - j * n_local, 0), n_local)
            for j in range(n)]


def _shard_cols(child: "Table", names) -> List[tuple]:
    """The columns ``names`` of each shard, in shard order."""
    if _n_shards(child) == 1:
        return [tuple(child.columns[n] for n in names)]
    return [tuple(child.columns[n].shards[j] for n in names)
            for j in range(_n_shards(child))]


def _encoded(ctx: ExecContext, program, names, n_q: int, shard_cols,
             capacity: int, block: int):
    """The kernel encoding of a slotted program for every shard's
    device, cached under ONE plan-shape key (so ``trace_hits`` /
    ``trace_misses`` count alike for a sharded and a single-device
    run)."""
    from ..kernels.filter_project.kernel import encode_program

    dtypes = tuple(c.dtype for c in shard_cols[0])
    devs = [cols[0].device for cols in shard_cols]
    key = ("slotmask", program, names, n_q, capacity, block,
           tuple(str(d) for d in dtypes), tuple(str(d) for d in devs))
    encs = _shape_cached(ctx, key, lambda: {
        str(d): encode_program(program, dtypes, d)
        for d in dict.fromkeys(devs)})
    return [encs[str(d)] for d in devs]


def _batch_masks(ctx: ExecContext, child: "Table", program, names,
                 ivals_rows, fvals_rows):
    """One ``filter_scan_batch`` launch per shard over the slotted
    program with ``len(ivals_rows)`` literal rows: per shard a
    ((n_q, n_local) mask, (n_q, blocks) counts) pair.  The kernel
    encoding is keyed by plan shape (literals live in operand arrays),
    so recurring templates with fresh constants reuse it.  Every
    shard's launch is issued before anything is read back."""
    from ..kernels.filter_project.ops import filter_mask_batch, pack_consts

    shard_cols = _shard_cols(child, names)
    block = min(2048, int(shard_cols[0][0].shape[0]))
    ic, fc = pack_consts(ivals_rows, fvals_rows)
    encs = _encoded(ctx, program, names, len(ivals_rows), shard_cols,
                    child.capacity, block)
    return [filter_mask_batch(cols, program, nr, ic, fc, block=block,
                              encoded=enc)
            for cols, nr, enc in zip(shard_cols, _shard_live(child), encs)]


def _route_mask(pred: E.Expr, child: "Table", ctx: ExecContext
                ) -> _ShardMask:
    """The predicate's mask and count, each shard evaluating its own
    rows on its device, by the first route that takes ``pred``: the
    slotted program (``filter_scan_batch``; a batch of one, so bit-
    identical to a window-batched dispatch of the same plan) when the
    shape cache is on, whatever ``use_pallas_filter`` says; then the
    literal program (``filter_scan``) on the card or with
    ``use_pallas_filter``, for what the slotted compile rejects or for
    every predicate when the shape cache is off; then the torch
    expression evaluator."""
    if ctx.shape_cache:
        compiled = _slot_compile(pred, child.schema)
        if compiled is not None:
            program, ivals, fvals, names = compiled
            out = _batch_masks(ctx, child, program, names, [ivals], [fvals])
            return _ShardMask([m[0] for m, _ in out],
                              [c.sum() for _, c in out])
    live = _shard_live(child)
    if ctx.use_pallas_filter or on_card(ctx.device):
        compiled = _literal_compile(pred, child.schema)
        if compiled is not None:
            program, numeric = compiled
            out = [_literal_mask(program, cols, nr)
                   for cols, nr in zip(_shard_cols(child, numeric), live)]
            return _ShardMask([m for m, _ in out], [c for _, c in out])
    names = child.schema.names
    out = [_pred_mask(pred, names, nr, cols)
           for cols, nr in zip(_shard_cols(child, names), live)]
    return _ShardMask([m for m, _ in out], [c for _, c in out])


def _compact_masked(mask: _ShardMask, new_cap: int, *cols):
    """``_compact_nz`` per shard: each shard compacts its own selected
    rows on its device, and the pieces are placed in shard order on the
    first device — the same rows in the same order as the single-device
    compaction, fill rows repeating global row 0 — with no host read
    (the shard counts stay on the device)."""
    if len(mask.masks) == 1:
        return _compact_nz(mask.masks[0], new_cap, *cols)
    dev = mask.masks[0].device
    n = len(mask.masks)
    lcap = min(new_cap, int(mask.masks[0].shape[0]))
    sels = [_nonzero_static(m, lcap) for m in mask.masks]
    counts = torch.stack([c.to(dev, torch.int64) for c in mask.counts])
    ends = torch.cumsum(counts, 0)
    pos = _arange(new_cap, dev)
    shard = torch.searchsorted(ends, pos, right=True)
    sc = torch.clamp(shard, max=n - 1)
    flat = torch.where(shard < n, sc * lcap + pos - (ends - counts)[sc],
                       torch.full_like(pos, n * lcap))
    out = []
    for c in cols:
        pieces = [_take(sh, sel).to(dev) for sh, sel in zip(c.shards, sels)]
        pieces.append(c.shards[0][:1])
        out.append(_take(torch.cat(pieces, 0), flat))
    return tuple(out)


# ---------------------------------------------------------------------------
# fused pipelines (relational.fuse): leaf → Filter* → Project in ONE pass
# ---------------------------------------------------------------------------
def _slot_compile(pred: E.Expr, schema):
    """Slotted compile of ``pred`` over the schema's numeric predicate
    columns.  Returns (program, ivals, fvals, names) or None when the
    predicate falls off the slotted route (string compares, col-col over
    strings, out-of-range consts...)."""
    from ..kernels.filter_project.ops import compile_predicate_slots

    kinds = {n: t.kind for n, t in schema.fields}
    pcols = E.columns_of(pred)
    names = tuple(n for n in schema.names
                  if n in pcols and kinds[n] in ("i32", "i64", "f32"))
    if not names:
        return None
    try:
        program, ivals, fvals = compile_predicate_slots(pred, names, kinds)
    except (ValueError, KeyError):
        return None
    return program, ivals, fvals, names


def _fused_est(src, pred: E.Expr, child: Table, est_rows: Optional[int],
               ctx: ExecContext) -> Optional[int]:
    """The fused pipeline's deferred-sync output-capacity estimate
    (shared verbatim by the per-query and window-batched routes, so a
    batched member sizes its compaction exactly like a solo run)."""
    est = ctx.estimate("filter", pred,
                       est_rows if est_rows is not None else child.nrows)
    if est is not None and est_rows is not None:
        est = min(est, child.nrows)
    if (est is not None and isinstance(src, L.Scan)
            and src.parts is not None):
        # partition-RESTRICTED scan (per-partition CE recompute): the
        # restriction exists because the covering predicate keeps these
        # partitions, so whole-table selectivity applied to partition
        # rows systematically undershoots (range partitioning on the
        # filter column is the worst case: every row passes) — forcing
        # the overflow re-dispatch on the warm recompute path.  Size at
        # the partition input; the overshoot guard recompacts the rare
        # genuinely-selective case.
        est = child.nrows
    if est is not None and isinstance(src, L.CachedScan):
        # residual over a covering relation: condition on the covering
        # plan's selectivity (the CE output already passed the OR of
        # member predicates, so base-table selectivities undershoot)
        cov = ctx.cache_plans.get(src.psi)
        sel_fn = getattr(ctx.cost_model, "plan_selectivity", None)
        if cov is not None and sel_fn is not None:
            est = min(child.nrows, int(est / sel_fn(cov)))
    return est


def _pruned_scan(ctx: ExecContext, src: L.Scan, st: "TableStorage",
                 pred: E.Expr):
    """Resolve the live partitions of a fused scan+filter: the
    conservative stats pruner first, then intersection with resident
    pid bitsets — observed history composes with, never overrides,
    statistics.  The deferred-sync capacity estimate stays taken
    over the FULL table (the qualifying rows all live in surviving
    partitions — estimating over the pruned input would undershoot by
    exactly the pruned fraction and force the overflow recompact on the
    hot path), then capped at the pruned input size by the caller.

    This is also the ``pid_pool`` fault point: the bitset read is
    attempted for EVERY fused scan+filter (an unpartitioned table is
    just a one-partition layout whose read trivially finds nothing),
    and any failure in the pid path — injected or real — degrades to
    stats-only pruning with a :class:`DegradationEvent` instead of
    surfacing.  A pid hit is an optimization, never a failure domain.

    Returns ``(resolved src, est_rows, pid_scan)``; ``pid_scan`` is
    ``(table, PartitionInfo, scanned parts)`` when the row mask this
    scan produces is eligible for presence recording (the scan started
    unrestricted, so absent-from-mask == empty-for-pred over the whole
    table), else None.
    """
    info = st.partitions
    partitioned = (ctx.prune and info is not None
                   and info.n_partitions > 1)
    live = prune_parts(pred, info) if partitioned else None
    if ctx.pid_cache is not None:
        try:
            ctx.check_fault("pid_pool", key=src.table)
            if partitioned:
                key = E.canonical(pred)
                live2, hits = ctx.pid_cache.intersect(
                    src.table, key, pred, info.n_partitions, live,
                    implies=lambda p, q, _s=st.schema:
                        _subsumes(p, q, _s))
                ctx.metrics.pid_hits += hits
                dropped = len(live) - len(live2)
                if dropped > 0:
                    ctx.metrics.pid_pruned_parts += dropped
                    # per-(table, pred) the drop count is deterministic
                    # within a window: assign, don't accumulate
                    ctx.pid_prune_log[(src.table, key)] = dropped
                    live = live2
        except Exception as exc:
            ctx.degradations.append(DegradationEvent(
                query=-1, attempt=1, action="degrade",
                level="stats-prune", error=repr(exc),
                detail={"point": "pid_pool", "table": src.table}))
    if not partitioned:
        return src, None, None
    est_rows = None
    if len(live) < info.n_partitions:
        from dataclasses import replace as _dc_replace

        src = _dc_replace(src, parts=tuple(live))
        est_rows = st.nrows
    scanned = src.parts if src.parts is not None else info.all_parts()
    return src, est_rows, (src.table, info, scanned)


def _pid_record(ctx: ExecContext, pid_scan, pred: E.Expr, mask,
                nrows: int) -> None:
    """Record the observed presence bitset for ``(table, pred)`` as a
    side effect of an eligible fused execution.  Record-once: the host
    read of ``mask`` synchronizes the device, so a key already resident
    is skipped before touching the array — warm streams pay nothing
    here.  Failures degrade to not-recording (never to the query)."""
    pool = ctx.pid_cache
    if pool is None or pid_scan is None or mask is None:
        return
    table_name, info, parts = pid_scan
    try:
        key = E.canonical(pred)
        if pool.contains(table_name, key):
            return
        host = mask.gather()[:nrows].cpu().numpy()
        present = pid_presence_from_mask(host, info, parts)
        pool.record(table_name, key, pred, info.n_partitions, present)
        ctx.metrics.pid_records += 1
    except Exception as exc:
        ctx.degradations.append(DegradationEvent(
            query=-1, attempt=1, action="degrade", level="no-record",
            error=repr(exc),
            detail={"point": "pid_pool", "table": table_name}))


def _exec_fused(node: FusedPipeline, ctx: ExecContext) -> Table:
    # covers the fused routes; the eager per-operator path (the
    # degradation ladder's bottom rung) never dispatches here
    ctx.check_fault("kernel_launch")
    src, pred = node.source, node.pred
    need = set(node.cols) | E.columns_of(pred)
    est_rows = None
    pid_scan = None
    if isinstance(src, L.Scan):
        st = ctx.catalog[src.table]
        if src.parts is None and not isinstance(pred, E.TrueExpr):
            # partition pruning: statistics (then resident pid bitsets)
            # refute the predicate on the skipped partitions, so the
            # scan reads only the surviving contiguous ranges
            src, est_rows, pid_scan = _pruned_scan(ctx, src, st, pred)
        needed = tuple(n for n in src.schema.names if n in need)
        child = _exec_scan(src, ctx, needed)
    else:
        table = _cached_scan_table(src, ctx)
        child = table.select([n for n in src.schema.names
                              if n in need and table.schema.has(n)])

    if isinstance(pred, E.TrueExpr):
        return _gathered(child.select(node.cols))
    est = _fused_est(src, pred, child, est_rows, ctx)
    # the kernels compute mask+count (per shard of a row-sharded scan);
    # only the data-dependent-shape compaction stays in torch (see
    # kernels.filter_project.kernel)
    mask = _route_mask(pred, child, ctx)

    def project_compact(new_cap: int):
        # only the output columns are ever compacted
        return _compact_masked(mask, new_cap,
                               *[child.columns[c] for c in node.cols])

    if est is not None:
        # one pass: the projected compaction is dispatched, sized by the
        # estimate, before the count is read
        outs, count = _deferred_dispatch(project_compact, est,
                                         child.capacity, mask.count())
    else:
        count = int(mask.count())
        outs = project_compact(next_pow2(max(count, 1)))
    _pid_record(ctx, pid_scan, pred, mask, child.nrows)
    ctx.metrics.rows_processed += child.nrows
    return Table(node.schema, dict(zip(node.cols, outs)), count)


# ---------------------------------------------------------------------------
# window-batched execution: same-shape fused pipelines -> ONE dispatch
# ---------------------------------------------------------------------------
@dataclass
class _BatchMember:
    """One window query admitted to a batched dispatch group."""
    pos: int                      # caller's window position
    node: FusedPipeline
    src: L.Node                   # prune-resolved source leaf
    need: frozenset               # scan columns (output + predicate)
    est_rows: Optional[int]       # pre-prune row count for estimation
    program: tuple                # slotted postfix program (the shape)
    ivals: tuple
    fvals: tuple
    pred_names: Tuple[str, ...]   # numeric predicate columns, schema order
    # (table, PartitionInfo, scanned parts) when this member's row mask
    # is eligible for pid-bitset presence recording (see _pruned_scan)
    pid_scan: Optional[tuple] = None


def plan_window_batches(plans, ctx: ExecContext):
    """Group a closed window's plans for batched kernel execution.

    ``plans`` is a sequence of ``(pos, logical plan)`` pairs.  A plan is
    batch-capable when it fuses to a FusedPipeline whose predicate
    compiles to a slotted program; plans sharing (source leaf, program
    shape, predicate columns) — i.e. literal variants of one template
    over one table — land in the same group and will evaluate as ONE
    batched mask dispatch.  Returns ``(n_candidates, groups)`` where
    groups have >= 2 members (singletons stay on the per-query path) and
    the cost model has priced the shared dispatch below per-query ones.
    """
    if not ctx.fuse or not ctx.shape_cache:
        return 0, []
    from dataclasses import replace as _dc_replace

    buckets: Dict[tuple, list] = {}
    n_cand = 0
    for pos, plan in plans:
        node = fuse_plan(L.as_node(plan))
        if not isinstance(node, FusedPipeline):
            continue
        pred = node.pred
        if isinstance(pred, E.TrueExpr):
            continue
        src = node.source
        est_rows = None
        pid_scan = None
        if isinstance(src, L.Scan):
            st = ctx.catalog.get(src.table)
            if st is None:
                continue
            if src.parts is None:
                # resolve pruning (stats + pid bitsets) NOW so the
                # group key reflects the actual scanned ranges (members
                # with different live partition sets must not share a
                # mask dispatch)
                src, est_rows, pid_scan = _pruned_scan(ctx, src, st,
                                                       pred)
            leaf = ("scan", src.table, src.parts, st.fmt)
        elif isinstance(src, L.CachedScan):
            leaf = ("cs", src.psi)
        else:
            continue
        compiled = _slot_compile(pred, src.schema)
        if compiled is None:
            continue
        program, ivals, fvals, pred_names = compiled
        n_cand += 1
        key = (leaf, program, pred_names)
        buckets.setdefault(key, []).append(_BatchMember(
            pos=pos, node=node, src=src,
            need=frozenset(node.cols) | E.columns_of(pred),
            est_rows=est_rows, program=program, ivals=ivals,
            fvals=fvals, pred_names=pred_names, pid_scan=pid_scan))

    groups = []
    wd = getattr(ctx.cost_model, "window_dispatch_cost", None) \
        if ctx.cost_model is not None else None
    for ms in buckets.values():
        if len(ms) < 2:
            continue
        if wd is not None and wd(len(ms), batched=True) >= \
                wd(len(ms), batched=False):
            continue
        groups.append(ms)
    return n_cand, groups


def _prepare_group(members, ctx: ExecContext):
    """Phase one of a group: per-member scans + the ONE batched
    mask/count launch (async — nothing here blocks on the device)."""
    children = []
    for m in members:
        src = m.src
        if isinstance(src, L.Scan):
            needed = tuple(n for n in src.schema.names if n in m.need)
            children.append(_exec_scan(src, ctx, needed))
        else:
            table = _cached_scan_table(src, ctx)
            children.append(table.select(
                [n for n in src.schema.names
                 if n in m.need and table.schema.has(n)]))
    base = children[0]
    for ch in children[1:]:
        if ch.capacity != base.capacity or ch.nrows != base.nrows:
            raise GroupDiverged("window-batch group children diverge")
    # predicate columns come from the FIRST member's child — same leaf,
    # same device buffers (scan cache), so no member pays a second scan.
    # Pad the member dimension to a power of two so realized group sizes
    # bucket into few compile shapes (a serving window closes with
    # whatever arrived — without padding every distinct size recompiles
    # the batch kernel).  Padded rows duplicate member 0's literals;
    # their mask/count rows are never read, and real members' rows are
    # computed independently of them (bit-identical).  A row-sharded
    # child takes one launch per shard for the whole group.
    n_pad = next_pow2(len(members))
    fill = [members[0]] * (n_pad - len(members))
    out = _batch_masks(ctx, base, members[0].program, members[0].pred_names,
                       [m.ivals for m in members + fill],
                       [m.fvals for m in members + fill])
    ctx.metrics.batched_dispatches += 1
    ctx.metrics.batched_queries += len(members)
    return children, out


def _finalize_group(members, prep, ctx: ExecContext):
    """Phase two: blocking count reads + per-member deferred-sync
    compactions (identical sizing to the solo ``_exec_fused`` path, so
    batched results are bit-identical to per-query dispatch)."""
    children, out = prep
    outs = []
    for q, (m, child) in enumerate(zip(members, children)):
        est = _fused_est(m.src, m.node.pred, child, m.est_rows, ctx)
        mrow = _ShardMask([mk[q] for mk, _ in out],
                          [ct[q].sum() for _, ct in out])
        crow = mrow.count()

        def project_compact(new_cap, mrow=mrow, child=child, m=m):
            return _compact_masked(mrow, new_cap,
                                   *[child.columns[c] for c in m.node.cols])

        if est is not None:
            cols_out, count = _deferred_dispatch(
                project_compact, est, child.capacity, crow)
        else:
            count = int(crow)
            cols_out = project_compact(next_pow2(max(count, 1)))
        _pid_record(ctx, m.pid_scan, m.node.pred, mrow, child.nrows)
        ctx.metrics.rows_processed += child.nrows
        outs.append(Table(m.node.schema,
                          dict(zip(m.node.cols, cols_out)), count))
    return outs


def _group_failed(ctx: ExecContext, group, exc: Exception,
                  failures: Dict[int, Exception]) -> None:
    if on_card(ctx.device) and not isinstance(
            exc, (InjectedFault, CEMaterializationError, GroupDiverged)):
        raise exc
    for m in group:
        failures[m.pos] = exc


def execute_window_batched(groups, ctx: ExecContext):
    """Run planned groups: phase one dispatches EVERY group's scans and
    batched mask kernels before phase two reads any count — CUDA's
    asynchronous launches overlap the remaining host-side work with
    device compute already in flight.  A failing group degrades whole (its
    members return to the caller's per-query path); per-member results
    carry an even split of the group's wall time.  On the card only an
    injected fault, a poisoned CE or a diverging group degrades; any
    other error (a kernel that fails to build or launch) propagates.

    Returns ``(results {pos: Table}, seconds {pos: float},
    failures {pos: Exception})``.
    """
    results: Dict[int, Table] = {}
    seconds: Dict[int, float] = {}
    failures: Dict[int, Exception] = {}
    with ctx.span("dispatch.batched", n_groups=len(groups),
                  n_queries=sum(len(g) for g in groups)):
        prepped = []
        for g in groups:
            t0 = time.perf_counter()
            try:
                prepped.append((g, _prepare_group(g, ctx),
                                time.perf_counter() - t0))
            except Exception as exc:
                _group_failed(ctx, g, exc, failures)
        for g, prep, dt0 in prepped:
            t0 = time.perf_counter()
            try:
                with ctx.span("dispatch.batched.finalize",
                              n_members=len(g)):
                    outs = _finalize_group(g, prep, ctx)
                    synchronize(ctx.device)
            except Exception as exc:
                _group_failed(ctx, g, exc, failures)
                continue
            dt = dt0 + (time.perf_counter() - t0)
            ctx.metrics.add_time("fused", dt)
            per = dt / len(g)
            for m, t in zip(g, outs):
                results[m.pos] = t
                seconds[m.pos] = per
    return results, seconds, failures


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------
def execute(node: L.Node, ctx: ExecContext) -> Table:
    from .stats import required_columns

    node = L.as_node(node)
    if ctx.fuse:
        node = fuse_plan(node)
    req = required_columns(node)
    return _exec(node, ctx, req)


def _exec(node: L.Node, ctx: ExecContext, req) -> Table:
    t0 = time.perf_counter()
    if isinstance(node, FusedPipeline):
        out = _exec_fused(node, ctx)
    elif isinstance(node, L.Scan):
        needed = req.get(id(node), frozenset(node.schema.names))
        ordered = tuple(n for n in node.schema.names if n in needed)
        out = _gathered(_exec_scan(node, ctx, ordered))
    elif isinstance(node, L.CachedScan):
        out = _exec_cached_scan(node, ctx, req)
    elif isinstance(node, L.Filter):
        child = _exec(node.child, ctx, req)
        out = _exec_filter(node.pred, child, ctx)
    elif isinstance(node, L.Project):
        child = _exec(node.child, ctx, req)
        out = child.select([c for c in node.cols if child.schema.has(c)])
    elif isinstance(node, L.Join):
        left = _exec(node.left, ctx, req)
        right = _exec(node.right, ctx, req)
        out = _exec_join(node, left, right, ctx)
    elif isinstance(node, L.Aggregate):
        child = _exec(node.child, ctx, req)
        out = _exec_aggregate(node, child, ctx)
    elif isinstance(node, L.Sort):
        child = _exec(node.child, ctx, req)
        out = _exec_sort(node, child, ctx)
    elif isinstance(node, L.Limit):
        child = _exec(node.child, ctx, req)
        new_n = min(node.n, child.nrows)
        cap = next_pow2(max(new_n, 1))
        cols = {n: child.columns[n][:cap] for n in child.schema.names}
        out = Table(child.schema, cols, new_n)
    elif isinstance(node, L.Union):
        left = _exec(node.left, ctx, req)
        right = _exec(node.right, ctx, req)
        out = _exec_union(left, right, ctx)
    elif isinstance(node, L.Cache):
        out = _materialize_cache(node, ctx, req)
    else:
        raise TypeError(type(node))
    synchronize(ctx.device)
    ctx.metrics.add_time(node.label.split(":")[0],
                         time.perf_counter() - t0)
    return out


def _concat_tables(schema: Schema, tables: list,
                   device: torch.device) -> Table:
    """Stack partition outputs (ascending partition id) into one
    relation: live rows of each piece, concatenated, padded to pow2."""
    total = sum(t.nrows for t in tables)
    cap = next_pow2(max(total, 1))
    if total == 0:
        return Table(schema, empty_like(schema, cap, device), 0)
    cols: Dict[str, torch.Tensor] = {}
    for name in schema.names:
        pieces = [t.columns[name][: t.nrows] for t in tables if t.nrows]
        cols[name] = _assemble(pieces, cap, pieces[0])
    return Table(schema, cols, total)


def _partitioned_ce_table(psi: bytes, ctx: ExecContext) -> Table:
    """A partition-grained CE's full output: resident partitions come
    from the cache, cold partitions re-run the covering plan restricted
    to that partition (admitted ones are materialized as they compute).
    Composition order is ascending partition id — the same order an
    unpartitioned materialization would produce.  Admissions run inside
    one cache transaction: a failure part-way through the partition
    loop rolls back the partitions this call already admitted, so the
    pool budget never leaks on a partial multi-entry admission."""
    composed = ctx.ce_part_memo.get((psi, "composed"))
    if composed is not None:
        # one composition per window: every consumer reads the same
        # Table (matching the whole-CE path's materialize-once shape)
        return composed
    pp = ctx.partitioned_ces[psi]
    pieces = []
    txn = ctx.cache.transaction() if ctx.cache is not None else None
    try:
        for pid in pp.live:
            cached = ctx.cache.get((psi, pid)) if ctx.cache is not None \
                else None
            if cached is not None:
                ctx.metrics.bytes_cached_read += cached.nbytes
                pieces.append(cached)
                continue
            memo = ctx.ce_part_memo.get((psi, pid))
            if memo is not None:
                pieces.append(memo)
                continue
            plan = restrict_to_parts(pp.plan, (pid,))
            if ctx.fuse:
                plan = fuse_plan(plan)
            t = _exec(plan, ctx, required_columns_of(plan))
            if txn is not None and pid in pp.admitted:
                ctx.check_fault("ce_admission", key=(psi, pid))
                txn.put((psi, pid), t, nbytes=t.nbytes,
                        est_bytes=t.logical_nbytes,
                        benefit=pp.benefits.get(pid, 0.0))
            else:
                ctx._memo_put((psi, pid), t)
            pieces.append(t)
    except Exception:
        if txn is not None:
            txn.rollback()
        raise
    if txn is not None:
        txn.commit()
    out = _concat_tables(pp.plan.schema, pieces, ctx.device)
    # prefer memoizing the composed table (later reads are then free);
    # it subsumes the per-partition entries, so release those on
    # success.  Under a tight budget the composed copy may not fit the
    # memo allowance — keep the (smaller) cold pieces instead and let
    # later reads re-concat from cache + memo.
    for pid in pp.live:
        ctx._memo_drop((psi, pid))
    if not ctx._memo_put((psi, "composed"), out):
        for pid, t in zip(pp.live, pieces):
            if ctx.cache is None or not ctx.cache.contains((psi, pid)):
                ctx._memo_put((psi, pid), t)
    return out


def _record_calibration(ctx: ExecContext, kind: str, psi: bytes, plan,
                        seconds: float, table: Table) -> None:
    """Cost-model accuracy accounting: one predicted-vs-measured sample
    per CE materialization / cached read, fed to the session's
    :class:`~repro_torch.core.costmodel.CalibrationLog`.  Best-effort —
    a model that can't price the plan just skips the sample."""
    tel = ctx.telemetry
    cm = ctx.cost_model
    if tel is None or cm is None:
        return
    try:
        if kind == "materialize":
            predicted = cm.execution_cost(plan) + cm.write_cost(plan)
        else:
            predicted = cm.read_cost(plan)
        sample = CalibrationSample(
            kind=kind, key=psi.hex()[:12],
            predicted_cost=float(predicted),
            measured_seconds=float(seconds),
            predicted_bytes=int(cm.output_bytes(plan)),
            measured_bytes=int(table.nbytes),
            predicted_rows=int(cm.output_rows(plan)),
            measured_rows=int(table.nrows))
    except Exception:
        return
    tel.calibration.record(sample)


def _materialize_cache(node: L.Cache, ctx: ExecContext, req) -> Table:
    assert ctx.cache is not None, "cache plan requires a CacheManager"
    existing = ctx.cache.get(node.psi)
    if existing is not None:
        # a WHOLE resident entry serves even when this window treats
        # the CE as partition-grained: eligibility for partitioning
        # depends on the other CEs in the window, so the same content
        # can be admitted whole in one window and per-partition in the
        # next — the already-materialized bytes must not be recomputed
        return existing
    if node.psi in ctx.failed_ces:
        raise CEMaterializationError(node.psi)
    try:
        if node.psi in ctx.partitioned_ces:
            return _partitioned_ce_table(node.psi, ctx)
        t0 = time.perf_counter()
        with ctx.span("ce.materialize", psi=node.psi):
            table = _exec(node.child, ctx, req)
            ctx.check_fault("ce_admission", key=node.psi)
            ctx.cache.put(node.psi, table, nbytes=table.nbytes,
                          est_bytes=table.logical_nbytes,
                          benefit=ctx.cache_values.get(node.psi, 0.0))
        _record_calibration(ctx, "materialize", node.psi, node.child,
                            time.perf_counter() - t0, table)
    except CEMaterializationError:
        raise
    except Exception as exc:
        ctx.failed_ces.add(node.psi)
        raise CEMaterializationError(node.psi, exc) from exc
    return table


def _cached_scan_table(node: L.CachedScan, ctx: ExecContext) -> Table:
    """The full covering relation behind a CachedScan (materializing on
    first touch: Spark cache() is a transformation — §6.3 footnote 5)."""
    assert ctx.cache is not None
    t0 = time.perf_counter()
    table = ctx.cache.get(node.psi)
    if table is not None:
        # whole resident entry — serves even if this window re-planned
        # the CE as partition-grained (see _materialize_cache)
        ctx.metrics.bytes_cached_read += table.nbytes
        if ctx.telemetry is not None:
            plan = ctx.cache_plans.get(node.psi)
            if plan is not None:
                _record_calibration(ctx, "cached_read", node.psi, plan,
                                    time.perf_counter() - t0, table)
        return table
    if node.psi in ctx.failed_ces:
        # poisoned earlier this window: fail fast so the service reruns
        # this consumer on its residual plan instead of recomputing the
        # covering union inline
        raise CEMaterializationError(node.psi)
    try:
        if node.psi in ctx.partitioned_ces:
            return _partitioned_ce_table(node.psi, ctx)
        plan = ctx.cache_plans.get(node.psi)
        if plan is None:
            raise KeyError(f"no cache plan registered for ψ="
                           f"{node.psi.hex()[:12]}")
        if ctx.fuse:
            plan = fuse_plan(plan)
        return _exec(plan, ctx, required_columns_of(plan))
    except CEMaterializationError:
        raise
    except Exception as exc:
        ctx.failed_ces.add(node.psi)
        raise CEMaterializationError(node.psi, exc) from exc


def _exec_cached_scan(node: L.CachedScan, ctx: ExecContext, req) -> Table:
    table = _cached_scan_table(node, ctx)
    # present the cached covering relation under this node's schema
    return table.select([n for n in node.schema.names
                         if n in table.schema.names])


def required_columns_of(plan: L.Node):
    from .stats import required_columns

    return required_columns(plan)

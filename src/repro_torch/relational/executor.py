"""The "SparkSQL Server" (paper §5): a centralized session that
accumulates client queries, runs the multi-query optimizer over the
batch, and executes cache plans + rewritten queries on the cluster.

Memory (see ROADMAP "Memory hierarchy"): the session owns ONE
budget-aware :class:`~repro_torch.core.memory.MemoryManager`; the CE cache
and the device scan cache are pools of it, CEs are retained across
batches (``retain_across_batches``), and each window's MCKP re-prices
still-resident CEs as zero-weight already-paid items.

Entry points (see ROADMAP "Query service"): the online front-end
is :class:`~repro_torch.relational.service.QueryService` (continuous
``submit`` + micro-batch windows); ``run_batch`` here is the one-shot
path, routed through the same window machinery as a pre-closed window.
Configuration lives in one frozen
:class:`~repro_torch.relational.service.SessionConfig`; the individual
keyword arguments of ``Session(...)`` are retained as deprecation
shims so existing call sites keep working.

Device: a Session runs on ``cuda`` unless constructed with
``device="cpu"`` (or another torch device); without a GPU the default
raises RuntimeError.  With ``ExecutionConfig.sharding`` (a port
``NamedSharding`` over one mesh axis) its scans are row-sharded over
that axis's devices and it runs on the first of them.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.cache import CacheManager
from ..core.faults import (DegradationEvent, FaultInjector, InjectedFault)
from ..core.memory import DEVICE, MemoryManager, PidPool
from ..core.optimizer import OptimizedBatch
from ..device import DeviceLike, on_card, resolve_device, synchronize
from . import expr as E
from . import logical as L
from .canonical import subsumption_residual
from .observe import Telemetry
from .partition import Partitioning, linear_scan_chain, partition_table
from .fuse import unfuse_plan
from .physical import (ExecContext, ExecMetrics, TableStorage, execute,
                       first_shard_device, shard_devices)
from .rules import optimize_single
from .schema import Table
from .service import QueryService, SessionConfig
from .stats import RelationalCostModel, StatsRegistry, build_table_stats

_UNSET = object()   # "kwarg not passed" sentinel (legacy-shim detection)


@dataclass
class QueryResult:
    table: Table
    seconds: float
    plan: L.Node


@dataclass
class BatchResult:
    # one slot per submitted query, submission order; a slot is None
    # when that query failed (its handle carries the QueryError) —
    # fault-free windows never contain None
    results: List[Optional[QueryResult]]
    total_seconds: float
    optimize_seconds: float = 0.0
    mqo: Optional[OptimizedBatch] = None
    cache_report: dict = field(default_factory=dict)
    metrics: Optional[ExecMetrics] = None
    # window resilience report: degradation/retry events,
    # n_failed, fault-injector telemetry, post-window audit — empty
    # when the window saw no failures and no injector is configured
    resilience: dict = field(default_factory=dict)

    @property
    def per_query_seconds(self) -> List[Optional[float]]:
        return [r.seconds if r is not None else None
                for r in self.results]

    @property
    def n_failed(self) -> int:
        return sum(1 for r in self.results if r is None)


@dataclass(frozen=True)
class SubsumptionMeta:
    """Semantic-reuse index entry for one resident CE: the
    covering tree is a Filter*/Project* chain over one unrestricted
    Scan, summarized as (table, conjunction, retained columns) so a
    later query can be matched by PREDICATE IMPLICATION instead of an
    exact strict-fingerprint equality."""

    tree: L.Node                  # covering tree (eviction-recompute plan)
    table: str
    pred: "object"                # conjunction of the chain's filters
    cols: frozenset               # column names the CE output retains


def _spill_to_host(table: Table) -> Table:
    return Table(table.schema,
                 {n: a.cpu() for n, a in table.columns.items()},
                 table.nrows)


def _unspiller(device: torch.device):
    """The CE pool's host -> device promotion for a session's device."""
    def unspill(table: Table) -> Table:
        return Table(table.schema,
                     {n: a.to(device) for n, a in table.columns.items()},
                     table.nrows)
    return unspill


def _apply_partitioning(storage: TableStorage, cols: Dict[str, np.ndarray],
                        spec: Partitioning):
    """Re-cluster a TableStorage so each partition is one contiguous
    row range (see relational.partition); returns the new storage and
    the reordered typed columns (for statistics)."""
    perm, reordered, info = partition_table(spec, storage.nrows, cols)
    csv_bytes = columnar = None
    if storage.fmt == "csv":
        csv_bytes = np.ascontiguousarray(
            storage.csv_bytes[: storage.nrows][perm])
    else:
        columnar = reordered
    return TableStorage(name=storage.name, schema=storage.schema,
                        nrows=storage.nrows, fmt=storage.fmt,
                        columnar=columnar, csv_bytes=csv_bytes,
                        partitions=info), reordered


class Session:
    """Catalog + stats + cache + MQO — the paper's prototype server.

    Prefer ``Session.from_config(SessionConfig(...))``; the individual
    keyword arguments below predate :class:`SessionConfig` and are kept
    as deprecation shims (they are folded into ``self.config``).
    """

    def __init__(self, budget_bytes=_UNSET,
                 sharding=_UNSET,
                 disk_latency_per_byte=_UNSET,
                 fuse=_UNSET,
                 defer_sync=_UNSET,
                 use_scan_cache=_UNSET,
                 policy=_UNSET,
                 host_budget_bytes=_UNSET,
                 retain_across_batches=_UNSET,
                 config: Optional[SessionConfig] = None,
                 device: DeviceLike = None):
        # sentinel defaults: "was this kwarg passed at all?" — the real
        # default values live in ONE place (the ExecutionConfig /
        # MemoryConfig dataclass fields; from_legacy_kwargs forwards
        # only what was passed), and an explicitly-passed default still
        # counts as a legacy kwarg (so mixing it with config= is caught
        # instead of silently dropped)
        passed = {k: v for k, v in dict(
            budget_bytes=budget_bytes, sharding=sharding,
            disk_latency_per_byte=disk_latency_per_byte, fuse=fuse,
            defer_sync=defer_sync, use_scan_cache=use_scan_cache,
            policy=policy, host_budget_bytes=host_budget_bytes,
            retain_across_batches=retain_across_batches).items()
            if v is not _UNSET}
        if config is not None and passed:
            # a config must be the WHOLE configuration — mixing it with
            # legacy knobs would silently drop whichever loses
            raise ValueError(
                f"pass either config= or the legacy keyword "
                f"arguments, not both (got {sorted(passed)})")
        if config is None:
            # deprecation shim: fold the legacy knob sprawl into the
            # unified config (execution / memory / mqo sub-configs)
            if passed:
                warnings.warn(
                    f"Session keyword arguments {sorted(passed)} are "
                    f"deprecated — build a SessionConfig and use "
                    f"Session.from_config(...)", DeprecationWarning,
                    stacklevel=2)
            config = SessionConfig.from_legacy_kwargs(**passed)
        self.config = config
        ex, mem = config.execution, config.memory
        # every scan, CE and result of this session lives here; a
        # row-sharded session places scan shards on its mesh axis's
        # devices and runs everything past the scans on the first one
        if ex.sharding is not None:
            shard_devices(ex.sharding)          # TypeError if unsupported
            if device is None:
                device = first_shard_device(ex.sharding)
        self.device = resolve_device(device)

        self.catalog: Dict[str, TableStorage] = {}
        self.stats = StatsRegistry()
        self.budget = int(mem.budget_bytes)
        self.cost_model = RelationalCostModel(
            self.stats, prune=getattr(ex, "prune", True))
        # execution-path knobs, mirrored as mutable attributes (bench
        # harnesses tweak e.g. disk_latency_per_byte post-construction;
        # self.config stays the frozen construction-time record)
        self.sharding = ex.sharding
        self.disk_latency_per_byte = ex.disk_latency_per_byte
        self.fuse = ex.fuse
        self.defer_sync = ex.defer_sync
        self.use_scan_cache = ex.use_scan_cache
        self.use_pallas_filter = ex.use_pallas_filter
        self.prune = getattr(ex, "prune", True)
        self.window_batch = getattr(ex, "window_batch", True)
        self.shape_cache = getattr(ex, "shape_cache", True)
        self.pid_cache = getattr(ex, "pid_cache", True)
        # One budget-aware memory hierarchy for everything the session
        # materializes on device (see core.memory): the CE cache spills
        # device -> host -> drop; evicted scan columns just drop (their
        # source host arrays still live in the catalog).  The host tier
        # is bounded too (default 4x the device budget) so a long-lived
        # session with retention cannot grow host RAM without limit.
        self.retain_across_batches = mem.retain_across_batches
        host_budget = mem.host_budget_bytes
        if host_budget is None:
            host_budget = 4 * self.budget
        self.memory = MemoryManager(self.budget,
                                    host_budget=host_budget,
                                    policy=mem.policy)
        self._scan_pool = self.memory.pool("scan")
        self._ce_cache = CacheManager(
            self.budget, spill_fn=_spill_to_host,
            unspill_fn=_unspiller(self.device), manager=self.memory,
            pool="ce")
        # strict content fingerprint -> loose psi, for every covering
        # relation materialized by an earlier window.  Strict keys are
        # the CACHE identity (several same-structure CEs with different
        # merged predicates stay resident side by side); the loose psi
        # is kept as the optimizer's cheap membership pre-filter.
        # Cache PLANS need no retention: rewrite_batch regenerates a
        # fresh, intra-window-consistent plan for every selected CE.
        self._resident_index: Dict[bytes, bytes] = {}
        # strict key -> SubsumptionMeta for resident CEs whose tree is
        # a Filter*/Project* chain over one Scan: the semantic-reuse
        # index — a later query whose predicate is IMPLIED by a
        # resident CE's weaker predicate resumes from the CE plus the
        # residual conjuncts, without an exact-fingerprint match.
        self._resident_meta: Dict[bytes, "SubsumptionMeta"] = {}
        # the fourth memory pool: per-(table, canonical conjunct)
        # partition-ID bitsets, populated as a side effect of fused
        # execution and intersected to prune partitions by observed
        # history before any scan
        self._pid_pool = PidPool(self.memory) if self.pid_cache else None
        # lazily-created QueryService backing the one-shot run_batch
        self._oneshot: Optional[QueryService] = None
        # -- resilience (ROADMAP "Failure semantics") ----------------
        # fault_injector is None unless config.resilience.faults enables
        # the harness; the memory manager shares it (spill_to_host
        # point) and ExecContext.from_exec_config picks it up from the
        # mirrored attribute below.  _sleep is the backoff clock,
        # injectable so retry tests never wall-sleep.
        self.resilience = config.resilience
        self.fault_injector = FaultInjector.from_config(
            config.resilience.faults)
        self.memory.faults = self.fault_injector
        self._sleep = time.sleep
        # -- telemetry (ROADMAP "Observability") ---------------------
        # always-on metrics registry + cost-model calibration log; span
        # tracing stays the no-op singleton until enable_tracing().
        # The memory manager, fault injector, and cost model all feed
        # the same hub, so metrics_report() has ONE source of truth.
        self._telemetry = Telemetry()
        self.memory.telemetry = self._telemetry
        self.cost_model.calibration_log = self._telemetry.calibration
        if self.fault_injector is not None:
            self.fault_injector.registry = self._telemetry.registry

    def telemetry(self) -> Telemetry:
        """The session's observability hub: metrics registry, span
        tracer (``.enable_tracing()`` to collect spans), calibration
        log, and trace exporters (see relational.observe)."""
        return self._telemetry

    def enable_tracing(self, clock=None):
        """Turn on query-lifecycle span tracing; returns the tracer."""
        return self._telemetry.enable_tracing(clock)

    def metrics_report(self) -> dict:
        """The unified observability report — see
        :func:`~repro_torch.relational.observe.build_metrics_report`."""
        from .observe import build_metrics_report

        return build_metrics_report(self)

    @classmethod
    def from_config(cls, config: SessionConfig,
                    device: DeviceLike = None) -> "Session":
        return cls(config=config, device=device)

    # -- catalog management -------------------------------------------------
    def register(self, storage: TableStorage,
                 columnar_for_stats: Optional[Dict[str, np.ndarray]] = None,
                 partitioning: Optional[Partitioning] = None):
        """Install (or replace) a table in the catalog.

        ``partitioning`` declares horizontal range/hash partitioning
        (relational.partition): the rows are physically RE-CLUSTERED so
        each partition is a contiguous range, per-partition min/max/NDV
        statistics are collected for pruning, scans go through
        per-partition device cache entries, and covering expressions
        over the table become partition-grained MCKP candidates.

        Re-registering a name invalidates everything derived from the
        old data: whole-table AND per-partition scan-pool entries (all
        scan keys lead with the table name), retained CE content
        including partition-grained ``(strict, pid)`` entries (the CE
        pool is cleared outright — CE plans can join across tables),
        and the old registration's table/partition statistics.
        """
        # re-registering a name must not serve the old table's device
        # buffers from the scan cache (keys lead with the table name) ...
        self._scan_pool.invalidate(lambda k: k[0] == storage.name)
        # ... and any retained CE content derived from the old data is
        # stale too (CE plans can join across tables — drop them all,
        # partition-grained entries included)
        if storage.name in self.catalog:
            self._ce_cache.clear()
            self._resident_index.clear()
            self._resident_meta.clear()
        # pid bitsets are per-table observations of the OLD rows: the
        # new data's partitions must not be pruned by them
        if self._pid_pool is not None:
            self._pid_pool.invalidate_table(storage.name)
        cols = storage.columnar if storage.columnar is not None \
            else columnar_for_stats
        assert cols is not None, "stats need typed columns (pre-processing)"
        if partitioning is not None:
            storage, cols = _apply_partitioning(storage, cols, partitioning)
        self.catalog[storage.name] = storage
        self.stats.register(
            storage.name,
            build_table_stats(cols, storage.nrows, storage.schema),
            partitions=storage.partitions)

    def table(self, name: str):
        """The catalog table as a fluent lazy :class:`Relation` — the
        root of the builder API (``.where(c.x > 5).select(...)...``).
        The Relation mirrors the legacy Node builder methods, so older
        ``.filter(E.cmp(...))``-style call sites keep working."""
        from .api import Relation

        return Relation(self.scan_node(name), session=self)

    def scan_node(self, name: str) -> L.Scan:
        """The raw logical Scan leaf (the pre-Relation ``table()``)."""
        st = self.catalog[name]
        return L.scan(name, st.schema, st.fmt)

    # -- execution ------------------------------------------------------------
    def _fresh_ctx(self, cache: Optional[CacheManager] = None) -> ExecContext:
        # the session itself quacks like an ExecutionConfig (the knobs
        # are mirrored as attributes above)
        return ExecContext.from_exec_config(
            self.catalog, self, cache=cache,
            cost_model=self.cost_model,
            scan_cache=self._scan_pool if self.use_scan_cache else None,
            pid_cache=self._pid_pool)

    def clear_scan_cache(self) -> None:
        """Drop memoized device scan buffers (e.g. after data changes)."""
        self._scan_pool.clear()

    def service(self, **kw) -> QueryService:
        """A new online front-end over this session (continuous
        ``submit`` + micro-batch MQO windows; see relational.service)."""
        return QueryService(self, **kw)

    def planning_capacity(self, budget: Optional[int] = None) -> int:
        """MCKP capacity for the next window: the device bytes new CE
        materializations can actually claim.  Bytes other pools hold
        (scan columns, serving prefix states) and bytes already pinned
        under retained resident CEs are subtracted from the device
        budget — planning with the full session budget would admit CEs
        the hierarchy immediately spills (ROADMAP open item)."""
        budget = self.budget if budget is None else int(budget)
        if budget <= 0 or not self.config.mqo.pressure_aware:
            return budget
        mm = self.memory
        ce_pool = mm.pools.get("ce")
        ce_dev = ce_pool.stats.used if ce_pool is not None else 0
        other = mm.device_used - ce_dev
        retained = 0
        if ce_pool is not None:
            # whole-CE residents tracked by the strict index, plus every
            # partition-grained (strict, pid) entry — both survive into
            # the next window, so their device bytes are not claimable
            retained = sum(
                e.nbytes for e in ce_pool.entries.values()
                if e.tier == DEVICE
                and (e.key in self._resident_index
                     if isinstance(e.key, bytes) else True))
        return max(0, min(budget, mm.device_budget - other - retained))

    def ce_resident_parts(self) -> Dict[bytes, frozenset]:
        """strict fingerprint -> resident partition ids, for every
        partition-grained CE entry still materialized (device or host
        tier) — the per-partition cross-window reuse set the optimizer
        re-prices as already-paid (rebuilt from live cache keys each
        window, so dropped entries disappear automatically)."""
        out: Dict[str, set] = {}
        for key in self._ce_cache.keys():
            if isinstance(key, tuple) and len(key) == 2:
                out.setdefault(key[0], set()).add(key[1])
        return {k: frozenset(v) for k, v in out.items()}

    # -- semantic subsumption ----------------------------------------
    def _note_subsumable(self, ce) -> None:
        """Index a retained CE for subsumption matching when its tree
        is a Filter*/Project* chain over one unrestricted Scan (the
        dominant CE shape after MQO rewriting)."""
        chain = linear_scan_chain(ce.tree)
        if chain is None:
            return
        scan, pred = chain
        if scan.parts is not None:
            return
        self._resident_meta[ce.strict_psi()] = SubsumptionMeta(
            tree=ce.tree, table=scan.table, pred=pred,
            cols=frozenset(ce.tree.schema.names))

    def find_subsumer(self, plan: L.Node):
        """A resident CE whose *weaker* predicate provably subsumes
        ``plan``'s — the semantic-reuse lookup.  ``plan`` must
        be a canonical Filter*/Project* chain over one unrestricted
        Scan; candidates must still be materialized, retain every
        column the query outputs or its residual conjuncts read, and
        satisfy ``subsumes(resident pred, query pred)`` under the
        table schema.  Smallest resident entry wins (cheapest re-read).

        Returns ``(strict key, SubsumptionMeta, residual pred)`` or
        None.  The caller resumes from ``CachedScan(strict)`` plus the
        residual conjuncts instead of recomputing from the base table —
        reuse WITHOUT an exact-fingerprint match.
        """
        if not self._resident_meta:
            return None
        chain = linear_scan_chain(L.as_node(plan))
        if chain is None:
            return None
        scan, pred = chain
        if scan.parts is not None or scan.table not in self.catalog:
            return None
        schema = self.catalog[scan.table].schema
        out_cols = set(plan.schema.names)
        qkey = E.canonical(pred)
        best = None
        for strict, meta in self._resident_meta.items():
            if meta.table != scan.table:
                continue
            if E.canonical(meta.pred) == qkey:
                # exact predicate match: the optimizer's resident
                # re-pricing path owns it (ψ-structural matching +
                # explain's cache_hit accounting) — subsumption only
                # claims STRICTLY weaker residents
                continue
            if not self._ce_cache.contains(strict):
                continue
            resid = subsumption_residual(meta.pred, pred, schema)
            if resid is None:
                continue
            if not (out_cols | E.columns_of(resid)) <= meta.cols:
                continue
            entry = self._ce_cache.entry(strict)
            nbytes = entry.nbytes if entry is not None else 0
            if best is None or nbytes < best[0]:
                best = (nbytes, strict, meta, resid)
        if best is None:
            return None
        return best[1], best[2], best[3]

    def run_one(self, plan: L.Node,
                ctx: Optional[ExecContext] = None) -> QueryResult:
        plan = L.as_node(plan)
        ctx = ctx or self._fresh_ctx()
        t0 = time.perf_counter()
        table = execute(plan, ctx)
        synchronize(ctx.device)
        return QueryResult(table, time.perf_counter() - t0, plan)

    # -- graceful degradation ----------------------------------------
    # route overrides per ladder rung: kernel route (slotted and
    # literal-program kernels) → fused torch (slotted kernel only) →
    # eager per-operator.  The eager rung also turns off deferred sync,
    # so estimate-overflow/OOM pressure ends at per-operator exact
    # sizing; the kernel_launch fault point is only checked on fused
    # dispatch, so the bottom rung cannot re-fire it.
    _LADDER = (
        ("kernel", {}),
        ("fused-torch", dict(use_pallas_filter=False)),
        ("eager", dict(use_pallas_filter=False, fuse=False,
                       defer_sync=False)),
    )
    # on the card every rung takes the kernels whatever
    # use_pallas_filter says, so the fused-torch rung would repeat the
    # kernel rung: the ladder there is kernel -> eager per-operator
    _CARD_LADDER = (
        ("kernel", {}),
        ("eager", dict(fuse=False, defer_sync=False)),
    )

    def _backoff(self, attempt: int) -> None:
        """Exponential backoff before retry ``attempt+1`` (attempt is
        1-based); base 0 disables sleeping, ``self._sleep`` is
        injectable for deterministic tests."""
        res = self.resilience
        base = float(res.backoff_base_s)
        if base > 0.0:
            self._sleep(base * res.backoff_multiplier ** (attempt - 1))

    def run_one_resilient(self, plan: L.Node, ctx: ExecContext, *,
                          query: int = 0,
                          events: Optional[list] = None) -> QueryResult:
        """``run_one`` under the degradation ladder: transient faults
        retry in place (a fresh draw from the seeded stream), kernel
        dispatch failures step the route down one rung, attempts are
        bounded by ``resilience.max_attempts`` with exponential backoff
        between them.  Every step is logged into ``events`` (the window
        report / failed-handle explain).  ``CEMaterializationError``
        propagates untouched — the service handles it by rerunning the
        consumer on its unshared residual plan.  On the card (a CUDA
        context) the ladder is kernel → eager, both rungs launch the
        kernels, and only injected faults step down it: a real error
        gives up at once."""
        from dataclasses import replace as _dc_replace

        from .physical import CEMaterializationError

        res = self.resilience
        if res is None or not res.degrade:
            return self.run_one(plan, ctx)
        events = events if events is not None else []
        card = on_card(ctx.device)
        ladder = self._CARD_LADDER if card else self._LADDER
        # start at the rung the context is actually configured for, so
        # "degrade one level" always changes something
        level = 0
        eager = not ctx.fuse and not ctx.defer_sync
        if card:
            level = 1 if eager else 0
        elif not ctx.use_pallas_filter:
            level = 2 if eager else 1
        max_attempts = max(1, int(res.max_attempts))
        last_exc: Optional[BaseException] = None
        for attempt in range(1, max_attempts + 1):
            name, over = ladder[level]
            cur = _dc_replace(ctx, **over) if over else ctx
            # the bottom rung must run per-operator even when the plan
            # arrived pre-fused (the rewriter fuses residuals itself)
            cur_plan = unfuse_plan(plan) if name == "eager" else plan
            try:
                return self.run_one(cur_plan, cur)
            except CEMaterializationError:
                raise
            except Exception as exc:
                last_exc = exc
                injected = isinstance(exc, InjectedFault)
                transient = injected and exc.point != "kernel_launch"
                if transient:
                    # e.g. a failed H2D transfer: the operation is
                    # expected to succeed on a later attempt — same rung
                    action = "retry"
                elif level + 1 < len(ladder) and (injected or not card):
                    action = "degrade"
                    level += 1
                else:
                    # eager bottom rung failed on a real error, or any
                    # real error on the card (a kernel that fails to
                    # build or launch must not hide behind a lower rung)
                    events.append(DegradationEvent(
                        query=query, attempt=attempt, action="give-up",
                        level=name, error=repr(exc)))
                    raise
                events.append(DegradationEvent(
                    query=query, attempt=attempt, action=action,
                    level=ladder[level][0], error=repr(exc)))
                if attempt < max_attempts:
                    self._backoff(attempt)
        raise last_exc

    def run_batch(
        self,
        plans: Sequence[L.Node],
        *,
        mqo: Optional[bool] = None,
        k: Optional[int] = None,
        budget_bytes: Optional[int] = None,
        locally_optimize: Optional[bool] = None,
    ) -> BatchResult:
        """Execute a batch of queries, with or without worksharing.

        The one-shot path is a *pre-closed* QueryService window, so it
        shares the online front-end's machinery bit for bit.  ``mqo`` /
        ``k`` / ``locally_optimize`` default to ``config.mqo``
        (``enabled`` / ``k`` / ``locally_optimize``); pass a value to
        override for this batch only.

        ``budget_bytes`` overrides the *planning* budget (MCKP
        capacity) for this batch only; actual admission is always
        enforced by the session-lifetime MemoryManager at the session
        budget.  A zero planning budget also disables cross-batch
        resident reuse — it is the "no caching at all" baseline.
        """
        if self._oneshot is None:
            self._oneshot = QueryService(self)
        return self._oneshot.run_closed(
            plans, mqo=mqo, k=k, budget_bytes=budget_bytes,
            locally_optimize=locally_optimize)

    # -- naive full-input caching (the paper's "FC" baseline) --------------
    def run_batch_fullcache(self, plans: Sequence[L.Node],
                            budget_bytes: Optional[int] = None
                            ) -> BatchResult:
        """Cache the entire input relations on first touch (§6.3 'FC')."""
        from ..core.fingerprint import fingerprint
        from .canonical import canonicalize_plan

        plans = [optimize_single(canonicalize_plan(p)) for p in plans]
        budget = budget_bytes if budget_bytes is not None else self.budget
        cache = CacheManager(budget, spill_fn=_spill_to_host,
                             unspill_fn=_unspiller(self.device))
        ctx = self._fresh_ctx(cache)

        # rewrite every Scan into CachedScan of the full relation
        def rewrite(node: L.Node) -> L.Node:
            if isinstance(node, L.Scan):
                psi = fingerprint(node)
                if psi not in ctx.cache_plans:
                    ctx.cache_plans[psi] = L.Cache(child=node, psi=psi)
                return L.CachedScan(psi=psi, _schema=node.schema,
                                    source_label=node.label)
            if not node.children:
                return node
            return node.with_children(
                tuple(rewrite(c) for c in node.children))

        rewritten = [rewrite(p) for p in plans]
        t0 = time.perf_counter()
        results = [self.run_one(p, ctx) for p in rewritten]
        return BatchResult(results, time.perf_counter() - t0,
                           cache_report=cache.report(), metrics=ctx.metrics)

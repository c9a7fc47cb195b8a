"""Online query service: continuous submission + micro-batch MQO windows.

The paper's §5 prototype is a *server*: clients submit queries at any
time, the server accumulates them, optimizes each accumulated batch
with the multi-query optimizer, executes, and returns results.  This
module is that front-end:

    svc = QueryService(session, max_batch=8, max_wait_s=0.05)
    h = svc.submit(plan)          # returns immediately: a lazy handle
    ...
    table = h.result()            # resolves (closing the window if open)
    h.explain()                   # chosen plan, matched CE/SE, reuse

**Window lifecycle.**  The first ``submit`` after a flush opens a
window (state held in one :class:`WindowState`, shared with the async
front).  The window *closes* (runs the MQO over its queries, executes,
and resolves every handle, in submission order) when any of:

  * it holds ``max_batch`` queries (count trigger, closes inside the
    submitting call);
  * ``max_wait_s`` has elapsed since the window opened — checked on
    every ``submit``/``poll``/``result`` (this sync front is
    cooperative: no background threads, so a deadline fires at the
    next call — ``result()`` on ANY handle, even an already-resolved
    one, runs the check, so an expired window is never stranded until
    the next unrelated ``submit``.  The async front retires the caveat
    entirely: its background closer task fires deadlines with no
    caller in flight — see ``relational.async_service``);
  * ``flush()`` is called explicitly, or ``result()`` is called on a
    handle still sitting in the open window.

The one-shot ``Session.run_batch`` is routed through this same
machinery as a *pre-closed* window (``run_closed``), so online and
batch execution share one code path — and are bit-identical on the
same plan set.

**Cross-window reuse.**  Each window's MCKP re-prices covering
expressions whose content is still resident from ANY earlier window as
zero-weight already-paid items.  CE cache entries are keyed by the
*strict* content fingerprint (not the loose structural ψ), so several
same-structure/different-predicate CEs — the signature of a recurring
windowed workload, where each window merges a different subset of a
template family — stay resident side by side instead of evicting one
another.  A window with a single matching query (fewer than ``k``
consumers) can still resume from a resident CE (single-query resident
resume; see ``core.optimizer``).

**SessionConfig.**  The session's former eight orthogonal constructor
knobs are grouped into one frozen :class:`SessionConfig` (``execution``
/ ``memory`` / ``mqo`` sub-configs); ``Session.from_config`` builds a
session from it and the legacy keyword arguments remain as deprecation
shims.
"""
from __future__ import annotations

import time
import warnings
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Set

from ..core.faults import DegradationEvent, InjectedFault
from ..core.fingerprint import fingerprint, fingerprint_set
from ..core.optimizer import MultiQueryOptimizer
from ..core.rewrite import attach_recompute_plan
from ..core.telemetry import NOOP_SPAN
from . import expr as E
from . import logical as L
from .canonical import canonicalize_plan
from .observe import ExplainCE, ExplainReport, build_metrics_report
from .rewriter import RelationalRewriter, make_ce_transform
from .rules import optimize_single

_UNSET = object()


def _coerce_submission(plan, entry: str, stacklevel: int = 3):
    """(logical node, cache hint) for a submitted query.

    :class:`~repro_torch.relational.api.Relation` is the supported frontend;
    raw ``logical.Node`` trees still work as a compat shim but are on a
    deprecation path — they miss the builder's ergonomics, not its
    sharing (both are canonicalized identically downstream).
    ``stacklevel`` points the warning at the caller's call site (the
    run_batch path has more intermediate frames than submit)."""
    hook = getattr(plan, "__plan_node__", None)
    if hook is not None:
        return hook(), bool(getattr(plan, "hint_cache", False))
    node = L.as_node(plan)
    warnings.warn(
        f"passing raw logical.Node trees to {entry} is deprecated "
        f"and the shim will be REMOVED two releases after v0.8 — "
        f"build queries with the Relation API (session.table(...)"
        f".where(...)...)", DeprecationWarning, stacklevel=stacklevel)
    return node, False


# ---------------------------------------------------------------------------
# unified session configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExecutionConfig:
    """Physical execution-path knobs (ROADMAP "Execution paths").

    ``fuse=False, defer_sync=False, use_scan_cache=False`` reproduces
    the seed eager executor.
    """

    fuse: bool = True
    defer_sync: bool = True
    use_scan_cache: bool = True
    use_pallas_filter: bool = False
    # partition pruning over partitioned tables (relational.partition):
    # fused pipelines skip partitions whose statistics refute the
    # predicate.  False forces the unpruned path (bit-identity tests).
    prune: bool = True
    # window batching: execute a closed window's same-shape fused
    # pipelines as ONE batched mask dispatch.  False keeps
    # per-query dispatch (the baseline the bench compares against).
    window_batch: bool = True
    # plan-shape compile cache: slotted predicate programs keyed by
    # plan SHAPE (literals hoisted to operand arrays) so recurring
    # templates never re-trace.  False forces literal-keyed jit.
    shape_cache: bool = True
    # partition-identifier bitset pool: record, per canonical
    # conjunct, which partitions produced any row as a side effect of
    # fused execution, and intersect resident bitsets on later queries
    # to prune by observed history ON TOP of the stats pruner.  False
    # disables both recording and lookup (stats-only pruning).
    pid_cache: bool = True
    # row sharding of scans: a launch.sharding.NamedSharding with a
    # one-axis spec, e.g. NamedSharding(mesh, ("data",))
    sharding: Optional[Any] = None
    disk_latency_per_byte: float = 0.0


@dataclass(frozen=True)
class MemoryConfig:
    """Memory-hierarchy knobs (ROADMAP "Memory hierarchy")."""

    budget_bytes: int = 1 << 30
    host_budget_bytes: Optional[int] = None   # None -> 4x device budget
    policy: str = "lru"                       # lru | benefit | admission
    retain_across_batches: bool = True


@dataclass(frozen=True)
class MqoConfig:
    """Multi-query-optimizer defaults applied per window."""

    enabled: bool = True
    k: int = 2                      # SE consumer threshold (Algorithm 1)
    locally_optimize: bool = True   # Catalyst-like single-query pass first
    max_compound_size: int = 4      # Algorithm 2 compound bound
    chain_cache_plans: bool = True  # larger CEs read smaller CEs' caches
    # Feed MemoryManager headroom (budget minus bytes other pools and
    # retained residents already hold) into the MCKP instead of the full
    # session budget, so planning stops over-admitting CEs the hierarchy
    # would immediately spill.
    pressure_aware: bool = True
    # Semantic subsumption: before the window optimizes, a query
    # whose predicate is IMPLIED by a retained resident CE's weaker
    # predicate resumes from that CE plus the residual conjuncts
    # (relational.canonical.subsumption_residual) — reuse without an
    # exact strict-fingerprint match.  False requires exact matches.
    subsumption: bool = True


@dataclass(frozen=True)
class ResilienceConfig:
    """Failure-handling knobs (ROADMAP "Failure semantics").

    * ``isolate`` — per-query fault isolation: a failing query resolves
      its own handle to a :class:`QueryError` while siblings in the
      window complete; off, the first failure aborts the window (every
      handle still resolves — to the same error).
    * ``degrade`` — the execution ladder: kernel route → fused torch
      → eager per-operator (on the card kernel → eager, stepped down
      only by injected faults); transient faults retry in place.
    * ``max_attempts`` — bounded attempts per query across retries and
      ladder steps (the ladder never loops forever).
    * ``backoff_base_s`` / ``backoff_multiplier`` — exponential backoff
      between attempts: sleep ``base * multiplier**(attempt-1)`` before
      attempt ``attempt+1``.  The default base of 0 disables sleeping
      (deterministic tests); the session clock is injectable
      (``Session._sleep``) so backoff tests never wall-sleep.
    * ``window_close_retries`` — bounded retries of the window-close
      step itself when its fault point fires.
    * ``audit_windows`` — run ``MemoryManager.audit()`` after every
      window and ``reconcile()`` on violations (cheap: pure bookkeeping
      arithmetic over live entries).
    * ``faults`` — optional :class:`~repro_torch.core.faults.FaultConfig`
      enabling the deterministic fault-injection harness.
    """

    isolate: bool = True
    degrade: bool = True
    max_attempts: int = 4
    backoff_base_s: float = 0.0
    backoff_multiplier: float = 2.0
    window_close_retries: int = 2
    audit_windows: bool = True
    faults: Optional[Any] = None      # core.faults.FaultConfig


@dataclass(frozen=True)
class SessionConfig:
    """Everything a Session needs, in one frozen value.

    Build variants with :func:`dataclasses.replace` on the sub-configs:

        cfg = SessionConfig(memory=MemoryConfig(budget_bytes=1 << 26))
        sess = Session.from_config(cfg)
    """

    execution: ExecutionConfig = field(default_factory=ExecutionConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    mqo: MqoConfig = field(default_factory=MqoConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)

    def with_execution(self, **kw) -> "SessionConfig":
        return replace(self, execution=replace(self.execution, **kw))

    def with_memory(self, **kw) -> "SessionConfig":
        return replace(self, memory=replace(self.memory, **kw))

    def with_mqo(self, **kw) -> "SessionConfig":
        return replace(self, mqo=replace(self.mqo, **kw))

    def with_resilience(self, **kw) -> "SessionConfig":
        return replace(self, resilience=replace(self.resilience, **kw))

    def with_faults(self, faults) -> "SessionConfig":
        """Attach a :class:`~repro_torch.core.faults.FaultConfig` (or None)."""
        return self.with_resilience(faults=faults)

    _LEGACY_EXECUTION_KEYS = frozenset(
        ("fuse", "defer_sync", "use_scan_cache", "sharding",
         "disk_latency_per_byte"))
    _LEGACY_MEMORY_KEYS = frozenset(
        ("budget_bytes", "host_budget_bytes", "policy",
         "retain_across_batches"))

    @classmethod
    def from_legacy_kwargs(cls, **kw) -> "SessionConfig":
        """Fold the pre-SessionConfig ``Session(...)`` keyword knobs
        into the unified config (the shared shim behind the legacy
        constructor path and helpers like ``build_tpcds_session``).
        Only keys actually passed are forwarded, so the sub-config
        dataclass field defaults stay the single source of truth."""
        unknown = set(kw) - cls._LEGACY_EXECUTION_KEYS \
            - cls._LEGACY_MEMORY_KEYS
        if unknown:
            raise TypeError(
                f"unknown legacy Session kwargs: {sorted(unknown)}")
        ex = {k: v for k, v in kw.items()
              if k in cls._LEGACY_EXECUTION_KEYS}
        mem = {k: v for k, v in kw.items()
               if k in cls._LEGACY_MEMORY_KEYS}
        if "budget_bytes" in mem:
            mem["budget_bytes"] = int(mem["budget_bytes"])
        return cls(execution=ExecutionConfig(**ex),
                   memory=MemoryConfig(**mem))


# ---------------------------------------------------------------------------
# window state
# ---------------------------------------------------------------------------
class WindowState:
    """One accumulating micro-batch window: the handles plus the
    *effective* close triggers for THIS window.

    Factored out of ``QueryService`` so the sync and async
    fronts share one lifecycle: both accumulate into a WindowState and
    hand the detached handle list to ``QueryService._run_window`` — the
    single execution path, so the two fronts are bit-identical on the
    same plan set.  The per-window ``max_batch`` / ``max_wait_s`` make
    adaptive windowing possible: the async policy sets them at open
    time from the arrival-rate EWMAs instead of fixed service knobs."""

    __slots__ = ("handles", "opened_at", "max_batch", "max_wait_s")

    def __init__(self):
        self.handles: List[QueryHandle] = []
        self.opened_at: Optional[float] = None
        self.max_batch: int = 1
        self.max_wait_s: Optional[float] = None

    @property
    def empty(self) -> bool:
        return not self.handles

    @property
    def size(self) -> int:
        return len(self.handles)

    def open(self, now: float, max_batch: int,
             max_wait_s: Optional[float]) -> None:
        """Arm the window for its first arrival with this window's
        effective close triggers."""
        assert not self.handles, "window already open"
        self.opened_at = now
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_s

    def append(self, handle: "QueryHandle") -> None:
        self.handles.append(handle)

    def contains(self, handle: "QueryHandle") -> bool:
        return any(h is handle for h in self.handles)

    def full(self) -> bool:
        return len(self.handles) >= self.max_batch

    def due(self, now: float) -> bool:
        """True when the deadline trigger should close the window."""
        return (bool(self.handles) and self.max_wait_s is not None
                and now - self.opened_at >= self.max_wait_s)

    def deadline(self) -> Optional[float]:
        """Absolute clock time of the deadline trigger (None when the
        window is empty or has no wait bound) — what the async closer
        task sleeps until."""
        if not self.handles or self.max_wait_s is None:
            return None
        return self.opened_at + self.max_wait_s

    def detach(self) -> List["QueryHandle"]:
        """Close the window: take the handles, reset to empty."""
        handles, self.handles = self.handles, []
        self.opened_at = None
        return handles


# ---------------------------------------------------------------------------
# lazy handles
# ---------------------------------------------------------------------------
@dataclass
class QueryError:
    """Terminal failure state of a :class:`QueryHandle`: the exception
    that killed the query after the resilience machinery gave up, plus
    the degradation/retry history that led there.  Sibling queries in
    the window are unaffected (per-query fault isolation)."""

    exception: BaseException
    window: int = -1
    position: int = -1
    attempts: int = 0
    events: List[dict] = field(default_factory=list)
    # strict cache keys (hex) the query's plan consumed that ARE
    # materialized despite the failure — work salvaged for siblings
    # and later windows
    salvaged_ces: List[str] = field(default_factory=list)

    def __repr__(self) -> str:
        return (f"QueryError({type(self.exception).__name__}: "
                f"{self.exception}, window={self.window}, "
                f"position={self.position}, attempts={self.attempts})")


class QueryHandle:
    """A submitted query: resolves when its micro-batch window runs.

    ``plan`` is the object as submitted (a Relation or a legacy raw
    Node — provenance for ``explain()``); ``node`` is the underlying
    logical tree the window optimizes."""

    __slots__ = ("plan", "node", "hint_cache", "seq", "tenant",
                 "_service", "_query_result", "_explain", "_done",
                 "_error", "_t_submit", "_family")

    def __init__(self, service: "QueryService", plan, seq: int, *,
                 node: Optional[L.Node] = None, hint_cache: bool = False,
                 tenant: Optional[str] = None):
        self._service = service
        self.plan = plan
        self.node = node if node is not None else L.as_node(plan)
        self.hint_cache = hint_cache
        self.seq = seq                  # submission order, service-wide
        self.tenant = tenant            # quota / attribution key
        self._query_result = None
        self._explain = None
        self._done = False
        self._error: Optional[QueryError] = None
        self._t_submit: Optional[float] = None    # service clock time
        self._family: Optional[str] = None        # loose psi hex (12)

    @property
    def done(self) -> bool:
        return self._done

    @property
    def failed(self) -> bool:
        """True when the handle resolved to a :class:`QueryError`."""
        return self._done and self._error is not None

    @property
    def error(self) -> Optional["QueryError"]:
        """The terminal failure state (None while pending or on
        success); inspecting it never raises — use ``result()`` to
        re-raise."""
        return self._error

    def result(self):
        """The query's output Table, forcing the window closed if this
        handle is still sitting in it (laziness must not deadlock).
        A failed query re-raises the exception that killed it.

        Awaiting ANY handle also drives the cooperative deadline clock
        (staleness fix): a different window whose ``max_wait_s``
        has expired closes here too, instead of sitting stranded until
        the next unrelated ``submit``."""
        if self._done:
            self._service.flush_expired()
        else:
            self._service._force(self)
        if not self._done:
            raise RuntimeError("handle was not resolved by its window")
        if self._error is not None:
            raise self._error.exception
        return self._query_result.table

    @property
    def query_result(self):
        """The full QueryResult (table + seconds + executed plan)."""
        if not self._done:
            self.result()
        if self._error is not None:
            raise self._error.exception
        return self._query_result

    def explain(self) -> dict:
        """Post-execution report: the chosen (rewritten) logical plan,
        every CE the plan consumes with its SE provenance, and whether
        each CE read hit an already-resident cache entry.  Rendered
        lazily — resolution stores only the ingredients, so windows
        (and run_batch) never pay for explains nobody asks for."""
        if not self._done:
            raise RuntimeError(
                "query still pending — call result(), flush() or poll()")
        if callable(self._explain):
            self._explain = self._explain()
        if isinstance(self._explain, ExplainReport):
            return self._explain.as_dict()
        return dict(self._explain)

    def explain_report(self) -> ExplainReport:
        """The typed report behind :meth:`explain`: one stable
        :class:`~repro_torch.relational.observe.ExplainReport` schema instead
        of ad-hoc dicts.  ``explain()`` stays the thin
        dict compat view over this object."""
        if not self._done:
            raise RuntimeError(
                "query still pending — call result(), flush() or poll()")
        if callable(self._explain):
            self._explain = self._explain()
        assert isinstance(self._explain, ExplainReport)
        return self._explain

    def _resolve(self, query_result, explain) -> None:
        self._query_result = query_result
        self._explain = explain
        self._done = True

    def _resolve_error(self, error: "QueryError", explain) -> None:
        self._error = error
        self._explain = explain
        self._done = True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = ("failed" if self.failed
                 else "done" if self._done else "pending")
        return f"QueryHandle(seq={self.seq}, {state})"


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
class QueryService:
    """Continuous-submission front-end over a :class:`Session`.

    Windows are cooperative (no threads): deadlines are checked on
    every ``submit`` / ``poll`` / ``result`` call.  ``clock`` is
    injectable for deterministic deadline tests.
    """

    def __init__(self, session, *,
                 max_batch: int = 8,
                 max_wait_s: Optional[float] = None,
                 mqo: Optional[bool] = None,
                 k: Optional[int] = None,
                 locally_optimize: Optional[bool] = None,
                 budget_bytes: Optional[int] = None,
                 clock=time.monotonic):
        mcfg = session.config.mqo
        self.session = session
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_s
        self.mqo = mcfg.enabled if mqo is None else bool(mqo)
        self.k = mcfg.k if k is None else int(k)
        self.locally_optimize = (mcfg.locally_optimize
                                 if locally_optimize is None
                                 else bool(locally_optimize))
        self.budget_bytes = budget_bytes
        self._clock = clock
        self._window = WindowState()
        self._n_windows = 0
        self._n_submitted = 0
        self._last_submit: Optional[float] = None   # inter-arrival EWMA

    # -- observability -------------------------------------------------------
    def telemetry(self):
        """The owning session's
        :class:`~repro_torch.relational.observe.Telemetry` hub."""
        return self.session.telemetry()

    def metrics_report(self) -> dict:
        """The unified observability report: registry snapshot,
        per-template-family latency percentiles, pool occupancy + hit
        rates, fault-injector telemetry, and the cost model's
        predicted-vs-actual calibration table."""
        return build_metrics_report(self.session)

    def _span(self, name: str, **attrs):
        tel = getattr(self.session, "_telemetry", None)
        if tel is not None and tel.tracer.enabled:
            return tel.tracer.span(name, **attrs)
        return NOOP_SPAN

    # -- submission ----------------------------------------------------------
    def submit(self, plan, *, tenant: Optional[str] = None) -> QueryHandle:
        """Add one query to the open window (opening one if needed).

        ``plan`` is a :class:`~repro_torch.relational.api.Relation` (raw
        ``logical.Node`` trees remain a deprecated compat shim).
        ``tenant`` labels the query for per-tenant metrics and pool-byte
        attribution (quota *enforcement* lives in the async front).
        Returns immediately with a lazy :class:`QueryHandle`.  If the
        previous window's deadline has passed, it is flushed first (its
        queries were due); if this arrival fills the window to
        ``max_batch``, the window closes inside this call.
        """
        self.flush_expired()
        node, hint = _coerce_submission(plan, "QueryService.submit")
        handle = QueryHandle(self, plan, self._n_submitted, node=node,
                             hint_cache=hint, tenant=tenant)
        now = self._note_submit(handle)
        with self._span("submit", seq=handle.seq):
            if self._window.empty:
                self._window.open(now, self.max_batch, self.max_wait_s)
            self._window.append(handle)
            if self._window.full():
                self.flush()
        return handle

    def _note_submit(self, handle: QueryHandle) -> float:
        """Shared submission bookkeeping (sync front and async front):
        stamp the handle's submit time, advance the submission counter,
        and record the arrival telemetry — ``queries.submitted`` (plus
        the per-tenant labeled child) and the inter-arrival EWMA the
        adaptive window policy feeds on.  Returns the clock reading."""
        now = self._clock()
        handle._t_submit = now
        tel = getattr(self.session, "_telemetry", None)
        if tel is not None:
            tel.registry.inc("queries.submitted")
            if handle.tenant is not None:
                tel.registry.inc("queries.submitted",
                                 labels={"tenant": handle.tenant})
            if self._last_submit is not None:
                tel.registry.ewma("arrival.interval_s").observe(
                    now - self._last_submit)
            self._last_submit = now
        self._n_submitted += 1
        return now

    def poll(self) -> bool:
        """Deadline check: closes the open window if ``max_wait_s`` has
        elapsed.  Returns True when a window ran."""
        return self.flush_expired() is not None

    def flush_expired(self):
        """Close the open window IFF its deadline has passed — the
        cooperative window-closing entry point for callers that are not
        submitting (a server event loop, a background ticker): unlike
        ``flush()`` it never cuts a still-filling window short, and
        unlike ``result()`` it does not block on any handle.  Returns
        the closed window's BatchResult, or None when no window was
        due (no deadline configured, nothing pending, or still within
        ``max_wait_s``)."""
        if self._window.due(self._clock()):
            return self.flush()
        return None

    @property
    def pending(self) -> int:
        return self._window.size

    def flush(self):
        """Close the open window now; resolves its handles.  Returns
        the window's BatchResult, or None when nothing was pending."""
        handles = self._window.detach()
        if not handles:
            return None
        return self._run_window(handles)

    def run_closed(self, plans: Sequence[L.Node], *,
                   mqo: Optional[bool] = None,
                   k: Optional[int] = None,
                   budget_bytes: Any = _UNSET,
                   locally_optimize: Optional[bool] = None):
        """The one-shot path: a pre-closed window over ``plans`` (no
        accumulation, independent of the open window).  This is what
        ``Session.run_batch`` routes through."""
        plans = list(plans)   # the input may be a one-shot iterator
        # plain loop, not a comprehension: comprehension frames differ
        # across Python versions (PEP 709), which would skew the
        # warning's stacklevel.  Frames above the warn: _coerce(1),
        # run_closed(2), run_batch(3), the user's call site(4).
        coerced = []
        for p in plans:
            coerced.append(
                _coerce_submission(p, "Session.run_batch", stacklevel=4))
        handles = [QueryHandle(self, p, -1, node=n, hint_cache=h)
                   for p, (n, h) in zip(plans, coerced)]
        now = self._clock()
        for h in handles:
            h._t_submit = now     # pre-closed: latency == window time
        tel = getattr(self.session, "_telemetry", None)
        if tel is not None:
            tel.registry.inc("queries.submitted", len(handles))
        return self._run_window(handles, mqo=mqo, k=k,
                                budget_bytes=budget_bytes,
                                locally_optimize=locally_optimize)

    # -- internals -----------------------------------------------------------
    def _force(self, handle: QueryHandle) -> None:
        self.flush_expired()
        if not handle._done and self._window.contains(handle):
            self.flush()

    def _family_of(self, node: L.Node) -> str:
        """Loose-ψ template family of one submission, computed exactly
        as ``_run_window_inner`` will (canonicalize, optionally locally
        optimize, loose fingerprint) — the async front's adaptive
        policy keys its arrival-rate EWMAs on this BEFORE the window
        runs."""
        p = canonicalize_plan(node)
        if self.locally_optimize:
            p = canonicalize_plan(optimize_single(p))
        return fingerprint(p).hex()[:12]

    def _run_window(self, handles: List[QueryHandle], *,
                    mqo: Optional[bool] = None,
                    k: Optional[int] = None,
                    budget_bytes: Any = _UNSET,
                    locally_optimize: Optional[bool] = None):
        """Close one window: optimize, execute, resolve every handle.

        Exception safety: ``flush()`` detached the window's
        state BEFORE this runs, so the service itself can never be left
        with a half-closed window — the corruption an escaping
        exception used to cause was permanently-unresolved handles.
        The safety net here guarantees every handle resolves to a
        result or a :class:`QueryError` no matter where the window
        died; with isolation off (or on non-Exception unwinds like
        KeyboardInterrupt) the exception still propagates to the
        caller afterwards."""
        sess = self.session
        window = self._n_windows
        self._n_windows += 1
        res = getattr(sess, "resilience", None)
        with self._span("window", window=window,
                        n_queries=len(handles)) as wsp:
            try:
                batch = self._run_window_inner(
                    handles, window, mqo=mqo, k=k,
                    budget_bytes=budget_bytes,
                    locally_optimize=locally_optimize)
            except BaseException as exc:
                wsp.set(error=repr(exc))
                self._resolve_window_error(handles, exc, window)
                self._audit_after_window(sess, res, None)
                if (res is not None and res.isolate
                        and isinstance(exc, Exception)):
                    from .executor import BatchResult

                    batch = BatchResult([None] * len(handles), 0.0)
                    batch.resilience = {"window_error": repr(exc),
                                        "n_failed": len(handles)}
                    return batch
                raise
            self._audit_after_window(sess, res, batch)
            return batch

    def _run_window_inner(self, handles: List[QueryHandle], window: int,
                          *, mqo, k, budget_bytes, locally_optimize):
        from .executor import BatchResult
        from .physical import CEMaterializationError

        sess = self.session
        res = getattr(sess, "resilience", None)
        injector = getattr(sess, "fault_injector", None)
        isolate = res is not None and res.isolate
        mqo = self.mqo if mqo is None else mqo
        k = self.k if k is None else k
        local = (self.locally_optimize if locally_optimize is None
                 else locally_optimize)
        budget_req = (self.budget_bytes if budget_bytes is _UNSET
                      else budget_bytes)

        # the window-close step is itself a named fault point, retried
        # a bounded number of times with backoff (each retry draws a
        # fresh decision from the seeded stream)
        if injector is not None:
            retries = res.window_close_retries if res is not None else 0
            for attempt in range(retries + 1):
                try:
                    injector.check("window_close")
                    break
                except InjectedFault:
                    if attempt >= retries:
                        raise
                    sess._backoff(attempt + 1)

        # The canonicalization pass runs for EVERY plan — builder-made
        # or hand-made — before anything fingerprints, so syntactic
        # variants (shuffled conjuncts, pushed negations, flipped
        # compares, redundant projections) map to one ψ and one strict
        # fingerprint.  It brackets local optimization: equal canonical
        # inputs make the deterministic single-query pass emit equal
        # trees, and the trailing pass restores normal form on whatever
        # that pass rebuilt.  Per-query isolation starts here: one
        # poisoned plan fails only its own handle, and the window
        # optimizes the survivors.
        n = len(handles)
        plans: List[Optional[L.Node]] = [None] * n
        errors: Dict[int, BaseException] = {}
        events: Dict[int, List[DegradationEvent]] = {
            i: [] for i in range(n)}
        with self._span("canonicalize", n_queries=n):
            for i, h in enumerate(handles):
                try:
                    p = canonicalize_plan(h.node)
                    if local:
                        p = canonicalize_plan(optimize_single(p))
                    plans[i] = p
                except Exception as exc:
                    if not isolate:
                        raise
                    errors[i] = exc
        live = [i for i in range(n) if i not in errors]
        tel = getattr(sess, "_telemetry", None)
        if tel is not None:
            # template family = loose structural fingerprint of the
            # canonical plan (the recurring-template key): per-family
            # latency histograms are observed at resolve time
            for i in live:
                handles[i]._family = fingerprint(plans[i]).hex()[:12]

        optimized = None
        ces: list = []
        pre_resident: frozenset = frozenset()
        subsumed: Dict[int, dict] = {}
        executed: List[Optional[L.Node]] = list(plans)
        if not mqo or not live:
            ctx = sess._fresh_ctx()
        else:
            # cache_hint() submissions: every loose ψ under a hinted
            # plan is an SE candidate even with a single consumer,
            # re-priced with a phantom future consumer (see
            # MultiQueryOptimizer.optimize).  Computed only on the MQO
            # path — the Merkle walks would be wasted work otherwise.
            hinted = frozenset()
            for i in live:
                if handles[i].hint_cache:
                    hinted |= fingerprint_set(plans[i])

            budget = budget_req if budget_req is not None else sess.budget
            cache = sess._ce_cache
            if not sess.retain_across_batches:
                # clear BEFORE computing the planning capacity: the
                # freed CE bytes are available to this window's MCKP
                cache.clear()
                sess._resident_index.clear()
                sess._resident_meta.clear()
            else:
                # prune metadata for entries the hierarchy has dropped —
                # these dicts must not grow with the workload's history
                for sfp in [s for s in sess._resident_index
                            if not cache.contains(s)]:
                    del sess._resident_index[sfp]
                for sfp in [s for s in sess._resident_meta
                            if not cache.contains(s)]:
                    del sess._resident_meta[sfp]
            capacity = sess.planning_capacity(budget)
            partitioner = None
            # prune=False must force the UNPRUNED path end to end: CE
            # partitioning both prunes live partitions and executes
            # partition-restricted scans, so the debugging knob
            # disables it
            if sess.prune and any(st.partitions is not None
                                  for st in sess.catalog.values()):
                from .partition import make_ce_partitioner

                partitioner = make_ce_partitioner(sess.catalog)
            optimizer = MultiQueryOptimizer(
                cost_model=sess.cost_model,
                rewriter=RelationalRewriter(fuse_residuals=sess.fuse),
                budget_bytes=capacity,
                k=k,
                ce_transform=make_ce_transform(),
                max_compound_size=sess.config.mqo.max_compound_size,
                chain_cache_plans=sess.config.mqo.chain_cache_plans,
                partitioner=partitioner,
                tracer=(tel.tracer if tel is not None and tel.tracing
                        else None),
            )
            # loose psi -> strict fingerprints of every resident
            # covering relation with that structure (a zero planning
            # budget disables resident reuse — it is the "no caching at
            # all" baseline); partition-grained residents are keyed
            # (strict, pid) and re-priced per partition
            resident: Dict[bytes, Set[bytes]] = {}
            resident_parts: Dict[bytes, frozenset] = {}
            if budget > 0:
                for sfp, psi in sess._resident_index.items():
                    resident.setdefault(psi, set()).add(sfp)
                resident_parts = sess.ce_resident_parts()
            with self._span("mqo", window=window,
                            n_live=len(live)) as msp:
                optimized = optimizer.optimize(
                    [plans[i] for i in live], resident=resident,
                    resident_parts=resident_parts, hinted=hinted)
                msp.set(n_selected=optimized.report.n_selected,
                        selected_weight=optimized.report.selected_weight)

            ces = optimized.rewritten.ces
            # strict keys cannot collide across content, so no
            # stale-entry eviction is needed; record which selected CEs
            # are already materialized BEFORE this window executes
            # (handle.explain).  A partitioned CE counts as resident
            # when ANY of its partitions is (that is what partial
            # residency means).
            pre_resident = frozenset(
                ce.strict_psi() for ce in ces
                if (cache.contains(ce.strict_psi())
                    or (ce.partition_detail is not None
                        and resident_parts.get(ce.strict_psi()))))
            if sess.retain_across_batches:
                for ce in ces:
                    # partitioned CEs are retained per (strict, pid)
                    # cache entry; whole-CE re-pricing would be unsound
                    if ce.partition_detail is None:
                        sess._resident_index[ce.strict_psi()] = ce.psi
                        sess._note_subsumable(ce)
            # -- semantic subsumption ---------------------------
            # Backstop for queries the MQO left UNREWRITTEN (no
            # intra-window sharing, no exact-fingerprint resident): if
            # a retained resident CE's weaker predicate IMPLIES the
            # query's, the query resumes from CachedScan(strict) + the
            # residual conjuncts — reuse with ZERO exact-fingerprint
            # matches.  Running AFTER the optimizer keeps priorities
            # right: a window that can share intra-window or resume
            # exactly still materializes / consumes its own tighter CE
            # (recurring template families keep per-threshold residents
            # side by side), and subsumption picks up only the queries
            # that would otherwise go cold.  The original canonical
            # plan stays in ``plans`` as the CEMaterializationError
            # fallback; the subsumer's covering tree is attached as a
            # recompute plan so eviction mid-window means recompute,
            # not failure.
            sub_plans: Dict[int, L.Node] = {}
            if budget > 0 and getattr(sess.config.mqo, "subsumption",
                                      True):
                for j, i in enumerate(live):
                    if optimized.rewritten.plans[j] is not plans[i]:
                        continue    # MQO already gave it sharing
                    try:
                        hit = sess.find_subsumer(plans[i])
                    except Exception:
                        continue    # lookup is an optimization only
                    if hit is None:
                        continue
                    strict, meta, resid = hit
                    sub_plans[i] = _subsumption_plan(
                        plans[i], strict, meta, resid)
                    attach_recompute_plan(
                        optimized.rewritten, strict,
                        L.Cache(child=meta.tree, psi=strict))
                    subsumed[i] = {
                        "strict_psi": strict.hex()[:12],
                        "residual": repr(E.canonical(resid)),
                    }
            optimized.report.n_subsumed = len(sub_plans)
            ctx = sess._fresh_ctx(cache)
            ctx.cache_plans = dict(optimized.rewritten.cache_plans)
            # execution-side records for partition-grained CEs: which
            # partitions are live, which the MCKP admitted,
            # per-partition benefit shares for the eviction policy
            for ce in ces:
                if ce.partition_detail is None:
                    continue
                pplan, slices = ce.partition_detail
                pplan.admitted = ce.admitted_partitions or frozenset()
                pplan.benefits = {
                    sl.pid: max(float(sl.value), 0.0) for sl in slices}
                ctx.partitioned_ces[ce.strict_psi()] = pplan
            # benefit-per-byte eviction ranks entries by the cost
            # model's savings estimate (Eq. 3 value at admission time)
            ctx.cache_values = {ce.strict_psi(): max(float(ce.value), 0.0)
                                for ce in ces}
            for j, i in enumerate(live):
                executed[i] = optimized.rewritten.plans[j]
            for i, p in sub_plans.items():
                executed[i] = p

        t0 = time.perf_counter()
        results: List[Optional[Any]] = [None] * n
        # window batching: same-shape fused pipelines in the
        # window execute as ONE batched mask dispatch; everything else
        # (and every batch failure) falls through to the per-query loop
        batched_done: Set[int] = set()
        shared_dispatch: Dict[int, List[int]] = {}
        with self._span("execute", window=window,
                        n_live=len(live)) as xsp:
            if getattr(sess, "window_batch", True) and len(live) >= 2:
                # the batched dispatch serves several queries at once;
                # attribute its admissions to the first live tenant
                # (first-toucher pays — same rule as shared CEs below)
                first_tenant = next(
                    (handles[i].tenant for i in live
                     if handles[i].tenant is not None), None)
                with _owning(sess, first_tenant):
                    batched_done, shared_dispatch = self._exec_batched(
                        sess, ctx, live, executed, results, events)
            xsp.set(n_batched=len(batched_done))
            for i in live:
                if i in batched_done:
                    continue
                try:
                    with _owning(sess, handles[i].tenant):
                        results[i] = sess.run_one_resilient(
                            executed[i], ctx, query=i, events=events[i])
                except CEMaterializationError as exc:
                    # a shared CE is poisoned: rerun THIS consumer on
                    # its unshared residual plan (the pre-rewrite
                    # canonical tree).  Sibling consumers fail fast on
                    # the poisoned ψ and fall back the same way,
                    # independently.
                    events[i].append(DegradationEvent(
                        query=i, attempt=len(events[i]) + 1,
                        action="fallback", level="residual",
                        error=repr(exc)))
                    try:
                        with _owning(sess, handles[i].tenant):
                            results[i] = sess.run_one_resilient(
                                plans[i], ctx, query=i, events=events[i])
                        executed[i] = plans[i]
                    except Exception as exc2:
                        if not isolate:
                            raise
                        errors[i] = exc2
                except Exception as exc:
                    if not isolate:
                        raise
                    errors[i] = exc
        total = time.perf_counter() - t0

        batch = BatchResult(
            results, total,
            optimize_seconds=(optimized.report.optimize_seconds
                              if optimized is not None else 0.0),
            mqo=optimized,
            cache_report=(sess._ce_cache.report()
                          if optimized is not None else {}),
            metrics=ctx.metrics,
        )
        all_events = [e.as_dict()
                      for i in range(n) for e in events[i]]
        # context-level degradations (e.g. a failed pid bitset read
        # falling back to stats-only pruning) are window-scoped, not
        # attributable to one handle — report them alongside
        all_events += [e.as_dict()
                       for e in getattr(ctx, "degradations", ())]
        rep: Dict[str, Any] = {}
        if all_events:
            rep["events"] = all_events
        if errors or not live:
            rep["n_failed"] = len(errors)
        if injector is not None:
            rep["faults"] = injector.report()
        batch.resilience = rep
        if tel is not None:
            # the ONE place window degradation/retry events and
            # per-window ExecMetrics enter the session-lifetime books
            for ev in all_events:
                tel.record_event(ev)
            tel.absorb_exec_metrics(ctx.metrics)
            tel.registry.inc("windows.closed")
            tel.registry.inc("queries.executed", len(live))
            tel.registry.histogram(
                "window.size",
                edges=tuple(float(x) for x in range(1, 65))).observe(n)
            tel.registry.observe("window.seconds", total)
        ce_by_key = {ce.strict_psi(): ce for ce in ces}
        with self._span("resolve", window=window):
            self._resolve(
                handles, batch, window, mqo=bool(mqo), k=k,
                executed_plans=executed, ce_by_key=ce_by_key,
                pre_resident=pre_resident, errors=errors,
                events=events, ctx=ctx,
                shared_dispatch=shared_dispatch,
                subsumed=subsumed,
                pid_log=dict(getattr(ctx, "pid_prune_log", {})))
        return batch

    @staticmethod
    def _exec_batched(sess, ctx, live, executed, results, events):
        """Window-batched execution step: plan same-shape dispatch
        groups over the window's live plans and run each group as ONE
        batched kernel call.  Returns ``(done positions, {position:
        sorted positions sharing its dispatch})``.  Any failure — the
        ``batched_launch`` fault point, a diverging group, a kernel
        error — degrades the affected queries back to the per-query
        loop (the degradation ladder handles them from there); results are
        bit-identical either way, so degradation is invisible to
        callers."""
        from .executor import QueryResult
        from .physical import (CEMaterializationError,
                               execute_window_batched,
                               plan_window_batches)

        done: Set[int] = set()
        shared: Dict[int, List[int]] = {}
        try:
            n_cand, groups = plan_window_batches(
                [(i, executed[i]) for i in live], ctx)
        except Exception:
            # planning must never take the window down — worst case
            # everything stays on the per-query path
            return done, shared
        if n_cand < 2:
            return done, shared
        # the shared dispatch is a named fault point: one check per
        # window with batchable candidates, BEFORE any group runs, so
        # an injected fault degrades the whole window to per-query
        # dispatch without consuming any per-query fault draws
        try:
            ctx.check_fault("batched_launch")
        except InjectedFault as exc:
            for g in groups:
                for m in g:
                    events[m.pos].append(DegradationEvent(
                        query=m.pos, attempt=1, action="degrade",
                        level="per-query", error=repr(exc)))
            return done, shared
        if not groups:
            return done, shared
        tables, seconds, failures = execute_window_batched(groups, ctx)
        for g in groups:
            poss = sorted(m.pos for m in g)
            for m in g:
                if m.pos not in tables:
                    continue
                results[m.pos] = QueryResult(
                    table=tables[m.pos], seconds=seconds[m.pos],
                    plan=executed[m.pos])
                done.add(m.pos)
                shared[m.pos] = poss
        for pos, exc in failures.items():
            if isinstance(exc, CEMaterializationError):
                # poisoned CE: the per-query loop's residual fallback
                # owns this case — not a batching degradation
                continue
            events[pos].append(DegradationEvent(
                query=pos, attempt=1, action="degrade",
                level="per-query", error=repr(exc)))
        return done, shared

    def _resolve(self, handles, batch, window, *, mqo, k,
                 executed_plans, ce_by_key, pre_resident,
                 errors=None, events=None, ctx=None,
                 shared_dispatch=None, subsumed=None,
                 pid_log=None) -> None:
        n = len(handles)
        errors = errors or {}
        events = events or {}
        shared_dispatch = shared_dispatch or {}
        subsumed = subsumed or {}
        pid_log = pid_log or {}
        tel = getattr(self.session, "_telemetry", None)
        now = self._clock() if tel is not None else 0.0
        for i, (h, qr) in enumerate(zip(handles, batch.results)):
            if h._done:
                continue
            failed = i in errors or qr is None
            if tel is not None:
                outcome = "queries.failed" if failed else "queries.succeeded"
                tel.registry.inc(outcome)
                if h.tenant is not None:
                    tel.registry.inc(outcome, labels={"tenant": h.tenant})
                if h._t_submit is not None:
                    lat = max(now - h._t_submit, 0.0)
                    tel.registry.observe("latency.all", lat)
                    if h.tenant is not None:
                        tel.registry.observe("latency.tenant", lat,
                                             labels={"tenant": h.tenant})
                    if h._family:
                        tel.registry.observe(
                            f"latency.family.{h._family}", lat)
            if failed:
                exc = errors.get(i, RuntimeError("query was not executed"))
                err, explain = self._failure_state(
                    h, exc, window, i, n, events.get(i, ()),
                    executed_plans[i], ctx)
                h._resolve_error(err, explain)
                continue
            h._resolve(qr, _LazyExplain(
                h, qr, window, i, n, bool(mqo), k,
                executed_plans[i], ce_by_key, pre_resident,
                shared_dispatch.get(i), subsumed.get(i), pid_log))

    @staticmethod
    def _failure_state(handle, exc, window, position, n, events, plan,
                       ctx):
        """The (QueryError, explain dict) pair for one failed handle:
        the triggering exception, the retry/degradation history, and
        which CEs of its rewritten plan were salvaged (materialized
        despite the failure — reusable by siblings and later windows)
        versus poisoned."""
        evs = [e.as_dict() for e in events]
        salvaged: List[str] = []
        failed_ces: List[str] = []
        cache = getattr(ctx, "cache", None) if ctx is not None else None
        if plan is not None and cache is not None:
            for key in _cached_scan_keys(plan):
                if key in getattr(ctx, "failed_ces", ()):
                    failed_ces.append(key.hex()[:12])
                elif cache.contains(key):
                    salvaged.append(key.hex()[:12])
        err = QueryError(
            exception=exc, window=window, position=position,
            attempts=max([e["attempt"] for e in evs], default=1),
            events=evs, salvaged_ces=salvaged)
        explain = ExplainReport(
            status="failed", window=window, position=position,
            window_size=n, error=repr(exc), events=tuple(evs),
            ces_salvaged=tuple(salvaged), ces_failed=tuple(failed_ces),
            submitted=L.explain(handle.node))
        return err, explain

    def _resolve_window_error(self, handles, exc, window) -> None:
        """Safety net: resolve every still-pending handle of a window
        that died outside the per-query execution loop."""
        n = len(handles)
        tel = getattr(self.session, "_telemetry", None)
        for i, h in enumerate(handles):
            if h._done:
                continue
            if tel is not None:
                tel.registry.inc("queries.failed")
                if h.tenant is not None:
                    tel.registry.inc("queries.failed",
                                     labels={"tenant": h.tenant})
            try:
                submitted = L.explain(h.node)
            except Exception:
                submitted = ""
            h._resolve_error(
                QueryError(exception=exc, window=window, position=i),
                ExplainReport(status="failed", window=window,
                              position=i, window_size=n,
                              error=repr(exc), submitted=submitted))

    @staticmethod
    def _audit_after_window(sess, res, batch) -> None:
        """Post-window pool self-audit: verify the memory invariants
        and repair (quarantine-then-drop) on violation, recording both
        in the window report."""
        if res is None or not res.audit_windows:
            return
        mm = getattr(sess, "memory", None)
        if mm is None or not hasattr(mm, "audit"):
            return
        violations = mm.audit()
        repair = mm.reconcile() if violations else None
        if batch is not None:
            batch.resilience["audit"] = {
                "violations": list(violations),
                "repair": repair,
            }


class _LazyExplain:
    """Deferred explain rendering: holds the window's ingredients and
    builds the report dict on first ``handle.explain()`` call."""

    __slots__ = ("handle", "qr", "window", "position", "window_size",
                 "mqo", "k", "executed_plan", "ce_by_key", "pre_resident",
                 "shared_dispatch", "subsumption", "pid_log")

    def __init__(self, handle, qr, window, position, window_size, mqo, k,
                 executed_plan, ce_by_key, pre_resident,
                 shared_dispatch=None, subsumption=None, pid_log=None):
        self.handle = handle
        self.qr = qr
        self.window = window
        self.position = position
        self.window_size = window_size
        self.mqo = mqo
        self.k = k
        self.executed_plan = executed_plan
        self.ce_by_key = ce_by_key
        self.pre_resident = pre_resident
        # window positions whose queries shared ONE batched mask
        # dispatch with this one (includes this position); None when
        # the query ran on the per-query path
        self.shared_dispatch = shared_dispatch
        # {"strict_psi", "residual"} when this query resumed from a
        # resident CE by predicate subsumption; None otherwise
        self.subsumption = subsumption
        # window-level (table, canonical pred) -> partitions the pid
        # bitset intersection pruned beyond statistics
        self.pid_log = pid_log or {}

    def __call__(self) -> ExplainReport:
        ce_reports = []
        for key in _cached_scan_keys(self.executed_plan):
            ce = self.ce_by_key.get(key)
            if ce is None:
                continue           # e.g. full-relation keys (not a CE)
            resident_repriced = bool(ce.cost_detail.get("resident", False))
            entry = ExplainCE(
                psi=ce.psi.hex()[:12],
                strict_psi=key.hex()[:12],
                label=ce.tree.label,
                m=ce.m,
                value=float(ce.value),
                weight=int(ce.weight),
                resident_repriced=resident_repriced,
                cache_hit=key in self.pre_resident,
                single_resume=resident_repriced and ce.m < self.k,
            )
            if ce.partition_detail is not None:
                pplan, _ = ce.partition_detail
                entry.partitions = {
                    "live": list(pplan.live),
                    "admitted": sorted(ce.admitted_partitions or ()),
                }
            ce_reports.append(entry)
        return ExplainReport(
            status="done",
            window=self.window,
            position=self.position,
            window_size=self.window_size,
            mqo=self.mqo,
            seconds=self.qr.seconds,
            plan=L.explain(self.qr.plan),
            submitted=L.explain(self.handle.plan),
            ces=tuple(ce_reports),
            resident_reuse=any(c.cache_hit for c in ce_reports),
            subsumption_hit=self.subsumption is not None,
            pid_pruned_parts=_pid_pruned_for(self.executed_plan,
                                             self.pid_log),
            subsumption=(dict(self.subsumption)
                         if self.subsumption is not None else None),
            shared_dispatch=(list(self.shared_dispatch)
                             if self.shared_dispatch else None),
        )


def _owning(sess, tenant: Optional[str]):
    """Scope ``sess.memory`` admissions to ``tenant`` (no-op context
    when the session has no attribution-capable manager)."""
    mm = getattr(sess, "memory", None)
    if mm is None or not hasattr(mm, "owning"):
        return nullcontext()
    return mm.owning(tenant)


def _subsumption_plan(plan: L.Node, strict: bytes, meta,
                      resid) -> L.Node:
    """CachedScan(resident CE) → residual Filter → Project producing
    exactly ``plan``'s output columns — the subsumption-resume plan
    (mirrors RelationalRewriter.make_extraction; left logical, so
    execution fuses/batches it like any chain)."""
    from .canonical import is_true

    out: L.Node = L.CachedScan(psi=strict, _schema=meta.tree.schema,
                               source_label=meta.tree.label)
    if not is_true(resid):
        out = L.Filter(child=out, pred=resid)
    if tuple(out.schema.names) != tuple(plan.schema.names):
        out = L.Project(child=out, cols=tuple(plan.schema.names))
    return out


def _pid_pruned_for(plan, pid_log) -> int:
    """Partitions the pid-bitset intersection pruned (beyond stats) for
    this query's fused scan+filter, looked up by (table, canonical
    predicate) in the window's prune log; 0 for non-scan plans."""
    if not pid_log or plan is None:
        return 0
    from .fuse import FusedPipeline, fuse_plan

    try:
        node = L.as_node(plan)
        if not isinstance(node, FusedPipeline):
            node = fuse_plan(node)
        if (isinstance(node, FusedPipeline)
                and isinstance(node.source, L.Scan)):
            return int(pid_log.get(
                (node.source.table, E.canonical(node.pred)), 0))
    except Exception:
        pass
    return 0


def _cached_scan_keys(plan: L.Node) -> List[bytes]:
    """Cache keys of every CachedScan the executed plan reads (fused
    pipelines expose their source leaf through ``children``)."""
    keys: List[bytes] = []
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, L.CachedScan):
            keys.append(node.psi)
        stack.extend(node.children)
    return keys

"""Asynchronous serving front: concurrent submission, a background
window closer, adaptive windows, per-tenant admission control.

The sync :class:`~repro_torch.relational.service.QueryService` is
cooperative: window deadlines fire only inside ``submit`` / ``poll`` /
``result`` calls, so a deadline window with no caller in flight sits
open, and thousands of concurrent clients would serialize on one
lock-step loop.  This module retires that caveat:

    svc = await AsyncQueryService(session, config=AsyncConfig(
        slo_p99_s=0.5, quotas={"acme": TenantQuota(max_bytes=1 << 24)},
    )).start()
    h = await svc.submit(plan, tenant="acme")   # enqueue, lock-free
    table = await h                             # or: await h.result()
    ...
    await svc.aclose()

**Architecture (single-writer).**  Submitters run on the asyncio event
loop and only append to the open :class:`WindowState` — plain
event-loop-thread mutation, no locks.  Closed windows (detached handle
lists) are pushed onto an ``asyncio.Queue`` and drained by ONE executor
task that runs each window via ``loop.run_in_executor`` on a dedicated
single-thread pool — so window MQO + execution stay strictly serialized
against the shared Session (the same ``QueryService._run_window`` the
sync front and ``run_batch`` use, hence bit-identical results on the
same plan set) while the event loop stays free to accept arrivals.
The worker ends each window with a synchronize of the session's device,
so a handle resolves only after its window's device work is complete.

**Background closer.**  A closer task sleeps until the open window's
deadline and closes it with *no caller in flight* — ``flush_expired`` /
``poll`` survive only as thin compat shims that nudge the closer.  The
deadline close is the ``async_close`` fault point: an injected fault
crashes the closer task, the supervisor restarts it (counted in
``async.closer_restarts``), and the due window closes on the next pass
— every pending handle still resolves.

**Admission control.**  ``submit(..., tenant=...)`` charges the
tenant's live CE/scan-pool bytes (``MemoryManager.owner_bytes``,
stamped first-toucher-pays during execution) and in-flight query count
against its :class:`TenantQuota`; over-quota submissions queue (FIFO
per tenant, re-evaluated as queries finish) or fail fast with
:class:`AdmissionError`.  ``metrics_report()`` grows per-tenant
occupancy/latency sections.

**Adaptive windowing.**  Per-template-family arrival-rate EWMAs set
each window's effective ``max_batch`` / ``max_wait_s`` at open time to
maximize expected sharing — the cost model's
``window_dispatch_cost(n, batched)`` savings grow with batch size —
subject to the p99 latency SLO (``AsyncConfig.slo_p99_s``): the wait
budget is what remains of the SLO after the observed p99 window
execution time, and the batch target is how many arrivals of the
opening query's family fit in that budget.  Chosen parameters and
predicted-vs-realized sharing are logged as spans + metrics
(``window.adaptive.*``).
"""
from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from ..device import synchronize
from . import logical as L  # noqa: F401  (type context for plans)
from .service import (QueryHandle, QueryService, WindowState,
                      _coerce_submission)

__all__ = [
    "AsyncConfig", "TenantQuota", "AdmissionError",
    "AdmissionController", "AdaptiveWindowPolicy", "WindowParams",
    "AsyncQueryHandle", "AsyncQueryService",
]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits.

    * ``max_bytes`` — cap on the tenant's attributed live pool bytes
      (CE + scan + everything stamped to it, first-toucher-pays); a
      submission while at/over the cap queues or fails.
    * ``max_inflight`` — cap on admitted-but-unresolved queries.
    * ``max_queued`` — cap on submissions waiting for admission
      (beyond it, ``submit`` raises even in ``"queue"`` mode).
    * ``on_over`` — ``"queue"`` (default: wait for headroom) or
      ``"fail"`` (raise :class:`AdmissionError` immediately).

    ``None`` on any limit disables that check."""

    max_bytes: Optional[int] = None
    max_inflight: Optional[int] = None
    max_queued: Optional[int] = None
    on_over: str = "queue"

    def __post_init__(self):
        assert self.on_over in ("queue", "fail"), self.on_over


@dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the async front.

    With ``adaptive=False`` (or no ``slo_p99_s``) every window uses the
    fixed ``max_batch`` / ``max_wait_s`` — the sync service's contract.
    With ``adaptive=True`` and an SLO those become the *defaults* for
    families with no arrival history, and each window's effective
    parameters come from :class:`AdaptiveWindowPolicy`."""

    max_batch: int = 8
    max_wait_s: Optional[float] = None
    # -- adaptive windowing --------------------------------------------------
    adaptive: bool = False
    slo_p99_s: Optional[float] = None   # end-to-end p99 latency target
    min_batch: int = 1
    max_batch_cap: int = 64
    # fallback p99 window-execution estimate until windows.seconds has
    # real observations (conservative: first windows close fast)
    exec_default_s: float = 0.05
    # -- admission control ---------------------------------------------------
    quotas: Mapping[str, TenantQuota] = field(default_factory=dict)
    # applied to tenants without an explicit quota (None: unlimited)
    default_quota: Optional[TenantQuota] = None


class AdmissionError(RuntimeError):
    """A submission rejected by admission control (quota exceeded with
    ``on_over="fail"``, or the tenant's admission queue is full)."""


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
class AdmissionController:
    """Per-tenant admission gate, event-loop-confined (no locks needed:
    counters only mutate on the loop thread).

    Byte usage is read from ``MemoryManager.owner_bytes`` — the live
    attribution the execution path stamps — so a tenant whose cached
    state was evicted automatically regains byte headroom.  Waiters are
    re-evaluated whenever one of the tenant's queries resolves (the
    moments in-flight slots and, typically, bytes are released)."""

    def __init__(self, session, config: AsyncConfig):
        self.session = session
        self.config = config
        self.inflight: Dict[str, int] = {}
        self.waiting: Dict[str, int] = {}
        self._conds: Dict[str, asyncio.Condition] = {}

    def quota_for(self, tenant: Optional[str]) -> Optional[TenantQuota]:
        if tenant is None:
            return None
        q = self.config.quotas.get(tenant)
        return q if q is not None else self.config.default_quota

    def _over(self, tenant: str, q: TenantQuota) -> Optional[str]:
        """The violated limit's name, or None when the tenant fits."""
        if (q.max_inflight is not None
                and self.inflight.get(tenant, 0) >= q.max_inflight):
            return "inflight"
        if q.max_bytes is not None:
            mm = getattr(self.session, "memory", None)
            if (mm is not None and hasattr(mm, "owner_bytes")
                    and mm.owner_bytes(tenant) >= q.max_bytes):
                return "bytes"
        return None

    def _tinc(self, name: str, tenant: str) -> None:
        tel = getattr(self.session, "_telemetry", None)
        if tel is not None:
            tel.registry.inc(name, labels={"tenant": tenant})

    async def acquire(self, tenant: Optional[str]) -> None:
        """Admit one submission for ``tenant`` (possibly after
        waiting); raises :class:`AdmissionError` on fail-fast quotas
        and full admission queues."""
        q = self.quota_for(tenant)
        if tenant is None or q is None:
            return
        reason = self._over(tenant, q)
        if reason is None:
            self.inflight[tenant] = self.inflight.get(tenant, 0) + 1
            self._tinc("admission.admitted", tenant)
            return
        if q.on_over == "fail":
            self._tinc("admission.rejected", tenant)
            raise AdmissionError(
                f"tenant {tenant!r} over quota ({reason})")
        if reason == "bytes" and self.inflight.get(tenant, 0) == 0:
            # nothing of this tenant is in flight, so no completion of
            # its own will ever free bytes — queueing would deadlock
            # (resident cached state alone exceeds the quota)
            self._tinc("admission.rejected", tenant)
            raise AdmissionError(
                f"tenant {tenant!r} resident bytes exceed max_bytes "
                f"with no queries in flight (would wait forever)")
        if (q.max_queued is not None
                and self.waiting.get(tenant, 0) >= q.max_queued):
            self._tinc("admission.rejected", tenant)
            raise AdmissionError(
                f"tenant {tenant!r} admission queue full "
                f"({self.waiting[tenant]} waiting)")
        cond = self._conds.setdefault(tenant, asyncio.Condition())
        self.waiting[tenant] = self.waiting.get(tenant, 0) + 1
        self._tinc("admission.queued", tenant)
        try:
            async with cond:
                await cond.wait_for(
                    lambda: self._over(tenant, q) is None)
        finally:
            self.waiting[tenant] -= 1
        self.inflight[tenant] = self.inflight.get(tenant, 0) + 1
        self._tinc("admission.admitted", tenant)

    def release(self, tenant: Optional[str]) -> None:
        """One of the tenant's queries resolved: free its in-flight
        slot and wake waiters to re-check their quotas."""
        if tenant is None:
            return
        if self.inflight.get(tenant, 0) > 0:
            self.inflight[tenant] -= 1
        cond = self._conds.get(tenant)
        if cond is not None and self.waiting.get(tenant, 0) > 0:
            asyncio.get_running_loop().create_task(self._notify(cond))

    @staticmethod
    async def _notify(cond: asyncio.Condition) -> None:
        async with cond:
            cond.notify_all()

    def report(self) -> Dict[str, Dict[str, int]]:
        tenants = set(self.inflight) | set(self.waiting)
        return {t: {"inflight": self.inflight.get(t, 0),
                    "waiting": self.waiting.get(t, 0)}
                for t in sorted(tenants)}


# ---------------------------------------------------------------------------
# adaptive windowing
# ---------------------------------------------------------------------------
@dataclass
class WindowParams:
    """One window's chosen parameters plus the prediction that chose
    them (logged to spans + metrics; realized sharing is recorded when
    the window resolves)."""

    max_batch: int
    max_wait_s: Optional[float]
    family: Optional[str] = None
    rate_hz: float = 0.0
    wait_budget_s: float = 0.0
    predicted_saving_s: float = 0.0


class AdaptiveWindowPolicy:
    """SLO-bounded window sizing from per-family arrival-rate EWMAs.

    Decision, made when a window OPENS (first arrival, family *f*):

        interval = EWMA inter-arrival of family f     (fallback: the
                   all-queries ``arrival.interval_s`` EWMA)
        rate     = 1 / interval
        exec99   = p99 of ``window.seconds``          (fallback:
                   ``exec_default_s``)
        budget   = max(0, slo_p99_s - exec99)         # wait we can afford
        n*       = clamp(1 + floor(rate * budget), min_batch,
                         max_batch_cap)
        wait     = min(budget, n* / rate)             # don't out-wait
                                                      # the batch target

    The opening query waits at most ``wait`` and then executes in
    ``exec99`` at the 99th percentile, so end-to-end p99 stays within
    the SLO by construction (given calibrated inputs).  A trickle
    family (rate → 0) degenerates to ``n* = min_batch`` closing
    immediately — latency-optimal; a bursty family fills large windows
    and harvests the ``(n-1) · dispatch`` sharing the cost model
    prices via ``window_dispatch_cost``."""

    def __init__(self, session, config: AsyncConfig, clock=None):
        self.session = session
        self.config = config
        self._clock = clock or time.monotonic
        self._last_arrival: Dict[str, float] = {}

    @property
    def _registry(self):
        tel = getattr(self.session, "_telemetry", None)
        return tel.registry if tel is not None else None

    def observe_arrival(self, family: Optional[str],
                        now: Optional[float] = None) -> None:
        """Feed one arrival of ``family`` into its inter-arrival EWMA
        (``arrival.family_interval_s{family=...}``)."""
        if family is None:
            return
        now = self._clock() if now is None else now
        reg = self._registry
        last = self._last_arrival.get(family)
        self._last_arrival[family] = now
        if last is not None and reg is not None:
            reg.ewma("arrival.family_interval_s",
                     labels={"family": family}).observe(max(now - last,
                                                            0.0))

    def _interval(self, family: Optional[str]) -> Optional[float]:
        reg = self._registry
        if reg is None:
            return None
        if family is not None:
            e = reg.ewma("arrival.family_interval_s",
                         labels={"family": family})
            if e.n > 0 and e.value > 0:
                return e.value
        e = reg.ewma("arrival.interval_s")
        if e.n > 0 and e.value > 0:
            return e.value
        return None

    def _exec_p99(self) -> float:
        reg = self._registry
        if reg is not None:
            h = reg.histogram("window.seconds")
            if h.count > 0:
                return float(h.percentile(0.99))
        return self.config.exec_default_s

    def predicted_saving(self, n: int) -> float:
        """Dispatch seconds a batched window of ``n`` saves over
        per-query dispatch (the ``window_dispatch_cost`` delta)."""
        cm = getattr(self.session, "cost_model", None)
        if cm is None or not hasattr(cm, "window_dispatch_cost"):
            return 0.0
        return max(cm.window_dispatch_cost(n, batched=False)
                   - cm.window_dispatch_cost(n, batched=True), 0.0)

    def realized_saving(self, metrics) -> float:
        """Dispatch seconds the window ACTUALLY saved, from its
        ExecMetrics: each batched group of k queries dispatched once
        instead of k times."""
        cm = getattr(self.session, "cost_model", None)
        if cm is None or not hasattr(cm, "c"):
            return 0.0
        bq = getattr(metrics, "batched_queries", 0)
        bd = getattr(metrics, "batched_dispatches", 0)
        return max(bq - bd, 0) * cm.c.dispatch

    def decide(self, family: Optional[str]) -> WindowParams:
        """The effective (max_batch, max_wait_s) for a window opened by
        a query of ``family``."""
        cfg = self.config
        if not cfg.adaptive or cfg.slo_p99_s is None:
            return WindowParams(cfg.max_batch, cfg.max_wait_s,
                                family=family)
        interval = self._interval(family)
        rate = (1.0 / interval) if interval else 0.0
        budget = max(0.0, cfg.slo_p99_s - self._exec_p99())
        n = int(1 + rate * budget)
        n = max(cfg.min_batch, min(n, cfg.max_batch_cap))
        wait = budget if rate <= 0 else min(budget, n / rate)
        params = WindowParams(
            max_batch=n, max_wait_s=wait, family=family,
            rate_hz=rate, wait_budget_s=budget,
            predicted_saving_s=self.predicted_saving(n))
        reg = self._registry
        if reg is not None:
            reg.observe("window.adaptive.batch", n)
            reg.observe("window.adaptive.wait_s", wait)
            reg.ewma("window.adaptive.predicted_saving_s").observe(
                params.predicted_saving_s)
        return params


# ---------------------------------------------------------------------------
# handles
# ---------------------------------------------------------------------------
class AsyncQueryHandle:
    """Awaitable view over a sync :class:`QueryHandle`.

    ``await handle`` (or ``await handle.result()``) yields the query's
    Table once its window has run; a failed query re-raises the
    exception that killed it (inspect ``failed`` / ``error`` to look
    without raising).  ``explain()`` / ``explain_report()`` delegate to
    the sync handle after resolution."""

    __slots__ = ("_inner", "_future", "tenant")

    def __init__(self, inner: QueryHandle, future: "asyncio.Future",
                 tenant: Optional[str] = None):
        self._inner = inner
        self._future = future
        self.tenant = tenant
        # inspect-without-awaiting (``h.failed``) is a supported use;
        # retrieving the exception here keeps asyncio from logging
        # "exception was never retrieved" for such handles
        future.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None)

    # -- awaiting ------------------------------------------------------------
    def __await__(self):
        return self._future.__await__()

    async def result(self):
        """The query's output Table (exceptions re-raised)."""
        return await self._future

    # -- delegated inspection ------------------------------------------------
    @property
    def seq(self) -> int:
        return self._inner.seq

    @property
    def done(self) -> bool:
        return self._future.done()

    @property
    def failed(self) -> bool:
        return self._inner.failed

    @property
    def error(self):
        return self._inner.error

    def explain(self) -> dict:
        return self._inner.explain()

    def explain_report(self):
        return self._inner.explain_report()

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        state = ("failed" if self.failed
                 else "done" if self.done else "pending")
        return f"AsyncQueryHandle(seq={self.seq}, {state})"


# ---------------------------------------------------------------------------
# the async service
# ---------------------------------------------------------------------------
class AsyncQueryService:
    """Concurrent-submission front over a shared :class:`Session`.

    Lifecycle: ``await start()`` (idempotent; ``submit`` lazily starts
    too), then ``await aclose()`` — or use it as an async context
    manager.  All state mutation happens on the event-loop thread
    except window execution, which one dedicated worker thread runs
    serially (single-writer against the Session)."""

    def __init__(self, session, *,
                 config: Optional[AsyncConfig] = None,
                 clock=None, **service_kw):
        cfg = config if config is not None else AsyncConfig()
        self.config = cfg
        # the sync core supplies _run_window (the ONE execution path),
        # submission bookkeeping, and the window/sequence counters
        self.core = QueryService(
            session, max_batch=cfg.max_batch, max_wait_s=cfg.max_wait_s,
            clock=clock if clock is not None else time.monotonic,
            **service_kw)
        self.policy = AdaptiveWindowPolicy(session, cfg,
                                           clock=self.core._clock)
        self.admission = AdmissionController(session, cfg)
        self._window = WindowState()
        self._resolvers: Dict[QueryHandle, "asyncio.Future"] = {}
        self._started = False
        self._closing = False
        self.closer_restarts = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queue: Optional[asyncio.Queue] = None
        self._wake: Optional[asyncio.Event] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closer_task: Optional[asyncio.Task] = None
        self._executor_task: Optional[asyncio.Task] = None

    @property
    def session(self):
        return self.core.session

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "AsyncQueryService":
        """Bind to the running loop and launch the executor + closer
        tasks (idempotent)."""
        if self._started:
            return self
        self._loop = asyncio.get_running_loop()
        self._queue = asyncio.Queue()
        self._wake = asyncio.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="repro-window")
        self._closing = False
        self._executor_task = asyncio.create_task(
            self._executor_loop(), name="repro-executor")
        self._closer_task = asyncio.create_task(
            self._supervised_closer(), name="repro-closer")
        self._started = True
        return self

    async def aclose(self) -> None:
        """Flush the open window, drain queued windows, stop the
        background tasks."""
        if not self._started:
            return
        self._closing = True
        self._close_window()
        await self._queue.join()
        for task in (self._closer_task, self._executor_task):
            task.cancel()
        await asyncio.gather(self._closer_task, self._executor_task,
                             return_exceptions=True)
        self._pool.shutdown(wait=True)
        self._started = False

    async def __aenter__(self) -> "AsyncQueryService":
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.aclose()

    # -- submission ----------------------------------------------------------
    async def submit(self, plan, *,
                     tenant: Optional[str] = None) -> AsyncQueryHandle:
        """Enqueue one query; returns an awaitable handle immediately
        (after admission control for ``tenant``).  Window accumulation
        is lock-free: this coroutine never blocks on window execution."""
        await self.start()
        await self.admission.acquire(tenant)
        node, hint = _coerce_submission(
            plan, "AsyncQueryService.submit")
        core = self.core
        handle = QueryHandle(core, plan, core._n_submitted, node=node,
                             hint_cache=hint, tenant=tenant)
        fut = self._loop.create_future()
        ah = AsyncQueryHandle(handle, fut, tenant=tenant)
        now = core._note_submit(handle)
        try:
            family = core._family_of(node)
        except Exception:
            family = None     # poisoned plan: the window will fail it
        handle._family = family
        self.policy.observe_arrival(family, now=now)
        if self._window.empty:
            params = self.policy.decide(family)
            self._window.open(now, params.max_batch, params.max_wait_s)
        self._window.append(handle)
        self._resolvers[handle] = fut
        if self._window.full():
            self._close_window()
        else:
            self._wake.set()    # closer re-arms on the new deadline
        return ah

    # -- window close / execution -------------------------------------------
    def _close_window(self) -> None:
        """Detach the open window (if any) and hand it to the executor
        task.  Loop-thread only."""
        handles = self._window.detach()
        if handles:
            self._queue.put_nowait(handles)
        if self._wake is not None:
            self._wake.set()

    async def _executor_loop(self) -> None:
        """The single writer: pops closed windows and runs each through
        the shared ``QueryService._run_window`` on the one-thread pool,
        then resolves the futures.  Serialization against the Session
        is by construction — one queue, one worker thread."""
        while True:
            handles = await self._queue.get()
            try:
                await self._loop.run_in_executor(
                    self._pool, self._run_window, handles)
            except Exception:
                # _run_window's safety net already resolved every
                # handle (to results or QueryErrors); with isolation
                # off the exception additionally escapes — the handles
                # carry it, nothing more to do here
                pass
            finally:
                reg = self._registry()
                if reg is not None:
                    reg.ewma(
                        "window.adaptive.realized_saving_s").observe(
                        self._realized_saving(handles))
                for h in handles:
                    self._finish(h)
                self._queue.task_done()

    def _run_window(self, handles) -> None:
        """The worker thread's job: one window through the shared
        ``QueryService._run_window``, then a wait for the session's
        device, so the futures resolve on finished device work."""
        try:
            self.core._run_window(handles)
        finally:
            synchronize(self.session.device)

    def _realized_saving(self, handles) -> float:
        tel = getattr(self.session, "_telemetry", None)
        if tel is None:
            return 0.0
        # window-level ExecMetrics were absorbed into the registry; use
        # the policy's model on the per-window shared-dispatch explain
        # data instead: each resolved handle that shared a dispatch of
        # size k contributed (k-1)/k of a dispatch saved
        cm = getattr(self.session, "cost_model", None)
        if cm is None or not hasattr(cm, "c"):
            return 0.0
        saved = 0.0
        for h in handles:
            if h.failed or not h._done:
                continue
            # _LazyExplain and a rendered ExplainReport both expose the
            # shared-dispatch positions; reading the ingredient avoids
            # paying for a full explain render per query
            shared = getattr(h._explain, "shared_dispatch", None)
            if shared:
                k = len(shared)
                if k > 1:
                    saved += (k - 1) / k * cm.c.dispatch
        return saved

    def _registry(self):
        tel = getattr(self.session, "_telemetry", None)
        return tel.registry if tel is not None else None

    def _finish(self, handle: QueryHandle) -> None:
        """Resolve one async future from its (now resolved) sync
        handle; release the tenant's admission slot."""
        fut = self._resolvers.pop(handle, None)
        self.admission.release(handle.tenant)
        if fut is None or fut.done():
            return
        if handle.failed:
            fut.set_exception(handle.error.exception)
        elif handle._done:
            fut.set_result(handle._query_result.table)
        else:      # unreachable: _run_window guarantees resolution
            fut.set_exception(
                RuntimeError("window did not resolve handle"))

    # -- background closer ---------------------------------------------------
    async def _supervised_closer(self) -> None:
        """Restart the closer when it crashes (the ``async_close``
        fault point): pending windows still close, handles resolve."""
        while True:
            try:
                await self._closer()
                return
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self.closer_restarts += 1
                tel = getattr(self.session, "_telemetry", None)
                if tel is not None:
                    tel.registry.inc("async.closer_restarts")
                    tel.record_event({
                        "action": "closer_restart", "level": "closer",
                        "error": repr(exc)})

    async def _closer(self) -> None:
        """Sleep until the open window's deadline, then close it — no
        caller in flight required.  Woken early whenever the window
        changes (submit, flush) to re-arm on the new deadline."""
        while True:
            self._wake.clear()
            deadline = self._window.deadline()
            if deadline is None:
                await self._wake.wait()
                continue
            delay = deadline - self.core._clock()
            if delay <= 0:
                inj = getattr(self.session, "fault_injector", None)
                if inj is not None:
                    # the fault point: a fire crashes this task BEFORE
                    # the close; the supervisor restarts it and the
                    # still-due window closes on the next pass
                    inj.check("async_close")
                self._close_window()
                continue
            try:
                await asyncio.wait_for(self._wake.wait(), timeout=delay)
            except asyncio.TimeoutError:
                pass

    # -- compat shims --------------------------------------------------------
    def flush_expired(self):
        """Compat shim: the background closer owns deadlines now; this
        only nudges it.  Returns None (there is never a synchronously
        closed window to hand back)."""
        if self._wake is not None:
            self._wake.set()
        return None

    def poll(self) -> bool:
        """Compat shim: deadline checks are automatic; see
        ``flush_expired``."""
        self.flush_expired()
        return False

    async def flush(self) -> None:
        """Close the open window now (without waiting for execution —
        ``await drain()`` for that)."""
        await self.start()
        self._close_window()

    async def drain(self) -> None:
        """Wait until every closed window has executed and resolved."""
        if self._queue is not None:
            await self._queue.join()

    # -- observability -------------------------------------------------------
    @property
    def pending(self) -> int:
        """Queries accumulated in the open window (excludes windows
        already queued for execution)."""
        return self._window.size

    def telemetry(self):
        return self.core.telemetry()

    def metrics_report(self) -> dict:
        """The unified report, plus the admission controller's live
        per-tenant in-flight/waiting counts merged into ``tenants``."""
        report = self.core.metrics_report()
        tenants = report.setdefault("tenants", {})
        for t, counts in self.admission.report().items():
            tenants.setdefault(t, {})["admission"] = counts
        return report

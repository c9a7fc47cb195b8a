"""Relational observability wiring: the session telemetry hub,
the typed ``explain()`` report schema, and the unified metrics report.

``core.telemetry`` supplies the primitives (span tracer, metrics
registry); this module binds them to the query engine:

* :class:`Telemetry` — one per :class:`~repro_torch.relational.executor.Session`
  (``sess.telemetry()``).  The metrics registry, the cost-model
  calibration log, and degradation/fault event counters are ALWAYS
  live (cheap dict increments on planning-path / rare events only);
  span tracing is opt-in via ``enable_tracing()`` — the default tracer
  is the no-op singleton, so the warm execution path pays nothing when
  tracing is off.
* :class:`ExplainReport` / :class:`ExplainCE` — the one typed schema
  behind ``handle.explain()``, replacing earlier ad-hoc dicts.
  ``as_dict()`` is the stable compat view: its key
  sets (:data:`EXPLAIN_DONE_KEYS` / :data:`EXPLAIN_FAILED_KEYS`) are
  pinned by tests.
* :func:`build_metrics_report` — the ``QueryService.metrics_report()``
  payload: registry snapshot, per-template-family latency percentiles,
  per-pool occupancy/hit rates from the memory hierarchy, fault-
  injector telemetry, and the predicted-vs-actual CE cost calibration
  table.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..core.costmodel import CalibrationLog
from ..core.telemetry import (MetricsRegistry, NOOP_TRACER, SpanTracer)

__all__ = [
    "Telemetry", "ExplainCE", "ExplainReport",
    "EXPLAIN_DONE_KEYS", "EXPLAIN_FAILED_KEYS",
    "build_metrics_report",
]


# ---------------------------------------------------------------------------
# the per-session telemetry hub
# ---------------------------------------------------------------------------
class Telemetry:
    """Session-scoped observability state.

    * ``registry`` — always-on :class:`MetricsRegistry` (query counts,
      inter-arrival EWMA, per-template latency histograms, degradation
      and fault event counters, absorbed per-window ``ExecMetrics``).
    * ``calibration`` — always-on :class:`CalibrationLog` fed by the
      executor's CE materializations and cached reads.
    * ``tracer`` — :data:`~repro_torch.core.telemetry.NOOP_TRACER` until
      ``enable_tracing()`` swaps in a collecting
      :class:`~repro_torch.core.telemetry.SpanTracer`.  Hot paths guard on
      ``tracer.enabled``, so disabled mode allocates nothing.
    """

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.registry = MetricsRegistry()
        self.calibration = CalibrationLog()
        self.tracer = NOOP_TRACER

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def enable_tracing(self, clock=None) -> SpanTracer:
        """Install (or return the existing) collecting span tracer."""
        if not self.tracer.enabled:
            self.tracer = SpanTracer(clock=clock or self.clock)
        return self.tracer

    def disable_tracing(self) -> None:
        self.tracer = NOOP_TRACER

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    # -- event / metric ingestion -------------------------------------------
    def record_event(self, ev: dict) -> None:
        """Fold one degradation/retry event dict (see
        :class:`~repro_torch.core.faults.DegradationEvent`) into the registry
        — the ONE place window/soak tests count events from."""
        reg = self.registry
        reg.inc("events.total")
        reg.inc(f"events.action.{ev.get('action', 'unknown')}")
        reg.inc(f"events.level.{ev.get('level', 'unknown')}")

    def absorb_exec_metrics(self, m) -> None:
        """Accumulate one window's :class:`ExecMetrics` into session-
        lifetime registry counters (called once per closed window)."""
        if m is None:
            return
        reg = self.registry
        reg.inc("bytes.read_disk", m.bytes_read_disk)
        reg.inc("bytes.parsed", m.bytes_parsed)
        reg.inc("bytes.ce_cached_read", m.bytes_cached_read)
        reg.inc("bytes.scan_cache_read", m.bytes_scan_cache_read)
        reg.inc("rows.processed", m.rows_processed)
        reg.inc("trace.hits", m.trace_hits)
        reg.inc("trace.misses", m.trace_misses)
        reg.inc("dispatch.batched", m.batched_dispatches)
        reg.inc("dispatch.batched_queries", m.batched_queries)
        reg.inc("pid.hits", m.pid_hits)
        reg.inc("pid.pruned_parts", m.pid_pruned_parts)
        reg.inc("pid.records", m.pid_records)
        for op, dt in m.op_seconds.items():
            reg.inc(f"op_seconds.{op}", dt)

    # -- export conveniences -------------------------------------------------
    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        return self.tracer.export_chrome_trace(path)

    def export_jsonl(self, path: Optional[str] = None) -> str:
        return self.tracer.export_jsonl(path)


# ---------------------------------------------------------------------------
# the typed explain schema (one schema for every report kind)
# ---------------------------------------------------------------------------
EXPLAIN_DONE_KEYS = frozenset((
    "status", "window", "position", "window_size", "mqo", "seconds",
    "plan", "submitted", "ces", "resident_reuse", "subsumption_hit",
    "pid_pruned_parts",
))
# present in a done report only when applicable
EXPLAIN_DONE_OPTIONAL_KEYS = frozenset(("subsumption", "shared_dispatch"))
EXPLAIN_FAILED_KEYS = frozenset((
    "status", "window", "position", "window_size", "error", "events",
    "ces_salvaged", "ces_failed", "submitted",
))
EXPLAIN_CE_KEYS = frozenset((
    "psi", "strict_psi", "label", "m", "value", "weight",
    "resident_repriced", "cache_hit", "single_resume",
))


@dataclass
class ExplainCE:
    """One covering expression consumed by the executed plan."""

    psi: str                       # loose structural fingerprint (hex)
    strict_psi: str                # strict content fingerprint (hex)
    label: str
    m: int                         # consumer count
    value: float                   # Eq. 3 value at admission
    weight: int                    # MCKP weight (0 when resident)
    resident_repriced: bool
    cache_hit: bool
    single_resume: bool
    partitions: Optional[dict] = None   # {"live": [...], "admitted": [...]}

    def as_dict(self) -> dict:
        d = {
            "psi": self.psi, "strict_psi": self.strict_psi,
            "label": self.label, "m": self.m, "value": self.value,
            "weight": self.weight,
            "resident_repriced": self.resident_repriced,
            "cache_hit": self.cache_hit,
            "single_resume": self.single_resume,
        }
        if self.partitions is not None:
            d["partitions"] = dict(self.partitions)
        return d


@dataclass
class ExplainReport:
    """The post-resolution report behind ``handle.explain()``.

    ``status`` is ``"done"`` or ``"failed"``; ``as_dict()`` renders the
    status-appropriate stable key set (the thin dict compat view —
    exactly the keys earlier callers relied on)."""

    status: str
    window: int
    position: int
    window_size: int
    submitted: str = ""
    # -- success fields ------------------------------------------------------
    mqo: bool = False
    seconds: float = 0.0
    plan: str = ""
    ces: Tuple[ExplainCE, ...] = ()
    resident_reuse: bool = False
    subsumption_hit: bool = False
    pid_pruned_parts: int = 0
    subsumption: Optional[dict] = None       # {"strict_psi", "residual"}
    shared_dispatch: Optional[List[int]] = None
    # -- failure fields ------------------------------------------------------
    error: str = ""
    events: Tuple[dict, ...] = ()
    ces_salvaged: Tuple[str, ...] = ()
    ces_failed: Tuple[str, ...] = ()

    def as_dict(self) -> dict:
        if self.status == "failed":
            return {
                "status": self.status,
                "window": self.window,
                "position": self.position,
                "window_size": self.window_size,
                "error": self.error,
                "events": list(self.events),
                "ces_salvaged": list(self.ces_salvaged),
                "ces_failed": list(self.ces_failed),
                "submitted": self.submitted,
            }
        out: Dict[str, Any] = {
            "status": self.status,
            "window": self.window,
            "position": self.position,
            "window_size": self.window_size,
            "mqo": self.mqo,
            "seconds": self.seconds,
            "plan": self.plan,
            "submitted": self.submitted,
            "ces": [ce.as_dict() for ce in self.ces],
            "resident_reuse": self.resident_reuse,
            "subsumption_hit": self.subsumption_hit,
            "pid_pruned_parts": self.pid_pruned_parts,
        }
        if self.subsumption is not None:
            out["subsumption"] = dict(self.subsumption)
        if self.shared_dispatch:
            out["shared_dispatch"] = list(self.shared_dispatch)
        return out


# ---------------------------------------------------------------------------
# the unified metrics report
# ---------------------------------------------------------------------------
def _pool_view(stats: dict) -> dict:
    hits = stats.get("hits", 0)
    misses = stats.get("misses", 0)
    return {**stats, "hit_rate": hits / max(hits + misses, 1)}


_TENANT_COUNTERS = (
    "queries.submitted", "queries.succeeded", "queries.failed",
    "admission.admitted", "admission.queued", "admission.rejected",
)


def _tenant_sections(session, reg) -> dict:
    """Per-tenant occupancy + outcome + latency views, built
    from the registry's labeled children (``...{tenant=...}``) and the
    memory manager's live owner attribution."""
    tenants: Dict[str, Dict[str, Any]] = {}
    mm = getattr(session, "memory", None)
    if mm is not None and hasattr(mm, "owner_usage"):
        for owner, by_pool in mm.owner_usage().items():
            t = tenants.setdefault(owner, {})
            t["pool_bytes"] = dict(by_pool)
            t["bytes_total"] = sum(by_pool.values())
    for base in _TENANT_COUNTERS:
        for labels, _key in reg.series(base):
            ten = labels.get("tenant")
            if ten is not None:
                tenants.setdefault(ten, {})[base] = reg.value(
                    base, labels=labels)
    for labels, key in reg.series("latency.tenant"):
        ten = labels.get("tenant")
        h = reg._histograms.get(key)
        if ten is not None and h is not None:
            tenants.setdefault(ten, {})["latency"] = h.as_dict()
    return tenants


def build_metrics_report(session) -> dict:
    """Everything observable about one session, in one dict: the
    registry snapshot, per-template-family latency percentiles, pool
    occupancy + hit rates per tier, per-tenant occupancy/latency
    sections, fault-injector telemetry, and the cost model's
    predicted-vs-actual calibration table."""
    tel: Telemetry = session.telemetry()
    snap = tel.registry.snapshot()
    latency = {"all": None, "families": {}}
    for name, h in snap["histograms"].items():
        if name == "latency.all":
            latency["all"] = h
        elif name.startswith("latency.family."):
            latency["families"][name[len("latency.family."):]] = h
    mem = session.memory.report()
    pools = {name: _pool_view(st)
             for name, st in mem.get("pools", {}).items()}
    injector = getattr(session, "fault_injector", None)
    calibration = tel.calibration.report()
    return {
        "registry": snap,
        "latency": latency,
        "arrival_interval_ewma_s": snap["ewmas"].get(
            "arrival.interval_s", {"value": 0.0, "n": 0}),
        "pools": pools,
        "memory": {k: v for k, v in mem.items() if k != "pools"},
        "tenants": _tenant_sections(session, tel.registry),
        "faults": injector.report() if injector is not None else None,
        "calibration": calibration,
    }


# ---------------------------------------------------------------------------
# MQO decisions, as two runs of one stream compare them
# ---------------------------------------------------------------------------
def mqo_decision(handle, strict_fp=None) -> tuple:
    """The MQO decisions behind one resolved handle: the rewritten plan,
    every CE it consumes (SE psi, strict key, label, consumers, value,
    weight, residency), the rewritten plan's strict fingerprint and the
    queries it shared a batched dispatch with.  ``strict_fp`` is the
    strict-fingerprint function of the handle's package (the port's by
    default)."""
    if strict_fp is None:
        from ..core.fingerprint import strict_fingerprint as strict_fp
    ex = handle.explain()
    ces = tuple((c["psi"], c["strict_psi"], c["label"], c["m"], c["value"],
                 c["weight"], c["cache_hit"]) for c in ex["ces"])
    return (ex["plan"], ces, strict_fp(handle.query_result.plan).hex(),
            tuple(ex.get("shared_dispatch") or ()))


def mqo_trace(tracer) -> list:
    """The window-level MQO decisions a span tracer recorded since the
    last call: per window the ``mqo`` / ``mqo.identify`` / ``mqo.solve``
    spans' attributes (SEs identified, CE items priced, MCKP budget,
    selected count, value and weight), in order.  Clears the tracer."""
    out = []

    def walk(span):
        if span.name.startswith("mqo"):
            out.append((span.name, tuple(sorted(span.attrs.items()))))
        for child in span.children:
            walk(child)

    for root in tracer.finished:
        walk(root)
    tracer.clear()
    return out

"""Unified telemetry: lifecycle span tracing + a metrics registry.

The repo's observability story used to be scattered — per-window
``ExecMetrics`` counters, ``BatchResult.resilience`` dicts,
``FaultInjector.report()``, per-pool books in ``core.memory`` — with no
timeline view and no latency distributions.  This module supplies the
two missing primitives; ``relational.observe`` wires them into the
query engine behind one ``Session.telemetry()`` surface.

**Span tracer.**  Nested wall-clock spans over an injectable monotonic
clock::

    tracer = SpanTracer()
    with tracer.span("window", window=0, n_queries=4) as sp:
        with tracer.span("mqo.solve"):
            ...
        sp.set(route="batched")

Spans are context managers, so every opened span closes even when the
instrumented region raises (the span is marked ``status="error"`` and
the exception propagates).  Closed root spans accumulate in
``tracer.finished`` and export as JSON-lines (one span per line,
depth-annotated) or Chrome trace-event JSON (complete ``"ph": "X"``
events, loadable in Perfetto / ``chrome://tracing``).

**Zero cost when disabled.**  The default tracer is :data:`NOOP_TRACER`
whose ``span()`` returns one preallocated singleton no-op context
manager — no clock reads, no allocations, nothing retained.  Hot paths
additionally guard on ``tracer.enabled`` so attribute dicts are never
even built.

**Metrics registry.**  Named counters / gauges / EWMAs and fixed-bucket
histograms (t-digest-free: percentiles are interpolated within
log-spaced buckets, exact min/max tracked outside them).  Everything is
create-on-first-use and snapshots to one plain dict.

**Labels.**  Every accessor takes an optional ``labels``
mapping; a labeled series is a separate child metric stored under the
canonical rendered key ``name{k=v,...}`` (label keys sorted), e.g.
``queries.submitted{tenant=acme}``.  The rendering is the snapshot
format — call sites never name-mangle — and :meth:`MetricsRegistry.series`
gives structured access (label dict + rendered key per child) so
report builders don't re-parse the rendered form.
"""
from __future__ import annotations

import json
import time
from bisect import bisect_left
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

__all__ = [
    "Span", "SpanTracer", "NoopTracer", "NOOP_TRACER",
    "Counter", "Gauge", "Ewma", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_EDGES", "labeled_key",
]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
class Span:
    """One timed region.  Opened by ``with tracer.span(name, **attrs)``;
    nesting follows the with-statement structure."""

    __slots__ = ("name", "t_start", "t_end", "attrs", "children",
                 "status", "_tracer")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.children: List["Span"] = []
        self.status = "ok"

    @property
    def duration(self) -> Optional[float]:
        if self.t_start is None or self.t_end is None:
            return None
        return self.t_end - self.t_start

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        self.t_start = tr.clock()
        if tr._stack:
            tr._stack[-1].children.append(self)
        tr._stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        now = tr.clock()
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", repr(exc))
        # close any child left open by a non-with escape below us, then
        # pop ourselves: the stack can never wedge on an unwound frame
        while tr._stack and tr._stack[-1] is not self:
            leaked = tr._stack.pop()
            if leaked.t_end is None:
                leaked.t_end = now
                leaked.status = "error"
        self.t_end = now
        if tr._stack and tr._stack[-1] is self:
            tr._stack.pop()
        if not tr._stack:
            tr.finished.append(self)
        return False

    def walk(self, depth: int = 0):
        yield depth, self
        for c in self.children:
            yield from c.walk(depth + 1)

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        dur = self.duration
        return (f"Span({self.name!r}, dur="
                f"{'open' if dur is None else f'{dur:.6f}s'}, "
                f"{len(self.children)} children)")


class _NoopSpan:
    """The shared do-nothing span: one module-level instance serves
    every disabled-mode ``span()`` call (zero per-call allocations)."""

    __slots__ = ()
    name = "noop"
    status = "ok"
    attrs: Dict[str, Any] = {}
    children: Sequence = ()
    duration = None

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Disabled-mode tracer: ``span()`` hands back the singleton no-op
    span without touching a clock or allocating anything."""

    enabled = False
    finished: Sequence = ()

    def span(self, name: str, **attrs) -> _NoopSpan:
        return NOOP_SPAN

    def clear(self) -> None:
        pass

    def export_jsonl(self, path: Optional[str] = None) -> str:
        if path:
            with open(path, "w") as f:
                f.write("")
        return ""

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        doc = {"traceEvents": [], "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


NOOP_TRACER = NoopTracer()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, bytes):
        return v.hex()[:12]
    return str(v)


class SpanTracer:
    """Collecting tracer with an injectable monotonic clock."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.finished: List[Span] = []    # closed root spans, in order
        self._stack: List[Span] = []

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def clear(self) -> None:
        self.finished.clear()
        self._stack.clear()

    # -- exporters ----------------------------------------------------------
    def export_jsonl(self, path: Optional[str] = None) -> str:
        """One JSON object per span (pre-order, ``depth`` gives the
        nesting level within its root)."""
        lines = []
        for root in self.finished:
            for depth, sp in root.walk():
                rec: Dict[str, Any] = {
                    "name": sp.name, "depth": depth,
                    "ts": sp.t_start, "dur": sp.duration,
                    "status": sp.status,
                }
                if sp.attrs:
                    rec["attrs"] = {k: _jsonable(v)
                                    for k, v in sp.attrs.items()}
                lines.append(json.dumps(rec))
        text = "\n".join(lines) + ("\n" if lines else "")
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (complete events), loadable in
        Perfetto or ``chrome://tracing``."""
        events = []
        for root in self.finished:
            for _, sp in root.walk():
                if sp.t_start is None or sp.t_end is None:
                    continue
                events.append({
                    "name": sp.name, "ph": "X", "cat": "repro",
                    "ts": sp.t_start * 1e6,
                    "dur": max((sp.t_end - sp.t_start) * 1e6, 0.0),
                    "pid": 1, "tid": 1,
                    "args": {k: _jsonable(v)
                             for k, v in sp.attrs.items()},
                })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Ewma:
    """Exponentially-weighted moving average (first observation seeds
    the value) — e.g. query inter-arrival times for adaptive windowing."""

    __slots__ = ("alpha", "value", "n")

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.value = 0.0
        self.n = 0

    def observe(self, v: float) -> None:
        self.n += 1
        self.value = (float(v) if self.n == 1
                      else self.alpha * float(v)
                      + (1.0 - self.alpha) * self.value)


# log-spaced seconds, 10 us .. ~178 s (4 buckets per decade)
DEFAULT_LATENCY_EDGES = tuple(10.0 ** (e / 4.0) for e in range(-20, 10))


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``edges`` are bucket UPPER bounds (ascending); one implicit
    overflow bucket catches everything beyond the last edge.  Exact
    min/max are tracked outside the buckets, so ``percentile(0)`` /
    ``percentile(1)`` are exact and interpolation never extrapolates
    past observed values."""

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, edges: Optional[Sequence[float]] = None):
        self.edges = tuple(float(e) for e in
                           (edges if edges is not None
                            else DEFAULT_LATENCY_EDGES))
        if any(b <= a for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError("histogram edges must be ascending")
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.edges, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """Linear interpolation within the bucket holding the q-th
        rank; NaN when empty."""
        if self.count == 0:
            return float("nan")
        q = min(max(float(q), 0.0), 1.0)
        target = q * self.count
        if target <= 0:
            return self.vmin
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = self.edges[i - 1] if i > 0 else self.vmin
                hi = self.edges[i] if i < len(self.edges) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return lo
                frac = (target - cum) / c
                return min(max(lo + frac * (hi - lo), self.vmin),
                           self.vmax)
            cum += c
        return self.vmax

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


def labeled_key(name: str,
                labels: Optional[Mapping[str, Any]] = None) -> str:
    """Canonical rendered key of a (possibly labeled) series:
    ``name`` bare, or ``name{k=v,...}`` with label keys sorted.  This
    is the snapshot's wire format — the ONE place label rendering
    lives, so call sites never mangle names by hand."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Create-on-first-use named metrics; one ``snapshot()`` dict.

    Labeled children (``labels={"tenant": "acme"}``) are independent
    series keyed by :func:`labeled_key`; :meth:`series` enumerates a
    name's children with their label dicts."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._ewmas: Dict[str, Ewma] = {}
        self._histograms: Dict[str, Histogram] = {}
        # base name -> [(labels, rendered key)], insertion-ordered
        self._series: Dict[str, List[Tuple[Dict[str, str], str]]] = {}

    def _key(self, name: str,
             labels: Optional[Mapping[str, Any]]) -> str:
        if not labels:
            return name
        key = labeled_key(name, labels)
        children = self._series.setdefault(name, [])
        if all(k != key for _, k in children):
            children.append(
                ({k: str(v) for k, v in labels.items()}, key))
        return key

    def series(self, name: str) -> List[Tuple[Dict[str, str], str]]:
        """Every labeled child of ``name`` as ``(labels, rendered
        key)`` pairs, in first-use order (empty for unlabeled names)."""
        return list(self._series.get(name, ()))

    # -- accessors (get-or-create) ------------------------------------------
    def counter(self, name: str,
                labels: Optional[Mapping[str, Any]] = None) -> Counter:
        name = self._key(name, labels)
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str,
              labels: Optional[Mapping[str, Any]] = None) -> Gauge:
        name = self._key(name, labels)
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def ewma(self, name: str, alpha: float = 0.2,
             labels: Optional[Mapping[str, Any]] = None) -> Ewma:
        name = self._key(name, labels)
        e = self._ewmas.get(name)
        if e is None:
            e = self._ewmas[name] = Ewma(alpha)
        return e

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None,
                  labels: Optional[Mapping[str, Any]] = None
                  ) -> Histogram:
        name = self._key(name, labels)
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(edges)
        return h

    # -- conveniences --------------------------------------------------------
    def inc(self, name: str, n: float = 1,
            labels: Optional[Mapping[str, Any]] = None) -> None:
        self.counter(name, labels=labels).inc(n)

    def set_gauge(self, name: str, v: float,
                  labels: Optional[Mapping[str, Any]] = None) -> None:
        self.gauge(name, labels=labels).set(v)

    def observe(self, name: str, v: float,
                labels: Optional[Mapping[str, Any]] = None) -> None:
        self.histogram(name, labels=labels).observe(v)

    def value(self, name: str,
              labels: Optional[Mapping[str, Any]] = None) -> float:
        """Current counter value (0 when never incremented)."""
        c = self._counters.get(labeled_key(name, labels))
        return c.value if c is not None else 0

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "ewmas": {k: {"value": e.value, "n": e.n}
                      for k, e in sorted(self._ewmas.items())},
            "histograms": {k: h.as_dict()
                           for k, h in sorted(self._histograms.items())},
        }

"""Unified telemetry subsystem (PR 9): span tracer well-formedness
(including under fault injection), Chrome trace-event export, the
zero-cost disabled mode, histogram percentile edge cases, the pinned
``explain()`` key sets, metrics-report contents, and event routing
through the one metrics registry.
"""
import json
import math
import time

import numpy as np
import pytest

from repro_torch.core.faults import FaultConfig
from repro_torch.core.telemetry import (Histogram, MetricsRegistry, NOOP_SPAN,
                                        NOOP_TRACER, SpanTracer)
from repro_torch.relational import (EXPLAIN_CE_KEYS, EXPLAIN_DONE_KEYS,
                                    EXPLAIN_DONE_OPTIONAL_KEYS,
                                    EXPLAIN_FAILED_KEYS, ExplainReport, I32,
                                    MemoryConfig, QueryService, Relation,
                                    Schema, Session, SessionConfig, Telemetry,
                                    expr as E, logical as L, make_storage)

from torch_fixtures import CPU
from torch_parity import one_torch_thread  # noqa: F401


S = Schema.of(("a", I32), ("b", I32), ("c", I32))
NROWS = 2000


def _mk_session(budget=1 << 24, *, config=None) -> Session:
    rng = np.random.default_rng(7)
    cols = {c: rng.integers(0, 100, NROWS).astype(np.int32)
            for c in ("a", "b", "c")}
    if config is None:
        config = SessionConfig(memory=MemoryConfig(budget_bytes=budget))
    sess = Session.from_config(config, device=CPU)
    st, _ = make_storage("t", S, NROWS, "columnar", cols=cols)
    sess.register(st)
    return sess


def _recurring(sess, n=3):
    """n identical queries: the window forms (and later re-hits) a CE,
    which is what exercises materialize + cached_read calibration."""
    return [sess.table("t").filter(E.cmp("a", ">", 50)).project("a", "b")
            for _ in range(n)]


def _all_spans(tracer):
    return [sp for root in tracer.finished for _, sp in root.walk()]


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------
class TestSpanTracer:
    def test_nesting_follows_with_structure(self):
        tr = SpanTracer()
        with tr.span("outer", k=1) as outer:
            with tr.span("inner"):
                pass
        assert [s.name for _, s in outer.walk()] == ["outer", "inner"]
        assert tr.finished == [outer] and tr._stack == []
        assert outer.duration is not None and outer.duration >= 0

    def test_span_closes_and_marks_error_on_raise(self):
        tr = SpanTracer()
        with pytest.raises(RuntimeError):
            with tr.span("w"):
                with tr.span("child"):
                    raise RuntimeError("boom")
        spans = _all_spans(tr)
        assert {s.name for s in spans} == {"w", "child"}
        assert all(s.t_end is not None for s in spans)
        assert all(s.status == "error" for s in spans)
        assert tr._stack == []

    def test_leaked_child_closed_by_parent_exit(self):
        tr = SpanTracer()
        with tr.span("parent") as p:
            leaked = tr.span("leaked")
            leaked.__enter__()      # never exited (simulated escape)
        assert tr._stack == []
        assert leaked.t_end is not None and leaked.status == "error"
        assert p.t_end is not None and p.children == [leaked]

    def test_lifecycle_spans_well_formed_under_fault_injection(self):
        # every window dies at window_close, yet every opened span must
        # close (error-marked) and the stack must never wedge
        cfg = SessionConfig(
            memory=MemoryConfig(budget_bytes=1 << 24)
        ).with_faults(FaultConfig(seed=0, rates={"window_close": 1.0}))
        sess = _mk_session(config=cfg)
        tr = sess.enable_tracing()
        svc = QueryService(sess, max_batch=3)
        handles = [svc.submit(q) for q in _recurring(sess)]
        assert all(h.done and h.failed for h in handles)
        assert tr._stack == [], "a span was left open by the fault"
        spans = _all_spans(tr)
        assert spans, "tracing collected nothing"
        assert all(s.t_end is not None for s in spans)
        # isolation catches the fault INSIDE the window span, which
        # records it as an attribute and still closes cleanly
        assert any(s.name == "window" and "error" in s.attrs
                   for s in spans)
        # the service survives and the NEXT window traces cleanly
        h = svc.submit(_recurring(sess, 1)[0])
        svc.flush()
        assert h.done and tr._stack == []


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
class TestExport:
    def _traced_session(self):
        sess = _mk_session()
        sess.enable_tracing()
        svc = QueryService(sess, max_batch=3)
        for _ in range(2):                   # second window re-hits CE
            for q in _recurring(sess):
                svc.submit(q)
            svc.flush()
        return sess

    def test_chrome_trace_valid_and_covers_lifecycle(self, tmp_path):
        sess = self._traced_session()
        path = tmp_path / "trace.json"
        doc = sess.telemetry().export_chrome_trace(str(path))
        # valid, round-trippable trace-event JSON
        assert set(doc) == {"traceEvents", "displayTimeUnit"}
        assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
        names = set()
        for ev in doc["traceEvents"]:
            assert ev["ph"] == "X"
            assert isinstance(ev["ts"], float) and ev["dur"] >= 0.0
            assert isinstance(ev["name"], str)
            json.dumps(ev["args"])           # attrs must be jsonable
            names.add(ev["name"])
        # the acceptance lifecycle: submit -> window -> MQO -> dispatch
        # -> resolve, plus the executor-side CE/H2D spans
        assert {"submit", "window", "canonicalize", "mqo",
                "mqo.identify", "mqo.solve", "execute",
                "resolve"} <= names
        assert names & {"dispatch.batched", "ce.materialize", "scan.h2d"}

    def test_jsonl_export_one_record_per_span(self):
        sess = self._traced_session()
        text = sess.telemetry().export_jsonl()
        recs = [json.loads(ln) for ln in text.splitlines()]
        assert len(recs) == len(_all_spans(sess.telemetry().tracer))
        for r in recs:
            assert {"name", "depth", "ts", "dur", "status"} <= set(r)
        assert any(r["depth"] > 0 for r in recs)

    def test_noop_tracer_exports_empty_doc(self):
        doc = NOOP_TRACER.export_chrome_trace()
        assert doc == {"traceEvents": [], "displayTimeUnit": "ms"}
        assert NOOP_TRACER.export_jsonl() == ""


# ---------------------------------------------------------------------------
# disabled mode is free
# ---------------------------------------------------------------------------
class TestDisabledMode:
    def test_disabled_span_is_the_singleton_noop(self):
        tel = Telemetry()
        assert tel.tracer is NOOP_TRACER and not tel.tracing
        assert tel.span("anything", big=object()) is NOOP_SPAN
        assert tel.span("other") is tel.span("third")   # one instance
        assert NOOP_SPAN.set(x=1) is NOOP_SPAN
        with tel.span("x") as sp:
            assert sp is NOOP_SPAN

    def test_disabled_mode_never_reads_the_clock(self):
        calls = [0]

        def clock():
            calls[0] += 1
            return time.monotonic()

        tel = Telemetry(clock=clock)
        for _ in range(100):
            with tel.span("hot"):
                pass
        assert calls[0] == 0, "disabled tracing touched the clock"
        tel.enable_tracing()
        with tel.span("hot"):
            pass
        assert calls[0] == 2                # enter + exit, nothing else

    def test_service_span_guard_skips_attr_building(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=2)
        assert svc._span("window", window=0) is NOOP_SPAN
        sess.enable_tracing()
        assert svc._span("window", window=0) is not NOOP_SPAN
        sess.telemetry().disable_tracing()
        assert svc._span("window", window=0) is NOOP_SPAN

    def test_disabled_run_retains_no_spans(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=3)
        for q in _recurring(sess):
            svc.submit(q)
        svc.flush()
        assert sess.telemetry().tracer is NOOP_TRACER
        assert list(sess.telemetry().tracer.finished) == []


# ---------------------------------------------------------------------------
# histogram percentiles
# ---------------------------------------------------------------------------
class TestHistogram:
    def test_empty_percentiles_are_nan(self):
        h = Histogram()
        assert math.isnan(h.percentile(0.5))
        assert math.isnan(h.mean)
        d = h.as_dict()
        assert d["count"] == 0 and d["min"] is None and d["max"] is None

    def test_single_value_every_percentile_exact(self):
        h = Histogram(edges=(1.0, 10.0, 100.0))
        h.observe(42.0)
        for q in (0.0, 0.5, 0.99, 1.0):
            assert h.percentile(q) == 42.0

    def test_p0_p100_exact_min_max(self):
        h = Histogram(edges=(1.0, 10.0, 100.0))
        for v in (0.3, 2.0, 5.0, 37.0, 512.0):   # under- and overflow
            h.observe(v)
        assert h.percentile(0.0) == 0.3
        assert h.percentile(1.0) == 512.0
        assert h.count == 5 and h.total == pytest.approx(556.3)

    def test_interpolation_bounded_by_observations(self):
        h = Histogram(edges=(1.0, 10.0, 100.0))
        for v in (2.0, 3.0, 4.0, 5.0, 6.0):
            h.observe(v)
        for q in (0.1, 0.5, 0.9):
            assert 2.0 <= h.percentile(q) <= 6.0
        assert h.percentile(0.5) == pytest.approx(4.0, abs=2.0)

    def test_quantile_clamped_to_unit_interval(self):
        h = Histogram(edges=(1.0,))
        h.observe(0.5)
        h.observe(2.0)
        assert h.percentile(-3.0) == 0.5
        assert h.percentile(7.0) == 2.0

    def test_non_ascending_edges_rejected(self):
        with pytest.raises(ValueError):
            Histogram(edges=(1.0, 1.0, 2.0))
        with pytest.raises(ValueError):
            Histogram(edges=(5.0, 1.0))

    def test_registry_create_on_first_use(self):
        reg = MetricsRegistry()
        reg.inc("x")
        reg.inc("x", 2)
        reg.observe("lat", 0.5)
        reg.ewma("e").observe(3.0)
        reg.set_gauge("g", 9.0)
        assert reg.value("x") == 3 and reg.value("never") == 0
        snap = reg.snapshot()
        assert snap["counters"]["x"] == 3
        assert snap["gauges"]["g"] == 9.0
        assert snap["ewmas"]["e"] == {"value": 3.0, "n": 1}
        assert snap["histograms"]["lat"]["count"] == 1


# ---------------------------------------------------------------------------
# the pinned explain schema
# ---------------------------------------------------------------------------
class TestExplainSchema:
    def test_done_report_key_set_pinned(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=3)
        handles = [svc.submit(q) for q in _recurring(sess)]
        for h in handles:
            d = h.explain()
            assert EXPLAIN_DONE_KEYS <= set(d)
            assert set(d) <= (EXPLAIN_DONE_KEYS
                              | EXPLAIN_DONE_OPTIONAL_KEYS)
            for ce in d["ces"]:
                assert EXPLAIN_CE_KEYS <= set(ce)
                assert set(ce) <= EXPLAIN_CE_KEYS | {"partitions"}
            rep = h.explain_report()
            assert isinstance(rep, ExplainReport)
            assert rep.status == "done" and rep.as_dict() == d

    def test_failed_report_key_set_pinned(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=1, mqo=False)
        h = svc.submit(Relation(L.scan("ghost", S, "columnar"), sess))
        assert h.done and h.failed
        d = h.explain()
        assert set(d) == EXPLAIN_FAILED_KEYS
        assert h.explain_report().status == "failed"

    def test_window_death_report_key_set_pinned(self):
        cfg = SessionConfig(
            memory=MemoryConfig(budget_bytes=1 << 24)
        ).with_faults(FaultConfig(seed=0, rates={"window_close": 1.0}))
        sess = _mk_session(config=cfg)
        svc = QueryService(sess, max_batch=2)
        handles = [svc.submit(q) for q in _recurring(sess, 2)]
        for h in handles:
            assert set(h.explain()) == EXPLAIN_FAILED_KEYS
            assert h.explain()["submitted"]


# ---------------------------------------------------------------------------
# the unified metrics report
# ---------------------------------------------------------------------------
class TestMetricsReport:
    def _warm_service(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=3)
        for _ in range(2):                   # window 2 re-reads the CE
            for q in _recurring(sess):
                svc.submit(q)
            svc.flush()
        return sess, svc

    def test_report_contents(self):
        sess, svc = self._warm_service()
        rep = svc.metrics_report()
        assert rep == sess.metrics_report()

        counters = rep["registry"]["counters"]
        assert counters["queries.submitted"] == 6
        assert counters["queries.executed"] == 6
        assert counters["queries.succeeded"] == 6
        assert counters.get("queries.failed", 0) == 0
        assert counters["windows.closed"] == 2
        assert counters["bytes.ce_cached_read"] > 0

        # per-template latency percentiles
        assert rep["latency"]["all"]["count"] == 6
        assert len(rep["latency"]["families"]) == 1
        fam = next(iter(rep["latency"]["families"].values()))
        assert fam["count"] == 6 and fam["p50"] >= 0.0
        assert rep["arrival_interval_ewma_s"]["n"] == 5

        # every pool reports occupancy + a hit rate
        assert rep["pools"]
        for st in rep["pools"].values():
            assert 0.0 <= st["hit_rate"] <= 1.0
        assert any(st["hits"] > 0 for st in rep["pools"].values())

    def test_calibration_has_both_kinds(self):
        sess, svc = self._warm_service()
        cal = svc.metrics_report()["calibration"]
        kinds = cal["kinds"]
        assert cal["n_samples"] >= 2
        assert "materialize" in kinds and "cached_read" in kinds
        for k in ("materialize", "cached_read"):
            row = kinds[k]
            assert row["n"] >= 1
            assert row["predicted_cost"] > 0
            assert row["measured_seconds"] > 0
        # the session-level calibration surface agrees
        assert sess.cost_model.calibration() == cal

    def test_fault_and_degradation_events_in_registry(self):
        # one scan_h2d fault inside the shared CE materialization: its
        # consumers fall back to residual plans -> degradation events
        # plus fault.* counters, all countable from the ONE registry
        cfg = SessionConfig(
            memory=MemoryConfig(budget_bytes=1 << 24)
        ).with_faults(FaultConfig(seed=0, schedule={"scan_h2d": (0,)}))
        sess = _mk_session(config=cfg)
        svc = QueryService(sess, max_batch=3)
        handles = [svc.submit(q) for q in _recurring(sess)]
        assert not any(h.failed for h in handles)
        reg = sess.telemetry().registry
        assert reg.value("events.total") >= 1
        assert reg.value("events.action.fallback") >= 1
        inj = sess.fault_injector.report()
        assert reg.value("fault.fired.scan_h2d") == \
            inj["fired"]["scan_h2d"]
        assert reg.value("fault.fired.total") == inj["n_fired"]
        assert reg.value("fault.invocations.scan_h2d") == \
            inj["invocations"]["scan_h2d"]
        rep = svc.metrics_report()
        assert rep["faults"] == inj


pytestmark = pytest.mark.usefixtures("one_torch_thread")

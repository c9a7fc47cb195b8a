"""Online QueryService API (ISSUE 3): window-closing semantics
(count / deadline / flush), lazy handle resolution, explain() contents,
SessionConfig, bit-identity of submit-then-flush vs legacy run_batch,
single-query resident resume, memory-pressure-aware MCKP capacity, and
the deferred-sync fused Sort path.
"""
import numpy as np
import pytest

from repro_torch.relational import (ExecutionConfig, I32, MemoryConfig,
                                    MqoConfig, QueryService, Schema, Session,
                                    SessionConfig, expr as E, logical as L,
                                    make_storage, next_pow2)

from torch_fixtures import CPU
from torch_fixtures import build_session, hr_queries
from torch_parity import one_torch_thread  # noqa: F401


S = Schema.of(("a", I32), ("b", I32), ("c", I32))


def _mk_session(budget=1 << 24, nrows=2000, **kw) -> Session:
    rng = np.random.default_rng(9)
    cols = {c: rng.integers(0, 100, nrows).astype(np.int32)
            for c in ("a", "b", "c")}
    sess = Session.from_config(
        SessionConfig.from_legacy_kwargs(budget_bytes=budget, **kw),
        device=CPU)
    st, _ = make_storage("t", S, nrows, "columnar", cols=cols)
    sess.register(st)
    return sess


def _shared_query(sess):
    return sess.table("t").filter(E.cmp("a", ">", 50)).project("a", "b")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _tables_bit_identical(ta, tb):
    assert ta.nrows == tb.nrows
    assert ta.schema.names == tb.schema.names
    for n in ta.schema.names:
        assert np.array_equal(np.asarray(ta.columns[n])[: ta.nrows],
                              np.asarray(tb.columns[n])[: tb.nrows]), n


# ---------------------------------------------------------------------------
# window lifecycle
# ---------------------------------------------------------------------------
class TestWindowClosing:
    def test_count_trigger_closes_inside_submit(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=2)
        h1 = svc.submit(_shared_query(sess))
        assert not h1.done and svc.pending == 1
        h2 = svc.submit(_shared_query(sess))
        # the second arrival filled the window: both resolved already
        assert h1.done and h2.done and svc.pending == 0

    def test_deadline_trigger_via_poll(self):
        sess = _mk_session()
        clock = FakeClock()
        svc = QueryService(sess, max_batch=100, max_wait_s=5.0,
                           clock=clock)
        h = svc.submit(_shared_query(sess))
        assert not svc.poll() and not h.done      # deadline not reached
        clock.advance(5.1)
        assert svc.poll() and h.done
        assert not svc.poll()                     # nothing pending now

    def test_overdue_window_flushes_before_new_arrival(self):
        sess = _mk_session()
        clock = FakeClock()
        svc = QueryService(sess, max_batch=100, max_wait_s=5.0,
                           clock=clock)
        h1 = svc.submit(_shared_query(sess))
        clock.advance(10.0)
        h2 = svc.submit(_shared_query(sess))
        # h1's window was due: it ran BEFORE h2 was accepted, and h2
        # opened a fresh window
        assert h1.done and not h2.done
        assert svc.pending == 1

    def test_explicit_flush(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=100)
        handles = [svc.submit(_shared_query(sess)) for _ in range(3)]
        assert not any(h.done for h in handles)
        batch = svc.flush()
        assert all(h.done for h in handles)
        assert len(batch.results) == 3
        assert svc.flush() is None                # empty flush is a no-op

    def test_result_forces_pending_window(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=100)
        h = svc.submit(_shared_query(sess))
        table = h.result()                        # must not deadlock
        assert h.done and table.nrows > 0

    def test_flush_expired_closes_due_window(self):
        """ISSUE 4 satellite: a deadline-expired window closes through
        ``flush_expired()`` alone — no submit/result call required (the
        ROADMAP's cooperative window-closing open item)."""
        sess = _mk_session()
        clock = FakeClock()
        svc = QueryService(sess, max_batch=100, max_wait_s=5.0,
                           clock=clock)
        h = svc.submit(_shared_query(sess))
        assert svc.flush_expired() is None        # not due yet
        assert not h.done and svc.pending == 1
        clock.advance(5.1)
        batch = svc.flush_expired()               # due: closes, returns
        assert batch is not None and len(batch.results) == 1
        assert h.done and svc.pending == 0
        assert svc.flush_expired() is None        # nothing pending

    def test_flush_expired_never_cuts_filling_window_short(self):
        sess = _mk_session()
        clock = FakeClock()
        svc = QueryService(sess, max_batch=100, max_wait_s=5.0,
                           clock=clock)
        handles = [svc.submit(_shared_query(sess)) for _ in range(3)]
        clock.advance(4.9)
        assert svc.flush_expired() is None        # within the deadline
        assert svc.pending == 3
        clock.advance(0.2)
        batch = svc.flush_expired()
        assert len(batch.results) == 3
        assert all(h.done for h in handles)

    def test_flush_expired_without_deadline_is_noop(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=100)   # no max_wait_s
        h = svc.submit(_shared_query(sess))
        assert svc.flush_expired() is None        # no deadline configured
        assert not h.done and svc.pending == 1
        svc.flush()
        assert h.done

    def test_handles_resolve_in_submission_order(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=100)
        t = sess.table("t")
        thresholds = [20, 40, 60, 80]
        handles = [svc.submit(t.filter(E.cmp("a", ">", thr)).project("a"))
                   for thr in thresholds]
        svc.flush()
        counts = [h.result().nrows for h in handles]
        # descending thresholds -> ascending row counts: each handle got
        # ITS OWN query's result (order preserved through the window)
        assert counts == sorted(counts, reverse=True)
        assert [h.explain()["position"] for h in handles] == [0, 1, 2, 3]

    def test_explain_before_resolution_raises(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=100)
        h = svc.submit(_shared_query(sess))
        with pytest.raises(RuntimeError):
            h.explain()


# ---------------------------------------------------------------------------
# explain() contents + cross-window reuse
# ---------------------------------------------------------------------------
class TestExplain:
    def test_cold_window_reports_ce_without_reuse(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=2)
        h1 = svc.submit(_shared_query(sess))
        svc.submit(_shared_query(sess))
        e = h1.explain()
        assert e["status"] == "done" and e["mqo"] and e["window"] == 0
        assert "filter" in e["submitted"] or "scan" in e["submitted"]
        assert isinstance(e["plan"], str) and e["plan"]
        assert len(e["ces"]) == 1                 # identical pair -> one CE
        ce = e["ces"][0]
        assert ce["m"] == 2
        assert not ce["cache_hit"] and not ce["resident_repriced"]
        assert not e["resident_reuse"]

    def test_warm_window_reports_resident_hit(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=2)
        svc.submit(_shared_query(sess))
        svc.submit(_shared_query(sess))           # window 0: materializes
        h = svc.submit(_shared_query(sess))
        svc.submit(_shared_query(sess))           # window 1: reuses
        e = h.explain()
        assert e["window"] == 1
        assert e["resident_reuse"]
        ce = e["ces"][0]
        assert ce["cache_hit"] and ce["resident_repriced"]
        assert ce["weight"] == 0                  # already-paid MCKP item

    def test_single_query_resident_resume(self):
        """ROADMAP open item: a window with ONE query (below the k
        consumer threshold) still rewrites against a still-resident CE
        whose strict fingerprint matches."""
        sess = _mk_session()
        svc = QueryService(sess, max_batch=2)
        svc.submit(_shared_query(sess))
        svc.submit(_shared_query(sess))           # materialize the CE
        h = svc.submit(_shared_query(sess))
        batch = svc.flush()                       # window of ONE query
        e = h.explain()
        assert e["window_size"] == 1
        assert e["resident_reuse"]
        assert e["ces"][0]["single_resume"]
        assert batch.mqo.report.n_single_resume >= 1
        assert batch.mqo.report.n_resident >= 1
        # and the resumed result matches independent execution
        base = sess.run_batch([_shared_query(sess)], mqo=False)
        assert (base.results[0].table.row_multiset()
                == h.result().row_multiset())

    def test_single_query_no_resume_without_matching_resident(self):
        sess = _mk_session()
        svc = QueryService(sess, max_batch=2)
        svc.submit(_shared_query(sess))
        svc.submit(_shared_query(sess))
        # same structure, different predicate: strict fp differs
        other = sess.table("t").filter(E.cmp("a", "<", 10)).project("a", "b")
        h = svc.submit(other)
        batch = svc.flush()
        assert batch.mqo.report.n_single_resume == 0
        assert not h.explain()["resident_reuse"]

    def test_same_structure_windows_stay_resident_side_by_side(self):
        """Strict-keyed CE cache: windows over the same template family
        (same loose psi, different merged predicates) must not evict
        one another — every recurring window gets warm reuse."""
        sess = _mk_session(nrows=4000)
        t = sess.table("t")
        fam = lambda thr: t.filter(E.cmp("a", ">", thr)).project("a", "b")
        svc = QueryService(sess, max_batch=2)
        for thr in (50, 70):                      # two same-psi windows
            svc.submit(fam(thr))
            svc.submit(fam(thr))
        # repeat the SAME two windows: both must hit their residents
        for thr in (50, 70):
            h = svc.submit(fam(thr))
            svc.submit(fam(thr))
            e = h.explain()
            assert e["resident_reuse"], f"threshold {thr} lost residency"


# ---------------------------------------------------------------------------
# one-shot path == pre-closed window
# ---------------------------------------------------------------------------
class TestBitIdentity:
    @pytest.mark.parametrize("mqo", [False, True])
    def test_submit_flush_matches_run_batch(self, hr_data, mqo):
        sess_a = build_session(hr_data)
        sess_b = build_session(hr_data)
        batch = sess_a.run_batch(hr_queries(sess_a), mqo=mqo)
        svc = QueryService(sess_b, max_batch=100, mqo=mqo)
        handles = [svc.submit(q) for q in hr_queries(sess_b)]
        svc.flush()
        for qr, h in zip(batch.results, handles):
            _tables_bit_identical(qr.table, h.result())

    def test_run_batch_is_a_window(self, hr_data):
        """run_batch routes through the service machinery: the session's
        one-shot service exists after the first call and its window
        counter advances per batch."""
        sess = build_session(hr_data)
        assert sess._oneshot is None
        sess.run_batch(hr_queries(sess))
        assert isinstance(sess._oneshot, QueryService)
        n = sess._oneshot._n_windows
        sess.run_batch(hr_queries(sess))
        assert sess._oneshot._n_windows == n + 1


# ---------------------------------------------------------------------------
# SessionConfig
# ---------------------------------------------------------------------------
class TestSessionConfig:
    def test_from_config_equals_legacy_kwargs(self):
        cfg = SessionConfig(
            execution=ExecutionConfig(fuse=False, defer_sync=False,
                                      use_scan_cache=False),
            memory=MemoryConfig(budget_bytes=1 << 20, policy="benefit",
                                retain_across_batches=False),
            mqo=MqoConfig(k=3))
        sess = Session.from_config(cfg, device=CPU)
        legacy = Session(device=CPU, budget_bytes=1 << 20, fuse=False,
                         defer_sync=False, use_scan_cache=False,
                         policy="benefit", retain_across_batches=False)
        for attr in ("budget", "fuse", "defer_sync", "use_scan_cache",
                     "retain_across_batches"):
            assert getattr(sess, attr) == getattr(legacy, attr), attr
        assert sess.memory.policy == legacy.memory.policy == "benefit"
        assert sess.config.mqo.k == 3

    def test_config_is_frozen(self):
        cfg = SessionConfig()
        with pytest.raises(Exception):
            cfg.memory = MemoryConfig()
        with pytest.raises(Exception):
            cfg.memory.budget_bytes = 1

    def test_with_helpers_build_variants(self):
        cfg = SessionConfig().with_memory(budget_bytes=123) \
                             .with_execution(fuse=False) \
                             .with_mqo(k=5)
        assert cfg.memory.budget_bytes == 123
        assert not cfg.execution.fuse
        assert cfg.mqo.k == 5
        # defaults untouched
        assert SessionConfig().memory.budget_bytes == 1 << 30

    def test_legacy_shim_defaults_match_config_defaults(self):
        assert Session(device=CPU).config == SessionConfig().with_memory(
            budget_bytes=1 << 30)

    def test_config_and_legacy_kwargs_clash_raises(self):
        with pytest.raises(ValueError, match="not both"):
            Session(device=CPU, budget_bytes=1 << 20, config=SessionConfig())

    def test_service_inherits_mqo_config(self):
        sess = Session.from_config(SessionConfig(mqo=MqoConfig(k=4)),
                                   device=CPU)
        svc = sess.service(max_batch=3)
        assert svc.k == 4 and svc.max_batch == 3


# ---------------------------------------------------------------------------
# memory-pressure-aware MCKP capacity
# ---------------------------------------------------------------------------
class TestPlanningCapacity:
    def test_hot_scan_pool_shrinks_capacity(self):
        sess = _mk_session(budget=64 * 1024, nrows=4000)
        assert sess.planning_capacity() == sess.budget   # nothing hot
        # heat the scan pool (3 columns x 4096 cap x 4B = 48 KiB)
        sess.run_batch([sess.table("t").filter(E.cmp("a", ">", -1))],
                       mqo=False)
        scan_used = sess.memory.pools["scan"].stats.used
        assert scan_used > 0
        cap = sess.planning_capacity()
        assert cap == sess.budget - scan_used
        # the window-level optimizer actually planned at that capacity
        res = sess.run_batch([_shared_query(sess), _shared_query(sess)])
        assert res.mqo.report.budget <= sess.budget - scan_used

    def test_retained_residents_shrink_capacity(self):
        sess = _mk_session(budget=1 << 24)
        res = sess.run_batch([_shared_query(sess), _shared_query(sess)])
        assert res.mqo.report.n_selected >= 1
        ce_used = sess.memory.pools["ce"].stats.used
        scan_used = sess.memory.pools["scan"].stats.used
        assert ce_used > 0
        assert sess.planning_capacity() == sess.budget - scan_used - ce_used

    def test_explicit_budget_still_caps(self):
        sess = _mk_session(budget=1 << 24)
        assert sess.planning_capacity(4096) <= 4096
        assert sess.planning_capacity(0) == 0    # no-caching baseline

    def test_pressure_aware_off_restores_full_budget(self):
        cfg = SessionConfig(memory=MemoryConfig(budget_bytes=64 * 1024),
                            mqo=MqoConfig(pressure_aware=False))
        sess = Session.from_config(cfg, device=CPU)
        rng = np.random.default_rng(9)
        cols = {c: rng.integers(0, 100, 4000).astype(np.int32)
                for c in ("a", "b", "c")}
        st, _ = make_storage("t", S, 4000, "columnar", cols=cols)
        sess.register(st)
        sess.run_batch([sess.table("t").filter(E.cmp("a", ">", -1))],
                       mqo=False)
        assert sess.planning_capacity() == sess.budget

    def test_capacity_never_negative(self):
        sess = _mk_session(budget=1024, nrows=4000)   # pool >> budget
        sess.run_batch([sess.table("t").filter(E.cmp("a", ">", -1))],
                       mqo=False)
        assert sess.planning_capacity() >= 0

    def test_retention_off_plans_at_full_budget(self):
        """With retention off the CE cache is cleared at window start,
        so a repeat batch must plan at the full capacity again — the
        previous batch's (about-to-be-freed) CE bytes must not shrink
        the MCKP capacity."""
        sess = _mk_session(budget=1 << 24, retain_across_batches=False)
        first = sess.run_batch([_shared_query(sess), _shared_query(sess)])
        assert first.mqo.report.n_selected >= 1
        repeat = sess.run_batch([_shared_query(sess), _shared_query(sess)])
        scan_used = sess.memory.pools["scan"].stats.used
        assert repeat.mqo.report.budget == sess.budget - scan_used
        assert repeat.mqo.report.n_selected >= 1   # worksharing intact


class TestMqoConfigHonored:
    def test_run_batch_uses_config_mqo_enabled(self):
        cfg = SessionConfig(memory=MemoryConfig(budget_bytes=1 << 24),
                            mqo=MqoConfig(enabled=False))
        sess = Session.from_config(cfg, device=CPU)
        rng = np.random.default_rng(9)
        cols = {c: rng.integers(0, 100, 2000).astype(np.int32)
                for c in ("a", "b", "c")}
        st, _ = make_storage("t", S, 2000, "columnar", cols=cols)
        sess.register(st)
        res = sess.run_batch([_shared_query(sess), _shared_query(sess)])
        assert res.mqo is None                 # config disabled the MQO
        res = sess.run_batch([_shared_query(sess), _shared_query(sess)],
                             mqo=True)         # explicit override wins
        assert res.mqo is not None


# ---------------------------------------------------------------------------
# deferred-sync fused Sort
# ---------------------------------------------------------------------------
class TestSortDeferredSync:
    @pytest.mark.parametrize("desc", [False, True])
    @pytest.mark.parametrize("by", ["a", "x"])
    def test_fused_sort_bit_identical_to_eager(self, desc, by):
        schema = Schema.of(("a", I32), ("x", I32), ("b", I32))
        rng = np.random.default_rng(3)
        cols = {"a": rng.integers(0, 50, 3000).astype(np.int32),
                "x": rng.integers(-100, 100, 3000).astype(np.int32),
                "b": np.arange(3000, dtype=np.int32)}

        def mk(fused):
            s = Session.from_config(SessionConfig.from_legacy_kwargs(
                budget_bytes=1 << 24, fuse=fused,
                defer_sync=fused, use_scan_cache=fused), device=CPU)
            st, _ = make_storage("s", schema, 3000, "columnar", cols=cols)
            s.register(st)
            return s

        q = lambda s: (s.table("s").filter(E.cmp("a", ">", 25))
                       .sort(by, desc=desc))
        te = mk(False).run_one(q(mk(False))).table
        tf = mk(True).run_one(q(mk(True))).table
        # stable sort over identical masked keys: live rows must match
        # bit for bit, including tie order
        _tables_bit_identical(te, tf)

    def test_sort_output_capacity_sized_from_estimate(self):
        sess = _mk_session(nrows=4000)
        q = sess.table("t").filter(E.cmp("a", ">", 90)).sort("b")
        table = sess.run_one(q).table
        est = sess.cost_model.sort_estimate(table.nrows)
        # capacity tracks the (exact) estimate, not the scan capacity
        assert table.capacity <= next_pow2(max(int(est * 1.25), 1))
        assert table.capacity < 4096


pytestmark = pytest.mark.usefixtures("one_torch_thread")

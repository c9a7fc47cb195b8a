"""Rewrite-phase details: extraction plans, cache-plan chaining, caching
semantics (first consumer pays — paper §6.3 footnote 5)."""
import numpy as np
import pytest

from repro_torch.core.fingerprint import fingerprint
from repro_torch.core.plan import walk
from repro_torch.relational import (ExecContext, I32, Schema, Session,
                                    expr as E, logical as L, make_storage,
                                    SessionConfig)

from torch_fixtures import CPU
from torch_parity import one_torch_thread  # noqa: F401


S = Schema.of(("a", I32), ("b", I32), ("c", I32))


@pytest.fixture()
def sess():
    rng = np.random.default_rng(9)
    cols = {c: rng.integers(0, 100, 2000).astype(np.int32)
            for c in ("a", "b", "c")}
    s = Session.from_config(
        SessionConfig.from_legacy_kwargs(budget_bytes=1 << 24), device=CPU)
    st, _ = make_storage("t", S, 2000, "columnar", cols=cols)
    s.register(st)
    return s


class TestExtraction:
    def test_identity_extraction_for_equal_members(self, sess):
        t = sess.table("t")
        q = lambda: t.filter(E.cmp("a", ">", 50)).project("a", "b")
        res = sess.run_batch([q(), q()], mqo=True)
        # equal members: rewritten plans are bare CachedScans (possibly
        # under a project for column order) with NO re-filter
        for plan in res.mqo.rewritten.plans:
            assert not any(isinstance(n, L.Filter) for n in walk(plan))

    def test_divergent_extraction_refilters(self, sess):
        t = sess.table("t")
        q1 = t.filter(E.cmp("a", ">", 80)).project("a", "b")
        q2 = t.filter(E.cmp("a", "<", 20)).project("a", "c")
        res = sess.run_batch([q1, q2], mqo=True)
        if res.mqo.report.n_selected:
            for plan in res.mqo.rewritten.plans:
                kinds = [type(n) for n in walk(plan)]
                if L.CachedScan in kinds:
                    assert L.Filter in kinds  # member predicate re-applied

    def test_first_consumer_pays_materialization(self, sess):
        t = sess.table("t")
        q = lambda: t.filter(E.cmp("a", ">", 50)).project("a")
        res = sess.run_batch([q(), q(), q()], mqo=True)
        rep = res.cache_report
        # one admission (first query), hits for the others
        assert rep["admissions"] >= 1
        assert rep["hits"] >= 2

    def test_extraction_columns_preserved(self, sess):
        """Augmented covering projects keep member predicate columns."""
        t = sess.table("t")
        q1 = t.filter(E.cmp("a", ">", 60)).project("b")
        q2 = t.filter(E.cmp("a", "<", 40)).project("c")
        res = sess.run_batch([q1, q2], mqo=True)
        base = sess.run_batch([q1, q2], mqo=False)
        for b, o in zip(base.results, res.results):
            assert b.table.row_multiset() == o.table.row_multiset()
            assert b.table.schema.names == o.table.schema.names


class TestBudgetBehavior:
    def test_zero_budget_rewrites_nothing(self, sess):
        t = sess.table("t")
        q = lambda: t.filter(E.cmp("a", ">", 50))
        res = sess.run_batch([q(), q()], mqo=True, budget_bytes=0)
        assert res.mqo.report.n_selected == 0
        for plan in res.mqo.rewritten.plans:
            assert not any(isinstance(n, L.CachedScan)
                           for n in walk(plan))

    def test_tiny_budget_prefers_small_high_value_ces(self, sess):
        t = sess.table("t")
        # one narrow shared SE (small weight) + one wide one (big weight)
        narrow = lambda thr: (t.filter(E.cmp("a", ">", thr))
                              .project("a"))
        wide = lambda thr: t.filter(E.cmp("b", ">", thr))
        qs = [narrow(90), narrow(95), wide(10), wide(5)]
        res = sess.run_batch(qs, mqo=True, budget_bytes=4096)
        assert res.mqo.report.selected_weight <= 4096

    def test_spill_on_underestimate(self):
        """Cardinality underestimates spill instead of crashing
        (paper §6.3 footnote 6-ii)."""
        from repro_torch.core.cache import CacheManager

        mgr = CacheManager(budget_bytes=100,
                           spill_fn=lambda x: ("host", x),
                           unspill_fn=lambda x: x[1])
        mgr.put(b"x" * 16, payload="A" * 10, nbytes=90, est_bytes=50)
        mgr.put(b"y" * 16, payload="B" * 10, nbytes=90, est_bytes=50)
        assert mgr.stats.spilled_bytes == 90       # second one spilled
        assert mgr.get(b"y" * 16) == "B" * 10      # still readable


pytestmark = pytest.mark.usefixtures("one_torch_thread")

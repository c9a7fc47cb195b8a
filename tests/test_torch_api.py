"""Fluent Relation frontend (ISSUE 5): builder semantics, operator
overloading, lazy/immutable behavior, cache hints, and the legacy
compat shims (raw logical.Node submission + legacy Session kwargs)
with their DeprecationWarnings and bit-identity guarantees.
"""
import warnings

import numpy as np
import pytest

from repro_torch.core.fingerprint import strict_fingerprint
from repro_torch.relational import (I32, ColExpr, MemoryConfig, Pred,
                                    QueryService, Relation, Schema, Session,
                                    SessionConfig, c, canonicalize_plan, col,
                                    expr as E, logical as L, make_storage)

from torch_fixtures import CPU
from torch_parity import one_torch_thread  # noqa: F401


S = Schema.of(("a", I32), ("b", I32), ("d", I32))


def _mk_session(budget=1 << 24, nrows=2000):
    rng = np.random.default_rng(5)
    cols = {n: rng.integers(0, 100, nrows).astype(np.int32)
            for n in ("a", "b", "d")}
    sess = Session.from_config(
        SessionConfig.from_legacy_kwargs(budget_bytes=budget), device=CPU)
    st, _ = make_storage("t", S, nrows, "columnar", cols=cols)
    sess.register(st)
    return sess, cols


# ---------------------------------------------------------------------------
# column expressions
# ---------------------------------------------------------------------------
class TestColumnExpressions:
    def test_namespace_and_col_helper(self):
        assert isinstance(c.price, ColExpr)
        assert c["net profit"].name == "net profit"
        assert col("qty").name == "qty"

    def test_comparison_builds_pred(self):
        p = c.a > 5
        assert isinstance(p, Pred)
        assert p.expr == E.cmp("a", ">", 5)
        assert (c.a == c.b).expr == E.col_cmp("a", "==", "b")

    def test_literal_on_left_reflected_dispatch(self):
        # Python reflects 5 < c.a into ColExpr.__gt__(5)
        assert (5 < c.a).expr == E.cmp("a", ">", 5)
        assert (5 == c.a).expr == E.cmp("a", "==", 5)

    def test_connectives(self):
        p = (c.a > 5) & (c.b == 3) | ~(c.d < 1)
        assert isinstance(p, Pred)
        got = canonicalize_plan(
            L.scan("t", S).filter(p.expr)).pred
        want = canonicalize_plan(L.scan("t", S).filter(
            E.or_(E.and_(E.cmp("a", ">", 5), E.cmp("b", "==", 3)),
                  E.cmp("d", ">=", 1)))).pred
        assert got == want

    def test_isin_between(self):
        # isin builds the first-class membership node (one kernel
        # opcode); canonicalization dedups + sorts the value set and
        # folds a singleton down to a plain compare
        from repro_torch.relational import canonicalize_expr
        assert (c.a.isin([2, 1])).expr == E.In(E.Col("a"), (2, 1))
        assert (canonicalize_expr(c.a.isin([2, 1, 2]).expr)
                == E.In(E.Col("a"), (1, 2)))
        assert (canonicalize_expr(c.a.isin([7]).expr)
                == E.cmp("a", "==", 7))
        assert ((c.a.between(3, 7)).expr
                == E.and_(E.cmp("a", ">=", 3), E.cmp("a", "<=", 7)))

    def test_isin_empty_is_false_and_executes(self):
        # empty membership canonicalizes to FALSE and returns no rows
        from repro_torch.relational import canonicalize_expr
        assert (c.a.isin([])).expr == E.In(E.Col("a"), ())
        assert canonicalize_expr(c.a.isin([]).expr) == E.Not(E.TRUE)
        sess, _ = _mk_session()
        out = sess.run_one(
            sess.table("t").where(c.a.isin([])).select("a"))
        assert out.table.nrows == 0

    def test_bool_coercion_raises(self):
        with pytest.raises(TypeError):
            bool(c.a > 5)

    def test_invalid_operand_fails_at_call_site(self):
        # review fix: comparing a column against a non-literal must
        # raise here, not deep inside fingerprinting
        with pytest.raises(TypeError, match="cannot compare column"):
            c.a == (c.b > 5)
        with pytest.raises(TypeError, match="cannot compare column"):
            c.a > [1, 2]

    def test_non_finite_literals_rejected(self):
        for bad in (float("nan"), float("inf"), -float("inf")):
            with pytest.raises(ValueError, match="non-finite"):
                c.a > bad

    def test_numpy_scalars_coerce_to_canonical_literals(self):
        assert (c.a > np.int64(5)).expr == E.cmp("a", ">", 5)
        assert (c.a > np.float32(5.5)).expr == E.cmp("a", ">", 5.5)


# ---------------------------------------------------------------------------
# the Relation builder
# ---------------------------------------------------------------------------
class TestRelationBuilder:
    def test_table_returns_bound_relation(self):
        sess, _ = _mk_session()
        rel = sess.table("t")
        assert isinstance(rel, Relation)
        assert rel.session is sess
        assert rel.columns == ("a", "b", "d")

    def test_builder_is_immutable(self):
        sess, _ = _mk_session()
        rel = sess.table("t")
        filtered = rel.where(c.a > 5)
        assert filtered is not rel
        assert isinstance(rel.plan, L.Scan)         # base unchanged
        assert isinstance(filtered.plan, L.Filter)

    def test_full_chain_compiles(self):
        sess, _ = _mk_session()
        rel = (sess.table("t").where(c.a > 5).select("a", "b")
               .group_by("a").agg(("n", "count", ""), ("s", "sum", "b"))
               .sort("a").limit(10))
        plan = rel.logical_plan()
        assert isinstance(plan, L.Limit)
        text = rel.explain_str()
        assert "Aggregate" in text and "Filter" in text

    def test_union_and_join_accept_relations_and_nodes(self):
        sess, _ = _mk_session()
        rel = sess.table("t").where(c.a > 90).select("a")
        u = rel.union(sess.table("t").where(c.a < 5).select("a"))
        assert isinstance(u.plan, L.Union)
        other = L.scan("u", Schema.of(("x", I32)))
        j = sess.table("t").join(other, "a", "x")
        assert isinstance(j.plan, L.Join)

    def test_collect_executes_on_bound_session(self):
        sess, cols = _mk_session()
        out = sess.table("t").where(c.a > 50).select("a").collect()
        assert out.nrows == int((cols["a"] > 50).sum())

    def test_select_rejects_duplicate_columns(self):
        sess, _ = _mk_session()
        with pytest.raises(ValueError, match="duplicate"):
            sess.table("t").select("a", "a")

    def test_run_batch_accepts_iterators(self):
        # review fix: a generator input must not be exhausted by the
        # coercion pass and silently yield an empty batch
        sess, cols = _mk_session()
        rels = (sess.table("t").where(c.a > v).select("a")
                for v in (10, 20))
        res = sess.run_batch(rels)
        assert len(res.results) == 2
        assert res.results[0].table.nrows == int((cols["a"] > 10).sum())

    def test_collect_unbound_raises(self):
        rel = Relation(L.scan("t", S))
        with pytest.raises(RuntimeError):
            rel.collect()

    def test_legacy_builder_methods_alias(self):
        sess, _ = _mk_session()
        a = sess.table("t").filter(E.cmp("a", ">", 5)).project("a")
        b = sess.table("t").where(c.a > 5).select("a")
        assert (strict_fingerprint(a.logical_plan())
                == strict_fingerprint(b.logical_plan()))


# ---------------------------------------------------------------------------
# legacy-surface shims
# ---------------------------------------------------------------------------
class TestLegacyShims:
    def test_raw_node_submit_warns_and_is_bit_identical(self):
        sess, _ = _mk_session()
        raw = (sess.scan_node("t").filter(E.cmp("a", ">", 50))
               .project("a", "b"))
        rel = sess.table("t").where(c.a > 50).select("a", "b")
        with pytest.warns(DeprecationWarning, match="Relation API"):
            legacy = sess.run_batch([raw])
        fresh, _ = _mk_session()
        modern = fresh.run_batch(
            [fresh.table("t").where(c.a > 50).select("a", "b")])
        ta = legacy.results[0].table
        tb = modern.results[0].table
        assert ta.schema.names == tb.schema.names
        for n in ta.schema.names:
            np.testing.assert_array_equal(
                np.asarray(ta.columns[n])[: ta.nrows],
                np.asarray(tb.columns[n])[: tb.nrows])
        # same session, same strict identity for both spellings
        assert (strict_fingerprint(canonicalize_plan(raw))
                == strict_fingerprint(rel.logical_plan()))

    def test_service_submit_raw_node_warns(self):
        sess, _ = _mk_session()
        svc = QueryService(sess, max_batch=1)
        with pytest.warns(DeprecationWarning):
            h = svc.submit(sess.scan_node("t").filter(E.cmp("a", ">", 0)))
        assert h.done

    def test_relation_submission_does_not_warn(self):
        sess, _ = _mk_session()
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            sess.run_batch([sess.table("t").where(c.a > 0).select("a")])

    def test_legacy_session_kwargs_warn(self):
        with pytest.warns(DeprecationWarning, match="SessionConfig"):
            sess = Session(device=CPU, budget_bytes=1 << 20, policy="benefit")
        assert sess.budget == 1 << 20
        assert sess.config.memory.policy == "benefit"

    def test_default_session_does_not_warn(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            Session(device=CPU)

    def test_config_plus_legacy_kwargs_still_raises(self):
        with pytest.raises(ValueError):
            Session(device=CPU, budget_bytes=1 << 20,
                    config=SessionConfig(
                        memory=MemoryConfig(budget_bytes=1 << 22)))

    def test_legacy_and_config_paths_agree(self):
        with pytest.warns(DeprecationWarning):
            a = Session(device=CPU, budget_bytes=1 << 22, policy="benefit",
                        retain_across_batches=False)
        b = Session.from_config(SessionConfig.from_legacy_kwargs(
            budget_bytes=1 << 22, policy="benefit",
            retain_across_batches=False), device=CPU)
        assert a.config == b.config


# ---------------------------------------------------------------------------
# cache hints
# ---------------------------------------------------------------------------
class TestCacheHint:
    def test_cache_hint_is_immutable_marker(self):
        sess, _ = _mk_session()
        rel = sess.table("t").where(c.a > 50).select("a", "b")
        hinted = rel.cache_hint()
        assert hinted.hint_cache and not rel.hint_cache

    def test_hinted_single_query_materializes_then_resumes(self):
        sess, _ = _mk_session()
        svc = QueryService(sess, max_batch=1)
        rel = sess.table("t").where(c.a > 50).select("a", "b")
        h1 = svc.submit(rel.cache_hint())       # lone query, k drops to 1
        ces = {ce["strict_psi"] for ce in h1.explain()["ces"]}
        assert ces, "hinted lone query should build a covering entry"
        # the same query (unhinted) in a later window resumes from it
        h2 = svc.submit(rel)
        ex = h2.explain()
        assert {ce["strict_psi"] for ce in ex["ces"]} == ces
        assert ex["resident_reuse"]

    def test_unhinted_single_query_builds_no_ce(self):
        sess, _ = _mk_session()
        svc = QueryService(sess, max_batch=1)
        h = svc.submit(sess.table("t").where(c.a > 50).select("a", "b"))
        assert not h.explain()["ces"]


# ---------------------------------------------------------------------------
# handle explain provenance
# ---------------------------------------------------------------------------
class TestExplainProvenance:
    def test_submitted_vs_executed_plan(self):
        sess, _ = _mk_session()
        svc = QueryService(sess, max_batch=2)
        rel = sess.table("t").where(c.a > 50).select("a", "b")
        h1, h2 = svc.submit(rel), svc.submit(rel)
        ex = h1.explain()
        assert "Scan" not in ex["plan"] or "cached" in ex["plan"] \
            or ex["ces"] == []
        assert ex["submitted"].startswith("project")
        assert h1.plan is rel               # provenance: as submitted
        assert isinstance(h1.node, L.Node)


pytestmark = pytest.mark.usefixtures("one_torch_thread")

"""Canonical plan IR (ISSUE 5): syntactic variants of one query —
shuffled conjuncts, pushed negations, double negations, flipped
literal-on-left compares, stacked filters, redundant projections —
canonicalize to identical expressions, identical strict fingerprints,
and hit the SAME resident covering expression across service windows.

Property tests run twice: a hypothesis version (skipped when the
package is absent) and a seeded always-run variant over the same
generators.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core.fingerprint import fingerprint, strict_fingerprint
from repro_torch.relational import (FALSE, I32, QueryService, Schema, Session,
                                    SessionConfig, c, canonicalize_expr,
                                    canonicalize_plan, expr as E, format_plan,
                                    logical as L, make_storage)

from torch_fixtures import CPU
from torch_parity import one_torch_thread  # noqa: F401


S = Schema.of(("a", I32), ("b", I32), ("d", I32))
COLS = ("a", "b", "d")


def _mk_session(budget=1 << 24, nrows=2000):
    rng = np.random.default_rng(3)
    cols = {n: rng.integers(0, 100, nrows).astype(np.int32)
            for n in COLS}
    sess = Session.from_config(
        SessionConfig.from_legacy_kwargs(budget_bytes=budget), device=CPU)
    st, _ = make_storage("t", S, nrows, "columnar", cols=cols)
    sess.register(st)
    return sess, cols


# ---------------------------------------------------------------------------
# random expression trees + semantics-preserving syntactic variants
# ---------------------------------------------------------------------------
def random_expr(rng: random.Random, depth: int = 3) -> E.Expr:
    if depth <= 0 or rng.random() < 0.35:
        col = rng.choice(COLS)
        op = rng.choice(E._OPS)
        if rng.random() < 0.15:            # col-col compare
            return E.col_cmp(col, op, rng.choice(COLS))
        return E.cmp(col, op, rng.randint(0, 100))
    kind = rng.random()
    parts = tuple(random_expr(rng, depth - 1)
                  for _ in range(rng.randint(2, 3)))
    if kind < 0.4:
        return E.And(parts)
    if kind < 0.8:
        return E.Or(parts)
    return E.Not(random_expr(rng, depth - 1))


def syntactic_variant(e: E.Expr, rng: random.Random) -> E.Expr:
    """A differently-spelled expression with identical semantics."""
    if rng.random() < 0.25:                 # double negation anywhere
        return E.Not(E.Not(syntactic_variant(e, rng)))
    if isinstance(e, E.Cmp):
        e = E.oriented(e)
        r = rng.random()
        if (r < 0.33 and isinstance(e.col, E.Col)
                and isinstance(e.rhs, E.Lit)):
            # literal-on-left spelling: a > 5  →  5 < a
            return E.Cmp(E.MIRROR[e.op], e.rhs, e.col)
        if r < 0.66:
            # negated complement: a > 5  →  ¬(a <= 5)
            return E.Not(E.Cmp(E.NEGATE[e.op], e.col, e.rhs))
        return e
    if isinstance(e, (E.And, E.Or)):
        parts = [syntactic_variant(p, rng) for p in e.parts]
        rng.shuffle(parts)                  # commutativity
        out = type(e)(tuple(parts))
        if rng.random() < 0.3:              # De Morgan spelling
            dual = E.Or if isinstance(e, E.And) else E.And
            return E.Not(dual(tuple(E.Not(p) for p in parts)))
        return out
    if isinstance(e, E.Not):
        return E.Not(syntactic_variant(e.part, rng))
    return e


def _eval_np(e: E.Expr, cols) -> np.ndarray:
    return np.asarray(E.eval_expr(e, {n: torch.as_tensor(np.asarray(v))
                                      for n, v in cols.items()}))


def check_variant_pair(seed: int, cols) -> None:
    rng = random.Random(seed)
    orig = random_expr(rng)
    var = syntactic_variant(orig, rng)
    canon_o, canon_v = canonicalize_expr(orig), canonicalize_expr(var)
    # one normal form...
    assert canon_o == canon_v, (E.pretty(orig), E.pretty(var))
    # ...that is semantics-preserving
    np.testing.assert_array_equal(_eval_np(orig, cols),
                                  _eval_np(canon_o, cols))
    np.testing.assert_array_equal(_eval_np(var, cols),
                                  _eval_np(canon_o, cols))
    # and plan-level: one strict fingerprint
    scan = L.scan("t", S)
    p1 = canonicalize_plan(scan.filter(orig).project("a"))
    p2 = canonicalize_plan(scan.filter(var).project("a"))
    assert fingerprint(p1) == fingerprint(p2)
    assert strict_fingerprint(p1) == strict_fingerprint(p2)


class TestPropertySeeded:
    """Always-run seeded variant of the hypothesis properties."""

    def test_variants_canonicalize_identically(self):
        rng = np.random.default_rng(0)
        cols = {n: rng.integers(0, 100, 257).astype(np.int32)
                for n in COLS}
        for seed in range(60):
            check_variant_pair(seed, cols)


class TestPropertyHypothesis:
    def test_variants_canonicalize_identically(self):
        hyp = pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        rng = np.random.default_rng(1)
        cols = {n: rng.integers(0, 100, 129).astype(np.int32)
                for n in COLS}

        @settings(max_examples=60, deadline=None)
        @given(st.integers(min_value=0, max_value=10_000))
        def prop(seed):
            check_variant_pair(seed, cols)

        prop()


# ---------------------------------------------------------------------------
# targeted normal-form rules
# ---------------------------------------------------------------------------
class TestExprNormalForm:
    def test_reversed_literal_compare_is_representable(self):
        # satellite: Lit-op-Col used to be unconstructible in practice
        e = E.Cmp("<", E.Lit(5), E.Col("a"))          # 5 < a
        assert canonicalize_expr(e) == E.cmp("a", ">", 5)
        assert E.columns_of(e) == frozenset({"a"})
        assert E.canonical(e) == E.canonical(E.cmp("a", ">", 5))
        assert "a" in E.pretty(e)

    def test_reversed_compare_evaluates(self):
        cols = {"a": np.arange(10, dtype=np.int32)}
        got = _eval_np(E.Cmp("<", E.Lit(5), E.Col("a")), cols)
        np.testing.assert_array_equal(got, np.arange(10) > 5)

    @pytest.mark.parametrize("op", E._OPS)
    def test_every_op_flips_consistently(self, op):
        cols = {"a": np.arange(-3, 9, dtype=np.int32)}
        lhs = E.Cmp(op, E.Lit(4), E.Col("a"))
        rhs = canonicalize_expr(lhs)
        np.testing.assert_array_equal(_eval_np(lhs, cols),
                                      _eval_np(rhs, cols))

    def test_col_col_compare_orientation(self):
        # a < b and b > a must share one canonical form (review fix)
        lhs = E.col_cmp("a", "<", "b")
        rhs = E.col_cmp("b", ">", "a")
        assert canonicalize_expr(lhs) == canonicalize_expr(rhs)
        assert E.canonical(lhs) == E.canonical(rhs)
        cols = {"a": np.arange(8, dtype=np.int32),
                "b": np.full(8, 4, dtype=np.int32)}
        np.testing.assert_array_equal(_eval_np(lhs, cols),
                                      _eval_np(rhs, cols))
        p1 = canonicalize_plan(L.scan("t", S).filter(lhs).project("a"))
        p2 = canonicalize_plan(L.scan("t", S).filter(rhs).project("a"))
        assert strict_fingerprint(p1) == strict_fingerprint(p2)

    def test_empty_disjunction_is_false(self):
        assert E.or_() == FALSE                     # review fix
        cols = {"a": np.arange(4, dtype=np.int32)}
        np.testing.assert_array_equal(_eval_np(E.or_(), cols),
                                      np.zeros(4, bool))

    def test_not_cmp_folds_to_complement(self):
        assert (canonicalize_expr(E.Not(E.cmp("a", ">=", 5)))
                == E.cmp("a", "<", 5))

    def test_double_negation_cancels(self):
        p = E.cmp("a", "==", 1)
        assert canonicalize_expr(E.Not(E.Not(p))) == p

    def test_de_morgan_pushdown(self):
        e = E.Not(E.And((E.cmp("a", ">", 1), E.cmp("b", "<", 2))))
        want = canonicalize_expr(
            E.Or((E.cmp("a", "<=", 1), E.cmp("b", ">=", 2))))
        assert canonicalize_expr(e) == want

    def test_conjunct_sort_and_dedup(self):
        x, y = E.cmp("a", ">", 1), E.cmp("b", "<", 2)
        assert (canonicalize_expr(E.And((y, x, y)))
                == canonicalize_expr(E.And((x, y))))

    def test_constant_folding(self):
        t = E.Cmp("<", E.Lit(1), E.Lit(2))      # true
        f = E.Cmp(">", E.Lit(1), E.Lit(2))      # false
        assert canonicalize_expr(t) == E.TRUE
        assert canonicalize_expr(f) == FALSE
        p = E.cmp("a", ">", 3)
        assert canonicalize_expr(E.And((t, p))) == p
        assert canonicalize_expr(E.And((f, p))) == FALSE
        assert canonicalize_expr(E.Or((t, p))) == E.TRUE
        assert canonicalize_expr(E.Or((f, p))) == p

    @pytest.mark.parametrize("op", E._OPS)
    def test_cross_type_const_fold_closed_under_complement(self, op):
        """review fix: Not(Lit-op-Lit) over incomparable literal types
        must fold to the complement of the un-negated fold, matching
        the un-canonicalized eval path."""
        e = E.Cmp(op, E.Lit(b"a"), E.Lit(5))
        plain = canonicalize_expr(e)
        negated = canonicalize_expr(E.Not(e))
        assert {plain, negated} == {E.TRUE, FALSE}
        cols = {"a": np.arange(4, dtype=np.int32)}
        np.testing.assert_array_equal(_eval_np(e, cols),
                                      _eval_np(plain, cols))
        np.testing.assert_array_equal(_eval_np(E.Not(e), cols),
                                      _eval_np(negated, cols))

    def test_nan_literal_negation_not_folded(self):
        """review fix: ¬(x > NaN) must NOT fold to x <= NaN (IEEE NaN
        satisfies neither side) — the Not survives canonicalization
        and both forms evaluate identically."""
        e = E.Not(E.cmp("a", ">", float("nan")))
        canon = canonicalize_expr(e)
        assert isinstance(canon, E.Not)
        cols = {"a": np.arange(4, dtype=np.float32)}
        np.testing.assert_array_equal(_eval_np(e, cols),
                                      _eval_np(canon, cols))
        # un-negated NaN compares still fold soundly (all-False)
        np.testing.assert_array_equal(
            _eval_np(E.cmp("a", ">", float("nan")), cols),
            np.zeros(4, bool))

    def test_nan_columns_rejected_at_registration(self):
        """The ordered-complement fold (¬(x<=v) → x>v) is only sound
        without NaN; registration must therefore refuse non-finite
        float columns (review fix: made explicit, was accidental)."""
        from repro_torch.relational import F32, Session as S_, make_storage \
            as mk
        import numpy as _np

        sch = Schema.of(("x", F32))
        cols = {"x": _np.array([1.0, _np.nan, 3.0], _np.float32)}
        sess = S_.from_config(
            SessionConfig.from_legacy_kwargs(budget_bytes=1 << 20),
            device=CPU)
        st, _ = mk("t", sch, 3, "columnar", cols=cols)
        with pytest.raises(ValueError, match="NaN"):
            sess.register(st, columnar_for_stats=cols)

    def test_constant_false_filter_executes(self):
        sess, _ = _mk_session()
        q = sess.table("t").where(E.Cmp(">", E.Lit(1), E.Lit(2)))
        out = sess.run_batch([q], mqo=False).results[0].table
        assert out.nrows == 0


class TestPlanNormalForm:
    def test_stacked_filters_merge(self):
        scan = L.scan("t", S)
        a = canonicalize_plan(
            scan.filter(E.cmp("a", ">", 5)).filter(E.cmp("b", "<", 3)))
        b = canonicalize_plan(
            scan.filter(E.and_(E.cmp("b", "<", 3), E.cmp("a", ">", 5))))
        assert strict_fingerprint(a) == strict_fingerprint(b)

    def test_true_filter_disappears(self):
        scan = L.scan("t", S)
        assert canonicalize_plan(scan.filter(E.TRUE)) == scan

    def test_identity_projection_disappears(self):
        scan = L.scan("t", S)
        assert canonicalize_plan(scan.project(*S.names)) == scan

    def test_project_project_collapses_and_dedups(self):
        scan = L.scan("t", S)
        a = canonicalize_plan(scan.project("a", "b").project("a", "a"))
        assert a == scan.project("a")

    def test_format_plan_renders_tree(self):
        other = L.scan("u", Schema.of(("x", I32)))
        plan = (L.scan("t", S).filter(E.cmp("a", ">", 5))
                .join(other, "a", "x"))
        text = format_plan(plan, show_schema=True)
        assert "Join" in text and "Filter" in text and "Scan t" in text
        assert "⟨" in text


# ---------------------------------------------------------------------------
# cross-window sharing: variants hit the SAME resident CE
# ---------------------------------------------------------------------------
class TestCrossWindowSharing:
    def _builder_query(self, sess):
        return (sess.table("t")
                .where((c.a > 50) & (c.b < 80))
                .select("a", "b"))

    def _variant_query(self, sess):
        # flipped literal, pushed negation, swapped conjuncts
        return (sess.table("t")
                .where(~(c.b >= 80) & (50 < c.a))
                .select("a", "b"))

    def _legacy_query(self, sess):
        return (sess.scan_node("t")
                .filter(E.and_(E.Not(E.cmp("b", ">=", 80)),
                               E.Cmp("<", E.Lit(50), E.Col("a"))))
                .project("a", "b"))

    def test_one_strict_fingerprint_three_spellings(self):
        sess, _ = _mk_session()
        plans = [canonicalize_plan(p) for p in
                 (self._builder_query(sess), self._variant_query(sess),
                  self._legacy_query(sess))]
        fps = {strict_fingerprint(p) for p in plans}
        assert len(fps) == 1

    def test_window_shares_one_ce_across_spellings(self):
        sess, _ = _mk_session()
        svc = QueryService(sess, max_batch=3)
        with pytest.warns(DeprecationWarning):
            handles = [svc.submit(self._builder_query(sess)),
                       svc.submit(self._variant_query(sess)),
                       svc.submit(self._legacy_query(sess))]
        keysets = [{ce["strict_psi"] for ce in h.explain()["ces"]}
                   for h in handles]
        assert keysets[0] and keysets[0] == keysets[1] == keysets[2]
        ta = handles[0].result()
        for h in handles[1:]:
            tb = h.result()
            assert ta.row_multiset() == tb.row_multiset()

    def test_variant_resumes_from_resident_ce_next_window(self):
        sess, _ = _mk_session()
        svc = QueryService(sess, max_batch=2)
        # window 1: two same-spelling queries materialize the CE
        h1 = svc.submit(self._builder_query(sess))
        h2 = svc.submit(self._builder_query(sess))
        assert h1.done and h2.done
        ces1 = {ce["strict_psi"] for ce in h1.explain()["ces"]}
        assert ces1
        # window 2: DIFFERENT spellings arrive; canonicalization maps
        # them onto the same strict key, so the resident CE is hit
        h3 = svc.submit(self._variant_query(sess))
        with pytest.warns(DeprecationWarning):
            h4 = svc.submit(self._legacy_query(sess))
        ex3, ex4 = h3.explain(), h4.explain()
        assert {ce["strict_psi"] for ce in ex3["ces"]} == ces1
        assert ex3["resident_reuse"] and ex4["resident_reuse"]
        assert all(ce["cache_hit"] for ce in ex3["ces"])

    def test_tpcds_builder_vs_handbuilt_share_one_ce(self):
        """ISSUE 5 acceptance: two syntactic variants of a TPC-DS-style
        query — one from the builder, one a hand-built raw tree — get
        equal strict fingerprints and consume ONE shared CE."""
        from repro_torch.relational.tpcds import build_tpcds_session

        sess = build_tpcds_session(scale_rows=4000, device=CPU)
        svc = QueryService(sess, max_batch=2)
        builder = (sess.table("store_sales")
                   .where((c.ss_sales_price > 50.0)
                          & (c.ss_quantity >= 10))
                   .select("ss_item_sk", "ss_sales_price"))
        hand = (sess.scan_node("store_sales")
                .filter(E.and_(
                    E.Not(E.cmp("ss_quantity", "<", 10)),
                    E.Cmp("<", E.Lit(50.0), E.Col("ss_sales_price"))))
                .project("ss_item_sk", "ss_sales_price"))
        assert (strict_fingerprint(canonicalize_plan(builder))
                == strict_fingerprint(canonicalize_plan(hand)))
        h1 = svc.submit(builder)
        with pytest.warns(DeprecationWarning):
            h2 = svc.submit(hand)
        e1, e2 = h1.explain(), h2.explain()
        keys = {ce["strict_psi"] for ce in e1["ces"]}
        assert keys and keys == {ce["strict_psi"] for ce in e2["ces"]}
        assert h1.result().row_multiset() == h2.result().row_multiset()

    def test_hypothesis_variants_share_resident_ce(self):
        """Seeded stream: random variant spellings of one template in
        later windows keep hitting the window-1 CE."""
        sess, _ = _mk_session()
        svc = QueryService(sess, max_batch=2)
        base = E.and_(E.cmp("a", ">", 30), E.cmp("b", "<=", 70))

        def q(pred):
            return sess.table("t").where(pred).select("a", "b")

        h = [svc.submit(q(base)), svc.submit(q(base))]
        want = {ce["strict_psi"] for ce in h[0].explain()["ces"]}
        assert want
        rng = random.Random(7)
        for _ in range(4):
            v1, v2 = (syntactic_variant(base, rng),
                      syntactic_variant(base, rng))
            ha, hb = svc.submit(q(v1)), svc.submit(q(v2))
            for hx in (ha, hb):
                ex = hx.explain()
                assert {ce["strict_psi"] for ce in ex["ces"]} == want
                assert ex["resident_reuse"]


class TestPlanShapeKeys:
    """Satellite (ISSUE 7): the plan-shape compile cache keys slotted
    programs by predicate SHAPE.  Properties: (i) every literal variant
    of one template compiles to ONE program (the shape key), with only
    the hoisted operand values differing; (ii) structurally different
    templates never collide onto one program; (iii) across a
    multi-window recurring stream the trace cache misses only in the
    first window."""

    KINDS = {"a": "i32", "b": "i32", "d": "i32"}

    def _slots(self, pred):
        from repro_torch.kernels.filter_project.ops import \
            compile_predicate_slots
        return compile_predicate_slots(
            canonicalize_expr(pred), COLS, self.KINDS)

    def test_literal_variants_one_shape_key(self):
        rng = random.Random(1234)
        templates = [
            lambda x, y: E.and_(E.cmp("a", ">", x), E.cmp("b", "<", y)),
            lambda x, y: E.or_(E.cmp("a", "==", x),
                               E.and_(E.cmp("b", ">=", y),
                                      E.cmp("d", "!=", x))),
            lambda x, y: E.Not(E.and_(E.cmp("d", "<=", x),
                                      E.cmp("a", "<", y))),
        ]
        for tpl in templates:
            progs, operands = set(), set()
            for _ in range(25):
                x, y = rng.randint(0, 60), rng.randint(61, 100)
                program, ivals, fvals = self._slots(tpl(x, y))
                progs.add(program)
                operands.add((ivals, fvals))
            assert len(progs) == 1, "literal variants must share ONE shape"
            assert len(operands) > 1, "literals must be hoisted, not baked"

    def test_distinct_structures_never_collide(self):
        structures = [
            E.cmp("a", ">", 5),
            E.cmp("a", ">=", 5),                      # different op
            E.cmp("b", ">", 5),                       # different column
            E.and_(E.cmp("a", ">", 5), E.cmp("b", "<", 9)),
            E.or_(E.cmp("a", ">", 5), E.cmp("b", "<", 9)),
            E.and_(E.cmp("a", ">", 5), E.cmp("b", "<", 9),
                   E.cmp("d", "==", 2)),              # extra term
            E.Not(E.cmp("a", "==", 5)),               # != after push-down
            E.In(E.Col("a"), (2, 5, 9)),              # membership opcode
            E.col_cmp("a", "<", "b"),                 # col-col compare
        ]
        progs = [self._slots(s)[0] for s in structures]
        assert len(set(progs)) == len(progs), \
            "structurally different predicates must map to distinct keys"

    def test_trace_cache_hits_across_windows(self):
        for window_batch in (True, False):
            sess, _ = _mk_session(nrows=4000)
            sess.window_batch = window_batch
            for w in range(3):
                qs = [sess.table("t")
                      .where((c.a > 10 + 7 * i + w) & (c.b < 90 - i - w))
                      .select("a", "b") for i in range(4)]
                m = sess.run_batch(qs, mqo=False).metrics
                if w == 0:
                    assert m.trace_misses > 0       # cold window traces
                else:
                    assert m.trace_misses == 0, \
                        (window_batch, w, m.trace_misses)
                    assert m.trace_hits > 0         # hit rate 1.0


pytestmark = pytest.mark.usefixtures("one_torch_thread")

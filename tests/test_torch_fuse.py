"""Pipeline-fusion correctness: FusedPipeline ≡ the eager executor.

The fusion property (ISSUE 1 acceptance): on ANY Scan→Filter*→Project
chain, over csv and columnar storage, through the Pallas-interpret and
the XLA path, with and without deferred synchronization, the fused
executor's live rows are bit-identical to the seed eager executor's.
Randomization is seeded numpy (hypothesis is optional in this repo).
"""
import numpy as np
import pytest

import repro.relational as R
from repro_torch.relational import (ExecContext, FusedPipeline, I32, Schema,
                                    Session, SessionConfig, execute,
                                    expr as E, fuse_plan, logical as L,
                                    make_storage)
from repro_torch.relational.rules import optimize_single

import torch_properties as props
from torch_fixtures import CPU, build_session, hr_queries
from torch_oracle import execute_oracle, multiset
from torch_parity import assert_parity, host, to_reference
from torch_parity import one_torch_thread  # noqa: F401

SCHEMA = props.FUSE_SCHEMA
_toy = props.toy
_cost_model = props.cost_model
_random_pred = props.random_pred
_random_chain = props.random_chain
_assert_tables_bit_identical = props.assert_tables_bit_identical


class TestFusePass:
    def test_chain_collapses(self):
        plan = (L.scan("t", SCHEMA, "columnar")
                .filter(E.cmp("v", ">", 10)).filter(E.cmp("k", "<", 5))
                .project("k", "v"))
        fused = fuse_plan(plan)
        assert isinstance(fused, FusedPipeline)
        assert fused.n_filters == 2
        assert fused.cols == ("k", "v")
        assert isinstance(fused.source, L.Scan)

    def test_pure_projection_not_fused(self):
        plan = L.scan("t", SCHEMA, "columnar").project("k")
        assert fuse_plan(plan) is plan

    def test_join_blocks_chain_but_inner_chains_fuse(self):
        s2 = Schema.of(("b", I32), ("q", I32))
        left = L.scan("t", SCHEMA, "columnar").filter(E.cmp("v", ">", 10))
        right = L.scan("r", s2, "columnar").filter(E.cmp("q", "<", 5))
        plan = left.join(right, "k", "b").filter(E.cmp("q", ">", 1))
        fused = fuse_plan(plan)
        assert isinstance(fused, L.Filter)          # above the join: eager
        join = fused.child
        assert isinstance(join, L.Join)
        assert all(isinstance(c, FusedPipeline) for c in join.children)

    def test_filter_above_fused_absorbs(self):
        inner = fuse_plan(L.scan("t", SCHEMA, "columnar")
                          .filter(E.cmp("v", ">", 10)).project("k", "v"))
        outer = fuse_plan(L.Filter(child=inner, pred=E.cmp("k", "<", 5)))
        assert isinstance(outer, FusedPipeline)
        assert outer.n_filters == 2
        assert isinstance(outer.source, L.Scan)

    def test_unknown_column_degrades_to_eager(self):
        # hand-built Filter over a Project that dropped the pred column
        plan = L.Filter(child=L.scan("t", SCHEMA, "columnar").project("k"),
                        pred=E.cmp("v", ">", 10))
        assert fuse_plan(plan) is plan


class TestFusedEqualsEager:
    """The acceptance property: fused output ≡ eager output, bit for bit."""

    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    @pytest.mark.parametrize("pallas", [False, True])
    def test_randomized_chains(self, fmt, pallas):
        for st, cols, plan in props.chain_draws(fmt, pallas):
            eager = execute(plan, props.eager_ctx(st, CPU))
            fused = execute(plan, ExecContext(device=CPU,
                catalog={"t": st}, use_pallas_filter=pallas))
            _assert_tables_bit_identical(eager, fused)

    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    @pytest.mark.parametrize("pallas", [False, True])
    def test_randomized_chains_match_the_reference_package(self, fmt,
                                                           pallas):
        """The same draws through the JAX package (its Pallas kernel in
        interpret mode where ``pallas``): eager and fused tables under
        ``torch_parity``'s contract."""
        for st, cols, plan in props.chain_draws(fmt, pallas):
            ref_st, _ = R.make_storage("t", to_reference(st.schema),
                                       st.nrows, fmt, cols=cols)
            ref_plan = to_reference(plan)
            for kw in (dict(fuse=False, defer_sync=False),
                       dict(use_pallas_filter=pallas)):
                want = R.execute(ref_plan, R.ExecContext(
                    catalog={"t": ref_st}, **kw))
                got = execute(plan, ExecContext(
                    device=CPU, catalog={"t": st}, **kw))
                assert_parity(host(want), host(got), f"{kw}\n"
                              + L.explain(plan))

    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    def test_deferred_sync_with_estimates(self, fmt):
        for st, cm, plan in props.deferred_draws(fmt):
            eager = execute(plan, props.eager_ctx(st, CPU))
            fused = execute(plan, ExecContext(device=CPU,
                catalog={"t": st}, cost_model=cm, scan_cache={}))
            _assert_tables_bit_identical(eager, fused)

    def test_estimate_overflow_recompacts(self):
        """A wildly wrong (too small) estimate must not lose rows."""
        # stats built from all-zero columns => selectivity of v>10 ~ 0,
        # while the actual data matches ~99% of rows
        st, cm, plan, _ = list(props.overflow_cases())[0]
        eager = execute(plan, props.eager_ctx(st, CPU))
        fused = execute(plan, ExecContext(device=CPU, catalog={"t": st},
                                          cost_model=cm))
        assert fused.nrows > 700     # the estimate really was wrong
        _assert_tables_bit_identical(eager, fused)

    def test_estimate_overflow_eager_ops(self):
        """Deferred sync on the eager Filter/Join/Aggregate path."""
        st, cm, plan, _ = list(props.overflow_cases())[1]
        eager = execute(plan, props.eager_ctx(st, CPU))
        deferred = execute(plan, ExecContext(device=CPU,
            catalog={"t": st}, cost_model=cm))
        assert eager.row_multiset() == deferred.row_multiset()


class TestScanCache:
    def test_hits_after_first_scan(self):
        st, cols = _toy(nrows=500)
        sc = {}
        plan = (L.scan("t", SCHEMA, "columnar")
                .filter(E.cmp("v", ">", 500)).project("k", "v"))
        ctx1 = ExecContext(device=CPU, catalog={"t": st}, scan_cache=sc)
        a = execute(plan, ctx1)
        assert ctx1.metrics.bytes_read_disk > 0
        assert ctx1.metrics.bytes_scan_cache_read == 0
        ctx2 = ExecContext(device=CPU, catalog={"t": st}, scan_cache=sc)
        b = execute(plan, ctx2)
        assert ctx2.metrics.bytes_read_disk == 0
        assert ctx2.metrics.bytes_scan_cache_read > 0
        _assert_tables_bit_identical(a, b)

    def test_csv_caches_raw_bytes_but_reparses(self):
        st, cols = _toy(nrows=300, fmt="csv")
        sc = {}
        plan = L.scan("t", SCHEMA, "csv").filter(E.cmp("v", ">", 500))
        ctx1 = ExecContext(device=CPU, catalog={"t": st}, scan_cache=sc)
        execute(plan, ctx1)
        parsed_first = ctx1.metrics.bytes_parsed
        ctx2 = ExecContext(device=CPU, catalog={"t": st}, scan_cache=sc)
        execute(plan, ctx2)
        assert ctx2.metrics.bytes_read_disk == 0          # raw bytes cached
        assert ctx2.metrics.bytes_parsed == parsed_first  # parse still paid


class TestSessionEndToEnd:
    """Fused Session ≡ seed-eager Session on the paper's running example
    (joins + aggregates + sorts above the fused leaf chains)."""

    @pytest.mark.parametrize("mqo", [False, True])
    def test_hr_queries_match(self, hr_data, mqo):
        eager_sess = build_session(hr_data)
        eager_sess.fuse = eager_sess.defer_sync = \
            eager_sess.use_scan_cache = False
        fused_sess = build_session(hr_data)
        base = eager_sess.run_batch(hr_queries(eager_sess), mqo=mqo)
        opt = fused_sess.run_batch(hr_queries(fused_sess), mqo=mqo)
        for b, o in zip(base.results, opt.results):
            assert b.table.row_multiset() == o.table.row_multiset()

    def test_second_batch_uses_scan_cache(self, hr_data):
        sess = build_session(hr_data)
        sess.run_batch(hr_queries(sess), mqo=False)
        m = sess.run_batch(hr_queries(sess), mqo=False).metrics
        assert m.bytes_read_disk == 0
        assert m.bytes_scan_cache_read > 0

    def test_mqo_divergent_extraction_is_fused(self):
        from repro_torch.core.plan import walk

        rng = np.random.default_rng(11)
        S = Schema.of(("a", I32), ("b", I32), ("c", I32))
        cols = {c: rng.integers(0, 100, 2000).astype(np.int32)
                for c in ("a", "b", "c")}
        sess = Session.from_config(
            SessionConfig.from_legacy_kwargs(budget_bytes=1 << 24), device=CPU)
        st, _ = make_storage("t", S, 2000, "columnar", cols=cols)
        sess.register(st)
        t = sess.table("t")
        q1 = t.filter(E.cmp("a", ">", 80)).project("a", "b")
        q2 = t.filter(E.cmp("a", "<", 20)).project("a", "c")
        res = sess.run_batch([q1, q2], mqo=True)
        if res.mqo.report.n_selected:
            fused_nodes = [n for p in res.mqo.rewritten.plans
                           for n in walk(p)
                           if isinstance(n, FusedPipeline)]
            assert fused_nodes, "divergent CE residuals should be fused"
        # and of course: results match the no-MQO run
        base = sess.run_batch([q1, q2], mqo=False)
        for b, o in zip(base.results, res.results):
            assert b.table.row_multiset() == o.table.row_multiset()


class TestReviewRegressions:
    def test_fractional_threshold_on_int_column_is_exact(self):
        # values around 2^24, where an f32 promotion would collapse
        # neighboring ints; the engine must fold to an exact int compare
        vals = np.array([2**24 - 1, 2**24, 2**24 + 1, 2**24 + 2, 5],
                        np.int32)
        sch = Schema.of(("v", I32))
        st, _ = make_storage("t", sch, len(vals), "columnar",
                             cols={"v": vals})
        for op, thr, expect in [
            (">", 2**24 + 0.5, {2**24 + 1, 2**24 + 2}),
            ("<=", 2**24 + 0.5, {2**24 - 1, 2**24, 5}),
            ("==", 10.5, set()),
            ("!=", 10.5, set(int(v) for v in vals)),
        ]:
            plan = L.scan("t", sch, "columnar").filter(E.cmp("v", op, thr))
            for ctx in (ExecContext(device=CPU, catalog={"t": st}, fuse=False,
                                    defer_sync=False),
                        ExecContext(device=CPU, catalog={"t": st}),
                        ExecContext(device=CPU, catalog={"t": st},
                                    use_pallas_filter=True)):
                got = {r[0] for r in execute(plan, ctx).row_multiset()}
                assert got == expect, (op, thr, got)

    def test_kernel_supports_string_colcol_with_schema(self):
        from repro_torch.kernels.filter_project.ops import kernel_supports

        pred = E.col_cmp("s1", "==", "s2")
        # without dtype info the name-only check cannot reject it...
        assert kernel_supports(pred)
        # ...but with the schema's numeric column set it must
        assert not kernel_supports(pred, numeric_cols=("k", "v"))
        assert kernel_supports(E.col_cmp("k", "<", "v"),
                               numeric_cols=("k", "v"))

    def test_gross_overestimate_shrinks_capacity(self):
        """An est-padded buffer must not outlive the operator: a result
        with ~0 rows keeps a tight capacity even when the estimate said
        20% of the table (else cached CEs are charged padded nbytes)."""
        st, cols = _toy(nrows=100_000, seed=9)
        cm = _cost_model(cols, 100_000)
        # contradiction: est ~ sel(v>500)*sel(v<400)*n >> 0, actual 0
        plan = (L.scan("t", SCHEMA, "columnar")
                .filter(E.and_(E.cmp("v", ">", 500), E.cmp("v", "<", 400)))
                .project("k", "v"))
        out = execute(plan, ExecContext(device=CPU, catalog={"t": st},
                                        cost_model=cm))
        assert out.nrows == 0
        assert out.capacity <= 2    # not the est-sized padded buffer
        eager = execute(plan, ExecContext(device=CPU,
            catalog={"t": st}, fuse=False, defer_sync=False))
        _assert_tables_bit_identical(eager, out)

    def test_register_invalidates_scan_cache(self):
        nrows = 256   # == capacity, so the cache key is identical
        sch = Schema.of(("v", I32))
        v1 = np.arange(nrows, dtype=np.int32)
        v2 = v1 + 10_000
        sess = Session.from_config(
            SessionConfig.from_legacy_kwargs(budget_bytes=1 << 24), device=CPU)
        st1, _ = make_storage("t", sch, nrows, "columnar", cols={"v": v1})
        sess.register(st1, columnar_for_stats={"v": v1})
        q = sess.table("t").filter(E.cmp("v", ">=", 0))
        first = sess.run_batch([q], mqo=False).results[0].table.to_numpy()
        np.testing.assert_array_equal(first["v"], v1)
        st2, _ = make_storage("t", sch, nrows, "columnar", cols={"v": v2})
        sess.register(st2, columnar_for_stats={"v": v2})
        q2 = sess.table("t").filter(E.cmp("v", ">=", 0))
        second = sess.run_batch([q2], mqo=False).results[0].table.to_numpy()
        np.testing.assert_array_equal(second["v"], v2)


class TestUnionDeferred:
    """Satellite (ISSUE 2): Union sizes its output from the sum of the
    input cardinality estimates and compacts every column in one fused
    dispatch — results must stay bit-identical to the seed eager path
    (per-column argsort compaction, exact sizing)."""

    def test_randomized_unions_match_eager(self):
        for st, cm, plan in props.union_draws():
            eager = execute(plan, props.eager_ctx(st, CPU))
            fused = execute(plan, ExecContext(device=CPU,
                catalog={"t": st}, cost_model=cm))
            _assert_tables_bit_identical(eager, fused)

    def test_empty_sides(self):
        st, cols = _toy(nrows=200, seed=1)
        cm = _cost_model(cols, 200)
        empty = (L.scan("t", SCHEMA, "columnar")
                 .filter(E.and_(E.cmp("v", ">", 2000)))   # matches nothing
                 .project("k", "v"))
        full = (L.scan("t", SCHEMA, "columnar")
                .filter(E.cmp("v", ">=", 0)).project("k", "v"))
        for plan in (empty.union(full), full.union(empty),
                     empty.union(empty)):
            eager = execute(plan, ExecContext(device=CPU,
                catalog={"t": st}, fuse=False, defer_sync=False))
            fused = execute(plan, ExecContext(device=CPU,
                catalog={"t": st}, cost_model=cm))
            _assert_tables_bit_identical(eager, fused)


class TestLocalOptimizerChains:
    """optimize_single output (the MQO input shape) also fuses cleanly."""

    def test_optimized_plan_fuses_and_matches(self):
        st, cols = _toy(nrows=600, seed=8)
        plan = (L.scan("t", SCHEMA, "columnar")
                .project("k", "v", "x")
                .filter(E.and_(E.cmp("v", ">", 100), E.cmp("x", "<", 0.9)))
                .project("k", "v"))
        opt = optimize_single(plan)
        eager = execute(opt, ExecContext(device=CPU,
            catalog={"t": st}, fuse=False, defer_sync=False))
        fused = execute(opt, ExecContext(device=CPU, catalog={"t": st}))
        _assert_tables_bit_identical(eager, fused)


class TestInListCoverage:
    """Satellite (ISSUE 7): ``In``-list membership runs through the
    postfix programs — every kernel route must match the eager/XLA
    oracle bit for bit, including fractional and out-of-range list
    values against integer columns."""

    def _contexts(self, st, pallas):
        return (
            ExecContext(device=CPU, catalog={"t": st}),   # slotted XLA
            ExecContext(device=CPU, catalog={"t": st},
                        shape_cache=False),               # literal jit
            ExecContext(device=CPU, catalog={"t": st},
                        use_pallas_filter=pallas),
        )

    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    @pytest.mark.parametrize("pallas", [False, True])
    def test_randomized_in_lists(self, fmt, pallas):
        for case in range(4 if pallas else 8):
            rng = np.random.default_rng(4000 + 10 * case + (fmt == "csv"))
            nrows = int(rng.integers(3, 900))
            st, cols = _toy(nrows=nrows, seed=case, fmt=fmt)
            vals = tuple(int(v) for v in
                         rng.integers(0, 20, int(rng.integers(1, 6))))
            pred: E.Expr = E.In(E.Col("k"), vals)
            in_only = not rng.integers(0, 2)
            if not in_only:
                pred = E.and_(pred, _random_pred(rng, {"k", "v", "x"}))
            plan = L.scan("t", SCHEMA, fmt).filter(pred).project("k", "v")
            eager = execute(plan, ExecContext(device=CPU,
                catalog={"t": st}, fuse=False, defer_sync=False))
            if in_only:      # numpy oracle for the membership itself
                keep = np.isin(cols["k"], np.asarray(vals, np.int32))
                assert eager.nrows == int(keep.sum())
            for ctx in self._contexts(st, pallas):
                _assert_tables_bit_identical(eager, execute(plan, ctx))

    @pytest.mark.parametrize("pallas", [False, True])
    def test_in_list_edge_values(self, pallas):
        # fractional values never equal an int column; out-of-range
        # values never equal; duplicates are harmless
        st, cols = _toy(nrows=400, seed=5)
        vals = (3, 3, 7.0, 7.5, 2**40, -2**40, 11)
        plan = (L.scan("t", SCHEMA, "columnar")
                .filter(E.In(E.Col("k"), vals)).project("k", "v"))
        expect = np.isin(cols["k"], np.asarray([3, 7, 11], np.int32))
        eager = execute(plan, ExecContext(device=CPU,
            catalog={"t": st}, fuse=False, defer_sync=False))
        assert eager.nrows == int(expect.sum())
        for ctx in self._contexts(st, pallas):
            _assert_tables_bit_identical(eager, execute(plan, ctx))


class TestI64Coverage:
    """Satellite (ISSUE 7): int64 columns (columnar-only)
    through every filter route — values beyond 2^32 must compare
    exactly (an f32/i32 downcast would collapse them).  torch has int64
    without a flag (the JAX package's copy needs x64 mode); each route
    is also held against the port's numpy oracle."""

    def _i64_case(self, nrows, seed):
        from repro_torch.relational import I64
        rng = np.random.default_rng(seed)
        sch = Schema.of(("big", I64), ("v", I32))
        cols = {
            "big": rng.integers(1, 1 << 40, nrows).astype(np.int64),
            "v": rng.integers(0, 1000, nrows).astype(np.int32),
        }
        st, _ = make_storage("t", sch, nrows, "columnar", cols=cols)
        return sch, st, cols

    @pytest.mark.parametrize("pallas", [False, True])
    def test_i64_filter_matches_oracle(self, pallas):
        for case in range(4):
            sch, st, cols = self._i64_case(600, 6000 + case)
            thr = int(np.median(cols["big"]))
            pred = E.and_(E.cmp("big", ">", thr),
                          E.cmp("v", "<", 700))
            plan = (L.scan("t", sch, "columnar")
                    .filter(pred).project("big", "v"))
            expect = (cols["big"] > thr) & (cols["v"] < 700)
            eager = execute(plan, ExecContext(
                device=CPU, catalog={"t": st}, fuse=False,
                defer_sync=False))
            assert eager.nrows == int(expect.sum())
            np.testing.assert_array_equal(
                np.sort(eager.to_numpy()["big"]),
                np.sort(cols["big"][expect]))
            assert eager.row_multiset() == multiset(
                execute_oracle(plan, {"t": (sch, 600, cols)}), plan.schema)
            for ctx in (ExecContext(device=CPU, catalog={"t": st}),
                        ExecContext(device=CPU, catalog={"t": st},
                                    shape_cache=False),
                        ExecContext(device=CPU, catalog={"t": st},
                                    use_pallas_filter=pallas)):
                _assert_tables_bit_identical(eager, execute(plan, ctx))

    def test_i64_in_list_exact_beyond_2_53(self):
        # neighbors beyond 2^53 are indistinguishable even in f64 — the
        # membership compare must stay integer-exact
        from repro_torch.relational import I64
        base = (1 << 53) + 2
        vals = np.array([base - 1, base, base + 1, 5], np.int64)
        sch = Schema.of(("big", I64))
        st, _ = make_storage("t", sch, len(vals), "columnar",
                             cols={"big": vals})
        plan = (L.scan("t", sch, "columnar")
                .filter(E.In(E.Col("big"), (int(base),))))
        for ctx in (ExecContext(device=CPU, catalog={"t": st}),
                    ExecContext(device=CPU, catalog={"t": st}, fuse=False,
                                defer_sync=False)):
            out = execute(plan, ctx)
            assert out.nrows == 1
            assert int(out.to_numpy()["big"][0]) == base


class TestWindowBatchIdentity:
    """Tentpole acceptance (ISSUE 7): a window executed as batched
    shared dispatches is BIT-identical to per-query dispatch — over
    both storage formats, both kernel routes, and mixed windows where
    only a subset of the plans share a template."""

    def _sessions(self, pallas):
        return props.window_sessions(self.fmt, pallas, CPU)

    def _mixed_window(self, sess, w):
        return props.mixed_window(sess, w)

    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    @pytest.mark.parametrize("pallas", [False, True])
    def test_mixed_window_bit_identical(self, fmt, pallas):
        self.fmt = fmt
        batched, perq = self._sessions(pallas)
        for w in range(3):
            rb = batched.run_batch(self._mixed_window(batched, w),
                                   mqo=False)
            rp = perq.run_batch(self._mixed_window(perq, w), mqo=False)
            assert rb.metrics.batched_dispatches >= 1
            assert rb.metrics.batched_queries == 4
            for a, b in zip(rb.results, rp.results):
                _assert_tables_bit_identical(a.table, b.table)

    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    def test_all_singletons_stay_per_query(self, fmt):
        self.fmt = fmt
        batched, perq = self._sessions(False)
        t = lambda s: s.table("t")
        mk = lambda s: [t(s).filter(E.cmp("v", ">", 500)).project("k"),
                        t(s).filter(E.cmp("x", "<", 0.4)).project("x"),
                        s.table("r").filter(E.cmp("k", "<", 9))
                        .project("k", "v")]
        rb = batched.run_batch(mk(batched), mqo=False)
        rp = perq.run_batch(mk(perq), mqo=False)
        assert rb.metrics.batched_dispatches == 0   # no shared template
        for a, b in zip(rb.results, rp.results):
            _assert_tables_bit_identical(a.table, b.table)


pytestmark = pytest.mark.usefixtures("one_torch_thread")

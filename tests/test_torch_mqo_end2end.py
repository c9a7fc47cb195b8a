"""End-to-end MQO invariants.

The system's core guarantee: for ANY batch of queries and ANY memory
budget, the MQO-rewritten batch produces EXACTLY the same result
multisets as independent execution — worksharing must never change
semantics.  Property-tested over random schemas/predicates/workloads.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

import repro.relational as R
from repro.core.fingerprint import strict_fingerprint as j_strict
from repro_torch.core.fingerprint import strict_fingerprint as t_strict
from repro_torch.relational import expr as E, logical as L
from torch_parity import assert_parity, host, to_reference

import torch_properties as props
from torch_fixtures import CPU, build_session, hr_queries
from torch_fixtures import hr_session  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401


def _assert_batches_equal(base, opt):
    assert len(base.results) == len(opt.results)
    for i, (b, o) in enumerate(zip(base.results, opt.results)):
        assert b.table.row_multiset() == o.table.row_multiset(), \
            f"query {i} diverged under MQO"


class TestRunningExample:
    """The paper's §3 example: 3 HR queries, 4 SEs (ψ1..ψ4)."""

    def test_identifies_paper_ses(self, hr_session):
        res = hr_session.run_batch(hr_queries(hr_session), mqo=True)
        r = res.mqo.report
        assert r.n_ses >= 4      # ψ1..ψ4 (plus scan-level SEs)
        assert r.n_selected >= 1
        assert r.selected_weight <= r.budget

    @pytest.mark.parametrize("budget_kb", [1, 64, 1024, 1 << 20])
    def test_results_identical_any_budget(self, hr_session, budget_kb):
        qs = hr_queries(hr_session)
        base = hr_session.run_batch(qs, mqo=False)
        opt = hr_session.run_batch(qs, mqo=True,
                                   budget_bytes=budget_kb * 1024)
        _assert_batches_equal(base, opt)

    def test_csv_format_identical(self, hr_data):
        sess = build_session(hr_data, fmt="csv")
        qs = hr_queries(sess)
        base = sess.run_batch(qs, mqo=False)
        opt = sess.run_batch(qs, mqo=True)
        _assert_batches_equal(base, opt)

    def test_fullcache_baseline_identical(self, hr_session):
        qs = hr_queries(hr_session)
        base = hr_session.run_batch(qs, mqo=False)
        fc = hr_session.run_batch_fullcache(qs)
        _assert_batches_equal(base, fc)

    def test_budget_respected(self, hr_session):
        res = hr_session.run_batch(hr_queries(hr_session), mqo=True,
                                   budget_bytes=256 * 1024)
        assert res.mqo.report.selected_weight <= 256 * 1024


class TestExtractionSafety:
    """Divergent filters below aggregates/limits must not be merged."""

    def test_aggregate_above_divergent_filters(self, hr_session):
        sal = hr_session.table("salaries")
        q1 = (sal.filter(E.cmp("salary", ">", 50_000))
              .groupby("from_year").agg(("n", "count", "")))
        q2 = (sal.filter(E.cmp("salary", ">", 20_000))
              .groupby("from_year").agg(("n", "count", "")))
        base = hr_session.run_batch([q1, q2], mqo=False)
        opt = hr_session.run_batch([q1, q2], mqo=True)
        _assert_batches_equal(base, opt)

    def test_equal_aggregates_do_share(self, hr_session):
        sal = hr_session.table("salaries")

        def q():
            return (sal.filter(E.cmp("salary", ">", 50_000))
                    .groupby("from_year").agg(("n", "count", "")))

        res = hr_session.run_batch([q(), q()], mqo=True)
        assert res.mqo.report.n_selected >= 1
        _assert_batches_equal(hr_session.run_batch([q(), q()], mqo=False),
                              res)

    def test_limit_above_divergent_filters(self, hr_session):
        sal = hr_session.table("salaries")
        q1 = sal.filter(E.cmp("salary", ">", 60_000)).sort("salary").limit(5)
        q2 = sal.filter(E.cmp("salary", ">", 10_000)).sort("salary").limit(5)
        base = hr_session.run_batch([q1, q2], mqo=False)
        opt = hr_session.run_batch([q1, q2], mqo=True)
        # limits have unspecified tie order; counts must match and each
        # result must still satisfy its own predicate
        for b, o in zip(base.results, opt.results):
            assert b.table.nrows == o.table.nrows


# ---------------------------------------------------------------------------
# property-based workload fuzzing
# ---------------------------------------------------------------------------
_COLS = ["c0", "c1", "c2"]


@st.composite
def _pred(draw, depth=0):
    kind = draw(st.sampled_from(
        ["cmp", "cmp", "cmp", "and", "or"] if depth < 2 else ["cmp"]))
    if kind == "cmp":
        return E.cmp(draw(st.sampled_from(_COLS)),
                     draw(st.sampled_from(["<", "<=", ">", ">=", "==",
                                           "!="])),
                     int(draw(st.integers(0, 60))))
    parts = draw(st.lists(_pred(depth=depth + 1), min_size=2, max_size=3))
    return (E.and_ if kind == "and" else E.or_)(*parts)


@st.composite
def _query(draw):
    base = L.scan("ft", _FUZZ_SCHEMA)
    q = base.filter(draw(_pred()))
    if draw(st.booleans()):
        cols = draw(st.lists(st.sampled_from(_COLS + ["c3"]), min_size=1,
                             max_size=4, unique=True))
        q = q.project(*cols)
    shape = draw(st.sampled_from(["plain", "plain", "agg", "sort", "join"]))
    if shape == "agg" and q.schema.has("c0"):
        aggs = [("n", "count", "")]
        if q.schema.has("c3"):
            aggs.append(("s3", "sum", "c3"))
        q = q.groupby("c0").agg(*aggs)
    elif shape == "sort" and q.schema.has("c1"):
        q = q.sort("c1", desc=draw(st.booleans()))
    elif shape == "join" and q.schema.has("c0"):
        other = L.scan("dim", _DIM_SCHEMA).filter(
            E.cmp("d1", draw(st.sampled_from([">", "<"])),
                  int(draw(st.integers(0, 60)))))
        q = q.join(other, "c0", "d0")
    return q


_FUZZ_SCHEMA = props.FUZZ_SCHEMA
_DIM_SCHEMA = props.DIM_SCHEMA


@pytest.fixture(scope="module")
def fuzz_session():
    return props.fuzz_session(CPU)


@pytest.fixture(scope="module")
def fuzz_pair():
    """A port session and the JAX package's over the fuzz tables, only
    ever given the same batches, so that their retained CEs agree."""
    ref = R.Session.from_config(
        R.SessionConfig.from_legacy_kwargs(budget_bytes=1 << 24))
    for name, (schema, n, cols) in props.fuzz_catalog().items():
        st, _ = R.make_storage(name, to_reference(schema), n, "columnar",
                               cols=cols)
        ref.register(st)
    return props.fuzz_session(CPU), ref


def _assert_reference_parity(pair, queries, budget_log2):
    """The port's batches (no MQO, then MQO at 2^budget_log2 bytes)
    against the JAX package's on the same plans (``torch_parity``'s
    contract): tables, and the MQO run's SEs, CEs and MCKP choice
    exactly.  Returns the port's two results."""
    port, ref = pair
    ref_q = [to_reference(q) for q in queries]
    out = []
    for mqo in (False, True):
        kw = dict(budget_bytes=1 << budget_log2) if mqo else {}
        got = port.run_batch(queries, mqo=mqo, **kw)
        want = ref.run_batch(ref_q, mqo=mqo, **kw)
        for i, (w, g) in enumerate(zip(want.results, got.results)):
            assert_parity(host(w.table), host(g.table),
                          f"query {i} mqo={mqo}\n" + L.explain(queries[i]))
        assert props.batch_decisions(got, t_strict) == \
            props.batch_decisions(want, j_strict)
        out.append(got)
    return out


class TestPropertyMQONeverChangesResults:
    @settings(max_examples=25, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(queries=st.lists(_query(), min_size=2, max_size=5),
           budget_log2=st.integers(10, 24))
    def test_rewritten_equals_baseline(self, fuzz_session, queries,
                                       budget_log2):
        base = fuzz_session.run_batch(queries, mqo=False)
        opt = fuzz_session.run_batch(queries, mqo=True,
                                     budget_bytes=1 << budget_log2)
        for i, (b, o) in enumerate(zip(base.results, opt.results)):
            assert b.table.row_multiset() == o.table.row_multiset(), \
                f"query {i} diverged (budget=2^{budget_log2})\n" + \
                L.explain(queries[i])
        assert opt.mqo.report.selected_weight <= (1 << budget_log2)


    @settings(max_examples=25, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(queries=st.lists(_query(), min_size=2, max_size=5),
           budget_log2=st.integers(10, 24))
    def test_matches_the_reference_package(self, fuzz_pair, queries,
                                           budget_log2):
        _assert_reference_parity(fuzz_pair, queries, budget_log2)


class TestPropertyMQONeverChangesResultsSeeded:
    """Seeded draws from the same space (``torch_properties.fuzz_batches``,
    the batches ``chip_smoke.py``'s phase P runs on the card), each
    also held against the JAX package."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_rewritten_equals_baseline(self, fuzz_pair, seed):
        for queries, budget_log2 in props.fuzz_batches(seed, 8):
            base, opt = _assert_reference_parity(fuzz_pair, queries,
                                                 budget_log2)
            for i, (b, o) in enumerate(zip(base.results, opt.results)):
                assert b.table.row_multiset() == o.table.row_multiset(), \
                    f"query {i} diverged (budget=2^{budget_log2})\n" + \
                    L.explain(queries[i])
            assert opt.mqo.report.selected_weight <= (1 << budget_log2)


class TestPropertyServiceEqualsOneShot:
    """ISSUE 3: the online QueryService is the same machinery as
    run_batch — for ANY workload and ANY window size, submitting the
    queries one at a time and letting windows close must produce the
    same result per query as the legacy one-shot batch."""

    @settings(max_examples=15, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(queries=st.lists(_query(), min_size=2, max_size=6),
           max_batch=st.integers(1, 6))
    def test_windowed_submit_equals_run_batch(self, fuzz_session,
                                              queries, max_batch):
        from repro_torch.relational import QueryService

        base = fuzz_session.run_batch(queries, mqo=True)
        svc = QueryService(fuzz_session, max_batch=max_batch)
        handles = [svc.submit(q) for q in queries]
        svc.flush()                       # close the trailing window
        for i, (b, h) in enumerate(zip(base.results, handles)):
            assert h.done
            assert b.table.row_multiset() == h.result().row_multiset(), \
                f"query {i} diverged (window={max_batch})\n" + \
                L.explain(queries[i])

    @settings(max_examples=10, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(queries=st.lists(_query(), min_size=2, max_size=4))
    def test_pre_closed_window_bit_identical(self, fuzz_session, queries):
        """submit-then-flush in one window vs run_batch on the same
        plans: exactly equal arrays, not just equal multisets."""
        from repro_torch.relational import QueryService

        batch = fuzz_session.run_batch(queries, mqo=True)
        svc = QueryService(fuzz_session, max_batch=len(queries) + 1)
        handles = [svc.submit(q) for q in queries]
        svc.flush()
        for qr, h in zip(batch.results, handles):
            ta, tb = qr.table, h.result()
            assert ta.nrows == tb.nrows
            assert ta.schema.names == tb.schema.names
            for n in ta.schema.names:
                assert np.array_equal(
                    np.asarray(ta.columns[n])[: ta.nrows],
                    np.asarray(tb.columns[n])[: tb.nrows]), n


pytestmark = pytest.mark.usefixtures("one_torch_thread")

"""Semantic subsumption + pid bitset pool (ISSUE 8).

Covers:
  * the ONE shared integer-threshold fold (``expr.fold_int_cmp``): a
    single case table pinned against every call site — the direct fold,
    interval normalization, and partition pruning — plus semantic
    ground truth via ``eval_expr`` (the three sites must never drift);
  * ``normalize_intervals`` unit semantics (range-merge, inclusive
    integer bounds, contradiction → FALSE, identity preservation);
  * ``subsumes`` / ``subsumption_residual`` unit semantics;
  * ``PidPool`` unit behavior (record / intersect / implies-closure /
    layout mismatch / invalidation / bytes accounting);
  * hypothesis properties:
      - the interval-normalized predicate selects the SAME rows as the
        raw spelling on random data,
      - pid-bitset-pruned execution is bit-identical to unpruned over
        both partition schemes x both storage formats,
      - a subsumption-resumed query returns exactly the rows of a
        from-scratch run;
  * service integration: ``explain()`` reports ``subsumption_hit`` /
    ``pid_pruned_parts``; the ``mqo.subsumption`` and
    ``execution.pid_cache`` knobs disable each channel independently.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.memory import MemoryManager, PidPool
from repro_torch.relational import (ExecutionConfig, I32, F32, MemoryConfig,
                                    MqoConfig, Partitioning, QueryService,
                                    Schema, Session, SessionConfig, expr as E,
                                    make_storage)
from repro_torch.relational.canonical import (FALSE, canonicalize_expr,
                                              is_false, is_true,
                                              normalize_intervals, subsumes,
                                              subsumption_residual)
from repro_torch.relational.datagen import generate_columns, synthetic_schema
from repro_torch.relational.partition import partition_table, prune_parts

from torch_fixtures import CPU
from torch_parity import one_torch_thread  # noqa: F401


INT_SCHEMA = Schema.of(("a", I32), ("b", I32), ("f", F32))

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _canon(pred):
    return E.canonical(canonicalize_expr(pred))


def _norm(pred, schema=INT_SCHEMA):
    return normalize_intervals(canonicalize_expr(pred), schema)


# ---------------------------------------------------------------------------
# the shared integer-threshold fold: ONE case table, every call site
# ---------------------------------------------------------------------------
# (op, fractional threshold, expected fold_int_cmp result).  All three
# consumers — eval_expr's exact compare lowering, partition pruning's
# per-partition maybe-check, and canonical interval normalization —
# route through expr.fold_int_cmp; this table pins them together.
FOLD_CASES = [
    (">", 10.5, ("cmp", ">", 10)),      # a > 10.5  ⟺  a > 10
    (">=", 10.5, ("cmp", ">=", 11)),    # a >= 10.5 ⟺  a >= 11
    ("<", 10.5, ("cmp", "<", 11)),      # a < 10.5  ⟺  a < 11
    ("<=", 10.5, ("cmp", "<=", 10)),    # a <= 10.5 ⟺  a <= 10
    (">", -0.5, ("cmp", ">", -1)),
    ("<", -0.5, ("cmp", "<", 0)),
    ("==", 10.5, ("all", False)),       # an int never equals a fraction
    ("!=", 10.5, ("all", True)),
    # thresholds beyond the i32 range saturate to a constant
    ("<", -3000000000.5, ("all", False)),
    (">", -3000000000.5, ("all", True)),
    ("<=", 3000000000.5, ("all", True)),
    (">=", 3000000000.5, ("all", False)),
]


def _inclusive(op, b):
    """The inclusive integer spelling interval normalization emits."""
    if op == ">":
        return (">=", b + 1)
    if op == "<":
        return ("<=", b - 1)
    return (op, b)


class TestSharedFoldCaseTable:
    @pytest.mark.parametrize("op,v,expect", FOLD_CASES)
    def test_direct_fold(self, op, v, expect):
        assert E.fold_int_cmp(op, v, bits=32) == expect

    @pytest.mark.parametrize("op,v,expect", FOLD_CASES)
    def test_fold_is_semantically_exact(self, op, v, expect):
        # ground truth: the folded compare selects the same int32 values
        a = np.array([-(1 << 31), -12, -1, 0, 1, 10, 11, 12,
                      (1 << 31) - 1], dtype=np.int64)
        npop = {"<": np.less, "<=": np.less_equal, ">": np.greater,
                ">=": np.greater_equal, "==": np.equal,
                "!=": np.not_equal}
        raw = npop[op](a.astype(np.float64), v)
        if expect[0] == "all":
            assert bool(raw.all()) == expect[1]
            assert bool(raw.any()) == expect[1]
        else:
            _, op2, b = expect
            assert np.array_equal(raw, npop[op2](a, b))

    @pytest.mark.parametrize("op,v,expect", FOLD_CASES)
    def test_normalize_intervals_site(self, op, v, expect):
        norm = _norm(E.cmp("a", op, v))
        if expect == ("all", True):
            assert is_true(norm)
        elif expect == ("all", False):
            assert is_false(norm)
        else:
            _, op2, b = expect
            op3, b3 = _inclusive(op2, b)
            assert E.canonical(norm) == _canon(E.cmp("a", op3, b3))

    @pytest.mark.parametrize("op,v,expect",
                             [c for c in FOLD_CASES if c[2][0] == "cmp"])
    def test_prune_parts_site(self, op, v, expect):
        # pruning the fractional spelling == pruning the folded spelling
        rng = np.random.default_rng(3)
        cols = {"n1": rng.integers(-40, 60, 4000).astype(np.int32)}
        _, _, info = partition_table(Partitioning("n1", "range", 8),
                                     4000, cols)
        _, op2, b = expect
        raw = set(prune_parts(E.cmp("n1", op, v), info))
        folded = set(prune_parts(E.cmp("n1", op2, b), info))
        assert raw == folded


# ---------------------------------------------------------------------------
# interval normal form (unit)
# ---------------------------------------------------------------------------
class TestNormalizeIntervals:
    def test_range_merge_keeps_tightest(self):
        p = _norm(E.and_(E.cmp("a", ">", 5), E.cmp("a", ">", 3)))
        assert E.canonical(p) == _canon(E.cmp("a", ">=", 6))

    def test_strict_int_bounds_become_inclusive(self):
        assert E.canonical(_norm(E.cmp("a", ">", 5))) == \
            _canon(E.cmp("a", ">=", 6))
        assert E.canonical(_norm(E.cmp("a", "<", 5))) == \
            _canon(E.cmp("a", "<=", 4))

    def test_contradiction_collapses_to_false(self):
        assert is_false(_norm(E.and_(E.cmp("a", ">", 5),
                                     E.cmp("a", "<", 3))))
        # adjacent strict bounds over ints: nothing between 5 and 6
        assert is_false(_norm(E.and_(E.cmp("a", ">", 5),
                                     E.cmp("a", "<", 6))))
        assert is_false(_norm(E.and_(E.cmp("a", "==", 2),
                                     E.cmp("a", "==", 3))))

    def test_degenerate_interval_becomes_eq(self):
        p = _norm(E.and_(E.cmp("a", ">=", 5), E.cmp("a", "<=", 5)))
        assert E.canonical(p) == _canon(E.cmp("a", "==", 5))

    def test_eq_absorbs_consistent_bounds(self):
        p = _norm(E.and_(E.cmp("a", "==", 7), E.cmp("a", ">", 2)))
        assert E.canonical(p) == _canon(E.cmp("a", "==", 7))

    def test_neq_outside_interval_is_dropped(self):
        p = _norm(E.and_(E.cmp("a", ">=", 5), E.cmp("a", "!=", 3)))
        assert E.canonical(p) == _canon(E.cmp("a", ">=", 5))

    def test_float_bounds_stay_strict(self):
        p = _norm(E.and_(E.cmp("f", ">", 0.5), E.cmp("f", ">", 0.25)))
        assert E.canonical(p) == _canon(E.cmp("f", ">", 0.5))

    def test_untouched_pred_preserves_identity(self):
        p = canonicalize_expr(E.and_(E.cmp("a", ">=", 5),
                                     E.cmp("b", "<=", 9)))
        assert normalize_intervals(p, INT_SCHEMA) is p

    def test_other_columns_kept_verbatim(self):
        p = _norm(E.and_(E.cmp("a", ">", 5), E.cmp("a", ">", 3),
                         E.cmp("b", "<", 9)))
        assert E.canonical(p) == _canon(E.and_(E.cmp("a", ">=", 6),
                                               E.cmp("b", "<=", 8)))


# ---------------------------------------------------------------------------
# subsumption (unit)
# ---------------------------------------------------------------------------
class TestSubsumption:
    S = INT_SCHEMA

    def test_conjunct_superset_subsumed(self):
        p = E.cmp("a", ">", 5)
        q = E.and_(E.cmp("a", ">", 5), E.cmp("b", "<", 3))
        assert subsumes(p, q, self.S)
        resid = subsumption_residual(p, q, self.S)
        # the residual comes back interval-normalized: b < 3 ⟺ b <= 2
        assert E.canonical(resid) == E.canonical(_norm(E.cmp("b", "<", 3)))
        # not symmetric: q has rows p lacks? no — p has rows q lacks
        assert not subsumes(q, p, self.S)

    def test_interval_containment_subsumed(self):
        p, q = E.cmp("a", ">=", 5), E.cmp("a", ">", 7)
        assert subsumes(p, q, self.S)
        resid = subsumption_residual(p, q, self.S)
        assert E.canonical(resid) == _canon(E.cmp("a", ">=", 8))
        assert not subsumes(q, p, self.S)

    def test_equal_preds_residual_true(self):
        p = E.and_(E.cmp("a", ">", 5), E.cmp("b", "<", 3))
        q = E.and_(E.cmp("b", "<", 3), E.cmp("a", ">", 5))
        assert is_true(subsumption_residual(p, q, self.S))

    def test_fractional_thresholds_fold_before_deciding(self):
        assert subsumes(E.cmp("a", ">", 4.5), E.cmp("a", ">=", 6), self.S)
        assert not subsumes(E.cmp("a", ">", 4.5), E.cmp("a", ">=", 4),
                            self.S)

    def test_contradictory_query_residual_false(self):
        q = E.and_(E.cmp("a", ">", 5), E.cmp("a", "<", 3))
        resid = subsumption_residual(E.cmp("b", ">", 0), q, self.S)
        assert resid is not None and is_false(resid)

    def test_eq_inside_interval_subsumed(self):
        p = E.and_(E.cmp("a", ">=", 5), E.cmp("a", "<=", 10))
        q = E.cmp("a", "==", 7)
        assert subsumes(p, q, self.S)
        assert E.canonical(subsumption_residual(p, q, self.S)) == \
            _canon(E.cmp("a", "==", 7))

    def test_in_membership_subsumed(self):
        p = E.isin("a", [1, 2, 3])
        q = E.isin("a", [1, 2])
        assert subsumes(p, q, self.S)
        assert not subsumes(q, p, self.S)

    def test_non_numeric_atoms_need_exact_match(self):
        # column-column compares are only implied by an exact canonical
        # match of the same atom
        p = E.col_cmp("a", "<", "b")
        q = E.and_(E.col_cmp("a", "<", "b"), E.cmp("a", ">", 5))
        assert subsumes(p, q, self.S)
        assert not subsumes(E.col_cmp("a", "<", "b"),
                            E.cmp("a", ">", 5), self.S)

    def test_disjoint_columns_not_subsumed(self):
        assert not subsumes(E.cmp("a", ">", 5), E.cmp("b", ">", 5), self.S)

    def test_or_pred_needs_exact_match(self):
        p = E.or_(E.cmp("a", ">", 5), E.cmp("b", ">", 5))
        q = E.and_(E.or_(E.cmp("a", ">", 5), E.cmp("b", ">", 5)),
                   E.cmp("a", "<", 100))
        assert subsumes(p, q, self.S)
        # a bare disjunct does NOT imply the disjunction's atom-set
        # conservatively? it does semantically, but the decision is
        # conservative — must simply never claim an unsound direction
        assert not subsumes(q, p, self.S)


# ---------------------------------------------------------------------------
# PidPool (unit)
# ---------------------------------------------------------------------------
class TestPidPool:
    def _pool(self, budget=1 << 16):
        return PidPool(MemoryManager(budget, host_budget=budget))

    def test_record_then_exact_intersect(self):
        pool = self._pool()
        pred = E.cmp("a", ">", 5)
        key = E.canonical(pred)
        pool.record("t", key, pred, 8, present=(1, 3))
        live, hits = pool.intersect("t", key, pred, 8,
                                    live=range(8))
        assert hits == 1 and live == (1, 3)
        assert pool.contains("t", key)

    def test_implies_closure_prunes_stronger_query(self):
        pool = self._pool()
        weak = E.cmp("a", ">", 5)
        pool.record("t", E.canonical(weak), weak, 8, present=(2, 5))
        strong = E.and_(E.cmp("a", ">", 5), E.cmp("b", "<", 3))
        live, hits = pool.intersect(
            "t", E.canonical(strong), strong, 8, live=range(8),
            implies=lambda p, q: subsumes(p, q, INT_SCHEMA))
        assert hits == 1 and live == (2, 5)
        # without the implies closure a different key finds nothing
        live2, hits2 = pool.intersect(
            "t", E.canonical(strong), strong, 8, live=range(8))
        assert hits2 == 0 and live2 == tuple(range(8))

    def test_layout_mismatch_skipped(self):
        pool = self._pool()
        pred = E.cmp("a", ">", 5)
        key = E.canonical(pred)
        pool.record("t", key, pred, 8, present=(1,))
        live, hits = pool.intersect("t", key, pred, 16, live=range(16))
        assert hits == 0 and live == tuple(range(16))

    def test_other_table_never_consulted(self):
        pool = self._pool()
        pred = E.cmp("a", ">", 5)
        key = E.canonical(pred)
        pool.record("t", key, pred, 8, present=(1,))
        live, hits = pool.intersect("u", key, pred, 8, live=range(8))
        assert hits == 0 and live == tuple(range(8))

    def test_invalidate_table_drops_only_its_keys(self):
        pool = self._pool()
        pa, pb = E.cmp("a", ">", 5), E.cmp("b", "<", 3)
        pool.record("t", E.canonical(pa), pa, 8, present=(1,))
        pool.record("u", E.canonical(pb), pb, 8, present=(2,))
        pool.invalidate_table("t")
        assert not pool.contains("t", E.canonical(pa))
        assert pool.contains("u", E.canonical(pb))

    def test_bitset_bytes_accounting(self):
        pool = self._pool()
        pred = E.cmp("a", ">", 5)
        pool.record("t", E.canonical(pred), pred, 8, present=(0,))
        assert pool.used_bytes == 1          # 8 partitions = 1 byte
        pred2 = E.cmp("b", ">", 5)
        pool.record("t", E.canonical(pred2), pred2, 1024, present=(9,))
        assert pool.used_bytes == 1 + 128    # 1024 partitions = 128 B


# ---------------------------------------------------------------------------
# properties: seeded always-run sweeps + hypothesis variants when available
# ---------------------------------------------------------------------------
_OPS = ("<", "<=", ">", ">=", "==", "!=")


def _rand_atom(rng):
    """One random compare atom over the INT_SCHEMA columns: integer,
    fractional-on-integer, and float thresholds all reachable."""
    name = ("a", "b", "f")[rng.integers(0, 3)]
    op = _OPS[rng.integers(0, len(_OPS))]
    if name == "f":
        thr = round(float(rng.uniform(-1.5, 1.5)), 3)
    elif rng.integers(0, 2):
        thr = int(rng.integers(-5, 105))
    else:
        thr = round(float(rng.uniform(-5, 105)), 2)
    return E.cmp(name, op, thr)


def _prop_cols(seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(v) for n, v in {
        "a": rng.integers(-10, 110, 512).astype(np.int32),
        "b": rng.integers(-10, 110, 512).astype(np.int32),
        "f": rng.uniform(-2, 2, 512).astype(np.float32),
    }.items()}


def _check_normal_form_rows(atoms):
    cols = _prop_cols(5)
    pred = E.and_(*atoms) if len(atoms) > 1 else atoms[0]
    norm = normalize_intervals(canonicalize_expr(pred), INT_SCHEMA)
    m_raw = np.asarray(E.eval_expr(pred, cols))
    m_norm = np.asarray(E.eval_expr(norm, cols))
    assert np.array_equal(m_raw, m_norm), E.pretty(pred)


def _check_residual_reconstructs(atoms, extra):
    """Whenever p subsumes q = p ∧ extra, rows(p) ∧ residual == rows(q).
    Returns True when the (conservative) decision actually fired."""
    cols = _prop_cols(7)
    p = E.and_(*atoms) if len(atoms) > 1 else atoms[0]
    q = E.and_(p, extra)
    resid = subsumption_residual(p, q, INT_SCHEMA)
    if resid is None:
        return False       # declining is always allowed, never wrong
    m_p = np.asarray(E.eval_expr(p, cols))
    m_q = np.asarray(E.eval_expr(q, cols))
    m_r = np.asarray(E.eval_expr(resid, cols))
    assert np.array_equal(m_p & m_r, m_q), E.pretty(q)
    return True


class TestNormalizationProperty:
    def test_interval_normal_form_selects_same_rows_seeded(self):
        rng = np.random.default_rng(23)
        for _ in range(150):
            n = int(rng.integers(1, 5))
            _check_normal_form_rows([_rand_atom(rng) for _ in range(n)])

    def test_residual_reconstructs_query_seeded(self):
        rng = np.random.default_rng(29)
        fired = 0
        for _ in range(150):
            n = int(rng.integers(1, 4))
            atoms = [_rand_atom(rng) for _ in range(n)]
            fired += _check_residual_reconstructs(atoms, _rand_atom(rng))
        assert fired > 50, "subsumption almost never decided"

    def test_normal_form_rows_property(self):
        pytest.importorskip("hypothesis",
                            reason="property tests need hypothesis")
        from hypothesis import HealthCheck, given, settings
        from hypothesis import strategies as st

        @given(seed=st.integers(0, 2 ** 16),
               n=st.integers(1, 4))
        @settings(max_examples=40, deadline=None,
                  suppress_health_check=[HealthCheck.too_slow])
        def prop(seed, n):
            rng = np.random.default_rng(seed)
            atoms = [_rand_atom(rng) for _ in range(n)]
            _check_normal_form_rows(atoms)
            _check_residual_reconstructs(atoms, _rand_atom(rng))

        prop()


SCHEMA = synthetic_schema(n_int=3, n_dbl=2, n_str=1)
NROWS = 4000
COLS = generate_columns(SCHEMA, NROWS, seed=11)


def _session(fmt="columnar", scheme="range", prune=True, pid=True,
             partitioned=True, subsumption=True):
    sess = Session.from_config(SessionConfig(
        execution=ExecutionConfig(prune=prune, pid_cache=pid),
        memory=MemoryConfig(budget_bytes=1 << 26),
        mqo=MqoConfig(subsumption=subsumption)), device=CPU)
    st, _ = make_storage("t", SCHEMA, NROWS, fmt, cols=COLS)
    sess.register(st, columnar_for_stats=COLS,
                  partitioning=(Partitioning("n1", scheme, 8)
                                if partitioned else None))
    return sess


def _check_pid_pruned_equals_unpruned(fmt, scheme, t, u):
    pruned = _session(fmt=fmt, scheme=scheme)
    plain = _session(fmt=fmt, scheme=scheme, prune=False, pid=False)
    qs = lambda s: [                         # noqa: E731
        s.table("t").filter(E.cmp("n1", "<", t)).project("n1", "n2"),
        s.table("t").filter(E.and_(E.cmp("n1", "<", t),
                                   E.cmp("n2", "<", u)))
         .project("n1", "n2"),
    ]
    # two passes: the first RECORDS presence bitsets, the second
    # INTERSECTS them (exact key for query 1, implies closure for the
    # strictly-stronger query 2)
    for _ in range(2):
        a = pruned.run_batch(qs(pruned), mqo=False)
        b = plain.run_batch(qs(plain), mqo=False)
        for ra, rb in zip(a.results, b.results):
            assert ra.table.row_multiset() == rb.table.row_multiset()
    assert pruned._pid_pool is not None
    assert pruned._pid_pool.used_bytes > 0


class TestPidPruningProperty:
    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    @pytest.mark.parametrize("scheme", ["range", "hash"])
    def test_bitset_pruned_equals_unpruned_seeded(self, fmt, scheme):
        rng = np.random.default_rng(31)
        for _ in range(3):
            t = int(rng.integers(50, 900))
            u = int(rng.integers(50, 900))
            _check_pid_pruned_equals_unpruned(fmt, scheme, t, u)

    def test_bitset_pruned_equals_unpruned_property(self):
        pytest.importorskip("hypothesis",
                            reason="property tests need hypothesis")
        from hypothesis import HealthCheck, given, settings
        from hypothesis import strategies as st

        @given(t=st.integers(50, 900), u=st.integers(50, 900),
               fmt=st.sampled_from(["columnar", "csv"]),
               scheme=st.sampled_from(["range", "hash"]))
        @settings(max_examples=8, deadline=None,
                  suppress_health_check=[HealthCheck.too_slow])
        def prop(t, u, fmt, scheme):
            _check_pid_pruned_equals_unpruned(fmt, scheme, t, u)

        prop()


def _check_resumed_equals_from_scratch(w, s, u, *, expect_hit=False):
    warm = _session(partitioned=False)
    cold = _session(partitioned=False)
    warm.disk_latency_per_byte = 5e-9        # make caching worthwhile
    seed = [warm.table("t").filter(E.cmp("n1", "<", w))
                .project("n1", "n2", "d1") for _ in range(3)]
    probe = lambda sess: sess.table("t").filter(  # noqa: E731
        E.and_(E.cmp("n1", "<", s), E.cmp("n2", ">=", u))
    ).project("n1", "n2")
    seeded = warm.run_batch(seed)
    assert seeded.mqo.rewritten.ces, "precondition: a CE formed"
    got = warm.run_batch([probe(warm)])
    want = cold.run_batch([probe(cold)], mqo=False)
    if expect_hit:
        assert got.mqo.report.n_subsumed == 1
    assert got.results[0].table.row_multiset() == \
        want.results[0].table.row_multiset()


class TestSubsumptionResumeProperty:
    def test_resumed_equals_from_scratch_seeded(self):
        rng = np.random.default_rng(37)
        for _ in range(3):
            _check_resumed_equals_from_scratch(
                int(rng.integers(400, 800)), int(rng.integers(100, 390)),
                int(rng.integers(100, 900)), expect_hit=True)

    def test_resumed_equals_from_scratch_property(self):
        pytest.importorskip("hypothesis",
                            reason="property tests need hypothesis")
        from hypothesis import HealthCheck, given, settings
        from hypothesis import strategies as st

        @given(w=st.integers(400, 800), s=st.integers(100, 390),
               u=st.integers(100, 900))
        @settings(max_examples=5, deadline=None,
                  suppress_health_check=[HealthCheck.too_slow])
        def prop(w, s, u):
            _check_resumed_equals_from_scratch(w, s, u)

        prop()


# ---------------------------------------------------------------------------
# service integration: explain fields + config knobs
# ---------------------------------------------------------------------------
class TestServiceIntegration:
    def _seed_and_probe(self, sess):
        svc = QueryService(sess, max_batch=4)
        seeds = [svc.submit(sess.table("t").filter(E.cmp("n1", "<", 500))
                            .project("n1", "n2", "d1")) for _ in range(3)]
        svc.flush()
        assert all(not h.failed for h in seeds)
        probe = svc.submit(sess.table("t").filter(
            E.and_(E.cmp("n1", "<", 300), E.cmp("n2", ">=", 400))
        ).project("n1", "n2"))
        svc.flush()
        return probe

    def test_explain_reports_subsumption_hit(self):
        sess = _session(partitioned=False)
        sess.disk_latency_per_byte = 5e-9
        h = self._seed_and_probe(sess)
        e = h.explain()
        assert e["subsumption_hit"] is True
        assert not e.get("resident_reuse")
        sub = e["subsumption"]
        assert len(sub["strict_psi"]) == 12
        assert "cmp" in sub["residual"]
        assert isinstance(e["pid_pruned_parts"], int)

    def test_subsumption_knob_disables_channel(self):
        sess = _session(partitioned=False, subsumption=False)
        sess.disk_latency_per_byte = 5e-9
        h = self._seed_and_probe(sess)
        e = h.explain()
        assert e["subsumption_hit"] is False
        assert "subsumption" not in e

    def test_pid_cache_knob_disables_pool(self):
        sess = _session(pid=False)
        assert sess._pid_pool is None
        h = self._seed_and_probe(sess)
        assert not h.failed
        assert h.explain()["pid_pruned_parts"] == 0

    def test_reregister_invalidates_pid_bitsets(self):
        sess = _session()
        q = lambda: sess.table("t").filter(       # noqa: E731
            E.cmp("n1", "<", 300)).project("n1")
        sess.run_batch([q()], mqo=False)
        assert sess._pid_pool.used_bytes > 0
        st, _ = make_storage("t", SCHEMA, NROWS, "columnar", cols=COLS)
        sess.register(st, columnar_for_stats=COLS,
                      partitioning=Partitioning("n1", "range", 8))
        assert sess._pid_pool.used_bytes == 0

    def test_pid_pool_is_tiny_next_to_ce_pool(self):
        sess = _session()
        sess.disk_latency_per_byte = 5e-9
        self._seed_and_probe(sess)
        ce_bytes = sess._ce_cache.used_bytes
        assert ce_bytes > 0
        assert sess._pid_pool.used_bytes <= max(1, ce_bytes // 100)


pytestmark = pytest.mark.usefixtures("one_torch_thread")

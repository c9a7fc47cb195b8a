"""Partitioned execution (ISSUE 4): partition-aware tables, pruning,
partition-grained MCKP admission / caching, and multi-device sharded
scans.

Covers:
  * partition layout + statistics (range/hash re-clustering);
  * pruning soundness — unit cases plus hypothesis property tests that
    pruned execution is bit-identical to unpruned on live rows, across
    both schemes and both storage formats;
  * partition-grained MCKP: a budget that cannot hold a full CE admits
    a strict subset of its partitions, partial hits compose resident +
    recomputed partitions, warm windows re-price resident partitions as
    zero-weight items;
  * the re-registration invalidation fix (per-partition statistics and
    partition-grained cache entries);
  * multi-device sharded scans: the port runs them on its row-sharded
    session in ``test_torch_spmd_relational.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.relational import (Partitioning, QueryService, expr as E,
                                    make_storage)
from repro_torch.relational.datagen import generate_columns
from repro_torch.relational.partition import (assign_partitions, hash_bucket,
                                              linear_scan_chain,
                                              partition_table, prune_parts,
                                              restrict_to_parts)

import torch_properties as props
from torch_fixtures import CPU
from torch_parity import one_torch_thread  # noqa: F401


SCHEMA = props.PART_SCHEMA
NROWS = props.PART_NROWS
COLS = props.PART_COLS


def make_session(fmt="columnar", partitioning=None, prune=True,
                 budget=1 << 26, nrows=NROWS, cols=None, name="t",
                 disk_latency=0.0):
    return props.part_session(CPU, fmt, partitioning, prune, budget, nrows,
                              cols, name, disk_latency)


# ---------------------------------------------------------------------------
# layout + statistics
# ---------------------------------------------------------------------------
class TestPartitionLayout:
    def test_range_reclusters_contiguously(self):
        spec = Partitioning("n1", "range", 8)
        perm, reordered, info = partition_table(spec, NROWS, COLS)
        assert info.n_partitions == 8
        assert int(info.offsets[-1]) == NROWS
        # partitions tile the rows; n1 ranges are non-overlapping
        highs = []
        for pid in range(8):
            lo, hi = info.part_range(pid)
            if hi > lo:
                part = reordered["n1"][lo:hi]
                cs = info.col_stats[pid]["n1"]
                assert cs.vmin == part.min() and cs.vmax == part.max()
                highs.append((cs.vmin, cs.vmax))
        for (lo1, hi1), (lo2, hi2) in zip(highs, highs[1:]):
            assert hi1 <= lo2 + 1e-9

    def test_range_quantiles_balance(self):
        spec = Partitioning("n1", "range", 8)
        _, _, info = partition_table(spec, NROWS, COLS)
        sizes = [info.part_rows(p) for p in range(8)]
        assert min(sizes) > NROWS // 32     # quantile split: roughly even

    def test_hash_assignment_deterministic(self):
        spec = Partitioning("n1", "hash", 8)
        a = assign_partitions(COLS["n1"], spec)
        b = assign_partitions(COLS["n1"], spec)
        assert np.array_equal(a, b)
        assert set(np.unique(a)) <= set(range(8))

    def test_partitioned_multiset_equals_unpartitioned(self):
        base = make_session()
        part = make_session(partitioning=Partitioning("n1", "range", 8))
        q = lambda s: s.table("t").filter(
            E.cmp("n1", "<", 300)).project("n1", "n2")
        a = base.run_batch([q(base)], mqo=False).results[0].table
        b = part.run_batch([q(part)], mqo=False).results[0].table
        assert a.row_multiset() == b.row_multiset()


# ---------------------------------------------------------------------------
# pruning (unit)
# ---------------------------------------------------------------------------
class TestPruning:
    def _info(self, scheme="range", n=8):
        spec = Partitioning("n1", scheme, n)
        _, _, info = partition_table(spec, NROWS, COLS)
        return info

    def test_range_lt_prunes_high_partitions(self):
        info = self._info()
        live = prune_parts(E.cmp("n1", "<", 100), info)
        assert 0 < len(live) < info.n_partitions
        # every row with n1 < 100 lives in a surviving partition
        for pid in set(range(info.n_partitions)) - set(live):
            assert info.col_stats[pid]["n1"].vmin >= 100

    def test_hash_eq_prunes_to_one_bucket(self):
        info = self._info("hash")
        v = int(COLS["n1"][0])
        live = prune_parts(E.cmp("n1", "==", v), info)
        want = int(hash_bucket(np.asarray([v], np.int64), 8)[0])
        assert live == (want,) or live == ()

    def test_or_unions_survivors(self):
        info = self._info()
        lo = prune_parts(E.cmp("n1", "<", 100), info)
        hi = prune_parts(E.cmp("n1", ">", 900), info)
        both = prune_parts(E.or_(E.cmp("n1", "<", 100),
                                 E.cmp("n1", ">", 900)), info)
        assert set(both) == set(lo) | set(hi)

    def test_not_is_conservative(self):
        info = self._info()
        live = prune_parts(E.not_(E.cmp("n1", "<", 100)), info)
        # partitions entirely below 100 are refuted; the rest survive
        for pid in set(range(info.n_partitions)) - set(live):
            assert info.col_stats[pid]["n1"].vmax < 100

    def test_nan_partition_is_unprunable(self):
        """NaN poisons min/max interval reasoning (every compare is
        False), which would UNSOUNDLY prune a partition still holding
        qualifying non-NaN rows — such partitions must survive."""
        nrows = 64
        cols = {
            "n1": np.arange(nrows, dtype=np.int32),
            "d1": np.linspace(0.0, 1.0, nrows).astype(np.float32),
        }
        cols["d1"][3] = np.nan               # lands in partition 0
        spec = Partitioning("n1", "range", 4)
        _, reordered, info = partition_table(spec, nrows, cols)
        assert info.col_stats[0]["d1"].has_nan
        # partition 0 holds qualifying rows (small d1) AND a NaN
        live = prune_parts(E.cmp("d1", "<", 0.1), info)
        assert 0 in live
        # NaN satisfies != — the partition must survive that too
        live_ne = prune_parts(E.cmp("d1", "!=", 0.5), info)
        assert 0 in live_ne
        # NaN-free partitions still prune normally on the partition col
        assert len(prune_parts(E.cmp("n1", "<", 5), info)) < 4

    def test_unknown_exprs_never_prune(self):
        info = self._info()
        allp = info.all_parts()
        assert prune_parts(E.cmp("s1", "==", "abcd"), info) == allp
        assert prune_parts(E.col_cmp("n1", "<", "n2"), info) == allp
        assert prune_parts(E.TRUE, info) == allp

    def test_plan_helpers(self):
        s = make_session(partitioning=Partitioning("n1", "range", 4))
        plan = (s.table("t").filter(E.cmp("n1", "<", 50))
                .project("n1", "n2"))
        scan, pred = linear_scan_chain(plan)
        assert scan.table == "t"
        assert E.canonical(pred) == E.canonical(E.cmp("n1", "<", 50))
        restricted = restrict_to_parts(plan, (1, 2))
        scan2, _ = linear_scan_chain(restricted)
        assert scan2.parts == (1, 2)
        # joins are not linear chains
        two = plan.join(s.table("t").project("n3"), "n1", "n3")
        assert linear_scan_chain(two) is None


# ---------------------------------------------------------------------------
# pruned == unpruned, property-tested (satellite 3)
# ---------------------------------------------------------------------------
_make_pred = props.make_pred
_PRED_COLS = props.PRED_COLS
_PRED_OPS = props.PRED_OPS
_random_pred = props.random_pred_tree


_SESS = {}


def _sessions(fmt, scheme):
    """Session pair (pruned, unpruned) over the SAME partitioned layout
    — memoized: the property tests call this many times."""
    key = (fmt, scheme)
    if key not in _SESS:
        part = Partitioning("n1", scheme, 8)
        _SESS[key] = (make_session(fmt, part, prune=True),
                      make_session(fmt, part, prune=False))
    return _SESS[key]


def _assert_pruned_bit_identical(pred, fmt, scheme):
    pruned, unpruned = _sessions(fmt, scheme)
    q = lambda s: props.pruned_query(s, pred)
    a = pruned.run_batch([q(pruned)], mqo=False).results[0].table
    b = unpruned.run_batch([q(unpruned)], mqo=False).results[0].table
    assert a.nrows == b.nrows, E.pretty(pred)
    an, bn = a.to_numpy(), b.to_numpy()
    for c in an:
        np.testing.assert_array_equal(an[c], bn[c])


def _assert_prune_conservative(pred, scheme):
    """Direct oracle: evaluate the predicate per partition; any
    partition holding a qualifying row must survive pruning."""
    part = Partitioning("n1", scheme, 8)
    _, reordered, info = partition_table(part, NROWS, COLS)
    live = set(prune_parts(pred, info))
    cols = {n: torch.as_tensor(v) for n, v in reordered.items()
            if v.ndim == 1}
    mask = np.asarray(E.eval_expr(pred, cols))
    for pid in range(info.n_partitions):
        lo, hi = info.part_range(pid)
        if mask[lo:hi].any():
            assert pid in live, (pid, E.pretty(pred))


class TestPrunedBitIdentitySeeded:
    """Always-run variant of the property tests (seeded generator over
    the same predicate space — CI also runs the hypothesis variant)."""

    @pytest.mark.parametrize("fmt", ["columnar", "csv"])
    @pytest.mark.parametrize("scheme", ["range", "hash"])
    def test_pruned_equals_unpruned_live_rows(self, fmt, scheme):
        rng = np.random.default_rng(0)
        for _ in range(12):
            _assert_pruned_bit_identical(_random_pred(rng), fmt, scheme)

    @pytest.mark.parametrize("scheme", ["range", "hash"])
    def test_prune_never_drops_qualifying_partitions(self, scheme):
        rng = np.random.default_rng(1)
        for _ in range(40):
            _assert_prune_conservative(_random_pred(rng), scheme)


try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st_

    _HYP = True
except ImportError:                      # pragma: no cover - CI has it
    _HYP = False

if _HYP:
    def _pred_strategy():
        leaf = st_.builds(
            _make_pred, st_.sampled_from(_PRED_COLS),
            st_.sampled_from(_PRED_OPS),
            st_.floats(min_value=0.0, max_value=1.0, allow_nan=False,
                       width=32))
        return st_.recursive(
            leaf,
            lambda children: st_.one_of(
                st_.lists(children, min_size=2, max_size=3).map(
                    lambda ps: E.and_(*ps)),
                st_.lists(children, min_size=2, max_size=3).map(
                    lambda ps: E.or_(*ps)),
                children.map(E.not_),
            ),
            max_leaves=4)

    class TestPrunedBitIdentity:
        @settings(max_examples=25, deadline=None,
                  suppress_health_check=list(HealthCheck))
        @given(pred=_pred_strategy(),
               fmt=st_.sampled_from(["columnar", "csv"]),
               scheme=st_.sampled_from(["range", "hash"]))
        def test_pruned_equals_unpruned_live_rows(self, pred, fmt,
                                                  scheme):
            _assert_pruned_bit_identical(pred, fmt, scheme)

        @settings(max_examples=20, deadline=None,
                  suppress_health_check=list(HealthCheck))
        @given(pred=_pred_strategy(),
               scheme=st_.sampled_from(["range", "hash"]))
        def test_prune_never_drops_qualifying_partitions(self, pred,
                                                         scheme):
            _assert_prune_conservative(pred, scheme)


# ---------------------------------------------------------------------------
# partition-grained MCKP + partial residency
# ---------------------------------------------------------------------------
def _dashboard(sess):
    t = lambda: sess.table("t")
    return [
        t().filter(E.cmp("n1", "<", 400)).project("n1", "n2", "n3", "d1"),
        t().filter(E.cmp("n1", "<", 300)).project("n1", "n2", "d2"),
        t().filter(E.cmp("n1", "<", 350)).project("n1", "n3", "d1"),
    ]


def _partitioned_csv_session(budget):
    return make_session("csv", Partitioning("n1", "range", 8),
                        budget=budget, disk_latency=5e-9)


class TestPartitionGrainedMckp:
    def test_full_budget_admits_all_live_partitions(self):
        sess = _partitioned_csv_session(1 << 30)
        r = sess.run_batch(_dashboard(sess), mqo=True)
        rep = r.mqo.report
        assert rep.n_partitioned >= 1
        assert rep.n_partition_items >= 2
        ce = next(c for c in r.mqo.rewritten.ces
                  if c.partition_detail is not None)
        live = ce.partition_detail[0].live
        assert 0 < len(live) < 8            # pruning cut some partitions
        assert ce.admitted_partitions == frozenset(live)

    def test_small_budget_admits_strict_subset(self):
        big = _partitioned_csv_session(1 << 30)
        rb = big.run_batch(_dashboard(big), mqo=True)
        full_w = sum(sl.weight for ce in rb.mqo.rewritten.ces
                     if ce.partition_detail
                     for sl in ce.partition_detail[1])
        assert full_w > 0
        sess = _partitioned_csv_session(max(full_w // 3, 1 << 12))
        r = sess.run_batch(_dashboard(sess), mqo=True)
        ce = next(c for c in r.mqo.rewritten.ces
                  if c.partition_detail is not None)
        adm, live = ce.admitted_partitions, ce.partition_detail[0].live
        assert 0 < len(adm) < len(live)     # the hot FRACTION, not all
        # partial hit composes resident + recomputed: results correct
        base = sess.run_batch(_dashboard(sess), mqo=False)
        for a, b in zip(base.results, r.results):
            assert a.table.row_multiset() == b.table.row_multiset()

    def test_warm_window_reprices_resident_partitions(self):
        big = _partitioned_csv_session(1 << 30)
        full_w = sum(sl.weight
                     for ce in big.run_batch(_dashboard(big),
                                             mqo=True).mqo.rewritten.ces
                     if ce.partition_detail
                     for sl in ce.partition_detail[1])
        sess = _partitioned_csv_session(max(full_w // 3, 1 << 12))
        r1 = sess.run_batch(_dashboard(sess), mqo=True)
        parts = sess.ce_resident_parts()
        assert parts and all(v for v in parts.values())
        r2 = sess.run_batch(_dashboard(sess), mqo=True)
        assert r2.mqo.report.n_resident_parts >= 1
        assert r2.metrics.bytes_cached_read > 0
        base = sess.run_batch(_dashboard(sess), mqo=False)
        for a, b in zip(base.results, r2.results):
            assert a.table.row_multiset() == b.table.row_multiset()

    def test_mqo_results_bitwise_stable_under_budgets(self):
        """Tiny vs unlimited budget: partition admission differs, the
        results must not (memory-hierarchy invariant extended to
        partition-grained entries)."""
        tiny = _partitioned_csv_session(1 << 14)
        huge = _partitioned_csv_session(1 << 30)
        rt = tiny.run_batch(_dashboard(tiny), mqo=True)
        rh = huge.run_batch(_dashboard(huge), mqo=True)
        for a, b in zip(rt.results, rh.results):
            assert a.table.row_multiset() == b.table.row_multiset()
        assert tiny.memory.device_used <= tiny.memory.device_budget

    def test_prune_false_disables_partition_grained_mqo(self):
        """ExecutionConfig.prune=False must force the unpruned path on
        the MQO route too: no CE partitioning, no partition-restricted
        scans — whole-CE behavior, bit-comparable to PR 3."""
        sess = make_session("csv", Partitioning("n1", "range", 8),
                            prune=False, budget=1 << 30,
                            disk_latency=5e-9)
        r = sess.run_batch(_dashboard(sess), mqo=True)
        assert r.mqo.report.n_partitioned == 0
        assert r.mqo.report.n_partition_items == 0
        assert all(ce.partition_detail is None
                   for ce in r.mqo.rewritten.ces)
        base = sess.run_batch(_dashboard(sess), mqo=False)
        for a, b in zip(base.results, r.results):
            assert a.table.row_multiset() == b.table.row_multiset()

    def test_explain_reports_partitions(self):
        sess = _partitioned_csv_session(1 << 30)
        svc = QueryService(sess, max_batch=len(_dashboard(sess)))
        handles = [svc.submit(q) for q in _dashboard(sess)]
        svc.flush()
        ex = handles[0].explain()
        ce_with_parts = [c for c in ex["ces"] if "partitions" in c]
        assert ce_with_parts
        info = ce_with_parts[0]["partitions"]
        assert set(info["admitted"]) <= set(info["live"])


# ---------------------------------------------------------------------------
# re-registration invalidation (satellite 2)
# ---------------------------------------------------------------------------
class TestReregisterInvalidation:
    def test_reregister_drops_partition_state(self):
        sess = _partitioned_csv_session(1 << 30)
        sess.run_batch(_dashboard(sess), mqo=True)
        assert sess.ce_resident_parts()
        assert "t" in sess.stats.partitions
        assert any(isinstance(k, tuple) and k[1] == "__csv__"
                   for k in sess._scan_pool.keys())

        # new data under the same name: different seed, no partitioning
        cols2 = generate_columns(SCHEMA, NROWS, seed=99)
        st2, _ = make_storage("t", SCHEMA, NROWS, "csv", cols=cols2)
        sess.register(st2, columnar_for_stats=cols2)
        assert not sess.ce_resident_parts()          # CE entries gone
        assert "t" not in sess.stats.partitions      # per-part stats gone
        assert not any(k[0] == "t" for k in sess._scan_pool.keys())
        # fresh execution serves the NEW data
        q = sess.table("t").filter(E.cmp("n1", "<", 300)).project("n1")
        got = sess.run_batch([q], mqo=True).results[0].table
        want = np.sort(cols2["n1"][cols2["n1"] < 300])
        np.testing.assert_array_equal(np.sort(got.to_numpy()["n1"]), want)

    def test_reregister_with_new_partitioning_reprunes(self):
        sess = make_session(partitioning=Partitioning("n1", "range", 8))
        assert sess.stats.partitions["t"].n_partitions == 8
        st2, _ = make_storage("t", SCHEMA, NROWS, "columnar", cols=COLS)
        sess.register(st2, columnar_for_stats=COLS,
                      partitioning=Partitioning("n2", "hash", 4))
        info = sess.stats.partitions["t"]
        assert info.n_partitions == 4 and info.spec.column == "n2"
        q = sess.table("t").filter(E.cmp("n2", "==", 77)).project("n2")
        got = sess.run_batch([q], mqo=False).results[0].table
        assert got.nrows == int((COLS["n2"] == 77).sum())


# The multi-device sharded scans (TestShardedPartitionedScan) run on the
# port's row-sharded session in tests/test_torch_spmd_relational.py.
pytestmark = pytest.mark.usefixtures("one_torch_thread")

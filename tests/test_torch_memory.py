"""Unified memory hierarchy: budget invariants, spill tiers, policies,
cross-batch CE retention (ISSUE 2).

The load-bearing properties:

  * ``device_used <= device_budget`` (and host analog) after ANY
    put/get/evict sequence, in every pool — hypothesis-tested;
  * batch results are bit-identical under a pathologically tiny budget
    (everything evicted/dropped) and an unlimited one, for every
    eviction policy;
  * a warm repeat of a batch re-prices resident CEs as zero-weight
    knapsack items and re-materializes nothing;
  * re-registering a table invalidates its scan-pool entries and any
    retained CE content.
"""
import numpy as np
import pytest

from repro_torch.core.memory import MemoryManager
from repro_torch.relational import Session, expr as E, make_storage

import torch_properties as props
from torch_fixtures import CPU
from torch_parity import one_torch_thread  # noqa: F401


def _mk_manager(device=100, host=None, policy="lru"):
    return MemoryManager(device, host_budget=host, policy=policy)


class TestTiers:
    def test_pools_share_one_device_budget(self):
        m = _mk_manager(100)
        a = m.pool("a")
        b = m.pool("b")
        a.put("x", 1, nbytes=60)
        b.put("y", 2, nbytes=60)          # evicts a's entry (lru)
        assert m.device_used == 60
        assert b.contains("y") and not a.contains("x")

    def test_two_tier_spill_then_drop(self):
        m = _mk_manager(100, host=100)
        p = m.pool("p", spill_fn=lambda x: ("host", x),
                   unspill_fn=lambda x: x[1])
        p.put("a", "A", nbytes=80)
        p.put("b", "B", nbytes=80)        # a -> host
        assert p.entry("a").spilled and m.host_used == 80
        p.put("c", "C", nbytes=80)        # b -> host would exceed: a drops
        assert m.device_used == 80 and m.host_used == 80
        assert not p.contains("a")        # dropped off the host tier
        assert p.get("b") == "B"          # unspilled from host

    def test_evict_to_drop_without_spill_fn(self):
        m = _mk_manager(100)
        p = m.pool("p")                   # no spill path: evict == drop
        p.put("a", "A", nbytes=60)
        p.put("b", "B", nbytes=60)
        assert not p.contains("a") and p.contains("b")
        assert m.device_used == 60 and m.host_used == 0
        assert p.stats.evictions == 1

    def test_promotion_on_hit_with_headroom(self):
        m = _mk_manager(100)
        p = m.pool("p", spill_fn=lambda x: x, unspill_fn=lambda x: x,
                   policy="admission")
        p.put("a", "A", nbytes=60)
        p.put("b", "B", nbytes=60)        # incoming spills (admission)
        assert p.entry("b").spilled
        p.evict("a")                      # budget frees up
        assert p.get("b") == "B"          # hit promotes back to device
        assert not p.entry("b").spilled
        assert p.stats.promotions == 1
        assert m.device_used == 60 and m.host_used == 0

    def test_oversized_entry_goes_straight_to_spill_path(self):
        m = _mk_manager(100, host=1000)
        p = m.pool("p", spill_fn=lambda x: x, unspill_fn=lambda x: x)
        e = p.put("big", "B", nbytes=500)
        assert e.spilled and m.device_used == 0 and m.host_used == 500

    def test_can_never_fit_entry_does_not_flush_residents(self):
        """An entry bigger than a whole tier is dropped without
        evicting anything from that tier."""
        m = _mk_manager(100, host=200)
        p = m.pool("p", spill_fn=lambda x: x, unspill_fn=lambda x: x)
        p.put("a", "A", nbytes=60)
        p.put("b", "B", nbytes=60)            # spills to host
        e = p.put("huge", "H", nbytes=500)    # > device AND > host
        assert e.tier == "dropped"
        assert p.contains("a") and p.contains("b")   # residents intact
        assert m.device_used == 60 and m.host_used == 60


class TestPolicies:
    def test_lru_evicts_least_recently_used(self):
        m = _mk_manager(100, policy="lru")
        p = m.pool("p")
        p.put("a", "A", nbytes=40)
        p.put("b", "B", nbytes=40)
        assert p.get("a") == "A"          # refresh a
        p.put("c", "C", nbytes=40)        # b is now the lru victim
        assert p.contains("a") and p.contains("c") and not p.contains("b")

    def test_benefit_evicts_lowest_benefit_per_byte(self):
        m = _mk_manager(100, policy="benefit")
        p = m.pool("p")
        p.put("cheap", "X", nbytes=40, benefit=1.0)
        p.put("dear", "Y", nbytes=40, benefit=100.0)
        p.put("new", "Z", nbytes=40, benefit=10.0)
        assert not p.contains("cheap")
        assert p.contains("dear") and p.contains("new")

    def test_admission_pool_protects_residents(self):
        m = _mk_manager(100, policy="admission")
        p = m.pool("p", spill_fn=lambda x: x, unspill_fn=lambda x: x)
        p.put("a", "A", nbytes=60)
        e = p.put("b", "B", nbytes=60)
        assert p.contains("a") and not p.entry("a").spilled
        assert e.spilled                  # the incoming entry spilled

    def test_admission_put_may_displace_evictable_pools(self):
        m = _mk_manager(100, policy="lru")
        scan = m.pool("scan")
        ce = m.pool("ce", policy="admission")
        scan.put("col", "S", nbytes=80)
        ce.put("psi", "C", nbytes=80)     # scan column yields
        assert ce.contains("psi") and not ce.entry("psi").spilled
        assert not scan.contains("col")


class TestMaintenance:
    def test_invalidate_by_predicate(self):
        m = _mk_manager(1000)
        p = m.pool("scan")
        p.put(("t1", "a"), 1, nbytes=10)
        p.put(("t1", "b"), 2, nbytes=10)
        p.put(("t2", "a"), 3, nbytes=10)
        assert p.invalidate(lambda k: k[0] == "t1") == 2
        assert not p.contains(("t1", "a")) and p.contains(("t2", "a"))
        assert m.device_used == 10

    def test_reput_same_key_replaces_accounting(self):
        m = _mk_manager(100)
        p = m.pool("p")
        p.put("a", "A", nbytes=60)
        p.put("a", "A2", nbytes=30)
        assert m.device_used == 30 and p.get("a") == "A2"

    def test_report_shape(self):
        m = _mk_manager(100)
        m.pool("p").put(b"\x12" * 16, "A", nbytes=10)
        rep = m.report()
        assert rep["device_used"] == 10
        assert rep["pools"]["p"]["entries"][0]["nbytes"] == 10


# ---------------------------------------------------------------------------
# hypothesis: budget invariants under arbitrary op sequences
# ---------------------------------------------------------------------------
class TestBudgetInvariants:
    KEYS = list(range(8))

    def _check(self, m: MemoryManager):
        dev = host = 0
        for p in m.pools.values():
            pd = sum(e.nbytes for e in p.entries.values()
                     if e.tier == "device")
            ph = sum(e.nbytes for e in p.entries.values()
                     if e.tier == "host")
            assert p.stats.used == pd
            assert p.stats.spilled_bytes == ph
            dev += pd
            host += ph
        assert m.device_used == dev
        assert m.host_used == host
        assert m.device_used <= m.device_budget
        if m.host_budget is not None:
            assert m.host_used <= m.host_budget

    def _run_ops(self, ops, device, host, policies):
        m = MemoryManager(device, host_budget=host)
        pools = [
            m.pool("p0", policy=policies[0]),
            m.pool("p1", spill_fn=lambda x: x, unspill_fn=lambda x: x,
                   policy=policies[1]),
        ]
        for op, pool_i, key, nbytes, benefit in ops:
            p = pools[pool_i]
            if op == "put":
                p.put(key, f"v{key}", nbytes=nbytes, benefit=benefit)
            elif op == "get":
                p.get(key)
            elif op == "evict":
                p.evict(key)
            else:
                p.clear()
            self._check(m)

    def test_property_used_le_budget(self):
        hyp = pytest.importorskip(
            "hypothesis", reason="property tests need hypothesis")
        from hypothesis import given, settings, strategies as st

        op = st.tuples(
            st.sampled_from(["put", "put", "put", "get", "evict", "clear"]),
            st.integers(0, 1),
            st.sampled_from(self.KEYS),
            st.integers(0, 130),
            st.floats(0.0, 10.0, allow_nan=False),
        )

        @settings(max_examples=120, deadline=None)
        @given(ops=st.lists(op, min_size=1, max_size=40),
               device=st.integers(0, 150),
               host=st.one_of(st.none(), st.integers(0, 150)),
               policies=st.tuples(
                   st.sampled_from(["lru", "benefit", "admission"]),
                   st.sampled_from(["lru", "benefit", "admission"])))
        def run(ops, device, host, policies):
            self._run_ops(ops, device, host, policies)

        run()

    def test_smoke_sequences_without_hypothesis(self):
        """Deterministic fallback so the invariant is exercised even
        when hypothesis is absent (it is optional in this repo)."""
        rng = np.random.default_rng(0)
        for case in range(50):
            ops = []
            for _ in range(30):
                ops.append((
                    ["put", "put", "put", "get", "evict", "clear"][
                        int(rng.integers(0, 6))],
                    int(rng.integers(0, 2)),
                    int(rng.integers(0, 8)),
                    int(rng.integers(0, 130)),
                    float(rng.random() * 10),
                ))
            self._run_ops(
                ops, int(rng.integers(0, 150)),
                None if rng.integers(0, 2) else int(rng.integers(0, 150)),
                (["lru", "benefit", "admission"][int(rng.integers(0, 3))],
                 ["lru", "benefit", "admission"][int(rng.integers(0, 3))]))


# ---------------------------------------------------------------------------
# end-to-end: budgets never change results; batches warm up across runs
# ---------------------------------------------------------------------------
S = props.MEM_SCHEMA


def _session(budget, policy="lru", nrows=4000, fmt="columnar",
             seed=7, **kw) -> Session:
    return props.memory_session(budget, CPU, policy, nrows, fmt, seed, **kw)


_shared_batch = props.shared_batch


class TestBudgetsNeverChangeResults:
    @pytest.mark.parametrize("policy", ["lru", "benefit"])
    def test_tiny_budget_bit_identical_to_unlimited(self, policy):
        """Everything evicted/dropped vs nothing evicted: same rows."""
        tiny = _session(budget=128, policy=policy)
        big = _session(budget=1 << 30, policy=policy)
        for _ in range(2):              # second pass hits retained state
            rt = tiny.run_batch(_shared_batch(tiny), mqo=True)
            rb = big.run_batch(_shared_batch(big), mqo=True)
            for a, b in zip(rt.results, rb.results):
                assert a.table.row_multiset() == b.table.row_multiset()
        assert tiny.memory.device_used <= 128

    @pytest.mark.parametrize("policy", ["lru", "benefit"])
    def test_thrashing_scan_pool_budget(self, policy):
        """A budget big enough to cache SOME scan columns but not all:
        eviction churns, results must still match the eager path."""
        sess = _session(budget=16 * 4000 + 64, policy=policy)
        eager = _session(budget=1 << 30)
        eager.fuse = eager.defer_sync = eager.use_scan_cache = False
        got = sess.run_batch(_shared_batch(sess), mqo=False)
        want = eager.run_batch(_shared_batch(eager), mqo=False)
        for a, b in zip(got.results, want.results):
            assert a.table.row_multiset() == b.table.row_multiset()
        assert sess.memory.device_used <= sess.memory.device_budget


class TestCrossBatchRetention:
    def test_warm_repeat_reprices_and_skips_rematerialization(self):
        sess = _session(budget=1 << 26, fmt="csv", nrows=20_000)
        cold = sess.run_batch(_shared_batch(sess), mqo=True)
        assert cold.mqo.report.n_selected >= 1
        adm_cold = cold.cache_report["admissions"]
        warm = sess.run_batch(_shared_batch(sess), mqo=True)
        assert warm.mqo.report.n_resident >= 1
        assert warm.mqo.report.selected_weight == 0   # all already paid
        assert warm.cache_report["admissions"] == adm_cold  # no re-puts
        base = sess.run_batch(_shared_batch(sess), mqo=False)
        for b, o in zip(base.results, warm.results):
            assert b.table.row_multiset() == o.table.row_multiset()

    def test_retention_off_restores_per_batch_behavior(self):
        sess = _session(budget=1 << 26, fmt="csv", nrows=20_000,
                        retain_across_batches=False)
        sess.run_batch(_shared_batch(sess), mqo=True)
        warm = sess.run_batch(_shared_batch(sess), mqo=True)
        assert warm.mqo.report.n_resident == 0

    def test_same_psi_different_predicates_not_reused(self):
        """Loose ψ collision across batches: the strict content check
        must refuse the zero-weight repricing and the stale bytes."""
        sess = _session(budget=1 << 26, fmt="csv", nrows=20_000)
        t = sess.table("t")
        b1 = lambda: t.filter(E.cmp("a", ">", 80)).project("a", "b")
        b2 = lambda: t.filter(E.cmp("a", "<", 15)).project("a", "b")
        sess.run_batch([b1(), b1(), b1()], mqo=True)
        res = sess.run_batch([b2(), b2(), b2()], mqo=True)
        assert res.mqo.report.n_resident == 0
        base = sess.run_batch([b2(), b2(), b2()], mqo=False)
        for b, o in zip(base.results, res.results):
            assert b.table.row_multiset() == o.table.row_multiset()


class TestReregisterInvalidation:
    def test_reregister_drops_scan_pool_entries(self):
        sess = _session(budget=1 << 26)
        sess.run_batch(_shared_batch(sess), mqo=False)
        assert any(k[0] == "t" for k in sess._scan_pool.keys())
        rng = np.random.default_rng(8)
        cols = {c: rng.integers(100, 200, 4000).astype(np.int32)
                for c in ("a", "b", "c")}
        st, _ = make_storage("t", S, 4000, "columnar", cols=cols)
        sess.register(st, columnar_for_stats=cols)
        assert not any(k[0] == "t" for k in sess._scan_pool.keys())

    def test_reregister_drops_retained_ce_content(self):
        sess = _session(budget=1 << 26, fmt="csv", nrows=20_000)
        cold = sess.run_batch(_shared_batch(sess), mqo=True)
        assert cold.mqo.report.n_selected >= 1
        assert sess._ce_cache.resident_psis()
        rng = np.random.default_rng(9)
        new_cols = {c: rng.integers(0, 100, 20_000).astype(np.int32)
                    for c in ("a", "b", "c")}
        st, _ = make_storage("t", S, 20_000, "csv", cols=new_cols)
        sess.register(st, columnar_for_stats=new_cols)
        assert not sess._ce_cache.resident_psis()
        # and the next batch over the NEW data is correct
        opt = sess.run_batch(_shared_batch(sess), mqo=True)
        base = sess.run_batch(_shared_batch(sess), mqo=False)
        for b, o in zip(base.results, opt.results):
            assert b.table.row_multiset() == o.table.row_multiset()


pytestmark = pytest.mark.usefixtures("one_torch_thread")

"""MCKP solver: DP vs brute-force (hypothesis property tests)."""
import math

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

import repro.core.candidates as RC
import repro.core.covering as RCov
import repro.core.identify as RI
import repro.core.mckp as RM
from repro_torch.core.candidates import KnapsackItem
from repro_torch.core.covering import CoveringExpression
from repro_torch.core.identify import SimilarSubexpression
from repro_torch.core.mckp import solve_bruteforce, solve_mckp
from torch_parity import one_torch_thread  # noqa: F401


def _item(group: int, value: float, weight: int) -> KnapsackItem:
    se = SimilarSubexpression(psi=b"x" * 16)
    ce = CoveringExpression(se=se, tree=None, psi=se.psi)  # type: ignore
    ce.value, ce.weight = value, weight
    return KnapsackItem(ces=(ce,), group=group)


def _ref_item(group: int, value: float, weight: int):
    """``_item`` of the JAX package's classes."""
    se = RI.SimilarSubexpression(psi=b"x" * 16)
    ce = RCov.CoveringExpression(se=se, tree=None, psi=se.psi)
    ce.value, ce.weight = value, weight
    return RC.KnapsackItem(ces=(ce,), group=group)


triples_strategy = st.lists(
    st.tuples(st.integers(0, 4),                      # group
              st.floats(0.1, 100, allow_nan=False),   # value
              st.integers(0, 50)),                    # weight
    min_size=0, max_size=12,
)
items_strategy = triples_strategy.map(
    lambda triples: [_item(g, v, w) for g, v, w in triples])


def _choice(sol, items):
    """The positions of a solution's items in the instance."""
    return sorted(next(i for i, it in enumerate(items) if it is chosen)
                  for chosen in sol.items)


class TestDPvsBruteForce:
    @settings(max_examples=200, deadline=None)
    @given(items=items_strategy, capacity=st.integers(0, 120))
    def test_dp_matches_bruteforce_value(self, items, capacity):
        dp = solve_mckp(items, capacity, max_buckets=4096)
        bf = solve_bruteforce(items, capacity)
        assert dp.total_weight <= capacity
        assert dp.total_value == pytest.approx(bf.total_value, rel=1e-9)

    @settings(max_examples=100, deadline=None)
    @given(items=items_strategy, capacity=st.integers(0, 120))
    def test_at_most_one_per_group(self, items, capacity):
        dp = solve_mckp(items, capacity)
        groups = [it.group for it in dp.items]
        assert len(groups) == len(set(groups))


class TestAgainstTheReferencePackage:
    """The same hypothesis instances through the JAX package's solver:
    ``solve_mckp``'s choice and value exactly."""

    @settings(max_examples=200, deadline=None)
    @given(triples=triples_strategy, capacity=st.integers(0, 120),
           max_buckets=st.sampled_from([4096, 8]))
    def test_solve_mckp_matches(self, triples, capacity, max_buckets):
        items = [_item(*t) for t in triples]
        ref_items = [_ref_item(*t) for t in triples]
        got = solve_mckp(items, capacity, max_buckets=max_buckets)
        want = RM.solve_mckp(ref_items, capacity, max_buckets=max_buckets)
        assert _choice(got, items) == _choice(want, ref_items)
        assert got.total_value == want.total_value
        assert got.total_weight == want.total_weight


class TestBasics:
    def test_empty(self):
        sol = solve_mckp([], 100)
        assert sol.items == [] and sol.total_value == 0

    def test_budget_zero_selects_nothing_heavy(self):
        sol = solve_mckp([_item(0, 10, 5)], 0)
        assert sol.items == []

    def test_zero_weight_items_always_fit(self):
        sol = solve_mckp([_item(0, 10, 0), _item(1, 5, 0)], 1)
        assert sol.total_value == 15

    def test_prefers_higher_value_in_group(self):
        sol = solve_mckp([_item(0, 10, 5), _item(0, 20, 5)], 10)
        assert sol.total_value == 20
        assert len(sol.items) == 1

    def test_bucketing_never_exceeds_budget(self):
        # coarse buckets round weights UP -> conservative
        items = [_item(i, 1.0, 1000 + i) for i in range(20)]
        sol = solve_mckp(items, 10_000, max_buckets=8)
        assert sol.total_weight <= 10_000

    def test_large_instance_runs_fast(self):
        items = [_item(g, float((g * 7 + j) % 13 + 1), (j * 97 + g) % 4096)
                 for g in range(50) for j in range(8)]
        sol = solve_mckp(items, 1 << 20, max_buckets=2048)
        assert sol.total_value > 0


pytestmark = pytest.mark.usefixtures("one_torch_thread")

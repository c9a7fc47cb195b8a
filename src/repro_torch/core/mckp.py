"""Multiple-Choice Knapsack solver (paper §4.3, Eq. 5).

Dynamic programming over a discretized capacity axis.  Selecting *at
most* one item per group (the classic MCKP uses exactly-one; the paper's
constraint is ≤ 1, equivalent to adding a zero-value/zero-weight item to
every group).  Weights are bytes, so the capacity axis is bucketed at a
configurable resolution — weights are rounded UP, hence the real budget
is never exceeded (the solution can only be conservatively sub-optimal
by the rounding slack).

Zero-weight items — cross-batch residents the optimizer re-prices as
"already paid" (their bytes are materialized from a previous batch) —
are lifted out of the DP: within a group the best zero-weight option is
a free baseline, so it is credited up front and every heavier option in
the group competes with its value *relative to* that baseline.  This is
an exact transformation (choosing nothing from the transformed group
means choosing the baseline) and keeps the capacity axis reserved for
bytes that still need materializing.

Partition-grained CEs (repro_torch.relational.partition) feed the solver one
item PER PARTITION, each in its own singleton group
(candidates.PartitionKnapsackItem): partitions of a CE are
independently admissible, so under a budget that cannot hold the full
CE the DP admits a strict subset — the CE's hot fraction — and a
partition already resident from an earlier window arrives as a
zero-weight item and rides the same baseline lifting.  The solver only
sees the (value, weight, group) protocol; nothing here is
partition-specific.

``solve_bruteforce`` enumerates all choices and is used by property
tests to validate the DP.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence

from .candidates import KnapsackItem


@dataclass
class MCKPSolution:
    items: List[KnapsackItem]
    total_value: float
    total_weight: int      # true (un-bucketed) bytes
    capacity: int
    buckets: int

    @property
    def ces(self):
        return [ce for item in self.items for ce in item.ces]


def solve_mckp(
    items: Sequence[KnapsackItem],
    capacity: int,
    *,
    max_buckets: int = 4096,
) -> MCKPSolution:
    """DP solution of Eq. 5.  O(g · |G_i| · buckets) time."""
    feasible = [it for it in items if it.weight <= capacity and it.value > 0]
    if not feasible or capacity < 0:
        return MCKPSolution([], 0.0, 0, capacity, 0)

    groups: Dict[int, List[KnapsackItem]] = defaultdict(list)
    for it in feasible:
        groups[it.group].append(it)

    # Lift out zero-weight (already-paid) baselines per group.
    base_value = 0.0
    base_choice: Dict[int, KnapsackItem] = {}
    base_of: Dict[int, float] = {}
    for gid in list(groups):
        zero = [it for it in groups[gid] if it.weight == 0]
        if not zero:
            continue
        best = max(zero, key=lambda it: it.value)
        base_value += best.value
        base_choice[gid] = best
        base_of[gid] = best.value
        # only heavier options that beat the free baseline stay in play
        groups[gid] = [it for it in groups[gid]
                       if it.weight > 0 and it.value > best.value]
        if not groups[gid]:
            del groups[gid]
    if not groups:
        picked0 = list(base_choice.values())
        return MCKPSolution(picked0, base_value, 0, capacity, 0)
    group_ids = sorted(groups)

    resolution = max(1, math.ceil(capacity / max_buckets))
    n_buckets = capacity // resolution
    scaled = {
        id(it): min(n_buckets + 1, math.ceil(it.weight / resolution)) if it.weight > 0 else 0
        for it in feasible
    }

    NEG = float("-inf")
    # dp[c] = best value using groups processed so far with scaled weight ≤ c
    dp = [0.0] * (n_buckets + 1)
    # choice[gi][c] = item chosen for group gi at capacity c (or None)
    choice: List[List[KnapsackItem | None]] = []

    for gi in group_ids:
        new_dp = list(dp)
        ch: List[KnapsackItem | None] = [None] * (n_buckets + 1)
        for it in groups[gi]:
            w = scaled[id(it)]
            if w > n_buckets:
                continue
            v = it.value - base_of.get(gi, 0.0)
            for c in range(n_buckets, w - 1, -1):
                cand = dp[c - w] + v
                if cand > new_dp[c]:
                    new_dp[c] = cand
                    ch[c] = it
        dp = new_dp
        choice.append(ch)

    # Backtrack from the best capacity.
    best_c = max(range(n_buckets + 1), key=lambda c: dp[c])
    picked: List[KnapsackItem] = []
    chosen_groups = set()
    c = best_c
    for gi_idx in range(len(group_ids) - 1, -1, -1):
        it = choice[gi_idx][c]
        if it is not None:
            picked.append(it)
            chosen_groups.add(group_ids[gi_idx])
            c -= scaled[id(it)]
    picked.reverse()
    # groups whose DP choice did not beat their free baseline keep it
    picked.extend(it for gid, it in sorted(base_choice.items())
                  if gid not in chosen_groups)

    total_w = sum(it.weight for it in picked)
    total_v = sum(it.value for it in picked)
    assert total_w <= capacity, "MCKP DP exceeded the memory budget"
    return MCKPSolution(picked, total_v, total_w, capacity, n_buckets)


def solve_bruteforce(items: Sequence[KnapsackItem], capacity: int) -> MCKPSolution:
    """Exact enumeration (exponential) — for tests on small instances."""
    groups: Dict[int, List[KnapsackItem]] = defaultdict(list)
    for it in items:
        groups[it.group].append(it)
    group_lists = [gs + [None] for gs in groups.values()]  # None = skip group

    best: tuple[float, int, List[KnapsackItem]] = (0.0, 0, [])

    def rec(i: int, value: float, weight: int, chosen: List[KnapsackItem]):
        nonlocal best
        if weight > capacity:
            return
        if i == len(group_lists):
            if value > best[0] + 1e-12:
                best = (value, weight, list(chosen))
            return
        for it in group_lists[i]:
            if it is None:
                rec(i + 1, value, weight, chosen)
            else:
                chosen.append(it)
                rec(i + 1, value + it.value, weight + it.weight, chosen)
                chosen.pop()

    rec(0, 0.0, 0, [])
    return MCKPSolution(best[2], best[0], best[1], capacity, 0)

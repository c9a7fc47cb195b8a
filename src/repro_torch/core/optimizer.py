"""End-to-end multi-query optimizer (the paper's four phases, §4).

    input set ──identify SEs──▶ build CEs ──price──▶ Algorithm 2 groups
       ──MCKP(budget)──▶ selected sharing plans ──rewrite──▶ output set

Generic over the plan type: the caller supplies a cost model, a
rewriter, and (optionally) a CE validator — e.g. the relational layer
rejects CEs whose member variants cannot be re-extracted through a
non-commuting operator.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Mapping, Optional, Sequence

from .candidates import PartitionKnapsackItem, generate_knapsack_items
from .costmodel import CostModel, price_ces, price_resident_ce
from .covering import CoveringExpression, build_covering_expressions
from .identify import identify_similar_subexpressions
from .mckp import MCKPSolution, solve_mckp
from .plan import PlanNode
from .rewrite import RewrittenBatch, Rewriter, rewrite_batch
from .telemetry import NOOP_SPAN


@dataclass
class MQOReport:
    n_queries: int = 0
    n_ses: int = 0
    n_ces: int = 0
    n_valid_ces: int = 0
    n_items: int = 0
    n_resident: int = 0
    n_single_resume: int = 0
    n_hinted: int = 0             # CEs re-priced by a cache_hint()
    n_partitioned: int = 0        # CEs split into per-partition items
    n_partition_items: int = 0
    n_resident_parts: int = 0     # partitions re-priced as already paid
    # queries resumed from a resident CE by predicate SUBSUMPTION (no
    # exact fingerprint match; see relational.canonical) — rewritten
    # before this optimizer ran, recorded here so window reports show
    # semantic reuse next to the re-priced residents it composes with
    n_subsumed: int = 0
    n_selected: int = 0
    selected_value: float = 0.0
    selected_weight: int = 0
    budget: int = 0
    optimize_seconds: float = 0.0
    details: dict = field(default_factory=dict)


@dataclass
class OptimizedBatch:
    rewritten: RewrittenBatch
    solution: MCKPSolution
    report: MQOReport


class MultiQueryOptimizer:
    def __init__(
        self,
        cost_model: CostModel,
        rewriter: Rewriter,
        *,
        budget_bytes: int,
        k: int = 2,
        ce_transform: Optional[
            Callable[[CoveringExpression], Optional[CoveringExpression]]
        ] = None,
        max_compound_size: int = 4,
        chain_cache_plans: bool = True,
        partitioner: Optional[Callable[[CoveringExpression],
                                       Optional[tuple]]] = None,
        tracer=None,
    ):
        self.cost_model = cost_model
        self.rewriter = rewriter
        self.budget = int(budget_bytes)
        self.k = k
        self.ce_transform = ce_transform
        self.max_compound_size = max_compound_size
        self.chain_cache_plans = chain_cache_plans
        # plan-type-specific hook splitting an eligible CE into
        # independent per-partition knapsack items (see
        # repro_torch.relational.partition.make_ce_partitioner); returns
        # (plan_record, [slices]) or None
        self.partitioner = partitioner
        # optional SpanTracer (repro_torch.core.telemetry): phase-level spans
        # for the identify / solve stages when tracing is enabled
        self.tracer = tracer

    def _span(self, name: str, **attrs):
        if self.tracer is not None and self.tracer.enabled:
            return self.tracer.span(name, **attrs)
        return NOOP_SPAN

    def optimize(self, plans: Sequence[PlanNode], *,
                 resident: Optional[Mapping[bytes, object]] = None,
                 resident_parts: Optional[Mapping[bytes, object]] = None,
                 hinted: Optional[frozenset] = None
                 ) -> OptimizedBatch:
        """Run the four phases.  ``resident`` maps the ψ of every CE
        still materialized from a previous window (the unified
        MemoryManager's CE pool) to the strict fingerprint(s) of the
        tree(s) that were materialized — a single ``bytes`` value or a
        collection of them (several same-structure CEs with different
        merged predicates can be resident at once under strict-keyed
        caching).  A new CE whose ψ AND strict content both match is
        re-priced as a zero-weight, already-paid knapsack item — its
        C_E and C_W were spent by window *k*, so window *k+1* pays only
        the reads and per-consumer extraction.  (ψ alone is loose: same
        structure, possibly different merged predicates — the strict
        check is what makes reuse sound.)  This turns per-window MQO
        into cross-window work sharing on recurring workloads.

        Single-query resident resume: subexpressions with fewer than
        ``k`` consumers in THIS window are normally never candidates,
        but when their ψ matches a resident CE they are admitted as
        single-member SEs — a lone recurring query can resume from a
        still-resident covering relation instead of recomputing
        (non-matching singles price at negative value and drop out).

        ``hinted`` is the set of loose ψ under ``cache_hint()``-marked
        submissions: their sub-k SEs are admitted as candidates too,
        and a hinted CE that prices at ≤ 0 is re-priced with one
        *phantom future consumer* (the hint asserts the query recurs),
        so a lone hinted query can materialize covering state for later
        windows to resume from — still subject to the budget."""
        t0 = time.perf_counter()
        report = MQOReport(n_queries=len(plans), budget=self.budget)
        res: Mapping[bytes, frozenset] = {}
        if resident:
            res = {psi: (frozenset((s,)) if isinstance(s, bytes)
                         else frozenset(s))
                   for psi, s in resident.items()}
        hinted = hinted or frozenset()

        # Phase 1: similar subexpression identification (Algorithm 1).
        with self._span("mqo.identify", n_queries=len(plans)) as sp:
            if (res or hinted) and self.k > 1:
                # one k=1 walk, partitioned: the >= k SEs are exactly
                # what identify(k=self.k) returns (k only filters at
                # the end), and sub-k SEs whose structure matches a
                # resident CE (or a cache hint) are admitted too, so
                # the strict content check below can decide
                # single-query resident resume
                every = identify_similar_subexpressions(plans, k=1)
                ses = [se for se in every if se.m >= self.k]
                ses += [se for se in every
                        if se.m < self.k and (se.psi in res
                                              or se.psi in hinted)]
            else:
                ses = identify_similar_subexpressions(plans, k=self.k)
            sp.set(n_ses=len(ses))
        report.n_ses = len(ses)

        # Phase 2a: covering expressions (+ plan-type specific transform:
        # extractability validation, projection augmentation, ...).
        ces = build_covering_expressions(ses)
        report.n_ces = len(ces)
        if self.ce_transform is not None:
            ces = [t for t in (self.ce_transform(ce) for ce in ces)
                   if t is not None]
        report.n_valid_ces = len(ces)

        # Phase 2b: pricing (Eq. 1–3) + Algorithm 2 candidate groups.
        price_ces(ces, self.cost_model)
        for ce in ces:
            if ce.psi not in hinted or ce.value > 0:
                continue
            # phantom future consumer: the hint asserts the query
            # recurs, so credit one extra read's worth of sharing —
            # avg per-consumer unshared cost minus the read +
            # extraction it would pay (never a net penalty)
            d = ce.cost_detail
            m = max(ce.m, 1)
            marginal = ((d["C_omega"] - d["C_X"]) / m) - d["C_R"]
            if marginal > 0:
                ce.value += marginal
                ce.cost_detail = {**d, "hinted": True}
                report.n_hinted += 1

        # Partition-grained admission: split eligible CEs into
        # independent per-partition items so the solver can keep the
        # hot fraction of a CE the budget cannot hold whole.  Only CEs
        # structurally disjoint from every other CE are split — a
        # nested CE stays in its Algorithm 2 group, where mutual
        # exclusion with its ancestors/descendants is what keeps
        # value/weight additive.  Must run BEFORE resident re-pricing:
        # a partitioned CE's residency is per partition, so whole-CE
        # re-pricing (which assumes all bytes are resident) would be
        # unsound for it.
        partitioned: List[CoveringExpression] = []
        if self.partitioner is not None:
            for ce in ces:
                if any(o is not ce and (ce.psi in o.fp_set
                                        or o.psi in ce.fp_set)
                       for o in ces):
                    continue
                detail = self.partitioner(ce)
                if detail is not None:
                    ce.partition_detail = detail
                    partitioned.append(ce)
        report.n_partitioned = len(partitioned)

        if res:
            for ce in ces:
                # cheap psi membership first — the strict content hash
                # (a full Merkle walk, memoized on the CE) only runs
                # for actual candidates
                if (ce.partition_detail is None and ce.psi in res
                        and ce.strict_psi() in res[ce.psi]):
                    price_resident_ce(ce)
                    report.n_resident += 1
                    if ce.m < self.k:
                        report.n_single_resume += 1
        items = generate_knapsack_items(
            [ce for ce in ces if ce.partition_detail is None],
            max_compound_size=self.max_compound_size)
        gid = 1 + max((it.group for it in items), default=-1)
        rp = resident_parts or {}
        for ce in partitioned:
            _, slices = ce.partition_detail
            res_pids = rp.get(ce.strict_psi(), frozenset())
            for sl in slices:
                if sl.pid in res_pids:
                    # this partition's bytes are already materialized:
                    # C_E and C_W are sunk, weight is zero (the
                    # per-partition analog of price_resident_ce)
                    item = PartitionKnapsackItem(
                        ce, sl.pid, value=max(sl.resident_value, 1e-12),
                        weight=0, group=gid)
                    report.n_resident_parts += 1
                else:
                    item = PartitionKnapsackItem(
                        ce, sl.pid, value=sl.value, weight=sl.weight,
                        group=gid)
                gid += 1
                if item.value > 0:
                    items.append(item)
        report.n_items = len(items)
        report.n_partition_items = sum(
            1 for it in items if isinstance(it, PartitionKnapsackItem))

        # Phase 3: sharing-plan selection (MCKP, Eq. 5).
        with self._span("mqo.solve", n_items=len(items),
                        budget=self.budget) as sp:
            solution = solve_mckp(items, self.budget)
            sp.set(selected_value=solution.total_value,
                   selected_weight=solution.total_weight)
        for it in solution.items:
            if isinstance(it, PartitionKnapsackItem):
                have = it.ce.admitted_partitions or frozenset()
                it.ce.admitted_partitions = have | {it.pid}
        selected: List[CoveringExpression] = []
        seen_ids = set()
        for ce in solution.ces:
            if id(ce) not in seen_ids:
                seen_ids.add(id(ce))
                selected.append(ce)
        report.n_selected = len(selected)
        report.selected_value = solution.total_value
        report.selected_weight = solution.total_weight

        # Phase 4: query rewriting.
        rewritten = rewrite_batch(
            plans, selected, self.rewriter,
            chain_cache_plans=self.chain_cache_plans)

        report.optimize_seconds = time.perf_counter() - t0
        report.details = {
            "ces": [
                {"label": ce.tree.label, "value": ce.value,
                 "weight": ce.weight, **ce.cost_detail}
                for ce in ces
            ],
        }
        return OptimizedBatch(rewritten=rewritten, solution=solution,
                              report=report)

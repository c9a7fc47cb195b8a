"""Single-query optimizer semantics + cost model properties (Eq. 1–3)."""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.core.costmodel import price_ce
from repro_torch.core.covering import build_covering_expressions
from repro_torch.core.identify import identify_similar_subexpressions
from repro_torch.relational import (ExecContext, I32, Schema, execute,
                                    expr as E, logical as L, make_storage)
from repro_torch.relational.rules import optimize_single
from repro_torch.relational.stats import (RelationalCostModel, StatsRegistry,
                                          build_table_stats, required_columns,
                                          selectivity)

from torch_fixtures import CPU
from torch_oracle import execute_oracle, multiset
from torch_parity import one_torch_thread  # noqa: F401


S_FACT = Schema.of(("a", I32), ("b", I32), ("c", I32))
S_DIM = Schema.of(("k", I32), ("v", I32))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    fact = {c: rng.integers(0, 50, 600).astype(np.int32)
            for c in ("a", "b", "c")}
    dim = {"k": np.arange(64, dtype=np.int32),
           "v": rng.integers(0, 50, 64).astype(np.int32)}
    st_f, _ = make_storage("fact", S_FACT, 600, "columnar", cols=fact)
    st_d, _ = make_storage("dim", S_DIM, 64, "columnar", cols=dim)
    reg = StatsRegistry()
    reg.register("fact", build_table_stats(fact, 600, S_FACT))
    reg.register("dim", build_table_stats(dim, 64, S_DIM))
    return {"storage": {"fact": st_f, "dim": st_d},
            "oracle": {"fact": (S_FACT, 600, fact),
                       "dim": (S_DIM, 64, dim)},
            "reg": reg}


def _plans():
    f = L.scan("fact", S_FACT)
    d = L.scan("dim", S_DIM)
    return [
        f.filter(E.cmp("a", ">", 25)).project("a", "b"),
        f.project("a", "b").filter(E.cmp("a", ">", 25)),
        f.join(d, "a", "k").filter(E.and_(E.cmp("b", "<", 30),
                                          E.cmp("v", ">", 10))),
        f.filter(E.cmp("c", "<", 10)).join(d, "a", "k")
         .project("a", "v").sort("v"),
        f.groupby("a").agg(("n", "count", ""), ("s", "sum", "b")),
    ]


class TestSingleQueryOptimizer:
    def test_semantics_preserved(self, data):
        for plan in _plans():
            opt = optimize_single(plan)
            got = execute(opt, ExecContext(device=CPU,
                                           catalog=data["storage"]))
            want = multiset(execute_oracle(plan, data["oracle"]),
                            plan.schema)
            assert got.row_multiset() == want, L.explain(plan)

    def test_filter_pushed_through_project(self):
        p = (L.scan("fact", S_FACT).project("a", "b")
             .filter(E.cmp("a", ">", 5)))
        opt = optimize_single(p)
        # filter must now sit below the projection
        assert isinstance(opt, L.Project)

    def test_join_filter_split_by_side(self):
        p = (L.scan("fact", S_FACT).join(L.scan("dim", S_DIM), "a", "k")
             .filter(E.and_(E.cmp("b", "<", 30), E.cmp("v", ">", 10))))
        opt = optimize_single(p)

        def filters_below_join(n, below=False):
            found = []
            if isinstance(n, L.Filter) and below:
                found.append(n)
            for c in n.children:
                found += filters_below_join(
                    c, below or isinstance(n, L.Join))
            return found

        assert len(filters_below_join(opt)) == 2

    def test_scan_pruning_inserts_projects(self):
        p = L.scan("fact", S_FACT).filter(E.cmp("a", ">", 5)).project("a")
        opt = optimize_single(p)
        from repro_torch.core.plan import walk

        scans = [n for n in walk(opt) if isinstance(n, L.Scan)]
        parents = [n for n in walk(opt)
                   if scans[0] in n.children]
        assert isinstance(parents[0], (L.Project, L.Filter))


class TestSelectivity:
    def test_bounds(self, data):
        reg = data["reg"]
        for e in [E.cmp("a", ">", 25), E.cmp("a", "==", 3),
                  E.and_(E.cmp("a", ">", 10), E.cmp("b", "<", 5)),
                  E.or_(E.cmp("a", ">", 49), E.cmp("a", "<", 1)),
                  E.not_(E.cmp("c", "!=", 7))]:
            s = selectivity(e, reg)
            assert 0.0 <= s <= 1.0, (E.pretty(e), s)

    def test_range_monotone(self, data):
        reg = data["reg"]
        sels = [selectivity(E.cmp("a", "<", t), reg)
                for t in (5, 15, 25, 35, 45)]
        assert sels == sorted(sels)

    def test_estimates_close_to_truth(self, data):
        reg = data["reg"]
        rng_vals = data["oracle"]["fact"][2]["a"]
        for thr in (10, 25, 40):
            est = selectivity(E.cmp("a", ">", thr), reg)
            true = float((rng_vals > thr).mean())
            assert abs(est - true) < 0.1, (thr, est, true)


class TestCostModelEquations:
    def _ces(self, data, plans):
        plans = [optimize_single(p) for p in plans]
        ses = identify_similar_subexpressions(plans)
        ces = build_covering_expressions(ses)
        cm = RelationalCostModel(data["reg"])
        for ce in ces:
            price_ce(ce, cm)
        return ces, cm

    def test_eq1_unshared_cost_is_sum(self, data):
        f = L.scan("fact", S_FACT)
        plans = [f.filter(E.cmp("a", ">", 10)).project("a"),
                 f.filter(E.cmp("a", ">", 30)).project("b")]
        ces, cm = self._ces(data, plans)
        ce = ces[0]
        total = sum(cm.execution_cost(o.node)
                    for o in ce.se.occurrences)
        assert ce.cost_detail["C_omega"] == pytest.approx(total)

    def test_eq2_structure(self, data):
        """Eq. 2 as the cost model computes it (``core/costmodel.py``,
        ``price_ce``): C_Omega = C_E* + C_W + m*C_R + C_X, the last term
        the extraction cost of the consumers' residuals.  The JAX
        package's copy of this test omits C_X and fails on both
        packages."""
        f = L.scan("fact", S_FACT)
        plans = [f.filter(E.cmp("a", ">", 10)),
                 f.filter(E.cmp("a", ">", 30))]
        ces, cm = self._ces(data, plans)
        ce = ces[0]
        d = ce.cost_detail
        assert d["C_Omega"] == pytest.approx(
            d["C_E_star"] + d["C_W"] + d["m"] * d["C_R"] + d["C_X"])

    def test_eq3_value_increases_with_m(self, data):
        f = L.scan("fact", S_FACT)
        two = [f.filter(E.cmp("a", ">", 10)),
               f.filter(E.cmp("a", ">", 30))]
        three = two + [f.filter(E.cmp("a", ">", 20))]
        ces2, _ = self._ces(data, two)
        ces3, _ = self._ces(data, three)
        by_label2 = max(ce.value for ce in ces2)
        by_label3 = max(ce.value for ce in ces3)
        assert by_label3 > by_label2

    def test_weight_is_rows_times_width(self, data):
        f = L.scan("fact", S_FACT)
        plans = [f.filter(E.cmp("a", ">", 10)).project("a"),
                 f.filter(E.cmp("a", ">", 30)).project("a")]
        ces, cm = self._ces(data, plans)
        for ce in ces:
            assert ce.weight == cm.output_rows(ce.tree) \
                * ce.tree.schema.row_mem_bytes


class TestRequiredColumns:
    def test_join_needs_keys_plus_outputs(self):
        p = (L.scan("fact", S_FACT).join(L.scan("dim", S_DIM), "a", "k")
             .project("b", "v"))
        req = required_columns(p)
        from repro_torch.core.plan import walk

        for n in walk(p):
            if isinstance(n, L.Scan) and n.table == "fact":
                assert req[id(n)] == frozenset({"a", "b"})
            if isinstance(n, L.Scan) and n.table == "dim":
                assert req[id(n)] == frozenset({"k", "v"})


pytestmark = pytest.mark.usefixtures("one_torch_thread")

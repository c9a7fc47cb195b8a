"""Physical operator correctness vs the numpy oracle, incl. CSV parsing."""
import numpy as np
import pytest

from repro_torch.relational import (F32, I32, STR, ExecContext, Schema,
                                    execute, expr as E, logical as L,
                                    make_storage)
from repro_torch.relational.datagen import generate_columns, to_csv_bytes

from torch_fixtures import CPU
from torch_oracle import execute_oracle, multiset
from torch_parity import one_torch_thread  # noqa: F401


SCHEMA = Schema.of(("k", I32), ("v", I32), ("x", F32), ("s", STR(8)))


def _toy(nrows=257, seed=0, fmt="columnar"):
    rng = np.random.default_rng(seed)
    cols = {
        "k": rng.integers(0, 20, nrows).astype(np.int32),
        "v": rng.integers(0, 1000, nrows).astype(np.int32),
        "x": rng.random(nrows).astype(np.float32),
        "s": rng.integers(97, 100, (nrows, 8)).astype(np.uint8),
    }
    st, _ = make_storage("t", SCHEMA, nrows, fmt, cols=cols)
    return st, cols


def _run(plan, storages):
    catalog = {st.name: st for st, _ in storages}
    ctx = ExecContext(device=CPU, catalog=catalog)
    table = execute(plan, ctx)
    return table.row_multiset()


def _expect(plan, storages):
    catalog = {}
    for st, cols in storages:
        if st.fmt == "csv":
            # apply the CSV storage truncation (8 fractional digits) so
            # the oracle sees what the engine can possibly read back
            cols = {
                n: (np.floor(a.astype(np.float64) * 1e8) / 1e8
                    ).astype(np.float32) if a.dtype == np.float32 else a
                for n, a in cols.items()
            }
        catalog[st.name] = (st.schema, st.nrows, cols)
    return multiset(execute_oracle(plan, catalog), plan.schema)


@pytest.mark.parametrize("fmt", ["columnar", "csv"])
class TestScanFormats:
    def test_roundtrip(self, fmt):
        st, cols = _toy(fmt=fmt)
        # exact columns round-trip exactly; the f32 column is checked
        # with allclose in TestCSVParse (CSV digit parse has ~1e-7 noise
        # that can flip the multiset's 4-decimal rounding on knife-edge
        # values).
        plan = L.scan("t", SCHEMA, fmt).project("k", "v", "s")
        assert _run(plan, [(st, cols)]) == _expect(plan, [(st, cols)])

    def test_filter(self, fmt):
        st, cols = _toy(fmt=fmt)
        plan = L.scan("t", SCHEMA, fmt).filter(E.cmp("v", ">", 500))
        assert _run(plan, [(st, cols)]) == _expect(plan, [(st, cols)])


class TestOps:
    def setup_method(self):
        self.st, self.cols = _toy()
        self.scan = L.scan("t", SCHEMA, "columnar")
        self.pair = [(self.st, self.cols)]

    def test_filter_compound_predicate(self):
        p = self.scan.filter(E.or_(
            E.and_(E.cmp("v", ">", 800), E.cmp("k", "<=", 10)),
            E.cmp("x", "<", 0.05),
            E.not_(E.cmp("v", "!=", 3)),
        ))
        assert _run(p, self.pair) == _expect(p, self.pair)

    def test_filter_string_eq(self):
        s0 = bytes(self.cols["s"][0].tobytes())
        p = self.scan.filter(E.cmp("s", "==", s0))
        got = _run(p, self.pair)
        assert got == _expect(p, self.pair)
        assert len(got) >= 1

    def test_filter_empty_result(self):
        p = self.scan.filter(E.cmp("v", ">", 10**8))
        assert _run(p, self.pair) == []

    def test_project(self):
        p = self.scan.project("v", "s")
        assert _run(p, self.pair) == _expect(p, self.pair)

    def test_sort_asc_desc(self):
        for desc in (False, True):
            p = self.scan.project("v", "k").sort("v", desc=desc)
            assert _run(p, self.pair) == _expect(p, self.pair)

    def test_limit(self):
        # limit rows are order-dependent; compare row COUNT + containment
        p = self.scan.sort("v").limit(10)
        got = _run(p, self.pair)
        assert len(got) == 10

    def test_union(self):
        a = self.scan.filter(E.cmp("v", ">", 900)).project("k", "v")
        b = self.scan.filter(E.cmp("v", "<", 50)).project("k", "v")
        p = a.union(b)
        assert _run(p, self.pair) == _expect(p, self.pair)

    def test_aggregate_all_fns(self):
        p = self.scan.groupby("k").agg(
            ("n", "count", ""), ("sv", "sum", "v"), ("mn", "min", "v"),
            ("mx", "max", "v"), ("avg", "mean", "x"))
        assert _run(p, self.pair) == _expect(p, self.pair)

    def test_aggregate_multikey(self):
        st2, cols2 = _toy(nrows=300, seed=3)
        p = (L.scan("t", SCHEMA, "columnar")
             .filter(E.cmp("v", "<", 500))
             .groupby("k", "v").agg(("n", "count", "")))
        assert _run(p, [(st2, cols2)]) == _expect(p, [(st2, cols2)])


class TestJoin:
    def _two(self, nl=211, nr=97, dup=True, seed=1):
        rng = np.random.default_rng(seed)
        sl = Schema.of(("a", I32), ("p", I32))
        sr = Schema.of(("b", I32), ("q", I32))
        lcols = {"a": rng.integers(0, 40, nl).astype(np.int32),
                 "p": rng.integers(0, 100, nl).astype(np.int32)}
        hi = 40 if dup else nr
        rcols = {"b": (rng.integers(0, hi, nr).astype(np.int32) if dup
                       else np.arange(nr, dtype=np.int32)),
                 "q": rng.integers(0, 100, nr).astype(np.int32)}
        stl, _ = make_storage("l", sl, nl, "columnar", cols=lcols)
        str_, _ = make_storage("r", sr, nr, "columnar", cols=rcols)
        return (stl, lcols), (str_, rcols), sl, sr

    def test_many_to_many(self):
        (stl, lc), (str_, rc), sl, sr = self._two(dup=True)
        p = L.scan("l", sl).join(L.scan("r", sr), "a", "b")
        assert _run(p, [(stl, lc), (str_, rc)]) == _expect(
            p, [(stl, lc), (str_, rc)])

    def test_fk_join(self):
        (stl, lc), (str_, rc), sl, sr = self._two(dup=False)
        p = L.scan("l", sl).join(L.scan("r", sr), "a", "b")
        assert _run(p, [(stl, lc), (str_, rc)]) == _expect(
            p, [(stl, lc), (str_, rc)])

    def test_join_no_matches(self):
        (stl, lc), (str_, rc), sl, sr = self._two()
        p = (L.scan("l", sl).filter(E.cmp("a", ">", 1000))
             .join(L.scan("r", sr), "a", "b"))
        assert _run(p, [(stl, lc), (str_, rc)]) == []

    def test_join_after_filters_with_stale_padding(self):
        # regression: compaction slack rows must never match (the
        # searchsorted sentinel bug)
        (stl, lc), (str_, rc), sl, sr = self._two(nl=300, nr=100)
        p = (L.scan("l", sl).filter(E.cmp("p", ">", 50))
             .join(L.scan("r", sr).filter(E.cmp("q", "<", 50)), "a", "b"))
        assert _run(p, [(stl, lc), (str_, rc)]) == _expect(
            p, [(stl, lc), (str_, rc)])


class TestCSVParse:
    def test_csv_int_parse_exact(self):
        rng = np.random.default_rng(0)
        vals = np.concatenate([
            np.array([0, 1, 999_999_999], np.int32),
            rng.integers(0, 10**9, 61).astype(np.int32)])
        schema = Schema.of(("v", I32))
        csv = to_csv_bytes(schema, {"v": vals}, len(vals))
        st = __import__("repro_torch.relational.physical",
                        fromlist=["TableStorage"]
                        ).TableStorage("t", schema, len(vals), "csv",
                                       csv_bytes=csv)
        ctx = ExecContext(device=CPU, catalog={"t": st})
        out = execute(L.scan("t", schema, "csv"), ctx)
        np.testing.assert_array_equal(
            np.asarray(out.columns["v"])[: len(vals)], vals)

    def test_csv_float_parse_close(self):
        rng = np.random.default_rng(0)
        vals = rng.random(64).astype(np.float32)
        schema = Schema.of(("x", F32))
        csv = to_csv_bytes(schema, {"x": vals}, len(vals))
        from repro_torch.relational.physical import TableStorage

        st = TableStorage("t", schema, len(vals), "csv", csv_bytes=csv)
        ctx = ExecContext(device=CPU, catalog={"t": st})
        out = execute(L.scan("t", schema, "csv"), ctx)
        np.testing.assert_allclose(
            np.asarray(out.columns["x"])[: len(vals)], vals, atol=1e-6)


class TestPallasFilterPath:
    """The engine's kernel-accelerated filter must agree with XLA."""

    def test_numeric_predicates_match(self):
        st, cols = _toy(nrows=1500, seed=5)
        plan = (L.scan("t", SCHEMA, "columnar")
                .filter(E.or_(E.and_(E.cmp("v", ">", 300),
                                     E.cmp("k", "<=", 15)),
                              E.cmp("x", "<", 0.1)))
                .project("k", "v"))
        ctx_x = ExecContext(device=CPU, catalog={"t": st})
        ctx_p = ExecContext(device=CPU, catalog={"t": st},
                            use_pallas_filter=True)
        a = execute(plan, ctx_x).row_multiset()
        b = execute(plan, ctx_p).row_multiset()
        assert a == b and len(a) > 0

    def test_string_predicate_falls_back(self):
        st, cols = _toy(nrows=300, seed=6)
        s0 = bytes(cols["s"][0].tobytes())
        plan = L.scan("t", SCHEMA, "columnar").filter(
            E.cmp("s", "==", s0))
        ctx_p = ExecContext(device=CPU, catalog={"t": st},
                            use_pallas_filter=True)
        ctx_x = ExecContext(device=CPU, catalog={"t": st})
        assert (execute(plan, ctx_p).row_multiset()
                == execute(plan, ctx_x).row_multiset())


pytestmark = pytest.mark.usefixtures("one_torch_thread")

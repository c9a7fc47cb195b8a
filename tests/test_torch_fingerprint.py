"""Fingerprint (Merkle-tree) properties: Definitions 1–3 of the paper."""
import numpy as np
import pytest

from repro_torch.core import fingerprint, all_fingerprints, tree_size
from repro_torch.relational import I32, STR, Schema, expr as E, logical as L

from torch_parity import one_torch_thread  # noqa: F401


S_EMP = Schema.of(("emp_id", I32), ("age", I32), ("gender", STR(4)),
                  ("dep", I32))
S_DEPT = Schema.of(("dept_id", I32), ("budget", I32))


def scan_emp():
    return L.scan("employees", S_EMP)


def scan_dept():
    return L.scan("departments", S_DEPT)


class TestLooseIdentity:
    def test_filters_with_different_predicates_share_fingerprint(self):
        a = scan_emp().filter(E.cmp("age", ">", 30))
        b = scan_emp().filter(E.cmp("age", "<", 20))
        assert fingerprint(a) == fingerprint(b)

    def test_projects_with_different_columns_share_fingerprint(self):
        a = scan_emp().project("emp_id")
        b = scan_emp().project("age", "dep")
        assert fingerprint(a) == fingerprint(b)

    def test_scan_of_different_tables_differ(self):
        assert fingerprint(scan_emp()) != fingerprint(scan_dept())

    def test_scan_of_different_formats_differ(self):
        a = L.scan("employees", S_EMP, "csv")
        b = L.scan("employees", S_EMP, "columnar")
        assert fingerprint(a) != fingerprint(b)


class TestStrictIdentity:
    def test_different_join_keys_differ(self):
        j1 = scan_emp().join(scan_dept(), "dep", "dept_id")
        j2 = scan_emp().join(scan_dept(), "emp_id", "dept_id")
        assert fingerprint(j1) != fingerprint(j2)

    def test_different_aggregates_differ(self):
        a = scan_emp().groupby("dep").agg(("n", "count", ""))
        b = scan_emp().groupby("dep").agg(("s", "sum", "age"))
        assert fingerprint(a) != fingerprint(b)

    def test_limit_n_matters(self):
        assert fingerprint(scan_emp().limit(5)) != fingerprint(
            scan_emp().limit(6))


class TestIsomorphism:
    def test_join_operand_order_is_isomorphic(self):
        j1 = scan_emp().join(scan_dept(), "dep", "dept_id")
        j2 = scan_dept().join(scan_emp(), "dept_id", "dep")
        assert fingerprint(j1) == fingerprint(j2)

    def test_union_operand_order_is_isomorphic(self):
        a = scan_emp().filter(E.cmp("age", ">", 1)).project("emp_id")
        b = scan_emp().filter(E.cmp("age", "<", 9)).project("emp_id")
        assert fingerprint(a.union(b)) == fingerprint(b.union(a))


class TestStructure:
    def test_different_shapes_differ(self):
        a = scan_emp().filter(E.cmp("age", ">", 30))
        b = scan_emp().filter(E.cmp("age", ">", 30)).project("emp_id")
        c = scan_emp().project("emp_id").filter(E.cmp("emp_id", ">", 30))
        fps = {fingerprint(a), fingerprint(b), fingerprint(c)}
        assert len(fps) == 3

    def test_all_fingerprints_covers_every_subtree(self):
        plan = (scan_emp().filter(E.cmp("age", ">", 30))
                .join(scan_dept(), "dep", "dept_id")
                .project("emp_id", "budget"))
        fps = all_fingerprints(plan)
        assert len(fps) == tree_size(plan)

    def test_deep_plan_no_recursion_error(self):
        node = scan_emp()
        for i in range(2000):
            node = node.filter(E.cmp("age", ">", i % 60))
        assert fingerprint(node)  # must not hit the recursion limit


pytestmark = pytest.mark.usefixtures("one_torch_thread")

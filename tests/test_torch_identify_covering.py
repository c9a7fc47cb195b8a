"""Algorithm 1 (SE identification) + CE construction (Definition 4)."""
import pytest

from repro_torch.core import (build_covering_expression, fingerprint,
                              identify_similar_subexpressions)
from repro_torch.relational import I32, STR, Schema, expr as E, logical as L

from torch_fixtures import CPU, hr_session  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401


S = Schema.of(("a", I32), ("b", I32), ("c", STR(4)))


def sc():
    return L.scan("t", S)


class TestIdentify:
    def test_running_example_counts(self, hr_session):
        from torch_fixtures import hr_queries

        from repro_torch.relational.rules import optimize_single

        plans = [optimize_single(q) for q in hr_queries(hr_session)]
        ses = identify_similar_subexpressions(plans)
        # ψ2-analog: filter/project over employees shared by all 3 queries
        ms = sorted(se.m for se in ses)
        assert len(ses) >= 3
        assert any(se.m == 3 for se in ses), ms

    def test_stops_high_when_no_unfriendly_ops(self):
        # Whole plans match and contain no joins: only ONE SE (the root),
        # not one per level — Algorithm 1 stops as high as possible.
        p1 = sc().filter(E.cmp("a", ">", 1)).project("a")
        p2 = sc().filter(E.cmp("a", ">", 2)).project("a", "b")
        ses = identify_similar_subexpressions([p1, p2])
        assert len(ses) == 1
        assert ses[0].occurrences[0].node.label == "project"

    def test_descends_through_unfriendly_roots(self):
        # Join roots are never SEs, but their friendly inputs are found.
        l1 = sc().filter(E.cmp("a", ">", 1))
        l2 = sc().filter(E.cmp("a", ">", 5))
        other = L.scan("u", S)
        p1 = l1.join(other, "a", "a")  # join: unfriendly root
        p2 = l2.join(other, "a", "a")
        ses = identify_similar_subexpressions([p1, p2])
        labels = {se.occurrences[0].node.label for se in ses}
        assert "filter" in labels
        assert "join" not in labels

    def test_threshold_k(self):
        p1 = sc().filter(E.cmp("a", ">", 1))
        p2 = sc().filter(E.cmp("a", ">", 2))
        p3 = L.scan("u", S).filter(E.cmp("b", ">", 3))
        assert len(identify_similar_subexpressions([p1, p2, p3], k=2)) == 1
        assert len(identify_similar_subexpressions([p1, p2, p3], k=3)) == 0

    def test_syntactically_equal_joins_shared_inside_se(self):
        # cache-unfriendly ops are shareable when syntactically equal,
        # surrounded by friendly operators (the ψ1 case of the paper).
        def mk(sel):
            return (sc().filter(E.cmp("a", ">", 0))
                    .join(L.scan("u", S).filter(E.cmp("b", ">", 0)),
                          "a", "b")
                    .project(*sel))

        p1, p2 = mk(("a",)), mk(("b",))
        ses = identify_similar_subexpressions([p1, p2])
        assert any(se.occurrences[0].node.label == "project" and
                   se.occurrences[0].node.children[0].label == "join"
                   for se in ses)


class TestCovering:
    def test_or_merge_and_union_cols(self):
        p1 = sc().filter(E.cmp("a", ">", 10)).project("a")
        p2 = sc().filter(E.cmp("b", "==", 5)).project("b")
        ses = identify_similar_subexpressions([p1, p2])
        ce = build_covering_expression(ses[0])
        proj = ce.tree
        filt = proj.children[0]
        assert isinstance(filt.pred, E.Or)
        assert set(proj.cols) >= {"a", "b"}

    def test_ce_fingerprint_matches_members(self):
        p1 = sc().filter(E.cmp("a", ">", 10)).project("a")
        p2 = sc().filter(E.cmp("b", "==", 5)).project("b")
        ses = identify_similar_subexpressions([p1, p2])
        ce = build_covering_expression(ses[0])
        assert fingerprint(ce.tree) == ses[0].psi

    def test_equal_members_produce_identical_ce(self):
        p1 = sc().filter(E.cmp("a", ">", 10)).project("a")
        p2 = sc().filter(E.cmp("a", ">", 10)).project("a")
        ses = identify_similar_subexpressions([p1, p2])
        ce = build_covering_expression(ses[0])
        assert not ce.tree.divergent
        assert E.canonical(ce.tree.children[0].pred) == E.canonical(
            E.cmp("a", ">", 10))

    def test_duplicate_predicates_removed_in_or(self):
        p1 = sc().filter(E.cmp("a", ">", 10))
        p2 = sc().filter(E.cmp("a", ">", 10))
        p3 = sc().filter(E.cmp("a", "<", 2))
        ses = identify_similar_subexpressions([p1, p2, p3])
        ce = build_covering_expression(ses[0])
        assert isinstance(ce.tree.pred, E.Or)
        assert len(ce.tree.pred.parts) == 2  # dedup of the repeated pred


pytestmark = pytest.mark.usefixtures("one_torch_thread")

"""The port's relational MQO slice against the JAX package, end to end.

A TPC-DS catalog at ``scale_rows=5_000`` is built once as JAX
``TableStorage`` and carried into the port with
``carry.storage_from_reference``, so both packages scan the same bytes.
The 50 queries go through a ``QueryService`` (windows of 8) cold then
warm, in both storage formats, and are compared under the parity
contract of ``torch_parity.py``: results, MQO decisions, and the
plan-shape cache's hit rate.  The HR example and the port's own
identities (fused = eager, batched = per-query) are in
``test_torch_slice_hr.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.relational.tpcds import generate_tpcds_catalog  # noqa: E402
from repro.relational.tpcds import tpcds_queries as j_tpcds  # noqa: E402
from repro_torch.relational.tpcds import tpcds_queries as t_tpcds  # noqa
from torch_parity import assert_parity, run_both  # noqa: E402


@pytest.fixture(scope="module")
def tpcds_catalog():
    return generate_tpcds_catalog(5_000, 0)


@pytest.fixture(scope="module", params=["columnar", "csv"])
def tpcds_runs(request, tpcds_catalog):
    return request.param, run_both(tpcds_catalog, request.param, j_tpcds,
                                    t_tpcds)


def test_tpcds_results_match_jax(tpcds_runs):
    fmt, runs = tpcds_runs
    for p, ((jt, _, _), (tt, _, _)) in enumerate(runs):
        assert len(jt) == len(tt) == 50
        for i, (a, b) in enumerate(zip(jt, tt)):
            assert_parity(a, b, f"{fmt}/pass{p}/q{i}")


def test_tpcds_mqo_decisions_match_jax(tpcds_runs):
    fmt, runs = tpcds_runs
    for p, ((_, jd, _), (_, td, _)) in enumerate(runs):
        assert len(jd) == len(td) == 51
        for i, (a, b) in enumerate(zip(jd, td)):
            assert a == b, (fmt, p, i)
    # the stream really shares work: SEs found in every window, CEs
    # consumed, resident on pass 2
    per_query, windows = runs[0][1][1][:-1], runs[0][1][1][-1]
    assert len([w for w in windows if w[0] == "mqo.identify"]) == 7
    assert all(dict(w[1])["n_ses"] > 0 for w in windows
               if w[0] == "mqo.identify")
    assert any(d[1] for d in per_query)
    assert any(ce[-1] for d in runs[1][1][1][:-1] for ce in d[1])


def test_tpcds_trace_hit_rate_is_one_when_warm(tpcds_runs):
    _, runs = tpcds_runs
    (_, _, jtrace), (_, _, ttrace) = runs[1]
    for hits, misses in (jtrace, ttrace):
        assert misses == 0 and hits > 0

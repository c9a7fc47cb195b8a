"""The HR example through both packages, and the port's own identities.

The paper's running-example catalog (``conftest.hr_data``) is carried
into the port with ``carry.storage_from_reference`` and its three
queries run through ``QueryService`` windows in both packages, cold then
warm, in both storage formats, under the parity contract of
``torch_parity.py``.  Inside the port the reference's identities
hold bit for bit on the TPC-DS stream: fused = eager and window-batched
= per-query.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.relational as T  # noqa: E402
from conftest import hr_queries  # noqa: E402
from repro.relational.tpcds import generate_tpcds_catalog  # noqa: E402
from repro_torch.core.fingerprint import strict_fingerprint as t_strict
from repro_torch.relational.tpcds import tpcds_queries as t_tpcds  # noqa
from torch_parity import assert_parity, run_both, sessions, stream  # noqa


@pytest.fixture(scope="module")
def tpcds_catalog():
    return generate_tpcds_catalog(5_000, 0)


def _port_hr_queries(sess):
    """``conftest.hr_queries`` spelled with the port's expression IR."""
    E = T.expr
    emp, dept, sal = (sess.table("employees"), sess.table("departments"),
                      sess.table("salaries"))
    q1 = (emp.filter(E.cmp("gender", "==", "F"))
          .join(dept.filter(E.cmp("location", "==", "us")),
                "dep", "dept_id")
          .join(sal.filter(E.cmp("salary", ">", 20000)),
                "emp_id", "sal_emp_id")
          .project("name", "dept_name", "salary")
          .sort("salary", desc=True))
    q2 = (emp.filter(E.cmp("gender", "==", "F"))
          .join(dept.filter(E.cmp("location", "==", "us")),
                "dep", "dept_id")
          .join(sal.filter(E.cmp("from_year", ">=", 2010)),
                "emp_id", "sal_emp_id")
          .project("name", "dept_name", "from_year"))
    q3 = (emp.filter(E.cmp("age", ">", 30))
          .join(sal.filter(E.cmp("salary", ">", 30000)),
                "emp_id", "sal_emp_id")
          .project("emp_id", "name", "salary", "from_year"))
    return [q1, q2, q3]


@pytest.mark.parametrize("fmt", ["columnar", "csv"])
def test_hr_queries_match_jax(hr_data, fmt):
    runs = run_both(hr_data, fmt, hr_queries, _port_hr_queries)
    for p, ((jt, jd, _), (tt, td, _)) in enumerate(runs):
        for i, (a, b) in enumerate(zip(jt, tt)):
            assert_parity(a, b, f"hr/{fmt}/pass{p}/q{i}")
        assert jd == td


def _port_stream(catalog, fmt, **exec_kw):
    _, ts = sessions(catalog, fmt, **exec_kw)
    return stream(ts, t_tpcds(ts), t_strict)[0]


@pytest.mark.parametrize("fmt", ["columnar", "csv"])
def test_port_fused_equals_eager(tpcds_catalog, fmt):
    fused = _port_stream(tpcds_catalog, fmt)
    eager = _port_stream(tpcds_catalog, fmt, fuse=False, defer_sync=False,
                         use_scan_cache=False)
    for i, (a, b) in enumerate(zip(fused, eager)):
        assert_parity(a, b, f"{fmt}/q{i}", rtol=0)


@pytest.mark.parametrize("fmt", ["columnar", "csv"])
def test_port_batched_equals_per_query(tpcds_catalog, fmt):
    batched = _port_stream(tpcds_catalog, fmt)
    single = _port_stream(tpcds_catalog, fmt, window_batch=False)
    for i, (a, b) in enumerate(zip(batched, single)):
        assert_parity(a, b, f"{fmt}/q{i}", rtol=0)

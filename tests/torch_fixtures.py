"""The port's counterparts of ``conftest.py``'s session fixtures.

``hr_data`` (the paper's running-example catalog as typed numpy
columns) is ``conftest.py``'s own fixture; the sessions built over it
here are the port's, on the CPU.  A test module takes ``hr_session`` by
importing it from here, which shadows ``conftest.py``'s JAX session.
"""
import pytest
import torch

from repro_torch.relational import (Session, SessionConfig, expr as E,
                                    make_storage)

CPU = torch.device("cpu")


def build_session(hr_data, fmt="columnar", budget=1 << 26,
                  device=CPU) -> Session:
    sess = Session.from_config(
        SessionConfig.from_legacy_kwargs(budget_bytes=budget),
        device=device)
    for name, (schema, nrows, cols) in hr_data.items():
        st, _ = make_storage(name, schema, nrows, fmt, cols=cols)
        sess.register(st, columnar_for_stats=cols)
    return sess


@pytest.fixture()
def hr_session(hr_data):
    return build_session(hr_data)


def hr_queries(sess: Session):
    """The paper's three running-example queries (§3)."""
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

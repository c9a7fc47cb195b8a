"""TPC-DS-analog star-schema workload (paper §6.2 macro-benchmark).

A scaled-down retail star schema (store_sales fact + item / customer /
store / date_dim dimensions) and a deterministic library of 50 queries
in the style of the TPC-DS templates runnable on this engine
(joins + filters + projections + aggregations).  Queries come in
parameterized template families, so a batch naturally exhibits the
similar-subexpression structure the paper exploits: same operator trees
with different predicates/columns.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .api import Relation, c
from .executor import Session
from .schema import F32, I32, STR, Schema
from .service import SessionConfig

STORE_SALES = Schema.of(
    ("ss_sold_date_sk", I32), ("ss_item_sk", I32), ("ss_customer_sk", I32),
    ("ss_store_sk", I32), ("ss_quantity", I32),
    ("ss_wholesale_cost", F32), ("ss_list_price", F32),
    ("ss_sales_price", F32), ("ss_ext_sales_price", F32),
    ("ss_net_profit", F32),
)
ITEM = Schema.of(
    ("i_item_sk", I32), ("i_brand_id", I32), ("i_category_id", I32),
    ("i_category", STR(12)), ("i_current_price", F32), ("i_manager_id", I32),
)
CUSTOMER = Schema.of(
    ("c_customer_sk", I32), ("c_birth_year", I32), ("c_birth_month", I32),
    ("c_gender", STR(4)), ("c_preferred", STR(4)),
)
STORE = Schema.of(
    ("s_store_sk", I32), ("s_state", STR(4)), ("s_number_employees", I32),
    ("s_floor_space", I32),
)
DATE_DIM = Schema.of(
    ("d_date_sk", I32), ("d_year", I32), ("d_moy", I32), ("d_dow", I32),
)

CATEGORIES = [b"Books", b"Electronics", b"Home", b"Jewelry", b"Music",
              b"Shoes", b"Sports", b"Toys", b"Women", b"Men"]
STATES = [b"CA", b"TX", b"NY", b"WA", b"GA", b"OH", b"IL", b"MI"]


def _pad(vals: List[bytes], width: int, n: int, rng) -> np.ndarray:
    pool = np.zeros((len(vals), width), np.uint8)
    for i, v in enumerate(vals):
        b = v[:width]
        pool[i, : len(b)] = np.frombuffer(b, np.uint8)
    return pool[rng.integers(0, len(vals), n)]


def generate_tpcds_catalog(scale_rows: int = 100_000, seed: int = 0
                           ) -> Dict[str, Tuple[Schema, int, dict]]:
    """Typed numpy columns for every table; fact table = scale_rows."""
    rng = np.random.default_rng(seed)
    n_item, n_cust, n_store = 2000, 5000, 100
    n_date = 365 * 5

    item = {
        "i_item_sk": np.arange(n_item, dtype=np.int32),
        "i_brand_id": rng.integers(1, 100, n_item).astype(np.int32),
        "i_category_id": rng.integers(1, 11, n_item).astype(np.int32),
        "i_category": _pad(CATEGORIES, 12, n_item, rng),
        "i_current_price": (rng.random(n_item) * 100).astype(np.float32),
        "i_manager_id": rng.integers(1, 50, n_item).astype(np.int32),
    }
    customer = {
        "c_customer_sk": np.arange(n_cust, dtype=np.int32),
        "c_birth_year": rng.integers(1930, 2005, n_cust).astype(np.int32),
        "c_birth_month": rng.integers(1, 13, n_cust).astype(np.int32),
        "c_gender": _pad([b"F", b"M"], 4, n_cust, rng),
        "c_preferred": _pad([b"Y", b"N"], 4, n_cust, rng),
    }
    store = {
        "s_store_sk": np.arange(n_store, dtype=np.int32),
        "s_state": _pad(STATES, 4, n_store, rng),
        "s_number_employees": rng.integers(50, 1000, n_store
                                           ).astype(np.int32),
        "s_floor_space": rng.integers(1000, 100000, n_store
                                      ).astype(np.int32),
    }
    date_dim = {
        "d_date_sk": np.arange(n_date, dtype=np.int32),
        "d_year": (1998 + (np.arange(n_date) // 365)).astype(np.int32),
        "d_moy": (1 + (np.arange(n_date) % 365) // 31).astype(np.int32)
        .clip(1, 12),
        "d_dow": (np.arange(n_date) % 7).astype(np.int32),
    }
    n = scale_rows
    wholesale = (rng.random(n) * 80).astype(np.float32)
    list_price = wholesale * (1.2 + rng.random(n).astype(np.float32))
    sales_price = list_price * (0.5 + 0.5 * rng.random(n)
                                ).astype(np.float32)
    qty = rng.integers(1, 100, n).astype(np.int32)
    store_sales = {
        "ss_sold_date_sk": rng.integers(0, n_date, n).astype(np.int32),
        "ss_item_sk": rng.integers(0, n_item, n).astype(np.int32),
        "ss_customer_sk": rng.integers(0, n_cust, n).astype(np.int32),
        "ss_store_sk": rng.integers(0, n_store, n).astype(np.int32),
        "ss_quantity": qty,
        "ss_wholesale_cost": wholesale,
        "ss_list_price": list_price,
        "ss_sales_price": sales_price,
        "ss_ext_sales_price": sales_price * qty,
        "ss_net_profit": (sales_price - wholesale) * qty,
    }
    return {
        "store_sales": (STORE_SALES, n, store_sales),
        "item": (ITEM, n_item, item),
        "customer": (CUSTOMER, n_cust, customer),
        "store": (STORE, n_store, store),
        "date_dim": (DATE_DIM, n_date, date_dim),
    }


def build_tpcds_session(scale_rows: int = 100_000, fmt: str = "columnar",
                        budget_bytes: int = 1 << 30, seed: int = 0,
                        config: SessionConfig = None,
                        device=None, **session_kw) -> Session:
    """``session_kw`` forwards memory-hierarchy knobs (policy,
    host_budget_bytes, retain_across_batches, ...); they are folded
    into a :class:`SessionConfig` here, so this helper stays off the
    deprecated legacy-kwargs path.  A full ``config`` (e.g. one
    carrying resilience/fault-injection settings) takes precedence
    and must not be mixed with legacy knobs.  ``device`` is the
    Session's (None -> cuda)."""
    from .datagen import make_storage

    catalog = generate_tpcds_catalog(scale_rows, seed)
    if config is not None:
        assert not session_kw and budget_bytes == 1 << 30, \
            "pass either a full SessionConfig or legacy knobs, not both"
        cfg = config
    else:
        cfg = SessionConfig.from_legacy_kwargs(budget_bytes=budget_bytes,
                                               **session_kw)
    sess = Session.from_config(cfg, device=device)
    for name, (schema, nrows, cols) in catalog.items():
        st, _ = make_storage(name, schema, nrows, fmt, cols=cols)
        sess.register(st, columnar_for_stats=cols)
    return sess


# ---------------------------------------------------------------------------
# the 50-query workload (parameterized template families)
# ---------------------------------------------------------------------------
def tpcds_queries(sess: Session) -> List[Relation]:
    """50 deterministic queries over the star schema, written against
    the fluent :class:`Relation` frontend (``where``/``select`` with
    the operator-overloaded ``c`` column namespace).

    Families (≈ TPC-DS query shapes, adapted to the engine's operator
    set): sales-by-category, customer demographics, store performance,
    profitability scans, date-window reports.  Parameters vary inside a
    family, producing loose-identical plans (the paper's SE setting).
    """
    ss = sess.table("store_sales")
    it = sess.table("item")
    cu = sess.table("customer")
    st_ = sess.table("store")
    dd = sess.table("date_dim")

    qs: List[Relation] = []

    # F1 (10 queries): category sales report for a given year
    #   ss ⋈ item (by category filter) ⋈ date (by year) → agg by brand
    for year, cat in [(1998, b"Books"), (1999, b"Books"),
                      (2000, b"Electronics"), (2001, b"Electronics"),
                      (1998, b"Home"), (1999, b"Sports"),
                      (2000, b"Toys"), (2001, b"Music"),
                      (1999, b"Shoes"), (2000, b"Books")]:
        q = (ss.join(it.where(c.i_category == cat),
                     "ss_item_sk", "i_item_sk")
             .join(dd.where(c.d_year == int(year)),
                   "ss_sold_date_sk", "d_date_sk")
             .group_by("i_brand_id")
             .agg(("total_sales", "sum", "ss_ext_sales_price"),
                  ("n", "count", "")))
        qs.append(q)

    # F2 (10 queries): high-value sales scans with price thresholds;
    # the last two are loss-leader scans whose col-col compare now also
    # routes through the fused filter kernel (postfix "ltc" ops)
    for thr in (50, 60, 70, 80, 90, 55, 65, 75):
        q = (ss.where((c.ss_sales_price > float(thr))
                      & (c.ss_quantity >= 10))
             .select("ss_item_sk", "ss_customer_sk", "ss_sales_price",
                     "ss_net_profit"))
        qs.append(q)
    for min_qty in (10, 25):
        q = (ss.where((c.ss_sales_price < c.ss_wholesale_cost)
                      & (c.ss_quantity >= min_qty))
             .select("ss_item_sk", "ss_customer_sk", "ss_sales_price",
                     "ss_net_profit"))
        qs.append(q)

    # F3 (8 queries): customer demographics per gender / birth cohort
    for gender, y0 in [(b"F", 1960), (b"M", 1960), (b"F", 1975),
                       (b"M", 1975), (b"F", 1990), (b"M", 1990),
                       (b"F", 1950), (b"M", 1950)]:
        q = (ss.join(cu.where((c.c_gender == gender)
                              & (c.c_birth_year >= y0)),
                     "ss_customer_sk", "c_customer_sk")
             .group_by("c_birth_year")
             .agg(("spend", "sum", "ss_ext_sales_price")))
        qs.append(q)

    # F4 (8 queries): store performance by state
    for state in STATES:
        q = (ss.join(st_.where(c.s_state == state),
                     "ss_store_sk", "s_store_sk")
             .group_by("s_store_sk")
             .agg(("profit", "sum", "ss_net_profit"),
                  ("vol", "sum", "ss_quantity")))
        qs.append(q)

    # F5 (6 queries): profitability scans (projection-heavy)
    for lo in (0.0, 10.0, 20.0, 30.0, 40.0, 50.0):
        q = (ss.where(c.ss_net_profit > lo)
             .select("ss_item_sk", "ss_net_profit")
             .sort("ss_net_profit", desc=True)
             .limit(100))
        qs.append(q)

    # F6 (8 queries): monthly windows inside a year
    for year, moy in [(1998, 11), (1998, 12), (1999, 11), (1999, 12),
                      (2000, 6), (2000, 7), (2001, 1), (2001, 2)]:
        q = (ss.join(dd.where((c.d_year == year) & (c.d_moy == moy)),
                     "ss_sold_date_sk", "d_date_sk")
             .join(it, "ss_item_sk", "i_item_sk")
             .group_by("i_category_id")
             .agg(("rev", "sum", "ss_ext_sales_price")))
        qs.append(q)

    assert len(qs) == 50
    return qs

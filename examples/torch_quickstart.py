"""Quickstart on the PyTorch port: the paper's running example (§3) end
to end, written against the fluent lazy :class:`Relation` frontend, on
the GPU unless ``--device`` says otherwise (the port's counterpart of
``examples/quickstart.py``).

Three HR queries share scans, filters and a join; queries are composed
with the operator-overloaded column namespace ``c`` (``c.salary >
20000``, combined with ``&``/``|``/``~``), compiled through the
canonical plan IR — so any syntactic spelling of the same query maps
to one fingerprint — and optimized as a batch: the multi-query
optimizer finds the similar subexpressions, builds covering sharing
plans, selects them under a memory budget via the multiple-choice
knapsack, rewrites the batch, and the engine executes it with the
covering relations cached in (device) RAM.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.relational import (I32, STR, MemoryConfig, Partitioning,
                              QueryService, Schema, Session, SessionConfig,
                              c, make_storage)


def build_catalog(sess: Session, seed: int = 7):
    rng = np.random.default_rng(seed)
    n_emp, n_dept, n_sal = 20_000, 60, 40_000
    gender = np.zeros((n_emp, 4), np.uint8)
    gender[:, 0] = np.where(rng.random(n_emp) < 0.5, ord("F"), ord("M"))
    loc = np.zeros((n_dept, 4), np.uint8)
    us = rng.random(n_dept) < 0.5
    loc[us, 0], loc[us, 1] = ord("u"), ord("s")
    loc[~us, 0], loc[~us, 1] = ord("f"), ord("r")
    tables = {
        "employees": (Schema.of(
            ("emp_id", I32), ("name", STR(12)), ("gender", STR(4)),
            ("age", I32), ("dep", I32)), n_emp, {
            "emp_id": np.arange(n_emp, dtype=np.int32),
            "name": rng.integers(97, 123, (n_emp, 12)).astype(np.uint8),
            "gender": gender,
            "age": rng.integers(18, 65, n_emp).astype(np.int32),
            "dep": rng.integers(0, n_dept, n_emp).astype(np.int32)}),
        "departments": (Schema.of(
            ("dept_id", I32), ("dept_name", STR(12)),
            ("location", STR(4))), n_dept, {
            "dept_id": np.arange(n_dept, dtype=np.int32),
            "dept_name": rng.integers(97, 123, (n_dept, 12)
                                      ).astype(np.uint8),
            "location": loc}),
        "salaries": (Schema.of(
            ("sal_emp_id", I32), ("salary", I32), ("from_year", I32)),
            n_sal, {
            "sal_emp_id": rng.integers(0, n_emp, n_sal).astype(np.int32),
            "salary": rng.integers(10_000, 90_000, n_sal
                                   ).astype(np.int32),
            "from_year": rng.integers(2000, 2020, n_sal
                                      ).astype(np.int32)}),
    }
    for name, (schema, nrows, cols) in tables.items():
        st, _ = make_storage(name, schema, nrows, "csv", cols=cols)
        if name == "salaries":
            # horizontal range partitioning (PR 4): rows re-clustered
            # into 8 contiguous salary ranges with per-partition
            # min/max/NDV stats — selective salary filters then PRUNE
            # partitions before scanning, and covering expressions over
            # the table can be cached partition by partition (the MCKP
            # keeps the hot fraction when the whole CE doesn't fit)
            sess.register(st, columnar_for_stats=cols,
                          partitioning=Partitioning(
                              column="salary", scheme="range",
                              n_partitions=8))
        else:
            sess.register(st, columnar_for_stats=cols)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args()

    from repro_torch.device import cli_device

    # one frozen config instead of the legacy knob sprawl (the old
    # keyword arguments still work as deprecation shims)
    sess = Session.from_config(SessionConfig(
        memory=MemoryConfig(budget_bytes=64 << 20)),
        device=cli_device(args.device))
    build_catalog(sess)
    emp, dept, sal = (sess.table("employees"), sess.table("departments"),
                      sess.table("salaries"))

    # lazy, immutable Relations: nothing executes until a sink is hit
    q1 = (emp.where(c.gender == "F")
          .join(dept.where(c.location == "us"), "dep", "dept_id")
          .join(sal.where(c.salary > 20000), "emp_id", "sal_emp_id")
          .select("name", "dept_name", "salary")
          .sort("salary", desc=True))
    q2 = (emp.where(c.gender == "F")
          .join(dept.where(c.location == "us"), "dep", "dept_id")
          .join(sal.where(c.from_year >= 2010), "emp_id", "sal_emp_id")
          .select("name", "dept_name", "from_year"))
    q3 = (emp.where(c.age > 30)
          .join(sal.where(c.salary > 30000), "emp_id", "sal_emp_id")
          .select("emp_id", "name", "salary", "from_year"))

    print("=== query 1 (canonical logical plan) ===")
    print(q1.explain_str(show_schema=True))

    # any spelling of the same predicate compiles to the same
    # fingerprint: literal-on-left, pushed negation, swapped conjuncts
    q1_variant = (emp.where(~(c.gender != "F"))
                  .join(dept.where("us" == c.location), "dep", "dept_id")
                  .join(sal.where(20000 < c.salary), "emp_id",
                        "sal_emp_id")
                  .select("name", "dept_name", "salary")
                  .sort("salary", desc=True))
    same = (q1.logical_plan() == q1_variant.logical_plan())
    print(f"\nsyntactic variant canonicalizes identically: {same}")

    base = sess.run_batch([q1, q2, q3], mqo=False)
    opt = sess.run_batch([q1, q2, q3], mqo=True)

    r = opt.mqo.report
    print(f"\nSEs found: {r.n_ses}   CEs built: {r.n_ces}   "
          f"selected: {r.n_selected}   "
          f"cache weight: {r.selected_weight / 1024:.0f} KiB "
          f"(budget {r.budget >> 20} MiB)")
    print(f"optimize time: {r.optimize_seconds * 1e3:.1f} ms")
    for i, (b, o) in enumerate(zip(base.results, opt.results)):
        same = b.table.row_multiset() == o.table.row_multiset()
        print(f"q{i + 1}: rows={o.table.nrows:6d} identical={same} "
              f"runtime {b.seconds:.3f}s -> {o.seconds:.3f}s")
    print(f"aggregate: {base.total_seconds:.3f}s -> "
          f"{opt.total_seconds:.3f}s "
          f"({opt.total_seconds / base.total_seconds:.2f}x)")

    # -- the online front-end: continuous submission, lazy handles ------
    # clients submit at any time; the service closes a micro-batch
    # window on count (here), deadline, or flush(), runs the MQO per
    # window, and re-prices still-resident covering relations as
    # already-paid — a recurring query resumes from cache.
    svc = QueryService(sess, max_batch=3)
    h1, h2, h3 = svc.submit(q1), svc.submit(q2), svc.submit(q3)
    print(f"\nQueryService: window closed on count, "
          f"h1 rows={h1.result().nrows}")
    e = h1.explain()
    print(f"h1 explain: window={e['window']} ces={len(e['ces'])} "
          f"resident_reuse={e['resident_reuse']}")

    # -- partition pruning on the partitioned table ---------------------
    # salaries is range-partitioned on salary: a selective filter scans
    # only the partitions whose [min, max] can satisfy it
    info = sess.stats.partitions["salaries"]
    high_pay = c.salary > 80_000
    from repro_torch.relational import prune_parts

    live = prune_parts(high_pay.expr, info)
    print(f"\npartitioned scan: salary>80000 touches "
          f"{len(live)}/{info.n_partitions} partitions {list(live)}")
    top = (sal.where(high_pay).select("sal_emp_id", "salary")).collect()
    print(f"rows={top.nrows} (pruned scan, bit-identical to unpruned)")

    # -- pid cache (PR 8): execution history prunes where stats can't ---
    # a needle predicate on NON-partition columns: every partition's
    # min/max covers both atoms, so stats refute nothing — but the
    # first execution records WHICH partitions actually produced rows
    # (a per-predicate bitset in the tiny `pid` memory pool), and the
    # repeat run intersects against it and scans only those
    needle = (c.from_year == 2001) & (c.sal_emp_id < 50)
    nq = sal.where(needle).select("sal_emp_id", "salary")
    first = sess.run_batch([nq], mqo=False)
    again = sess.run_batch([nq], mqo=False)
    same = (first.results[0].table.row_multiset()
            == again.results[0].table.row_multiset())
    print(f"pid pool: run 1 recorded {first.metrics.pid_records} "
          f"bitset(s); run 2 hit {again.metrics.pid_hits} and pruned "
          f"{again.metrics.pid_pruned_parts}/{info.n_partitions} "
          f"partitions (identical rows: {same})")

    # -- semantic subsumption (PR 8): resume from a WEAKER resident CE --
    # a window of identical broad queries materializes a covering
    # expression for age >= 30; a later STRICTLY STRONGER query — never
    # seen before, so no exact-fingerprint reuse is possible — is
    # recognized (after the window's MQO leaves it unrewritten) as
    # IMPLIED by the resident predicate and resumes from the cached CE,
    # applying only the residual conjuncts
    weak = emp.where(c.age >= 30).select("emp_id", "age", "dep")
    for h in [svc.submit(weak) for _ in range(3)]:
        h.result()
    strong = emp.where((c.age >= 45) & (c.dep < 20)).select("emp_id",
                                                            "age")
    hp = svc.submit(strong)
    svc.flush()
    ex = hp.explain()
    sub = ex.get("subsumption", {})
    print(f"subsumption: hit={ex['subsumption_hit']} "
          f"exact_ce_hit={ex['resident_reuse']} "
          f"rows={hp.result().nrows}")
    print(f"  resumes from CE {sub.get('strict_psi')} "
          f"with residual {sub.get('residual')}")

    # -- async serving front (PR 10): concurrent clients, one session ---
    # the asyncio front takes concurrent submissions on the event loop,
    # a BACKGROUND task closes deadline windows (no caller needs to be
    # in flight), and admission control charges each tenant's in-flight
    # count and attributed pool bytes against its quota.  Execution
    # still funnels through the one sync window path, so results are
    # bit-identical to run_batch / QueryService.
    import asyncio

    from repro_torch.relational import (AsyncConfig, AsyncQueryService,
                                  TenantQuota)

    async def serve():
        cfg = AsyncConfig(
            max_batch=3, max_wait_s=0.05,
            quotas={"dash": TenantQuota(max_inflight=8),
                    "adhoc": TenantQuota(max_inflight=1,
                                         on_over="queue")})
        async with AsyncQueryService(sess, config=cfg) as asvc:
            handles = [await asvc.submit(q, tenant="dash")
                       for q in (q1, q2, q3)]
            ha = await asvc.submit(q3, tenant="adhoc")
            tables = [await h for h in handles] + [await ha]
            return tables, asvc.metrics_report()

    atabs, arep = asyncio.run(serve())
    same = all(a.row_multiset() == b.table.row_multiset()
               for a, b in zip(atabs[:3], opt.results))
    print(f"\nasync front: {len(atabs)} queries over 2 tenants, "
          f"bit-identical to the batch run: {same}")
    for t, row in sorted(arep["tenants"].items()):
        print(f"  tenant {t}: submitted="
              f"{row.get('queries.submitted', 0):.0f} "
              f"bytes={row.get('bytes_total', 0)}B "
              f"admission={row.get('admission')}")


if __name__ == "__main__":
    main()

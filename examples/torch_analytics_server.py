"""Analytics-server scenario on the PyTorch port (the counterpart of
``examples/analytics_server.py``, on the GPU unless ``--device`` says
otherwise): the TPC-DS-analog workload served ONLINE
through the QueryService (paper §5's accumulate-optimize-execute server,
PR 3's continuous-submission front-end), with queries composed in the
fluent :class:`Relation` frontend (PR 5).

Clients submit lazy Relations one at a time; the service accumulates
them into micro-batch windows (closed by count here), compiles every
submission through the canonical plan IR — so differently-spelled
equivalent queries share one fingerprint — runs the multi-query
optimizer per window with resident-CE re-pricing, and resolves lazy
handles.  A recurring dashboard pass is compared against (a) the same
queries with MQO off and (b) the cold first pass — showing both
within-window sharing and cross-window resident reuse.  A final
section demonstrates the canonicalization contract: a builder-made
query and a differently-spelled hand-built ``logical.Node`` tree of
the same semantics land on the SAME covering expression.

A resilience section (PR 6) then replays a dashboard window under
deterministic fault injection: transient faults recover invisibly
(retry / one rung down the degradation ladder, logged per attempt),
while a query driven past ``max_attempts`` resolves its OWN handle to
a ``QueryError`` — siblings complete, ``result()`` re-raises,
``explain()`` carries the post-mortem, and the memory-pool audit stays
clean.

A final telemetry section (PR 9) replays a warm dashboard pass with
span tracing enabled, dumps a Perfetto-loadable Chrome trace of the
query lifecycle, and prints the unified ``metrics_report()``: query
counters, per-template latency percentiles, pool hit rates, and the
cost model's predicted-vs-actual calibration table.

    PYTHONPATH=src python examples/torch_analytics_server.py \
        [--window 12] [--max-batch 4] [--passes 3] [--device cpu]
"""
import argparse
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=12,
                    help="queries per dashboard pass (capped at the "
                         "16-query F2+F5 template pool)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="micro-batch window size (count trigger)")
    ap.add_argument("--passes", type=int, default=3,
                    help="recurring dashboard passes (first is cold)")
    ap.add_argument("--scale-rows", type=int, default=80_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args()

    from repro_torch.device import cli_device

    device = cli_device(args.device)

    from repro_torch.relational import QueryService, c, expr as E
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    sess = build_tpcds_session(scale_rows=args.scale_rows,
                               budget_bytes=1 << 30, device=device)
    qs = tpcds_queries(sess)
    # a recurring dashboard draws from template FAMILIES (the paper's
    # SE setting): interleave the scan-heavy F2 (high-value sales) and
    # F5 (profitability) families so every window holds similar shapes
    rng = np.random.default_rng(args.seed)
    pool = list(range(10, 20)) + list(range(36, 42))   # F2 + F5
    idx = rng.permutation(pool)[: min(args.window, len(pool))]
    dashboard = [qs[i] for i in idx]
    print(f"dashboard of {len(dashboard)} queries: "
          f"{sorted(idx.tolist())}, window size {args.max_batch}")

    # baseline: same queries, no worksharing
    base = sess.run_batch(dashboard, mqo=False)

    svc = QueryService(sess, max_batch=args.max_batch)
    pass_seconds = []
    reuse_counts = []
    for p in range(args.passes):
        t0 = time.perf_counter()
        handles = [svc.submit(q) for q in dashboard]
        svc.flush()                       # close the trailing window
        pass_seconds.append(time.perf_counter() - t0)
        reuse_counts.append(
            sum(1 for h in handles if h.explain()["resident_reuse"]))
        if p == 0:
            for b, h in zip(base.results, handles):
                assert (b.table.row_multiset()
                        == h.result().row_multiset())
            ex = handles[0].explain()
            print(f"first handle explain: window={ex['window']} "
                  f"pos={ex['position']} ces={len(ex['ces'])} "
                  f"reuse={ex['resident_reuse']}")

    cold, warm = pass_seconds[0], min(pass_seconds[1:] or pass_seconds)
    print(f"queries with resident-CE reuse per pass: {reuse_counts}")
    print(f"no-MQO baseline: {base.total_seconds:.2f}s   "
          f"cold windowed pass: {cold:.2f}s   "
          f"warm windowed pass: {warm:.2f}s")
    print(f"aggregate ratio (warm windowed / no-MQO): "
          f"{warm / base.total_seconds:.2f}")
    print(f"warm speedup over cold: {cold / max(warm, 1e-9):.2f}x")

    # -- canonicalization recovers sharing across query spellings -------
    # the same semantics three ways: fluent builder, fluent builder
    # with flipped/negated/shuffled predicates, and a hand-assembled
    # legacy logical.Node tree (accepted as a deprecated shim)
    ss = sess.table("store_sales")
    q_builder = (ss.where((c.ss_sales_price > 50.0)
                          & (c.ss_quantity >= 10))
                 .select("ss_item_sk", "ss_sales_price"))
    q_variant = (ss.where(~(c.ss_quantity < 10)
                          & (50.0 < c.ss_sales_price))
                 .select("ss_item_sk", "ss_sales_price"))
    raw_scan = sess.scan_node("store_sales")
    q_legacy = (raw_scan
                .filter(E.and_(E.cmp("ss_quantity", ">=", 10),
                               E.cmp("ss_sales_price", ">", 50.0)))
                .project("ss_item_sk", "ss_sales_price"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        h1, h2, h3 = (svc.submit(q_builder), svc.submit(q_variant),
                      svc.submit(q_legacy))
        svc.flush()
    keys = [{ce["strict_psi"] for ce in h.explain()["ces"]}
            for h in (h1, h2, h3)]
    print(f"\nmixed-spelling window: builder/variant/legacy CE keys "
          f"equal = {keys[0] == keys[1] == keys[2]} "
          f"(shared CE provenance: {sorted(keys[0])})")

    # -- error handles and degradation reporting (PR 6) -----------------
    # the same dashboard window on a session with deterministic fault
    # injection: a seeded 10% transient rate at the kernel-launch and
    # H2D points.  Transient faults recover invisibly — retried in
    # place or one rung down the Pallas → fused-XLA → eager ladder —
    # and every step lands in the window report.
    from repro_torch.core.faults import FaultConfig
    from repro_torch.relational import MemoryConfig, SessionConfig

    fcfg = (SessionConfig(memory=MemoryConfig(budget_bytes=1 << 30))
            .with_faults(FaultConfig(seed=args.seed, rates={
                "kernel_launch": 0.10, "scan_h2d": 0.10})))
    fsess = build_tpcds_session(scale_rows=args.scale_rows, config=fcfg,
                                device=device)
    fsvc = QueryService(fsess, max_batch=args.max_batch)
    fhandles = [fsvc.submit(q) for q in tpcds_queries(fsess)[10:14]]
    fsvc.flush()
    rep = fsess.fault_injector.report()
    print(f"\nfaulted window: {rep['n_fired']} faults fired "
          f"{rep['fired']}, "
          f"failed handles: {sum(h.failed for h in fhandles)}/4 "
          f"(transient faults recover without failing queries)")

    # drive one query past max_attempts: a scheduled fault kills the
    # first query's first two H2D transfers (attempts 1 and 2), so its
    # handle resolves to a QueryError — the window's other query, whose
    # transfers draw later schedule indices, is untouched
    hard = (SessionConfig(memory=MemoryConfig(budget_bytes=1 << 30))
            .with_resilience(max_attempts=2)
            .with_faults(FaultConfig(seed=args.seed,
                                     schedule={"scan_h2d": (0, 1)})))
    hsess = build_tpcds_session(scale_rows=args.scale_rows, config=hard,
                                device=device)
    hsvc = QueryService(hsess, max_batch=2)
    h_doomed = hsvc.submit(hsess.table("store_sales")
                           .where(c.ss_sales_price > 60.0)
                           .select("ss_item_sk"))
    h_fine = hsvc.submit(hsess.table("store_sales")
                         .where(c.ss_quantity >= 20)
                         .select("ss_item_sk"))
    hsvc.flush()
    err = h_doomed.error
    ex = h_doomed.explain()
    print(f"doomed handle: failed={h_doomed.failed} after "
          f"{err.attempts} attempts — {err.exception!r}")
    print("  attempt log:",
          [f"{e['action']}->{e['level']}" for e in ex["events"]])
    try:
        h_doomed.result()
    except Exception as exc:
        print(f"  result() re-raises: {type(exc).__name__}")
    print(f"sibling handle unaffected: "
          f"{h_fine.result().nrows} rows; "
          f"memory audit clean = {hsess.memory.audit() == []}")

    # -- window-batched shared dispatch (PR 7) ---------------------------
    # a recurring template family: four same-SHAPE filters whose
    # literals change every window.  The executor hoists the literals
    # into operand arrays and runs the whole window as ONE batched mask
    # dispatch — ``explain()`` names the window positions that shared
    # it — and the compiled program is keyed by plan shape, so window 2
    # (fresh literals) re-traces nothing.
    from repro_torch.relational import MqoConfig

    wb_cfg = SessionConfig(memory=MemoryConfig(budget_bytes=1 << 30),
                           mqo=MqoConfig(enabled=False))
    wsess = build_tpcds_session(scale_rows=args.scale_rows, config=wb_cfg,
                                device=device)
    wsvc = QueryService(wsess, max_batch=4)
    print()
    for w in range(2):
        tpl = [wsess.table("store_sales")
               .where((c.ss_quantity > 5 + 3 * i + w)
                      & (c.ss_quantity < 80 - 2 * i))
               .select("ss_item_sk", "ss_quantity") for i in range(4)]
        whs = [wsvc.submit(q) for q in tpl]
        wsvc.flush()
        ex = whs[0].explain()
        print(f"batched window {w}: shared_dispatch="
              f"{ex.get('shared_dispatch')} "
              f"({sum(h.result().nrows for h in whs)} rows out, "
              f"literals fresh, one kernel launch for the window)")

    # -- semantic subsumption (PR 8) -------------------------------------
    # drill-down serving: the dashboard's broad filter stays resident,
    # and every follow-up narrows it with FRESH literals — no exact
    # fingerprint ever repeats, so resident re-pricing (PR 3) can't
    # fire.  Subsumption recognizes each drill-down the window's MQO
    # left unrewritten as IMPLIED by the weaker resident CE and resumes
    # from it, applying only the residual conjuncts.
    dsess = build_tpcds_session(scale_rows=args.scale_rows,
                                budget_bytes=1 << 30, device=device)
    dsvc = QueryService(dsess, max_batch=4)
    broad = (dsess.table("store_sales")
             .where(c.ss_sales_price > 40.0)
             .select("ss_item_sk", "ss_sales_price", "ss_quantity"))
    for h in [dsvc.submit(broad) for _ in range(3)]:
        h.result()                    # window materializes the broad CE
    dsvc.flush()
    print()
    for k in range(3):
        drill = (dsess.table("store_sales")
                 .where((c.ss_sales_price > 52.0 + k)
                        & (c.ss_quantity >= 11 + k))
                 .select("ss_item_sk", "ss_sales_price"))
        dh = dsvc.submit(drill)
        dsvc.flush()
        dx = dh.explain()
        sub = dx.get("subsumption", {})
        print(f"drill-down {k}: subsumption_hit={dx['subsumption_hit']} "
              f"exact_ce_hit={dx['resident_reuse']} "
              f"rows={dh.result().nrows} "
              f"resumes from {sub.get('strict_psi')} "
              f"residual={sub.get('residual')}")

    # -- unified telemetry (PR 9) ----------------------------------------
    # the long-lived session has been counting all along (the metrics
    # registry and the cost-model calibration log are always on); span
    # tracing is opt-in.  Enable it, replay one warm dashboard pass
    # through the original service, and dump a Perfetto-loadable Chrome
    # trace of the full lifecycle (submit -> window -> canonicalize ->
    # MQO -> dispatch -> resolve) next to a metrics snapshot.
    sess.enable_tracing()
    for h in [svc.submit(q) for q in dashboard]:
        h.result()
    svc.flush()
    os.makedirs("reports", exist_ok=True)
    trace_path = os.path.join("reports", "analytics_trace.json")
    doc = sess.telemetry().export_chrome_trace(trace_path)
    print(f"\ntraced warm pass: {len(doc['traceEvents'])} span events "
          f"-> {trace_path} (load in https://ui.perfetto.dev)")

    rep = svc.metrics_report()
    counters = rep["registry"]["counters"]
    lat = rep["latency"]["all"]
    print(f"queries: {counters['queries.submitted']:.0f} submitted / "
          f"{counters.get('queries.succeeded', 0):.0f} ok / "
          f"{counters.get('queries.failed', 0):.0f} failed over "
          f"{counters['windows.closed']:.0f} windows; "
          f"inter-arrival EWMA "
          f"{rep['arrival_interval_ewma_s']['value'] * 1e3:.2f} ms")
    print(f"latency p50/p90/p99 = {lat['p50'] * 1e3:.1f}/"
          f"{lat['p90'] * 1e3:.1f}/{lat['p99'] * 1e3:.1f} ms over "
          f"{len(rep['latency']['families'])} template families")
    for name, st in sorted(rep["pools"].items()):
        print(f"pool {name:<6} hit_rate={st['hit_rate']:.2f} "
              f"used={st.get('used', 0)}B evictions="
              f"{st.get('evictions', 0)}")
    for kind, row in rep["calibration"]["kinds"].items():
        print(f"calibration[{kind}]: n={row['n']} "
              f"predicted_cost={row['predicted_cost']:.3g} "
              f"measured={row['measured_seconds']:.3f}s "
              f"bytes_err={row['bytes_mean_abs_rel_err']:.2f}")

    # -- async serving front (PR 10) -------------------------------------
    # the same warm session served to CONCURRENT clients: submissions
    # land on the asyncio event loop, a background task closes deadline
    # windows with nobody in flight, per-tenant admission bounds each
    # client class, and with ``adaptive=True`` per-family arrival-rate
    # EWMAs + the p99 SLO budget size every window at open time —
    # bursty dashboard traffic fills large shared windows while the SLO
    # caps the wait.  Execution funnels through the same sync window
    # path, so results stay bit-identical.
    import asyncio

    from repro_torch.relational import (AsyncConfig, AsyncQueryService,
                                  TenantQuota)

    n_clients, per_client = 6, 4

    async def client(asvc, i, rng2, handles):
        for k in range(per_client):
            await asyncio.sleep(float(rng2.exponential(0.005)))
            h = await asvc.submit(dashboard[(i + k) % len(dashboard)],
                                  tenant=f"team{i % 2}")
            handles.append(h)

    async def serve():
        # the SLO budget is what's left after the OBSERVED window-exec
        # p99 — this session's cold compile passes pushed that to
        # seconds, so a tight SLO would (correctly) collapse every
        # window to min_batch; a loose one lets the arrival EWMAs grow
        # shared windows up to the cap
        cfg = AsyncConfig(
            max_batch=4, max_wait_s=0.02,
            adaptive=True, slo_p99_s=10.0, max_batch_cap=16,
            quotas={"team0": TenantQuota(max_inflight=16),
                    "team1": TenantQuota(max_inflight=16)})
        async with AsyncQueryService(sess, config=cfg) as asvc:
            handles = []
            rngs = [np.random.default_rng(100 + i)
                    for i in range(n_clients)]
            t0 = time.perf_counter()
            await asyncio.gather(*(client(asvc, i, rngs[i], handles)
                                   for i in range(n_clients)))
            tables = await asyncio.gather(
                *(h.result() for h in handles))
            wall = time.perf_counter() - t0
            return handles, tables, wall, asvc.metrics_report()

    ahandles, atables, wall, arep = asyncio.run(serve())
    sizes = sorted(h.explain()["window_size"] for h in ahandles)
    print(f"\nasync adaptive serving: {len(atables)} queries from "
          f"{n_clients} concurrent clients in {wall:.2f}s "
          f"({len(atables) / wall:.0f} q/s), window sizes {sizes}")
    for t in sorted(arep["tenants"]):
        row = arep["tenants"][t]
        print(f"  tenant {t}: submitted="
              f"{row.get('queries.submitted', 0):.0f} "
              f"bytes={row.get('bytes_total', 0)}B "
              f"admission={row.get('admission')}")


if __name__ == "__main__":
    main()

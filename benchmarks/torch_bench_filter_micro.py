"""Paper Fig. 5–7 on the PyTorch port (the counterpart of
``benchmarks/bench_filter_micro.py``): the filter micro-benchmark and
the fused-vs-eager pipeline comparison, on the GPU unless ``--device``
says otherwise.

Two queries over the synthetic "people" relation, each a filter with a
different predicate on the same attribute, executed with (i) no
sharing, (ii) naive full-input caching (FC), (iii) worksharing (WS),
per input size and format; then batched Scan→Filter→Project chains
through the fused executor against the eager one
(``common.fused_vs_eager``).

Correctness (hard failures): WS rows equal the unshared run's, fused
rows equal eager's.  Speed gate (the exit status, the reference's
loud failure): ``ws_over_base <= 1.05`` in every row.

    PYTHONPATH=src python benchmarks/torch_bench_filter_micro.py \
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line, fused_vs_eager  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

MAX_WS_OVER_BASE = 1.05


def _mk_session(device, nrows: int, fmt: str, budget: int,
                fused: bool = True):
    from repro_torch.relational import Session, SessionConfig, make_storage
    from repro_torch.relational.datagen import (generate_columns,
                                                people_schema)

    schema = people_schema()
    cols = generate_columns(schema, nrows, seed=0)
    # fused=False is the eager executor (per-operator dispatch, host
    # sync after every filter, no device scan cache)
    sess = Session.from_config(SessionConfig.from_legacy_kwargs(
        budget_bytes=budget, fuse=fused, defer_sync=fused,
        use_scan_cache=fused), device=device)
    st, _ = make_storage("people", schema, nrows, fmt, cols=cols)
    sess.register(st, columnar_for_stats=cols)
    return sess


def _queries(sess):
    from repro_torch.relational import expr as E

    people = sess.table("people")
    # paper Fig. 5: SELECT * WHERE age < P1 / age > P2 (age uniform in
    # [1, 1000]) — ~25% selectivity each
    return [people.filter(E.cmp("age", "<", 250)),
            people.filter(E.cmp("age", ">", 750))]


def _chain_queries(sess):
    """Batched Scan→Filter→Project chains (the fusion-layer hot path)."""
    from repro_torch.relational import expr as E

    people = sess.table("people")
    return [
        people.filter(E.cmp("age", "<", 250))
              .project("name", "age", "salary"),
        people.filter(E.cmp("age", ">", 750))
              .project("name", "age", "salary"),
        people.filter(E.and_(E.cmp("age", ">", 250),
                             E.cmp("salary", "<", 500_000)))
              .project("name", "salary"),
        people.filter(E.cmp("d1", "<", 0.5)).project("age", "d1", "d2"),
    ]


def run(device="cuda", sizes=(50_000, 100_000, 200_000),
        fmts=("csv", "columnar"), budget: int = 1 << 28,
        repeats: int = 3, fused_sizes=(100_000,)) -> Dict:
    """Baseline / FC / WS per size and format, then fused vs eager at
    ``fused_sizes``; writes ``reports/bench/torch_filter_micro.json``."""
    out: Dict = {"sizes": list(sizes), "rows": []}
    for fmt in fmts:
        for n in sizes:
            sess = _mk_session(device, n, fmt, budget)
            qs = _queries(sess)
            # steady state: the first pass pays the kernels' and
            # caches' first use; keep the minimum over ``repeats``
            sess.run_batch(qs, mqo=False)
            base = min((sess.run_batch(qs, mqo=False)
                        for _ in range(repeats)),
                       key=lambda r: r.total_seconds)
            sess.run_batch_fullcache(qs)
            fc = min((sess.run_batch_fullcache(qs)
                      for _ in range(repeats)),
                     key=lambda r: r.total_seconds)
            sess.run_batch(qs, mqo=True)
            ws = min((sess.run_batch(qs, mqo=True)
                      for _ in range(repeats)),
                     key=lambda r: r.total_seconds)
            for b, o in zip(base.results, ws.results):
                assert b.table.row_multiset() == o.table.row_multiset()
            input_bytes = sess.catalog["people"].disk_bytes
            ws_cache = sum(e["nbytes"] for e in
                           ws.cache_report.get("entries", []))
            fc_cache = sum(e["nbytes"] for e in
                           fc.cache_report.get("entries", []))
            out["rows"].append({
                "fmt": fmt, "nrows": n,
                "q_base": [r.seconds for r in base.results],
                "q_fc": [r.seconds for r in fc.results],
                "q_ws": [r.seconds for r in ws.results],
                "agg_base": base.total_seconds,
                "agg_fc": fc.total_seconds,
                "agg_ws": ws.total_seconds,
                "ws_over_base": ws.total_seconds / base.total_seconds,
                "fc_over_base": fc.total_seconds / base.total_seconds,
                "cache_frac_ws": ws_cache / max(input_bytes, 1),
                "cache_frac_fc": fc_cache / max(input_bytes, 1),
            })
    out["fused"] = fused_vs_eager(
        lambda *a, **kw: _mk_session(device, *a, **kw), _chain_queries,
        "torch_filter_micro_fused", sizes=fused_sizes, fmts=fmts,
        budget=budget, repeats=repeats)["rows"]
    save("filter_micro_fused", {"rows": out["fused"]}, device)
    save("filter_micro", out, device)
    return out


def gate(out: Dict) -> List[str]:
    """Worksharing must not be slower than per-query execution
    (``benchmarks/bench_filter_micro.py``'s regression check)."""
    return [f"worksharing slower than baseline at {r['fmt']}/{r['nrows']}: "
            f"ws_over_base={r['ws_over_base']:.3f} > {MAX_WS_OVER_BASE}"
            for r in out["rows"] if r["ws_over_base"] > MAX_WS_OVER_BASE]


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    lines = [csv_line(
        f"filter_micro[{r['fmt']},{r['nrows']}]", r["agg_ws"],
        f"ws/base={r['ws_over_base']:.2f};fc/base="
        f"{r['fc_over_base']:.2f};cache_frac={r['cache_frac_ws']:.2f}")
        for r in out["rows"]]
    lines += [csv_line(
        f"filter_micro_fused[{r['fmt']},{r['nrows']}]", r["agg_fused"],
        f"fused_speedup={r['fused_speedup']:.2f}") for r in out["fused"]]
    return finish(lines, gate(out))


if __name__ == "__main__":
    sys.exit(main())

"""Paper Fig. 8–9 on the PyTorch port (the counterpart of
``benchmarks/bench_projection_micro.py``): the projection
micro-benchmark and its fused-vs-eager pipeline comparison, on the GPU
unless ``--device`` says otherwise.

Two projection-only queries over overlapping column sets of the
synthetic "people" relation, run with no sharing (base), naive
full-input caching (FC) and worksharing (WS), per input size and
format.  On the columnar (Parquet-analog) format projections are
already cheap, so the paper reports near-zero benefit over the base
(while still beating FC); on CSV the parse cost makes worksharing win.
Then batched Scan→Filter→Project chains over the same wide column sets
through the fused executor against the eager one
(``common.fused_vs_eager``).

Correctness (hard failures): WS rows equal the base run's, fused rows
equal eager's.  No speed gate, as in the JAX bench.

    PYTHONPATH=src python benchmarks/torch_bench_projection_micro.py \\
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line, fused_vs_eager  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

SIZES = (50_000, 100_000)
FMTS = ("columnar", "csv")
BUDGET = 1 << 28


def _mk_session(device, nrows: int, fmt: str, budget: int,
                fused: bool = True):
    from repro_torch.relational import Session, SessionConfig, make_storage
    from repro_torch.relational.datagen import (generate_columns,
                                                people_schema)

    schema = people_schema()
    cols = generate_columns(schema, nrows, seed=1)
    sess = Session.from_config(SessionConfig.from_legacy_kwargs(
        budget_bytes=budget, fuse=fused, defer_sync=fused,
        use_scan_cache=fused), device=device)
    st, _ = make_storage("people", schema, nrows, fmt, cols=cols)
    sess.register(st, columnar_for_stats=cols)
    return sess


def _queries(sess):
    people = sess.table("people")
    return [people.project("name", "age", "salary"),
            people.project("name", "dept", "d1", "d2")]


def _chain_queries(sess):
    """Scan→Filter→Project chains over the projection workload's wide
    column sets."""
    from repro_torch.relational import expr as E

    people = sess.table("people")
    return [
        people.filter(E.cmp("salary", ">", 100))
              .project("name", "age", "salary"),
        people.filter(E.cmp("d1", "<", 0.75))
              .project("name", "dept", "d1", "d2"),
    ]


def run_fused_vs_eager(device="cuda", **kw) -> Dict:
    """Fused executor against the eager one; writes
    ``reports/bench/torch_projection_micro_fused.json``."""
    kw.setdefault("fmts", FMTS)
    out = fused_vs_eager(lambda *a, **k: _mk_session(device, *a, **k),
                         _chain_queries, "torch_projection_micro_fused",
                         **kw)
    return save("projection_micro_fused", out, device)


def run(device="cuda", sizes=SIZES, fmts=FMTS, budget: int = BUDGET
        ) -> Dict:
    """Base / FC / WS per size and format; writes
    ``reports/bench/torch_projection_micro.json``."""
    out: Dict = {"rows": []}
    for fmt in fmts:
        for n in sizes:
            sess = _mk_session(device, n, fmt, budget)
            qs = _queries(sess)
            sess.run_batch(qs, mqo=False)        # first use
            base = sess.run_batch(qs, mqo=False)
            sess.run_batch_fullcache(qs)
            fc = sess.run_batch_fullcache(qs)
            sess.run_batch(qs, mqo=True)
            ws = sess.run_batch(qs, mqo=True)
            for b, o in zip(base.results, ws.results):
                assert b.table.row_multiset() == o.table.row_multiset()
            out["rows"].append({
                "fmt": fmt, "nrows": n,
                "agg_base": base.total_seconds,
                "agg_fc": fc.total_seconds,
                "agg_ws": ws.total_seconds,
                "ws_over_base": ws.total_seconds / base.total_seconds,
                "ws_over_fc": ws.total_seconds / max(fc.total_seconds,
                                                     1e-9),
            })
    save("projection_micro", out, device)
    return out


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    lines = [csv_line(
        f"projection_micro[{r['fmt']},{r['nrows']}]", r["agg_ws"],
        f"ws/base={r['ws_over_base']:.2f};ws/fc={r['ws_over_fc']:.2f}")
        for r in out["rows"]]
    fused = run_fused_vs_eager(device)
    lines += [csv_line(
        f"projection_micro_fused[{r['fmt']},{r['nrows']}]", r["agg_fused"],
        f"fused_speedup={r['fused_speedup']:.2f}") for r in fused["rows"]]
    return finish(lines, [])


if __name__ == "__main__":
    sys.exit(main())

"""Paper Fig. 3 on the PyTorch port (the counterpart of
``benchmarks/bench_macro_tpcds.py``): the TPC-DS macro-benchmark, on
the GPU unless ``--device`` says otherwise.

All 50 queries of the TPC-DS-analog workload run in identifier order
with MQO off and on, over a CSV dataset (paper §6.1: the parse cost is
the shareable work the covering expressions remove).  Each mode gets a
warm-up pass and then a measured pass on one session.  Reported: the
per-query runtime ratio (MQO on over off) and its CDF figures (the
paper: about 60% of queries at >= 80% reduction, about 82% improved),
the SE / CE / selected-CE counts, the optimizer's seconds (the paper:
under 2 s) and the cache's bytes.  ``run_disk_profile`` repeats one
pass of each mode under the paper's ~200 MB/s commodity-disk read cost
on every byte fetched from the catalog (cache hits skip it).

Correctness (hard failure): every query's row multiset with MQO equals
its row multiset without.  No speed gate, as in the JAX bench.  On the
card a query's seconds include its device time (the executor
synchronizes after every operator).

    PYTHONPATH=src python benchmarks/torch_bench_macro_tpcds.py \\
        [--device cpu] [--scale-rows N]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line, percentile  # noqa: E402
from torch_common import finish, parse_args, save  # noqa: E402

SCALE_ROWS = 120_000
BUDGET = 1 << 30
FMT = "csv"
DISK_LATENCY = 5e-9         # paper §6.3 commodity-disk regime (~200 MB/s)


def _ratios(base, opt) -> List[float]:
    for i, (b, o) in enumerate(zip(base.results, opt.results)):
        assert b.table.row_multiset() == o.table.row_multiset(), \
            f"query {i}: rows with MQO differ from rows without"
    return [o.seconds / max(b.seconds, 1e-9)
            for b, o in zip(base.results, opt.results)]


def _cdf(ratios: List[float]) -> Dict:
    return {
        "improved_frac": sum(1 for x in ratios if x < 1.0) / len(ratios),
        "ge80pct_reduction_frac": sum(1 for x in ratios if x <= 0.2)
        / len(ratios),
        "median_ratio": percentile(ratios, 0.5),
    }


def run(device="cuda", scale_rows: int = SCALE_ROWS, budget: int = BUDGET,
        fmt: str = FMT, name: str = "macro_tpcds") -> Dict:
    """The RAM profile; writes ``reports/bench/torch_<name>.json``."""
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    sess = build_tpcds_session(scale_rows=scale_rows, budget_bytes=budget,
                               fmt=fmt, device=device)
    qs = tpcds_queries(sess)
    sess.run_batch(qs, mqo=False)           # first use of kernels, caches
    base = sess.run_batch(qs, mqo=False)
    sess.run_batch(qs, mqo=True)
    opt = sess.run_batch(qs, mqo=True)
    ratios = _ratios(base, opt)
    r = opt.mqo.report
    out = {
        "scale_rows": scale_rows, "fmt": fmt, "budget": budget,
        "n_queries": len(qs),
        "ratios": ratios,
        "base_seconds": [b.seconds for b in base.results],
        "opt_seconds": [o.seconds for o in opt.results],
        **_cdf(ratios),
        "agg_base_s": base.total_seconds,
        "agg_opt_s": opt.total_seconds,
        "agg_ratio": opt.total_seconds / base.total_seconds,
        "n_ses": r.n_ses, "n_ces": r.n_ces,
        "n_selected": r.n_selected,
        "optimize_seconds": r.optimize_seconds,
        "cache_used_bytes": opt.cache_report.get("used", 0),
        "cache_budget": opt.cache_report.get("budget", 0),
    }
    save(name, out, device)
    return out


def run_disk_profile(device="cuda", scale_rows: int = SCALE_ROWS,
                     budget: int = BUDGET,
                     disk_latency_per_byte: float = DISK_LATENCY) -> Dict:
    """Fig. 3 under the paper's storage regime, one pass of each mode
    (the kernels are warm from :func:`run`; the sleep dominates);
    writes ``reports/bench/torch_macro_tpcds_disk.json``."""
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    sess = build_tpcds_session(scale_rows=scale_rows, budget_bytes=budget,
                               fmt="csv", device=device)
    sess.disk_latency_per_byte = disk_latency_per_byte
    qs = tpcds_queries(sess)
    base = sess.run_batch(qs, mqo=False)
    opt = sess.run_batch(qs, mqo=True)
    ratios = sorted(_ratios(base, opt))
    out = {
        "scale_rows": scale_rows,
        "disk_latency_per_byte": disk_latency_per_byte,
        "agg_ratio": opt.total_seconds / base.total_seconds,
        **_cdf(ratios),
    }
    save("macro_tpcds_disk", out, device)
    return out


def main(argv=None) -> int:
    device, args = parse_args(
        argv, __doc__.splitlines()[0],
        lambda ap: ap.add_argument(
            "--scale-rows", type=int, default=SCALE_ROWS,
            help="store_sales rows of the RAM profile (default "
                 f"{SCALE_ROWS}; 2880404 is SF1)"))
    out = run(device, scale_rows=args.scale_rows)
    d = run_disk_profile(device)
    lines = [
        csv_line(f"macro_tpcds[50q,{out['scale_rows']}]", out["agg_opt_s"],
                 f"agg_ratio={out['agg_ratio']:.2f};"
                 f"improved={out['improved_frac']:.2f};"
                 f"ge80pct={out['ge80pct_reduction_frac']:.2f};"
                 f"ses={out['n_ses']};opt_s={out['optimize_seconds']:.2f}"),
        csv_line("macro_tpcds[50q,disk200MBps]", 0.0,
                 f"agg_ratio={d['agg_ratio']:.2f};"
                 f"improved={d['improved_frac']:.2f};"
                 f"ge80pct={d['ge80pct_reduction_frac']:.2f};"
                 f"median={d['median_ratio']:.2f}"),
    ]
    return finish(lines, [])


if __name__ == "__main__":
    sys.exit(main())

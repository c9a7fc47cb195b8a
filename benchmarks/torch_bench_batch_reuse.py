"""Cross-batch cache reuse on the PyTorch port (the counterpart of
``benchmarks/bench_batch_reuse.py``): cold against warm repeats of one
batch, per eviction policy, on the GPU unless ``--device`` says
otherwise.

A recurring TPC-DS-style dashboard batch (the scan-heavy F2 + F5
template families over the CSV fact table, under the paper's ~200 MB/s
disk profile) runs repeatedly on one session with cross-batch retention
on.  The cold run pays disk reads, CSV parse and CE materialization;
the warm repeats re-price still-resident CEs as zero-weight knapsack
items and pay only the per-query residuals.  The kernels' and caches'
first use is paid on a throwaway session.

Correctness (hard failure): the warm tables equal MQO-off execution.
Speed gate (the exit status, the reference's acceptance): warm speedup
``>= 1.5`` for every policy.

    PYTHONPATH=src python benchmarks/torch_bench_batch_reuse.py \\
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

SCALE_ROWS = 120_000
BUDGET = 1 << 30
FMT = "csv"                 # parse is the shareable work CEs eliminate
DISK_LATENCY = 5e-9         # paper §6.3 commodity-disk regime (~200 MB/s)
POLICIES = ("lru", "benefit")
REPEATS = 3
MIN_WARM_SPEEDUP = 1.5


def _dashboard(qs):
    """The recurring scan-heavy batch: F2 (10) + F5 (6) queries."""
    return qs[10:20] + qs[36:42]


def _run_policy(device, policy: str, scale_rows: int, repeats: int) -> Dict:
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    def session():
        return build_tpcds_session(scale_rows=scale_rows, fmt=FMT,
                                   budget_bytes=BUDGET, policy=policy,
                                   device=device)

    warmup = session()
    warmup.run_batch(_dashboard(tpcds_queries(warmup)), mqo=True)

    sess = session()
    sess.disk_latency_per_byte = DISK_LATENCY
    qs = _dashboard(tpcds_queries(sess))
    cold = sess.run_batch(qs, mqo=True)
    warm_runs = [sess.run_batch(qs, mqo=True) for _ in range(repeats)]
    warm = min(warm_runs, key=lambda b: b.total_seconds)

    base = sess.run_batch(qs, mqo=False)
    for b, w in zip(base.results, warm.results):
        assert b.table.row_multiset() == w.table.row_multiset()

    return {
        "policy": policy,
        "n_queries": len(qs),
        "cold_s": cold.total_seconds,
        "warm_s": warm.total_seconds,
        "warm_run_seconds": [w.total_seconds for w in warm_runs],
        "warm_speedup": cold.total_seconds / max(warm.total_seconds, 1e-12),
        "cold_selected": cold.mqo.report.n_selected,
        "warm_resident": warm.mqo.report.n_resident,
        "warm_selected_weight": warm.mqo.report.selected_weight,
        "cache": {k: v for k, v in warm.cache_report.items()
                  if k != "entries"},
        "memory": {k: v for k, v in sess.memory.report().items()
                   if k != "pools"},
    }


def run(device="cuda", scale_rows: int = SCALE_ROWS, policies=POLICIES,
        repeats: int = REPEATS) -> Dict:
    """Every policy; writes ``reports/bench/torch_batch_reuse.json``."""
    out = {"scale_rows": scale_rows, "fmt": FMT,
           "disk_latency_per_byte": DISK_LATENCY,
           "policies": [_run_policy(device, p, scale_rows, repeats)
                        for p in policies]}
    save("batch_reuse", out, device)
    return out


def gate(out: Dict) -> List[str]:
    return [f"{r['policy']}: warm speedup {r['warm_speedup']:.2f} < "
            f"{MIN_WARM_SPEEDUP}" for r in out["policies"]
            if r["warm_speedup"] < MIN_WARM_SPEEDUP]


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    lines = [csv_line(
        f"batch_reuse[{r['policy']}]", r["warm_s"],
        f"cold_s={r['cold_s']:.3f};warm_s={r['warm_s']:.3f};"
        f"speedup={r['warm_speedup']:.2f};resident={r['warm_resident']}")
        for r in out["policies"]]
    return finish(lines, gate(out))


if __name__ == "__main__":
    sys.exit(main())

"""Paper Fig. 4 on the PyTorch port (the counterpart of
``benchmarks/bench_window.py``): the batching-window sweep, on the GPU
unless ``--device`` says otherwise.

Random subsets of the 50 TPC-DS-analog queries (drawn without
replacement by ``np.random.default_rng(seed).choice``, the JAX bench's
draws in its order) of growing window size run with MQO off and on;
reported per window size: the aggregate runtime ratios and the SE
counts (the paper: larger windows, more SEs, lower aggregate runtime).
Each subset gets a warm-up pass per mode and then a measured pass.

Correctness (hard failure): rows with MQO equal rows without.  No speed
gate, as in the JAX bench.

    PYTHONPATH=src python benchmarks/torch_bench_window.py [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line, percentile  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

WINDOW_SIZES = (2, 5, 10, 15, 20)
TRIALS = 5
SCALE_ROWS = 60_000
BUDGET = 1 << 30
SEED = 0


def subsets(n_queries: int, window_sizes=WINDOW_SIZES, trials: int = TRIALS,
            seed: int = SEED) -> List[List[int]]:
    """The query indices of every trial, window by window, in the order
    the sweep runs them."""
    rng = np.random.default_rng(seed)
    return [[int(i) for i in rng.choice(n_queries, size=w, replace=False)]
            for w in window_sizes for _ in range(trials)]


def run(device="cuda", window_sizes=WINDOW_SIZES, trials: int = TRIALS,
        scale_rows: int = SCALE_ROWS, budget: int = BUDGET,
        seed: int = SEED) -> Dict:
    """The sweep; writes ``reports/bench/torch_window_sweep.json``."""
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    sess = build_tpcds_session(scale_rows=scale_rows, budget_bytes=budget,
                               fmt="csv", device=device)
    qs = tpcds_queries(sess)
    drawn = iter(subsets(len(qs), window_sizes, trials, seed))
    out: Dict = {"window_sizes": list(window_sizes), "scale_rows": scale_rows,
                 "per_window": {}}
    for w in window_sizes:
        ratios, n_ses, idxs = [], [], []
        for _ in range(trials):
            idx = next(drawn)
            batch = [qs[i] for i in idx]
            sess.run_batch(batch, mqo=False)     # first use
            base = sess.run_batch(batch, mqo=False)
            sess.run_batch(batch, mqo=True)
            opt = sess.run_batch(batch, mqo=True)
            for b, o in zip(base.results, opt.results):
                assert b.table.row_multiset() == o.table.row_multiset(), idx
            ratios.append(opt.total_seconds / base.total_seconds)
            n_ses.append(opt.mqo.report.n_ses)
            idxs.append(idx)
        out["per_window"][w] = {
            "ratios": ratios,
            "median_ratio": percentile(ratios, 0.5),
            "mean_ses": float(np.mean(n_ses)),
            "ses": n_ses,
            "subsets": idxs,
        }
    save("window_sweep", out, device)
    return out


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    lines = [csv_line(f"window_sweep[w={w}]", d["median_ratio"],
                      f"median_ratio={d['median_ratio']:.2f};"
                      f"mean_ses={d['mean_ses']:.1f}")
             for w, d in out["per_window"].items()]
    return finish(lines, [])


if __name__ == "__main__":
    sys.exit(main())

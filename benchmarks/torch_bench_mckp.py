"""Paper §6.2 on the PyTorch port (the counterpart of
``benchmarks/bench_mckp.py``): the optimizer's overhead (the paper:
"less than 2 seconds").

The MCKP solver over synthetic CE populations far beyond the paper's
(60 SEs / 45 CEs), on the host, at the JAX bench's four sizes; then the
end-to-end ``optimize`` of the 50 TPC-DS-analog queries over a session
of 20,000 rows whose tables live on ``--device`` (the GPU unless it
says otherwise; the optimizer reads their statistics).

No speed gate, as in the JAX bench: ``under_2s`` is printed.

    PYTHONPATH=src python benchmarks/torch_bench_mckp.py [--device cpu]
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

SOLVER_SIZES = ((45, 4), (200, 8), (1000, 8), (5000, 4))
CAPACITY = 256 << 20
MAX_BUCKETS = 4096
E2E_ROWS = 20_000
E2E_BUDGET = 1 << 30
UNDER_S = 2.0


def _items(g: int, per_group: int) -> List:
    from repro_torch.core.candidates import KnapsackItem
    from repro_torch.core.covering import CoveringExpression
    from repro_torch.core.identify import SimilarSubexpression

    items = []
    for gi in range(g):
        for j in range(per_group):
            se = SimilarSubexpression(psi=bytes([gi % 256, j % 256]) * 8)
            ce = CoveringExpression(se=se, tree=None, psi=se.psi)
            ce.value = float((gi * 31 + j * 7) % 97 + 1)
            ce.weight = ((gi * 131 + j * 17) % 4096 + 1) * 1024
            items.append(KnapsackItem(ces=(ce,), group=gi))
    return items


def run_solver(sizes=SOLVER_SIZES) -> List[Dict]:
    """The solver's seconds and value at each (groups, items a group)."""
    from repro_torch.core.mckp import solve_mckp

    rows = []
    for g, per in sizes:
        items = _items(g, per)
        t0 = time.perf_counter()
        sol = solve_mckp(items, capacity=CAPACITY, max_buckets=MAX_BUCKETS)
        rows.append({"groups": g, "items": len(items),
                     "seconds": time.perf_counter() - t0,
                     "value": sol.total_value})
    return rows


def run_end_to_end(device="cuda", scale_rows: int = E2E_ROWS) -> Dict:
    """One ``optimize`` of the 50 queries' single-query plans."""
    from repro_torch.core.optimizer import MultiQueryOptimizer
    from repro_torch.relational.rewriter import (RelationalRewriter,
                                                 make_ce_transform)
    from repro_torch.relational.rules import optimize_single
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    sess = build_tpcds_session(scale_rows=scale_rows, device=device)
    plans = [optimize_single(q) for q in tpcds_queries(sess)]
    opt = MultiQueryOptimizer(sess.cost_model, RelationalRewriter(),
                              budget_bytes=E2E_BUDGET,
                              ce_transform=make_ce_transform())
    t0 = time.perf_counter()
    res = opt.optimize(plans)
    return {"seconds": time.perf_counter() - t0, "scale_rows": scale_rows,
            "n_ses": res.report.n_ses, "n_ces": res.report.n_ces,
            "n_selected": res.report.n_selected}


def run(device="cuda", sizes=SOLVER_SIZES, scale_rows: int = E2E_ROWS
        ) -> Dict:
    """Both parts; writes ``reports/bench/torch_mckp_overhead.json``."""
    out = {"solver": run_solver(sizes),
           "end_to_end": run_end_to_end(device, scale_rows)}
    out["end_to_end"]["under_2s"] = out["end_to_end"]["seconds"] < UNDER_S
    save("mckp_overhead", out, device)
    return out


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    lines = [csv_line(f"mckp_solver[g={r['groups']}]", r["seconds"],
                      f"items={r['items']}") for r in out["solver"]]
    e = out["end_to_end"]
    lines.append(csv_line("mqo_optimize[50q]", e["seconds"],
                          f"ses={e['n_ses']};under_2s={e['under_2s']}"))
    return finish(lines, [])


if __name__ == "__main__":
    sys.exit(main())

"""Window-batched kernel execution and the plan-shape cache on the
PyTorch port (the counterpart of ``benchmarks/bench_window_batch.py``),
on the GPU unless ``--device`` says otherwise.

A recurring dashboard template family — ``n_queries`` same-SHAPE filter
pipelines over one table, literals fresh every window — is streamed
for ``n_windows`` windows through two sessions:

* **baseline** — ``window_batch=False, shape_cache=False``: per-query
  dispatch with literal-keyed programs, so every window's fresh
  literals miss the plan-shape cache;
* **batched** — the defaults: the window's same-shape plans execute as
  ONE batched mask launch (``filter_scan_batch`` on the card) whose
  slotted program is keyed by plan shape, literals in operand arrays.

Correctness (hard failures): batched tables equal per-query ones, every
window takes the shared dispatch, and the plan-shape cache's hit rate
(``trace_hits`` / ``trace_misses``) is 1.0 from the second window on.
Speed gate (the exit status): warm throughput ``>= 3.0x`` baseline.

    PYTHONPATH=src python benchmarks/torch_bench_window_batch.py \
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

N_ROWS = 100_000
N_QUERIES = 6               # template family size per window
N_WINDOWS = 5               # window 0 is the cold window
FMT = "columnar"
MIN_WARM_SPEEDUP = 3.0


def _mk_session(device, cols, n_rows: int, window_batch: bool,
                shape_cache: bool):
    from repro_torch.relational import Session, SessionConfig, make_storage
    from repro_torch.relational.datagen import synthetic_schema

    sess = Session.from_config(SessionConfig().with_execution(
        window_batch=window_batch, shape_cache=shape_cache), device=device)
    schema = synthetic_schema(n_int=6, n_dbl=4, n_str=2)
    st, _ = make_storage("fact", schema, n_rows, FMT, cols=cols)
    sess.register(st, columnar_for_stats=cols)
    return sess


def _window(sess, w: int, n_queries: int):
    """One window of the recurring template: same plan shape for all
    members, literals a function of ``(w, i)`` so every window is FRESH
    literals."""
    from repro_torch.relational import expr as E

    qs = []
    for i in range(n_queries):
        lo = 50 + 13 * i + 7 * w           # n1 uniform in [1, 1000]
        hi = 920 - 11 * i - 5 * w
        qs.append(sess.table("fact")
                  .filter(E.and_(E.cmp("n1", ">", lo),
                                 E.cmp("n1", "<", hi)))
                  .project("n1", "n2", "d1"))
    return qs


def run(device="cuda", n_rows: int = N_ROWS, n_queries: int = N_QUERIES,
        n_windows: int = N_WINDOWS) -> Dict:
    """Both sessions over ``n_windows`` windows; writes
    ``reports/bench/torch_window_batch.json``."""
    from repro_torch.relational.datagen import (generate_columns,
                                                synthetic_schema)

    cols = generate_columns(synthetic_schema(n_int=6, n_dbl=4, n_str=2),
                            n_rows, seed=7)
    base = _mk_session(device, cols, n_rows, False, False)
    batched = _mk_session(device, cols, n_rows, True, True)

    rows: List[Dict] = []
    for w in range(n_windows):
        rb = base.run_batch(_window(base, w, n_queries), mqo=False)
        rg = batched.run_batch(_window(batched, w, n_queries), mqo=False)
        for q, (a, b) in enumerate(zip(rb.results, rg.results)):
            if a.table.row_multiset() != b.table.row_multiset():
                raise AssertionError(
                    f"window_batch divergence: window {w} query {q} "
                    f"differs between batched and per-query dispatch")
        m = rg.metrics
        hits, misses = m.trace_hits, m.trace_misses
        rows.append({
            "window": w,
            "base_s": rb.total_seconds,
            "batched_s": rg.total_seconds,
            "trace_hits": hits,
            "trace_misses": misses,
            "trace_hit_rate": hits / max(hits + misses, 1),
            "batched_dispatches": m.batched_dispatches,
            "batched_queries": m.batched_queries,
        })
        if m.batched_dispatches < 1:
            raise AssertionError(
                f"window_batch: window {w} never took the shared "
                f"batched dispatch (batched_dispatches=0)")
        if w >= 1 and misses != 0:
            raise AssertionError(
                f"window_batch: plan-shape cache missed on window {w} "
                f"({misses} misses — hit rate must be 1.0 from the "
                f"second window on)")

    warm = rows[1:]
    warm_base = sum(r["base_s"] for r in warm)
    warm_batched = sum(r["batched_s"] for r in warm)
    out = {
        "n_rows": n_rows, "n_queries": n_queries,
        "n_windows": n_windows, "fmt": FMT,
        "rows": rows,
        "warm_base_s": warm_base,
        "warm_batched_s": warm_batched,
        "warm_speedup": warm_base / max(warm_batched, 1e-12),
        "warm_trace_hit_rate": min(r["trace_hit_rate"] for r in warm),
    }
    save("window_batch", out, device)
    return out


def gate(out: Dict) -> List[str]:
    """Warm windows at least ``MIN_WARM_SPEEDUP`` x the per-query
    baseline (``benchmarks/bench_window_batch.py``)."""
    if out["warm_speedup"] < MIN_WARM_SPEEDUP:
        return [f"warm throughput only {out['warm_speedup']:.2f}x the "
                f"per-query baseline (floor {MIN_WARM_SPEEDUP:.1f}x)"]
    return []


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    lines = [csv_line(
        f"window_batch[w{r['window']}]", r["batched_s"],
        f"base={r['base_s']:.4f};hit_rate={r['trace_hit_rate']:.2f};"
        f"dispatches={r['batched_dispatches']}") for r in out["rows"]]
    lines.append(csv_line(
        "window_batch[warm]", out["warm_batched_s"],
        f"speedup={out['warm_speedup']:.2f}x;"
        f"hit_rate={out['warm_trace_hit_rate']:.2f}"))
    return finish(lines, gate(out))


if __name__ == "__main__":
    sys.exit(main())

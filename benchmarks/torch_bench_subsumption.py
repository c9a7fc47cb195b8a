"""Semantic subsumption and the pid pool on the PyTorch port (the
counterpart of ``benchmarks/bench_subsumption.py``), on the GPU unless
``--device`` says otherwise.

Interactive drill-down serving over one CSV fact table: a window of
identical broad queries (``n1 < 600``) materializes one covering
expression, and every follow-up NARROWS it with fresh literals
(``n1 < t & n2 >= u``), so no fingerprint ever repeats and only
subsumption can reuse the resident CE:

* ``cold_stream_s`` — the drill-down stream on a fresh session with no
  resident CE;
* ``warm_stream_s`` — the same-shaped stream (fresh literals every
  pass, best of ``repeats``) on the session holding the broad CE.

A second phase runs a needle predicate over non-partition columns of a
range-partitioned sibling twice: the first run records which partitions
produced rows in the ``pid`` pool, the repeat prunes the others.

Correctness (hard failures): warm tables equal mqo-off execution on an
untouched session; every warm drill-down resumes through subsumption
with ZERO exact-fingerprint CE hits (``exact_hits=0``); the pid pool
holds at most 1% of the CE pool's bytes.  Speed gate (the exit status):
``subsumption_warm_speedup >= 1.3``.

    PYTHONPATH=src python benchmarks/torch_bench_subsumption.py \
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

SCALE_ROWS = 120_000
FMT = "csv"                 # parse is the shareable work CEs eliminate
DISK_LATENCY = 5e-9         # paper §6.3 commodity-disk regime (~200 MB/s)
N_PARTITIONS = 8
N_SEED = 3                  # identical broad queries in the seed window
N_DRILL = 8                 # strictly-stronger singletons per pass
REPEATS = 5
MIN_SPEEDUP = 1.3


def build_session(device, cols, scale_rows: int):
    from repro_torch.relational import (MemoryConfig, Partitioning, Session,
                                        SessionConfig, make_storage)
    from repro_torch.relational.datagen import synthetic_schema

    schema = synthetic_schema(n_int=6, n_dbl=4, n_str=2)
    sess = Session.from_config(SessionConfig(
        memory=MemoryConfig(budget_bytes=1 << 28)), device=device)
    sess.disk_latency_per_byte = DISK_LATENCY
    # UNPARTITIONED fact: whole-CE residency is what subsumption
    # resumes from
    st, _ = make_storage("fact", schema, scale_rows, FMT, cols=cols)
    sess.register(st, columnar_for_stats=cols)
    # partitioned sibling for the pid-pool phase
    stp, _ = make_storage("factp", schema, scale_rows, FMT, cols=cols)
    sess.register(stp, columnar_for_stats=cols,
                  partitioning=Partitioning("n1", "range", N_PARTITIONS))
    return sess


def _broad(sess):
    from repro_torch.relational import expr as E

    return (sess.table("fact").filter(E.cmp("n1", "<", 600))
            .project("n1", "n2", "n3", "d1"))


def _drill(sess, k: int, pass_no: int):
    """One strictly-stronger follow-up; literals depend on both the
    stream position and the pass, so no fingerprint repeats."""
    from repro_torch.relational import expr as E

    t = 580 - 10 * k - pass_no          # always < 600: implied by broad
    u = 90 + 10 * k + pass_no
    return (sess.table("fact")
            .filter(E.and_(E.cmp("n1", "<", t), E.cmp("n2", ">=", u)))
            .project("n1", "n2"))


def _drill_pass(sess, svc, pass_no: int, n_drill: int) -> Dict:
    """One streamed drill-down pass of singleton windows, flushed one
    by one (any win must come from cross-window semantic reuse)."""
    t0 = time.perf_counter()
    handles = []
    for k in range(n_drill):
        h = svc.submit(_drill(sess, k, pass_no))
        svc.flush()
        handles.append(h)
    for h in handles:
        h.result()
    return {"seconds": time.perf_counter() - t0, "handles": handles}


def _seed(sess, svc) -> None:
    for h in [svc.submit(_broad(sess)) for _ in range(N_SEED)]:
        h.result()
    svc.flush()


def run(device="cuda", scale_rows: int = SCALE_ROWS, n_drill: int = N_DRILL,
        repeats: int = REPEATS) -> Dict:
    """Cold vs warm drill-down streams and the pid phase; writes
    ``reports/bench/torch_bench_subsumption.json``."""
    from repro_torch.relational import QueryService
    from repro_torch.relational.datagen import (generate_columns,
                                                synthetic_schema)

    cols = generate_columns(synthetic_schema(n_int=6, n_dbl=4, n_str=2),
                            scale_rows, seed=8)

    def fresh():
        sess = build_session(device, cols, scale_rows)
        return sess, QueryService(sess, max_batch=N_SEED + 1)

    # first use of the kernels and caches on a throwaway session
    wsess, wsvc = fresh()
    _seed(wsess, wsvc)
    _drill_pass(wsess, wsvc, 0, n_drill)

    # cold: nothing resident, every drill-down a full disk + parse scan
    cold_sess, cold_svc = fresh()
    cold = _drill_pass(cold_sess, cold_svc, 0, n_drill)
    assert all(not h.explain()["subsumption_hit"] for h in cold["handles"])

    # warm: the broad CE is resident; every pass re-draws literals
    sess, svc = fresh()
    _seed(sess, svc)
    warm_passes = [_drill_pass(sess, svc, p + 1, n_drill)
                   for p in range(repeats)]
    warm = min(warm_passes, key=lambda p: p["seconds"])

    explains: List[Dict] = [h.explain() for p in warm_passes
                            for h in p["handles"]]
    all_subsumed = all(e["subsumption_hit"] for e in explains)
    exact_hits = sum(bool(e["resident_reuse"]) for e in explains)

    verify = build_session(device, cols, scale_rows)
    vq = [_drill(verify, k, repeats) for k in range(n_drill)]
    base = verify.run_batch(vq, mqo=False)
    for b, h in zip(base.results, warm_passes[-1]["handles"]):
        assert b.table.row_multiset() == h.result().row_multiset()

    def needle():
        from repro_torch.relational import expr as E

        return (sess.table("factp")
                .filter(E.and_(E.cmp("n2", "==", 777),
                               E.cmp("n3", "<", 50)))
                .project("n1", "n2"))

    sess.run_batch([needle()], mqo=False)       # records the bitset
    r2 = sess.run_batch([needle()], mqo=False)  # intersects it
    pid_bytes = sess._pid_pool.used_bytes
    ce_bytes = sess._ce_cache.used_bytes

    speedup = cold["seconds"] / max(warm["seconds"], 1e-12)
    out = {
        "scale_rows": scale_rows, "fmt": FMT,
        "disk_latency_per_byte": DISK_LATENCY,
        "n_seed": N_SEED, "n_drill": n_drill, "repeats": repeats,
        "cold_stream_s": cold["seconds"],
        "warm_stream_s": warm["seconds"],
        "warm_pass_seconds": [p["seconds"] for p in warm_passes],
        "subsumption_warm_speedup": speedup,
        "warm_drilldowns": len(explains),
        "all_subsumption_hits": all_subsumed,
        "exact_ce_hits": exact_hits,
        "pid_bytes": int(pid_bytes),
        "ce_bytes": int(ce_bytes),
        "pid_repeat_pruned_parts": int(r2.metrics.pid_pruned_parts),
        "accept_speedup_ge_1_3": speedup >= MIN_SPEEDUP,
        "accept_zero_exact_hits": all_subsumed and exact_hits == 0,
        "accept_pid_le_1pct_of_ce": ce_bytes > 0
        and pid_bytes <= max(1, ce_bytes // 100),
    }
    save("bench_subsumption", out, device)
    if not out["accept_zero_exact_hits"]:
        raise AssertionError(f"subsumption: {exact_hits} exact CE hits, "
                             f"all drill-downs subsumed: {all_subsumed}")
    if not out["accept_pid_le_1pct_of_ce"]:
        raise AssertionError(f"pid pool {pid_bytes} bytes, more than 1% "
                             f"of the CE pool's {ce_bytes}")
    return out


def gate(out: Dict) -> List[str]:
    if not out["accept_speedup_ge_1_3"]:
        return [f"subsumption warm speedup "
                f"{out['subsumption_warm_speedup']:.2f} < {MIN_SPEEDUP}"]
    return []


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    lines = [
        csv_line("subsumption_cold_stream", out["cold_stream_s"],
                 f"drilldowns={out['n_drill']}"),
        csv_line("subsumption_warm_stream", out["warm_stream_s"],
                 f"speedup={out['subsumption_warm_speedup']:.2f}x "
                 f"exact_hits={out['exact_ce_hits']} "
                 f"pid_bytes={out['pid_bytes']}/{out['ce_bytes']}"),
    ]
    return finish(lines, gate(out))


if __name__ == "__main__":
    sys.exit(main())

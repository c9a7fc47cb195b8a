"""Resilience overhead on the PyTorch port (the counterpart of
``benchmarks/bench_resilience.py``): warm-stream throughput at a 5%
injected transient-fault rate against the fault-free warm stream, on
the GPU unless ``--device`` says otherwise.

The recurring F2 + F5 dashboard streams through count-closed
QueryService windows on two long-lived sessions that differ only in
fault injection: one clean, one with a seeded 5% Bernoulli rate (seed 6)
at the transient points ``scan_h2d``, ``kernel_launch`` and
``spill_to_host``.  Warm windows run with CEs and scan columns
resident, so the faults land on the hot path: a kernel launch retries
one rung down the degradation ladder (on the card, kernel -> eager;
both rungs launch the kernels, and a real kernel error still raises),
an H2D transfer retries in place, a spill degrades to a drop; per-query
isolation and the window audit stay on.

Correctness (hard failures): every warm query resolves, its rows equal
the clean run's, and the faulted session's memory audit is clean.
Speed gate (the exit status, the reference's acceptance):
``throughput_ratio = faulted_qps / fault_free_qps >= 0.8``.

    PYTHONPATH=src python benchmarks/torch_bench_resilience.py \\
        [--device cpu]
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

SCALE_ROWS = 60_000
BUDGET = 1 << 30
FMT = "csv"
DISK_LATENCY = 5e-9
MAX_BATCH = 4
REPEATS = 3
FAULT_RATE = 0.05
FAULT_POINTS = ("scan_h2d", "kernel_launch", "spill_to_host")
FAULT_SEED = 6
MIN_RATIO = 0.8


def _dashboard(qs):
    picked = qs[10:20] + qs[36:42]
    order = np.random.default_rng(0).permutation(len(picked))
    return [picked[i] for i in order]


def _mk_session(device, faulted: bool, scale_rows: int):
    from repro_torch.core.faults import FaultConfig, FaultInjector
    from repro_torch.relational.tpcds import build_tpcds_session

    sess = build_tpcds_session(scale_rows=scale_rows, fmt=FMT,
                               budget_bytes=BUDGET, device=device)
    sess.disk_latency_per_byte = DISK_LATENCY
    if faulted:
        cfg = FaultConfig(seed=FAULT_SEED,
                          rates={p: FAULT_RATE for p in FAULT_POINTS})
        sess.fault_injector = FaultInjector.from_config(cfg)
        sess.memory.faults = sess.fault_injector
    return sess


def _warm_stream(sess, repeats: int) -> Dict:
    """Prime one full pass, then the best of ``repeats`` warm passes."""
    from repro_torch.relational import QueryService
    from repro_torch.relational.tpcds import tpcds_queries

    queries = _dashboard(tpcds_queries(sess))
    svc = QueryService(sess, max_batch=MAX_BATCH)
    for q in queries:                    # prime: materializes the CEs
        svc.submit(q)
    svc.flush()
    best, handles = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        hs = [svc.submit(q) for q in queries]
        svc.flush()
        dt = time.perf_counter() - t0
        if dt < best:
            best, handles = dt, hs
    failed = [h.error for h in handles if not h.done or h.failed]
    assert not failed, f"warm queries failed under the 5% transient " \
                       f"rate: {failed}"
    return {"seconds": best, "handles": handles, "n_queries": len(queries)}


def run(device="cuda", scale_rows: int = SCALE_ROWS, repeats: int = REPEATS
        ) -> Dict:
    """Clean vs faulted warm streams; writes
    ``reports/bench/torch_resilience.json``."""
    from repro_torch.relational import QueryService
    from repro_torch.relational.tpcds import tpcds_queries

    warmup = _mk_session(device, False, scale_rows)
    wsvc = QueryService(warmup, max_batch=MAX_BATCH)
    for q in _dashboard(tpcds_queries(warmup)):
        wsvc.submit(q)
    wsvc.flush()

    clean = _mk_session(device, False, scale_rows)
    faulted = _mk_session(device, True, scale_rows)
    base = _warm_stream(clean, repeats)
    hurt = _warm_stream(faulted, repeats)

    for i, (hb, hf) in enumerate(zip(base["handles"], hurt["handles"])):
        assert hb.result().row_multiset() == hf.result().row_multiset(), \
            f"query {i}: rows under faults differ from the clean run's"
    violations = faulted.memory.audit()
    assert violations == [], violations

    n = base["n_queries"]
    inj = faulted.fault_injector
    ratio = base["seconds"] / max(hurt["seconds"], 1e-12)
    out = {
        "scale_rows": scale_rows, "fmt": FMT, "max_batch": MAX_BATCH,
        "fault_rate": FAULT_RATE, "fault_points": list(FAULT_POINTS),
        "fault_seed": FAULT_SEED,
        "n_queries": n,
        "fault_free_warm_s": base["seconds"],
        "faulted_warm_s": hurt["seconds"],
        "fault_free_qps": n / max(base["seconds"], 1e-12),
        "faulted_qps": n / max(hurt["seconds"], 1e-12),
        "throughput_ratio": ratio,
        "faults_fired": inj.n_fired,
        "faults_by_point": inj.fired_by_point(),
        "acceptance_ratio_ge_0.8": ratio >= MIN_RATIO,
    }
    save("resilience", out, device)
    return out


def gate(out: Dict) -> List[str]:
    if out["throughput_ratio"] < MIN_RATIO:
        return [f"faulted / fault-free warm throughput "
                f"{out['throughput_ratio']:.2f} < {MIN_RATIO}"]
    return []


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    return finish([csv_line(
        "resilience_warm_stream", out["faulted_warm_s"],
        f"fault_free_s={out['fault_free_warm_s']:.3f};"
        f"faulted_s={out['faulted_warm_s']:.3f};"
        f"ratio={out['throughput_ratio']:.2f};"
        f"faults_fired={out['faults_fired']}")], gate(out))


if __name__ == "__main__":
    sys.exit(main())

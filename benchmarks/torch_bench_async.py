"""Async serving front on the PyTorch port (the counterpart of
``benchmarks/bench_async.py``, its traffic and gate unchanged): Poisson
arrivals from concurrent clients through the asyncio front, adaptive
vs fixed-knob windows, plus the single-client async-vs-sync latency
lane, on the GPU unless ``--device`` says otherwise.

Workload: ``N_CLIENTS`` open-loop clients submit filter/project queries
drawn from three template families (fresh literal per arrival) with
seeded exponential inter-arrival gaps, over a CSV table of ``NROWS``
rows under the paper's commodity-disk profile.  Two modes on
identically-primed sessions: **fixed** (``max_batch=8``,
``max_wait_s=20 ms``) and **adaptive** (arrival EWMAs + the p99 SLO
budget size each window, cap 64).  Measured per mode: wall throughput
and per-query latency p50/p95/p99; the single-client lane runs the same
queries one at a time through the sync ``QueryService`` and the async
front on one warm session.

Correctness (hard failures): every handle resolves, none fails.  With
``keep=True`` the run also keeps every table, each query's MQO
decisions and the membership of every window, so that :func:`verify`
can replay the same windows on another device and compare.

Speed gate (the exit status, as the reference's loud failure):
``adaptive_over_fixed_throughput >= 1.2`` at ``adaptive_p99 <=
fixed_p99``, and ``async_over_sync_latency <= 1.10``.

    PYTHONPATH=src python benchmarks/torch_bench_async.py [--device cpu]
"""
from __future__ import annotations

import asyncio
import os
import sys
import time
from typing import Dict, List

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))

from common import csv_line, percentile  # noqa: E402
from torch_common import finish, parse_device, save  # noqa: E402

NROWS = 100_000
BUDGET = 1 << 30
FMT = "csv"                 # parse is the shareable work CEs eliminate
DISK_LATENCY = 5e-9         # paper §6.3 commodity-disk regime
N_CLIENTS = 32
N_PER_CLIENT = 8               # 256 queries per mode
MEAN_GAP_S = 0.08              # per client => ~400 q/s offered
SLO_P99_S = 2.0
FIXED = dict(max_batch=8, max_wait_s=0.02)
ADAPTIVE = dict(max_batch=8, max_wait_s=0.02, adaptive=True,
                slo_p99_s=SLO_P99_S, max_batch_cap=64,
                exec_default_s=0.05)
SINGLE_N = 50
MIN_ADAPTIVE_SPEEDUP = 1.2
MAX_ASYNC_OVER_SYNC = 1.10
WARMUP_SEED, MEASURED_SEED = 5000, 1000


def _mk_session(device, nrows: int):
    from repro_torch.relational import (I32, MemoryConfig, Schema, Session,
                                        SessionConfig, make_storage)

    rng = np.random.default_rng(7)
    cols = {k: rng.integers(0, 1000, nrows).astype(np.int32)
            for k in ("a", "b", "c")}
    sess = Session.from_config(
        SessionConfig(memory=MemoryConfig(budget_bytes=BUDGET)),
        device=device)
    schema = Schema.of(("a", I32), ("b", I32), ("c", I32))
    st, _ = make_storage("t", schema, nrows, FMT, cols=cols)
    sess.register(st, columnar_for_stats=cols)
    sess.disk_latency_per_byte = DISK_LATENCY
    return sess


def _query(sess, fam: int, lit: int):
    """One arrival: template family ``fam`` with a fresh literal —
    same loose-psi family (the adaptive policy's EWMA key), distinct
    strict fingerprint (no trivial resident short-circuit)."""
    from repro_torch.relational import expr as E

    t = sess.table("t")
    if fam == 0:
        return t.filter(E.cmp("a", ">", lit)).project("a", "b")
    if fam == 1:
        return t.filter(E.cmp("b", "<", lit)).project("b", "c")
    return (t.filter(E.and_(E.cmp("a", ">", lit),
                            E.cmp("c", ">", lit // 2)))
            .project("a", "c"))


def _prime(sess) -> None:
    """Pay the kernels' and caches' first use once per session (both
    modes get the identical priming), outside the measured stream."""
    sess.run_batch([_query(sess, f, 100 + f) for f in range(3)],
                   mqo=True)
    sess.run_batch([_query(sess, f, 900 - f) for f in range(3)],
                   mqo=True)


def _open_loop(sess, cfg_kw: Dict, seed0: int, n_clients: int,
               n_per_client: int, mean_gap_s: float):
    """One open-loop stream through a fresh async front; returns the
    latencies, the wall seconds and per query (client, k) its family,
    literal and async handle."""
    from repro_torch.relational import AsyncConfig, AsyncQueryService

    sent: Dict = {}

    async def client(svc, idx, rng, lats, waiters):
        for k in range(n_per_client):
            await asyncio.sleep(float(rng.exponential(mean_gap_s)))
            fam, lit = (idx + k) % 3, int(rng.integers(1, 999))
            t0 = time.perf_counter()
            h = await svc.submit(_query(sess, fam, lit))
            sent[idx, k] = (fam, lit, h)

            async def waiter(h=h, t0=t0):
                await h
                lats.append(time.perf_counter() - t0)

            waiters.append(asyncio.create_task(waiter()))

    async def go():
        lats: List[float] = []
        waiters: List[asyncio.Task] = []
        async with AsyncQueryService(
                sess, config=AsyncConfig(**cfg_kw)) as svc:
            rngs = [np.random.default_rng(seed0 + i)
                    for i in range(n_clients)]
            t0 = time.perf_counter()
            await asyncio.gather(*(
                client(svc, i, rngs[i], lats, waiters)
                for i in range(n_clients)))
            await svc.flush()
            await asyncio.gather(*waiters)
            wall = time.perf_counter() - t0
        return lats, wall

    lats, wall = asyncio.run(go())
    n = n_clients * n_per_client
    bad = [key for key, (_, _, h) in sent.items()
           if not h.done or h.failed]
    if len(sent) != n or len(lats) != n or bad:
        raise AssertionError(f"{len(sent)} of {n} queries sent, "
                             f"{len(lats)} resolved; unresolved or failed: "
                             f"{bad[:5]}")
    return lats, wall, sent


def _kept(sent) -> Dict:
    """Per query its table and MQO decisions, and the windows' members
    in execution order (what :func:`verify` replays)."""
    from repro_torch.relational.observe import mqo_decision

    tables, decisions, members = {}, {}, {}
    for key, (fam, lit, h) in sent.items():
        tables[key] = h._inner.result()
        decisions[key] = mqo_decision(h._inner)
        ex = h._inner.explain()
        members.setdefault(ex["window"], []).append(
            (ex["position"], key, fam, lit))
    windows = [[m[1:] for m in sorted(members[w])] for w in sorted(members)]
    return dict(tables=tables, decisions=decisions, windows=windows)


def _run_mode(name: str, cfg_kw: Dict, device, nrows: int, n_clients: int,
              n_per_client: int, mean_gap_s: float, keep: bool):
    """One mode on a primed session: an unmeasured stream, then the
    measured one; returns its numbers and, with ``keep``, both streams'
    kept tables, decisions and windows (else None)."""
    sess = _mk_session(device, nrows)
    _prime(sess)
    # unmeasured: pays this mode's own batched-kernel shapes
    _, _, warm_sent = _open_loop(sess, cfg_kw, WARMUP_SEED, n_clients,
                                 n_per_client, mean_gap_s)
    reg = sess.telemetry().registry
    w_before = reg.value("windows.closed")
    lats, wall, sent = _open_loop(sess, cfg_kw, MEASURED_SEED, n_clients,
                                  n_per_client, mean_gap_s)
    n = n_clients * n_per_client
    windows = reg.value("windows.closed") - w_before
    batch_h = reg.histogram("window.adaptive.batch")
    wait_h = reg.histogram("window.adaptive.wait_s")
    exec_h = reg.histogram("window.seconds")
    out = {
        "mode": name, "n_queries": n, "wall_s": wall,
        "throughput_qps": n / max(wall, 1e-12),
        "latency_p50_s": percentile(lats, 0.50),
        "latency_p95_s": percentile(lats, 0.95),
        "latency_p99_s": percentile(lats, 0.99),
        "windows_closed": windows,
        "mean_window_size": n / max(windows, 1),
        "adaptive_batch_mean": (batch_h.mean
                                if batch_h.count else None),
        "adaptive_wait_s_mean": wait_h.mean if wait_h.count else None,
        # what the adaptive policy budgets against: the session's window
        # execution p99 (priming and the unmeasured stream included)
        "window_exec_p99_s": (exec_h.percentile(0.99)
                              if exec_h.count else None),
        "predicted_saving_s_ewma":
            reg.ewma("window.adaptive.predicted_saving_s").value or None,
        "realized_saving_s_ewma":
            reg.ewma("window.adaptive.realized_saving_s").value or None,
    }
    return out, ([_kept(warm_sent), _kept(sent)] if keep else None)


def _single_client_lane(device, nrows: int, single_n: int, keep: bool):
    """Same warm session, same query stream: sync QueryService vs the
    async front, one query at a time (max_batch=1); returns the numbers
    and, with ``keep``, every table and MQO decision (else None)."""
    from repro_torch.relational import (AsyncConfig, AsyncQueryService,
                                        QueryService)
    from repro_torch.relational.observe import mqo_decision

    sess = _mk_session(device, nrows)
    _prime(sess)
    rng = np.random.default_rng(42)
    lits = [int(rng.integers(1, 999)) for _ in range(single_n)]

    # the windows' execution seconds, inside QueryService._run_window;
    # a query's latency beyond them is the front's own cost
    exec_h = sess.telemetry().registry.histogram("window.seconds")
    mark = [(exec_h.count, exec_h.total)]
    svc = QueryService(sess, max_batch=1)
    sync_lats: List[float] = []
    sync_handles = []
    for k, lit in enumerate(lits):
        q = _query(sess, k % 3, lit)
        t0 = time.perf_counter()
        h = svc.submit(q)
        h.result()
        sync_lats.append(time.perf_counter() - t0)
        sync_handles.append(h)
    mark.append((exec_h.count, exec_h.total))

    async def go():
        lats: List[float] = []
        handles = []
        async with AsyncQueryService(
                sess, config=AsyncConfig(max_batch=1)) as asvc:
            # unmeasured warm-up of the loop/pool plumbing
            await (await asvc.submit(_query(sess, 0, 500)))
            mark.append((exec_h.count, exec_h.total))
            for k, lit in enumerate(lits):
                q = _query(sess, k % 3, lit)
                t0 = time.perf_counter()
                h = await asvc.submit(q)
                await h
                lats.append(time.perf_counter() - t0)
                handles.append(h._inner)
        return lats, handles

    async_lats, async_handles = asyncio.run(go())
    mark.append((exec_h.count, exec_h.total))
    s_mean = sum(sync_lats) / len(sync_lats)
    a_mean = sum(async_lats) / len(async_lats)
    out = {
        "n_queries": single_n,
        "sync_mean_s": s_mean, "async_mean_s": a_mean,
        "sync_exec_mean_s": (mark[1][1] - mark[0][1])
        / max(mark[1][0] - mark[0][0], 1),
        "async_exec_mean_s": (mark[3][1] - mark[2][1])
        / max(mark[3][0] - mark[2][0], 1),
        "sync_p50_s": percentile(sync_lats, 0.50),
        "async_p50_s": percentile(async_lats, 0.50),
        "async_over_sync_latency": a_mean / max(s_mean, 1e-12),
    }
    if not keep:
        return out, None
    handles = sync_handles + async_handles
    return out, dict(tables=[h.result() for h in handles],
                     decisions=[mqo_decision(h) for h in handles])


def run(device="cuda", nrows: int = NROWS, n_clients: int = N_CLIENTS,
        n_per_client: int = N_PER_CLIENT, mean_gap_s: float = MEAN_GAP_S,
        single_n: int = SINGLE_N, keep: bool = False) -> Dict:
    """Both modes and the single-client lane on ``device``; writes
    ``reports/bench/torch_async_serving.json``.  With ``keep`` the
    result also holds, under ``"kept"`` (not written), the tables,
    decisions and window members :func:`verify` compares."""
    sizes = (nrows, n_clients, n_per_client, mean_gap_s)
    fixed, kept_fixed = _run_mode("fixed", FIXED, device, *sizes, keep)
    adaptive, kept_adaptive = _run_mode("adaptive", ADAPTIVE, device,
                                        *sizes, keep)
    single, kept_single = _single_client_lane(device, nrows, single_n,
                                              keep)
    speedup = (adaptive["throughput_qps"]
               / max(fixed["throughput_qps"], 1e-12))
    out = {
        "nrows": nrows, "n_clients": n_clients,
        "n_per_client": n_per_client, "mean_gap_s": mean_gap_s,
        "offered_qps": n_clients / mean_gap_s,
        "slo_p99_s": SLO_P99_S,
        "fixed": fixed, "adaptive": adaptive,
        "single_client": single,
        "adaptive_over_fixed_throughput": speedup,
        "min_adaptive_speedup": MIN_ADAPTIVE_SPEEDUP,
        "max_async_over_sync": MAX_ASYNC_OVER_SYNC,
    }
    save("async_serving", out, device)
    if keep:
        out["kept"] = {"fixed": kept_fixed, "adaptive": kept_adaptive,
                       "single_client": kept_single}
    return out


def gate(out: Dict) -> List[str]:
    """The reference's speed gate (``benchmarks/bench_async.py``); the
    failures, empty when it holds."""
    f, a, s = out["fixed"], out["adaptive"], out["single_client"]
    failures = []
    speedup = out["adaptive_over_fixed_throughput"]
    if speedup < MIN_ADAPTIVE_SPEEDUP:
        failures.append(f"adaptive/fixed throughput {speedup:.2f} < "
                        f"{MIN_ADAPTIVE_SPEEDUP}")
    if a["latency_p99_s"] > f["latency_p99_s"]:
        failures.append(f"adaptive p99 {a['latency_p99_s']:.3f}s worse "
                        f"than fixed {f['latency_p99_s']:.3f}s")
    if s["async_over_sync_latency"] > MAX_ASYNC_OVER_SYNC:
        failures.append(f"single-client async/sync latency "
                        f"{s['async_over_sync_latency']:.3f} > "
                        f"{MAX_ASYNC_OVER_SYNC}")
    return failures


def _same_table(a, b) -> bool:
    x, y = a.to_numpy(), b.to_numpy()
    return a.schema == b.schema and a.nrows == b.nrows and all(
        np.array_equal(x[n], y[n]) for n in x)


def verify(out: Dict, device) -> int:
    """Replay the windows of a ``keep=True`` run (its priming, both
    open-loop streams of each mode, window by window with the same
    members in the same order, and the single-client lane) through the
    sync ``QueryService`` on ``device``; every table must equal the
    run's and every query's MQO decisions too.  Raises AssertionError
    at the first difference; returns the queries compared."""
    from repro_torch.relational import QueryService
    from repro_torch.relational.observe import mqo_decision

    n = 0
    for mode in ("fixed", "adaptive"):
        sess = _mk_session(device, out["nrows"])
        _prime(sess)
        for stream, kept in enumerate(out["kept"][mode]):
            svc = QueryService(sess, max_batch=1 << 30, max_wait_s=3600.0)
            for w, members in enumerate(kept["windows"]):
                handles = [(key, svc.submit(_query(sess, fam, lit)))
                           for key, fam, lit in members]
                svc.flush()
                for key, h in handles:
                    where = f"{mode}/stream{stream}/window{w}/query{key}"
                    if not _same_table(h.result(), kept["tables"][key]):
                        raise AssertionError(f"{where}: tables differ")
                    got = mqo_decision(h)
                    if got != kept["decisions"][key]:
                        raise AssertionError(
                            f"{where}: MQO decisions differ: "
                            f"{got} vs {kept['decisions'][key]}")
                    n += 1
    kept = out["kept"]["single_client"]
    _, replay = _single_client_lane(device, out["nrows"],
                                    out["single_client"]["n_queries"], True)
    for i, (a, b, x, y) in enumerate(zip(
            replay["tables"], kept["tables"],
            replay["decisions"], kept["decisions"])):
        if not _same_table(a, b) or x != y:
            raise AssertionError(f"single-client query {i}: tables or MQO "
                                 f"decisions differ")
        n += 1
    return n


def main(argv=None) -> int:
    device = parse_device(argv, __doc__.splitlines()[0])
    out = run(device)
    f, a, s = out["fixed"], out["adaptive"], out["single_client"]
    lines = [
        csv_line("async_fixed", f["wall_s"] / f["n_queries"],
                 f"qps={f['throughput_qps']:.0f};"
                 f"p50={f['latency_p50_s']*1e3:.1f}ms;"
                 f"p99={f['latency_p99_s']*1e3:.1f}ms;"
                 f"windows={f['windows_closed']}"),
        csv_line("async_adaptive", a["wall_s"] / a["n_queries"],
                 f"qps={a['throughput_qps']:.0f};"
                 f"p50={a['latency_p50_s']*1e3:.1f}ms;"
                 f"p99={a['latency_p99_s']*1e3:.1f}ms;"
                 f"windows={a['windows_closed']};"
                 f"speedup={out['adaptive_over_fixed_throughput']:.2f}"),
        csv_line("async_single_client", s["async_mean_s"],
                 f"sync={s['sync_mean_s']*1e3:.2f}ms;"
                 f"async={s['async_mean_s']*1e3:.2f}ms;"
                 f"ratio={s['async_over_sync_latency']:.3f}"),
    ]
    return finish(lines, gate(out))


if __name__ == "__main__":
    sys.exit(main())

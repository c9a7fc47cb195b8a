#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs its main path on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch`` with ``nvcc``, holds
each kernel bitwise against its plain torch version over a seeded
opcode sweep, times both at the main path's shapes, streams the 50
TPC-DS queries at SF1 scale through ``QueryService`` windows on the card
and on the CPU (results and MQO decisions must agree), runs the
literal-program route, and prints one line per phase.  The line before
the last is the kernels' JSON; the last line is the device JSON.  Any
failure exits non-zero; without CUDA it exits non-zero before any
result.  The script imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SF1_STORE_SALES_ROWS = 2_880_404   # TPC-DS SF1 store_sales cardinality
FILTER_SCAN_CU = "src/repro_torch/kernels/filter_project/csrc/filter_scan.cu"
WINDOW = 8                         # QueryService max_batch
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside tensor cores
F32_RTOL = 1e-5                    # card vs CPU f32 aggregates (see below)
# The card and the CPU sum f32 aggregates through f64 prefix sums whose
# association order differs (a parallel scan on the card), so a group's
# sum may round to a neighbouring f32; every other value must be equal.


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def build_kernels() -> tuple:
    """Build the port's one kernel source with nvcc; returns the wall
    seconds and ptxas's per-kernel resource lines (registers, stack
    frame, spills)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.compile_source(ROOT / FILTER_SCAN_CU)
    seconds = time.perf_counter() - t0
    usage = [line.split("ptxas info    :")[-1].strip()
             for line in lib.with_suffix(".log").read_text().splitlines()
             if "Used" in line or "stack frame" in line]
    return seconds, usage


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
CMPS = ("lt", "le", "gt", "ge", "eq", "ne")


def sweep_columns(rng, n: int, device):
    """i32 / i64 (beyond 2^53) / f32 columns with many equal values."""
    import numpy as np
    import torch

    big = 2 ** 53
    host = [
        rng.integers(-40, 40, n).astype(np.int32),
        (big + rng.integers(-6, 6, n)).astype(np.int64),
        (rng.integers(-40, 40, n) * 0.5).astype(np.float32),
        rng.integers(-40, 40, n).astype(np.int32),
    ]
    return [torch.from_numpy(h).to(device) for h in host]


def random_leaf(rng, dtypes, slotted: bool, ivals: list, fvals: list,
                kinds: set) -> tuple:
    """One leaf op, literal / slot / col-col / in / const."""
    import torch

    n_cols = len(dtypes)
    kind = rng.choice(["lit", "slot", "cc", "in", "const"] if slotted
                      else ["lit", "cc", "in", "const"],
                      p=[0.3, 0.3, 0.2, 0.15, 0.05] if slotted
                      else [0.45, 0.3, 0.2, 0.05])
    a = int(rng.integers(n_cols))
    op = CMPS[int(rng.integers(6))]
    dt = dtypes[a]
    big = 2 ** 53
    if kind == "const":
        kinds.add("const")
        return ("const", bool(rng.integers(2)))
    if kind == "cc":
        b = int(rng.integers(n_cols))
        kinds.add(op + "c")
        return (op + "c", a, b)
    if kind == "in":
        kinds.add("in")
        if dt == torch.float32:
            vals = tuple(float(v) * 0.5 for v in rng.integers(-40, 40, 4))
        elif dt == torch.int64:
            vals = tuple(big + int(v) for v in rng.integers(-6, 6, 3)) \
                + (big + 0.5, 2 ** 70)
        else:
            vals = tuple(int(v) for v in rng.integers(-40, 40, 3)) \
                + (3.5, 2 ** 40, 7.0)
        return ("in", a, vals)
    if kind == "slot":
        kinds.add(op + "$")
        if rng.random() < 0.5:
            ivals.append(None)
            return (op, a, ("$i", len(ivals) - 1))
        fvals.append(None)
        return (op, a, ("$f", len(fvals) - 1))
    kinds.add(op)
    if dt == torch.float32:
        return (op, a, float(rng.integers(-40, 40)) * 0.5)
    if dt == torch.int64:
        base = big + int(rng.integers(-6, 6))
        return (op, a, base + 0.5 if rng.random() < 0.2 else base)
    v = int(rng.integers(-40, 40))
    return (op, a, v + 0.5 if rng.random() < 0.3 else v)


def random_program(rng, dtypes, slotted: bool, kinds: set):
    """A random postfix program of 1-6 leaves joined by and/or/not,
    with the number of i32 / f32 slots it reads."""
    ivals, fvals = [], []
    prog = [random_leaf(rng, dtypes, slotted, ivals, fvals, kinds)]
    for _ in range(int(rng.integers(0, 6))):
        prog.append(random_leaf(rng, dtypes, slotted, ivals, fvals, kinds))
        if rng.random() < 0.3:
            prog.append(("not",))
            kinds.add("not")
        glue = "and" if rng.random() < 0.5 else "or"
        kinds.add(glue)
        prog.append((glue,))
    return tuple(prog), len(ivals), len(fvals)


def kernel_sweep(device) -> dict:
    """Seeded opcode sweep: both kernels must be bitwise equal to their
    plain versions.  Returns the max |mask difference| per kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.kernels.filter_project import ref as R
    from repro_torch.kernels.filter_project.ops import _pad_rows

    rng = np.random.default_rng(0)
    kinds: set = set()
    checked = {"filter_scan": 0, "filter_scan_batch": 0}
    for n, nrows, block in ((5000, 4321, 1024), (300, 300, 128),
                            (4096, 1000, 2048)):
        cols = sweep_columns(rng, n, device)
        dtypes = [c.dtype for c in cols]
        padded, _ = _pad_rows(cols, block)
        for trial in range(120):
            slotted = trial % 2 == 1
            prog, ki, kf = random_program(rng, dtypes, slotted, kinds)
            if not slotted:
                got = K.filter_scan(padded, prog, nrows, block=block)
                want = R.filter_scan_ref(padded, prog, nrows, block)
                name = "filter_scan"
            else:
                n_q = (1, 3, 8)[trial % 3]
                ic = torch.from_numpy(rng.integers(
                    -40, 40, (n_q, max(ki, 1))).astype(np.int32)).to(device)
                fc = torch.from_numpy((rng.integers(
                    -40, 40, (n_q, max(kf, 1))) * 0.5).astype(
                        np.float32)).to(device)
                got = K.filter_scan_batch(padded, prog, nrows, ic, fc,
                                          block=block)
                want = R.filter_scan_batch_ref(padded, prog, nrows, ic, fc,
                                               block)
                name = "filter_scan_batch"
            for g, w in zip(got, want):
                if g.shape != w.shape or not torch.equal(g, w):
                    raise AssertionError(
                        f"{name} disagrees with its plain version on "
                        f"program {prog} (n={n}, nrows={nrows}, "
                        f"block={block})")
            checked[name] += 1
    want_kinds = ({c for c in CMPS} | {c + "c" for c in CMPS}
                  | {c + "$" for c in CMPS}
                  | {"in", "const", "and", "or", "not"})
    missing = want_kinds - kinds
    if missing:
        raise AssertionError(f"sweep missed opcodes {sorted(missing)}")
    return checked


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_timings(device) -> dict:
    """Kernel vs plain version at the main path's shapes: SF1
    store_sales (capacity 2^22), the F2 predicate, 8 queries."""
    import numpy as np
    import torch

    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.kernels.filter_project import ref as R
    from repro_torch.kernels.filter_project.ops import (
        compile_predicate, compile_predicate_slots, pack_consts)
    from repro_torch.relational import expr as E
    from repro_torch.relational.schema import next_pow2
    from repro_torch.relational.tpcds import generate_tpcds_catalog

    _, nrows, cols = generate_tpcds_catalog(SF1_STORE_SALES_ROWS)[
        "store_sales"]
    cap = next_pow2(nrows)
    block = 2048
    names = ("ss_quantity", "ss_sales_price")
    dev_cols = []
    for name in names:
        host = np.zeros(cap, cols[name].dtype)
        host[:nrows] = cols[name]
        dev_cols.append(torch.from_numpy(host).to(torch.float32 if
                        name == "ss_sales_price" else torch.int32)
                        .to(device))
    kinds = {"ss_quantity": "i32", "ss_sales_price": "f32"}
    rows_i, rows_f = [], []
    program = None
    for thr in (50, 60, 70, 80, 90, 55, 65, 75):
        pred = E.and_(E.cmp("ss_sales_price", ">", float(thr)),
                      E.cmp("ss_quantity", ">=", 10))
        program, iv, fv = compile_predicate_slots(pred, names, kinds)
        rows_i.append(iv)
        rows_f.append(fv)
    ic, fc = (torch.from_numpy(a).to(device)
              for a in pack_consts(rows_i, rows_f))
    n_q = ic.shape[0]
    enc = K.encode_program(program, [c.dtype for c in dev_cols], device)
    lit = compile_predicate(E.and_(E.cmp("ss_sales_price", ">", 50.0),
                                   E.cmp("ss_quantity", ">=", 10)), names)
    enc_lit = K.encode_program(lit, [c.dtype for c in dev_cols], device)
    # the function reads each live row's predicate columns once (rows
    # at or past nrows are false without a read) and writes every mask
    # byte and count
    row_bytes = sum(c.element_size() for c in dev_cols)
    n_blocks = cap // block
    out = {}
    for name, n, kern, plain in (
            ("filter_scan_batch", n_q,
             lambda: K.filter_scan_batch(dev_cols, program, nrows, ic, fc,
                                         block=block, encoded=enc),
             lambda: R.filter_scan_batch_ref(dev_cols, program, nrows, ic,
                                             fc, block)),
            ("filter_scan", 1,
             lambda: K.filter_scan(dev_cols, lit, nrows, block=block,
                                   encoded=enc_lit),
             lambda: R.filter_scan_ref(dev_cols, lit, nrows, block))):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max(float((g.to(torch.int64) - w.to(torch.int64))
                        .abs().max()) for g, w in zip(got, want))
        if err != 0:
            raise AssertionError(f"{name} disagrees at the main shapes")
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        nbytes = nrows * row_bytes + n * cap + n * n_blocks * 4
        ops = 3 * nrows * n      # two compares and one and per live row
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations", max_abs_err=err,
                         shape=f"N={cap} nrows={nrows} n_q={n} block={block}")
    return out


# ---------------------------------------------------------------------------
# phase 4-5: the main path through QueryService windows
# ---------------------------------------------------------------------------
def run_stream(sess, queries, sync) -> dict:
    """Stream ``queries`` through one QueryService in windows of
    WINDOW; returns per-query tables and decisions, the window-level
    MQO decisions (when the session traces) and window times."""
    from repro_torch.relational.observe import mqo_decision, mqo_trace

    svc = sess.service(max_batch=WINDOW)
    handles, windows = [], []
    t_start = time.perf_counter()
    for i in range(0, len(queries), WINDOW):
        t0 = time.perf_counter()
        chunk = [svc.submit(q) for q in queries[i:i + WINDOW]]
        if len(chunk) < WINDOW:
            svc.flush()
        sync()
        windows.append(time.perf_counter() - t0)
        handles += chunk
    total = time.perf_counter() - t_start
    tables = [h.result() for h in handles]
    decisions = [mqo_decision(h) for h in handles]
    tracer = sess.telemetry().tracer
    if tracer.enabled:
        decisions.append(mqo_trace(tracer))
    return dict(tables=tables, decisions=decisions, windows=windows,
                seconds=total)


def compare_tables(a, b, label: str) -> None:
    """Rows, order, counts, int and string columns exact; f32 within
    F32_RTOL."""
    import numpy as np

    ca, sa, na = a.to_numpy(), a.schema, a.nrows
    cb, sb, nb = b.to_numpy(), b.schema, b.nrows
    if sa != sb or na != nb:
        raise AssertionError(f"{label}: schema/rows differ ({na} vs {nb})")
    for name, t in sa.fields:
        x, y = ca[name], cb[name]
        if x.dtype != y.dtype:
            raise AssertionError(f"{label}.{name}: {x.dtype} vs {y.dtype}")
        if t.kind == "f32":
            np.testing.assert_allclose(x, y, rtol=F32_RTOL, atol=0,
                                       err_msg=f"{label}.{name}")
        elif not np.array_equal(x, y):
            raise AssertionError(f"{label}.{name}: values differ")


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    k = (len(xs) - 1) * q
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def device_time(fn, device) -> dict:
    """Run ``fn`` under ``torch.profiler``; returns its wall seconds,
    the device-busy seconds (the summed time of the kernels and copies
    that ran on the device — one stream, so they do not overlap; host
    ops, which the profiler also credits with their kernels' time, are
    left out), the top device events and the filter kernel's own row
    (its summed device time and launches).  ``busy`` is None when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import synchronize

    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        wall = time.perf_counter() - t0
    dev = [(e.key, e.self_device_time_total / 1e6, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    dev.sort(key=lambda x: -x[1])
    busy = sum(t for _, t, _ in dev) or None
    filt = [(t, n) for k, t, n in dev if "filter_scan_kernel" in k]
    filt = (sum(t for t, _ in filt), sum(n for _, n in filt))
    return dict(out=out, wall=wall, busy=busy, top=dev[:6], filter=filt)


def main_path(K, cuda, scale_rows: int = SF1_STORE_SALES_ROWS) -> dict:
    """Phase 4: SF1 TPC-DS stream, cold then warm, columnar then CSV,
    on the card and on the CPU; results and decisions must agree."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    cpu = torch.device("cpu")
    stats = {"launches": {}, "passes": [], "reference": {}, "batched": 0,
             "events": 0}
    for fmt in ("columnar", "csv"):
        card = build_tpcds_session(scale_rows=scale_rows, fmt=fmt,
                                   device=cuda)
        host = build_tpcds_session(scale_rows=scale_rows, fmt=fmt,
                                   device=cpu)
        # span tracing records each window's SEs, CE items and MCKP
        # selection, compared below with the per-query decisions
        card.enable_tracing()
        host.enable_tracing()
        for p, phase in enumerate(("cold", "warm")):
            K.reset_launches()
            got = run_stream(card, tpcds_queries(card),
                             lambda: synchronize(cuda))
            launched = dict(K.LAUNCHES)
            for k, v in K.LAUNCHES.items():
                stats["launches"][k] = stats["launches"].get(k, 0) + v
            want = run_stream(host, tpcds_queries(host), lambda: None)
            for i, (a, b) in enumerate(zip(got["tables"], want["tables"])):
                compare_tables(a, b, f"{fmt}/{phase}/q{i}")
            if got["decisions"] != want["decisions"]:
                bad = [i for i, (x, y) in enumerate(
                    zip(got["decisions"], want["decisions"])) if x != y]
                raise AssertionError(f"{fmt}/{phase}: MQO decisions differ "
                                     f"between card and CPU at {bad} (index "
                                     f"{len(got['tables'])}: the windows)")
            if not any(name == "mqo.identify" and dict(attrs)["n_ses"] > 0
                       for name, attrs in got["decisions"][-1]):
                raise AssertionError(f"{fmt}/{phase}: no window found SEs")
            qps = len(got["tables"]) / got["seconds"]
            stats["passes"].append(dict(
                fmt=fmt, phase=phase, qps=qps,
                p50=percentile(got["windows"], 0.5),
                p99=percentile(got["windows"], 0.99),
                cpu_qps=len(want["tables"]) / want["seconds"]))
            log(f"main path {fmt}/{phase}: {qps:.2f} queries/s on the card "
                f"(CPU {stats['passes'][-1]['cpu_qps']:.2f}), window p50 "
                f"{stats['passes'][-1]['p50'] * 1e3:.1f} ms p99 "
                f"{stats['passes'][-1]['p99'] * 1e3:.1f} ms, "
                f"launches {launched}; results and "
                f"MQO decisions equal the CPU run")
            if p == 0:
                stats["reference"][fmt] = got["tables"]
        if fmt == "columnar":
            # one more warm pass under the profiler: where the card's
            # time goes, and how much of the pass it is busy at all
            K.reset_launches()
            prof = device_time(lambda: run_stream(
                card, tpcds_queries(card), lambda: synchronize(cuda)), cuda)
            for k, v in K.LAUNCHES.items():
                stats["launches"][k] = stats["launches"].get(k, 0) + v
            for i, (a, b) in enumerate(zip(prof["out"]["tables"],
                                           want["tables"])):
                compare_tables(a, b, f"{fmt}/profiled/q{i}")
            if prof["busy"] is None:
                log("main path columnar/warm, profiled: device time not "
                    "measured (the profiler saw no device activity)")
            else:
                top = "; ".join(f"{k[:48]} {t * 1e3:.2f} ms x{n}"
                                for k, t, n in prof["top"])
                ft, fn = prof["filter"]
                log(f"main path columnar/warm, profiled: wall "
                    f"{prof['wall'] * 1e3:.1f} ms, device busy "
                    f"{prof['busy'] * 1e3:.1f} ms (idle share "
                    f"{1 - prof['busy'] / prof['wall']:.3f}); "
                    f"filter_scan_kernel {ft * 1e3:.3f} ms x{fn} "
                    f"({ft / prof['busy']:.3f} of busy); top device "
                    f"events: {top}")
        reg = card.telemetry().registry
        stats["batched"] += reg.value("dispatch.batched")
        stats["events"] += reg.value("events.total")
        del card, host
    if stats["launches"].get("filter_scan_batch", 0) <= 0:
        raise AssertionError("main path never launched filter_scan_batch")
    if stats["batched"] <= 0:
        raise AssertionError("main path made no batched dispatch")
    if stats["events"] != 0:
        raise AssertionError(f"main path logged {stats['events']} "
                             f"DegradationEvents")
    return stats


def literal_route(K, reference, cuda,
                  scale_rows: int = SF1_STORE_SALES_ROWS) -> dict:
    """Phase 5: the F2 and F5 families with use_pallas_filter=True and
    shape_cache=False go through the literal-program filter_scan."""
    from repro_torch.device import synchronize
    from repro_torch.relational import SessionConfig
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    cfg = SessionConfig().with_execution(use_pallas_filter=True,
                                         shape_cache=False)
    sess = build_tpcds_session(scale_rows=scale_rows, config=cfg,
                               device=cuda)
    qs = tpcds_queries(sess)
    picked = list(range(10, 20)) + list(range(40, 46))   # F2, F5
    K.reset_launches()
    got = run_stream(sess, [qs[i] for i in picked],
                     lambda: synchronize(cuda))
    launches = dict(K.LAUNCHES)
    if launches["filter_scan"] <= 0:
        raise AssertionError("literal route never launched filter_scan")
    for i, t in zip(picked, got["tables"]):
        compare_tables(t, reference["columnar"][i], f"literal/q{i}")
    events = sess.telemetry().registry.value("events.total")
    if events:
        raise AssertionError(f"literal route logged {events} events")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    seconds, usage = build_kernels()
    log(f"build: {seconds:.1f} s (nvcc, sm_90a); ptxas: {'; '.join(usage)}")

    from repro_torch.kernels.filter_project import kernel as K

    cuda = torch.device("cuda")
    checked = kernel_sweep(cuda)
    log(f"kernels vs plain versions: bitwise equal over "
        f"{checked['filter_scan']} literal and "
        f"{checked['filter_scan_batch']} slotted programs")
    timings = kernel_timings(cuda)
    for name, t in timings.items():
        log(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}) [{smi}]")

    stats = main_path(K, cuda)
    literal = literal_route(K, stats["reference"], cuda)
    log(f"literal route: filter_scan launched {literal['filter_scan']} "
        f"times, results equal the main path's")
    log(f"total {time.perf_counter() - t_all:.1f} s")

    kernels = []
    for name, launches, path, line in (
            ("filter_scan_batch",
             stats["launches"].get("filter_scan_batch", 0), "main",
             "src/repro/kernels/filter_project/kernel.py:122"),
            ("filter_scan", literal["filter_scan"], "literal-route",
             "src/repro/kernels/filter_project/kernel.py:57")):
        t = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=FILTER_SCAN_CU, replaces=line,
            launches=launches, path=path, max_abs_err=t["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

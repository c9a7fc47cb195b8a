#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs its main path on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch`` with ``nvcc`` (one
process per source, all at once) and drives both of the port's paths:

* relational: holds the filter kernel bitwise against its plain torch
  versions over a seeded opcode sweep that runs every compiled variant,
  times it at the main path's shapes, streams the 50 TPC-DS queries at
  SF1 scale through ``QueryService`` windows on the card and on the CPU
  (results and MQO decisions must agree), and runs the literal-program
  route;
* CSV decode and the async front (A0, A): holds the CSV decoder
  (``parse_fields`` and its one-field forms ``parse_i32`` /
  ``parse_f32``) bitwise against its plain versions and times it at
  SF1; A0 streams the 50 queries through ``AsyncQueryService`` on the
  SF1 CSV tables (tables and MQO decisions must equal the CPU sync
  front's, and each CSV scan must launch the decoder once); A serves
  32 open-loop clients (two tenants, three template families) in fixed
  and adaptive windows, every table equal to the CPU's;
* attention (S1): holds ``decode_attention`` and ``flash_attention``
  against their plain versions over a sweep of masks, GQA groups, head
  dims, dtypes, strided views and long caches, checks that a second
  call equals the first and that decode of a batch equals each row
  decoded alone (bitwise), and times them at the serving path's shapes
  beside the plain version and ``scaled_dot_product_attention``, with
  the profiler's device time of the one kernel each call launches;
* serving (S2): serves granite-8b at full width through the prefix-cache
  MQO engine three times (no MQO, MQO cold, MQO warm), which must
  generate the same tokens and take the MQO decisions computed on the
  CPU, and checks ``Model.forward`` with the flash kernel against the
  plain attention on the card;
* families (S3): holds the Mamba, RG-LRU, MoE and MLA families'
  ``-smoke`` configs on the card against the CPU (S3a), then serves
  falcon-mamba-7b, recurrentgemma-9b, llama4-scout (6 of 48 layers) and
  deepseek-v2 (4 of 60) at full width the same three ways (S3b), with
  S2's checks per family;
* training (T0-T2): holds the differentiable ``flash_attention`` (the
  kernel's forward, a recompute backward through the plain version)
  against autograd through the plain version, gradients bitwise and the
  bf16 forward per row, up to T1's shape (T0); trains granite-8b at
  full width, 8 of its 36 layers, with f32 masters, AdamW and block
  remat for 8 steps at seq_len 4096 through ``train(...)``, checking
  every leaf's gradient, the kernel's launches and step 1 against the
  plain attention (a control without the causal mask must fail that
  check), and printing step seconds,
  tokens/s, the model FLOP/s share, peak memory and one profiled step
  (T1); and runs the JAX package's fault-tolerance tests on the card:
  a preempted, resumed run equals an uninterrupted one bitwise (T2).

``--only relational|async|attention|serving|families|training|timings``
runs one group (for bring-up: ``relational`` leaves out A0 and A,
``async`` runs the CSV decoder, A0 and A, ``serving``, ``families`` and
``training`` run S1 first, ``timings`` only times the filter kernel and
the decoder); with no
argument every phase runs.  ``--only timings --tree
DIR`` times the kernels of another checkout through its own wrappers,
so that an earlier commit's kernels (``git archive`` into DIR) and this
one's can be timed in turns on one card.  It prints one
line per phase.  The line before the last is the kernels' JSON; the
last line is the device JSON.  Any failure exits non-zero; without CUDA it exits non-zero before
any result.  The script imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SF1_STORE_SALES_ROWS = 2_880_404   # TPC-DS SF1 store_sales cardinality
FILTER_SCAN_CU = "src/repro_torch/kernels/filter_project/csrc/filter_scan.cu"
CSV_PARSE_CU = "src/repro_torch/kernels/filter_project/csrc/csv_parse.cu"
DECODE_CU = ("src/repro_torch/kernels/decode_attention/csrc/"
             "decode_attention.cu")
FLASH_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SOURCES = (FILTER_SCAN_CU, CSV_PARSE_CU, DECODE_CU, FLASH_CU)
WINDOW = 8                         # QueryService max_batch
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
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


def build_kernels(sources=SOURCES, root: Path = ROOT) -> tuple:
    """Build the port's kernel sources (paths under the checkout
    ``root``) with nvcc, one process per source started together;
    returns the wall seconds and, per source, a summary of ptxas's
    per-kernel resource report (registers, stack frame, spills)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(lambda src: _build.compile_source(root / src),
                             sources))
    seconds = time.perf_counter() - t0
    usage = {}
    for src, lib in zip(sources, libs):
        lines = lib.with_suffix(".log").read_text().splitlines()
        regs = [int(w) for line in lines if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        stack = [int(line.split("ptxas info    :")[-1].split()[0])
                 for line in lines if "stack frame" in line]
        spills = sum("0 bytes spill stores" not in line
                     for line in lines if "stack frame" in line)
        usage[Path(src).stem] = (
            f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"stack frame up to {max(stack)} bytes, {spills} with spills")
        if src in (FILTER_SCAN_CU, CSV_PARSE_CU):
            for kernel, figures in ptxas_kernels(lines).items():
                usage[kernel] = figures
    return seconds, usage


def ptxas_kernels(lines) -> dict:
    """Per kernel of a ptxas ``-v`` report, "R registers, S bytes stack
    frame, X bytes spill stores, Y bytes spill loads"; a template's
    integer arguments are written out (``filter_scan_kernel<8, 2>``)."""
    import re

    out, name = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"([A-Za-z_]+_kernel)(I(?:Li\d+E)+E)?",
                             mangled)
            name = base.group(1) if base else mangled
            if base and base.group(2):
                args = re.findall(r"Li(\d+)E", base.group(2))
                name += f"<{', '.join(args)}>"
            out[name] = ""
        elif name and "stack frame" in line:
            out[name] = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out[name] = f"{regs} registers, {out[name]}"
            name = None
    return out


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


def deep_program(rng, dtypes, slotted: bool, kinds: set, depth: int):
    """A program whose stack reaches ``depth``: ``depth`` leaves pushed
    first, then folded by and/or (with nots) from the top, so it needs
    the kernel's wider stack variants."""
    ivals, fvals = [], []
    prog = [random_leaf(rng, dtypes, slotted, ivals, fvals, kinds)
            for _ in range(depth)]
    for _ in range(depth - 1):
        if rng.random() < 0.2:
            prog.append(("not",))
        prog.append(("and",) if rng.random() < 0.5 else ("or",))
    return tuple(prog), len(ivals), len(fvals)


# (N, nrows, block) of the filter sweep: N a block multiple and not (the
# columns are padded), N not a multiple of the 2048- or 4096-row tile,
# nrows inside a tile, blocks down to the 1-4 rows the engine uses for
# tiny tables
FILTER_SWEEP = ((5000, 4321, 1024), (300, 300, 128), (4096, 1000, 2048),
                (5000, 4999, 512), (6144, 5000, 2048), (100, 37, 4),
                (9, 5, 1))
SWEEP_NQ = (1, 3, 8, 64)
SWEEP_DEPTHS = (5, 9, 17, 33, 64)  # each needs a wider stack variant


def kernel_sweep(device) -> dict:
    """Seeded opcode sweep: the filter kernel must be bitwise equal to
    its plain versions, over every opcode, n_q in SWEEP_NQ, programs deep enough for every stack
    variant (every compiled variant must run), 16 columns (a narrower
    tile), a column not 16-byte aligned, and the shapes of FILTER_SWEEP.
    Returns the programs checked per entry point and the variants run."""
    import numpy as np
    import torch

    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.kernels.filter_project import ref as R
    from repro_torch.kernels.filter_project.ops import _pad_rows

    rng = np.random.default_rng(0)
    kinds: set = set()
    checked = {"filter_scan": 0, "filter_scan_batch": 0}
    variants = set()

    def check(name, got, want, prog, what):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(
                    f"{name} disagrees with its plain version on program "
                    f"{prog} ({what})")

    def run(cols, prog, ki, kf, slotted, nrows, block, n_q, what):
        if not slotted:
            want = R.filter_scan_ref(cols, prog, nrows, block)
            check("filter_scan", K.filter_scan(cols, prog, nrows,
                                               block=block), want, prog,
                  what)
            name, queries = "filter_scan", 1
        else:
            ic = torch.from_numpy(rng.integers(
                -40, 40, (n_q, max(ki, 1))).astype(np.int32)).to(device)
            fc = torch.from_numpy((rng.integers(
                -40, 40, (n_q, max(kf, 1))) * 0.5).astype(
                    np.float32)).to(device)
            check("filter_scan_batch", K.filter_scan_batch(
                cols, prog, nrows, ic, fc, block=block),
                R.filter_scan_batch_ref(cols, prog, nrows, ic, fc, block),
                prog, what)
            name, queries = "filter_scan_batch", n_q
        enc = K.encode_program(prog, [c.dtype for c in cols], device)
        variants.add(K.kernel_variant(enc.max_depth, queries))
        checked[name] += 1

    for n, nrows, block in FILTER_SWEEP:
        cols = sweep_columns(rng, n, device)
        dtypes = [c.dtype for c in cols]
        padded, _ = _pad_rows(cols, block)
        for trial in range(120):
            slotted = trial % 2 == 1
            n_q = SWEEP_NQ[trial // 2 % len(SWEEP_NQ)]
            if trial % 10 in (8, 9):    # every depth, with 1 and 8 queries
                deep = trial // 10
                prog, ki, kf = deep_program(
                    rng, dtypes, slotted, kinds,
                    SWEEP_DEPTHS[deep % len(SWEEP_DEPTHS)])
                n_q = 8 if deep % 2 else 1
            else:
                prog, ki, kf = random_program(rng, dtypes, slotted, kinds)
            run(padded, prog, ki, kf, slotted, nrows, block, n_q,
                f"n={n}, nrows={nrows}, block={block}, n_q={n_q}")
    # 16 columns, 4 of them int64: the block's tile narrows to fit
    wide = sweep_columns(rng, 3072, device) * 4
    for trial in range(24):
        slotted = trial % 2 == 1
        prog, ki, kf = random_program(rng, [c.dtype for c in wide], slotted,
                                      kinds)
        run(wide, prog, ki, kf, slotted, 3000, 1024, 8, "16 columns")
    # columns that start 4 bytes past an aligned address: staged without
    # vector loads
    base = sweep_columns(rng, 4097, device)
    shifted = [c[1:] for c in base]
    for trial in range(24):
        slotted = trial % 2 == 1
        prog, ki, kf = random_program(rng, [c.dtype for c in shifted],
                                      slotted, kinds)
        run(shifted, prog, ki, kf, slotted, 4000, 4096, 8, "unaligned")
    want_kinds = ({c for c in CMPS} | {c + "c" for c in CMPS}
                  | {c + "$" for c in CMPS}
                  | {"in", "const", "and", "or", "not"})
    missing = want_kinds - kinds
    if missing:
        raise AssertionError(f"sweep missed opcodes {sorted(missing)}")
    want_variants = {(w, 1) for w in (1, 2, 4, 8, 16)} | {
        (w, K.QUERIES_PER_PASS) for w in (1, 2)}
    if variants != want_variants:
        raise AssertionError(f"sweep ran stack variants {sorted(variants)}, "
                             f"not {sorted(want_variants)}")
    checked["variants"] = len(variants)
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
    store_sales (capacity 2^22), the F2 predicate, 8 queries (and 64,
    the adaptive windows' cap), the literal program."""
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
    for k in range(64):
        thr = (50, 60, 70, 80, 90, 55, 65, 75)[k % 8] + k // 8
        pred = E.and_(E.cmp("ss_sales_price", ">", float(thr)),
                      E.cmp("ss_quantity", ">=", 10))
        program, iv, fv = compile_predicate_slots(pred, names, kinds)
        rows_i.append(iv)
        rows_f.append(fv)
    consts = {n_q: tuple(torch.from_numpy(a).to(device) for a in
                         pack_consts(rows_i[:n_q], rows_f[:n_q]))
              for n_q in (8, 64)}
    enc = K.encode_program(program, [c.dtype for c in dev_cols], device)
    lit = compile_predicate(E.and_(E.cmp("ss_sales_price", ">", 50.0),
                                   E.cmp("ss_quantity", ">=", 10)), names)
    enc_lit = K.encode_program(lit, [c.dtype for c in dev_cols], device)
    # the function reads each live row's predicate columns once (rows
    # at or past nrows are false without a read) and writes every mask
    # byte and count
    row_bytes = sum(c.element_size() for c in dev_cols)
    n_blocks = cap // block
    # (name, n_q, kernel call, plain version)
    cases = []
    for n_q in (8, 64):
        ic, fc = consts[n_q]
        key = "filter_scan_batch" + ("" if n_q == 8 else f"/nq{n_q}")
        cases.append((key, n_q, lambda ic=ic, fc=fc: K.filter_scan_batch(
            dev_cols, program, nrows, ic, fc, block=block, encoded=enc),
            lambda ic=ic, fc=fc: R.filter_scan_batch_ref(
                dev_cols, program, nrows, ic, fc, block)))
    cases.append(("filter_scan", 1,
                  lambda: K.filter_scan(dev_cols, lit, nrows, block=block,
                                        encoded=enc_lit),
                  lambda: R.filter_scan_ref(dev_cols, lit, nrows, block)))
    out = {}
    for name, n, kern, plain in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max(float((g.to(torch.int64) - w.to(torch.int64))
                        .abs().max()) for g, w in zip(got, want))
        if err != 0:
            raise AssertionError(f"{name} disagrees at the main shapes")
        nbytes = nrows * row_bytes + n * cap + n * n_blocks * 4
        ops = 3 * nrows * n      # two compares and one and per live row
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        out[name] = dict(ms=time_ms(kern),
                         device_ms=profiled_ms(kern, ("filter_scan_kernel",)),
                         plain_ms=time_ms(plain),
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations", max_abs_err=err,
                         shape=f"N={cap} nrows={nrows} n_q={n} block={block}")
    return out


def device_kernels(fn, reps: int = 20, windows: int = 3) -> dict:
    """Per device kernel name, (launches per call, device ms per call) of
    ``fn``, from ``torch.profiler`` over ``windows`` windows of ``reps``
    calls after one unprofiled call.  The profiler has dropped some of a
    window's kernels now and then, so a kernel's launches per call are
    the most any window saw, and its time per launch the mean over every
    launch of it that the windows saw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}     # kernel name -> [most in a window, total us, launches]
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count:
                rec = seen.setdefault(e.key, [0, 0.0, 0])
                rec[0] = max(rec[0], e.count)
                rec[1] += e.self_device_time_total
                rec[2] += e.count
    return {k: (most / reps, most / reps * us / n / 1e3)
            for k, (most, us, n) in seen.items()}


def marked(kernels: dict, marks) -> tuple:
    """(device ms per call, launches per call) of the kernels of
    :func:`device_kernels` whose names hold one of ``marks`` ("" matches
    every kernel); (None, 0) when there are none."""
    hits = [v for k, v in kernels.items() if any(m in k for m in marks)]
    if not hits:
        return None, 0
    return sum(ms for _, ms in hits), sum(n for n, _ in hits)


def profiled_ms(fn, marks, reps: int = 20):
    """Device ms per call of ``fn``'s kernels whose names hold one of
    ``marks``; None when the profiler saw none of them."""
    return marked(device_kernels(fn, reps), marks)[0]


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times, the median replay's
    CUDA-event time over ``calls``.  No host work runs between the
    kernels, so this holds a kernel and a library call to the same
    measure without the profiler."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, reps=reps)
    del graph
    return ms / calls


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


# the CSV decoder's one-field forms: name, wrapper, plain version,
# field width
# the decoder's device kernel, and the one-field kernels that a
# checkout given by --tree may launch instead
DECODER_MARKS = ("parse_fields_kernel", "parse_i32_kernel",
                 "parse_f32_kernel")


def parse_kernels():
    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.kernels.filter_project import ref as R

    return (("parse_i32", K.parse_i32, R.parse_i32_ref, 10),
            ("parse_f32", K.parse_f32, R.parse_f32_ref, 8))


def _bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def ascii_digits(values, width: int):
    """Zero-padded ASCII digits of non-negative ``values``."""
    import numpy as np

    out = np.zeros((len(values), width), np.uint8)
    v = np.asarray(values, np.int64)
    for k in range(width - 1, -1, -1):
        out[:, k] = v % 10 + 48
        v = v // 10
    return out


def _equal_fields(got, want, want_cpu) -> bool:
    import torch

    return len(got) == len(want) == len(want_cpu) and all(
        g.shape == w.shape and torch.equal(_bits(g), _bits(w))
        and torch.equal(_bits(g).cpu(), _bits(c))
        for g, w, c in zip(got, want, want_cpu))


def parse_sweep(device) -> int:
    """The CSV decoder bitwise against its plain versions, on the card
    and on the CPU.  One-field calls: fields of a raw (n, 90) row matrix
    at odd offsets (strided views) and one contiguous field, values up
    to 9,999,999,999, rows of ASCII zeros and rows of zero bytes.
    Multi-field calls: random field sets (1-12 fields of 10 or 8 bytes,
    overlapping or not) of row matrices 90 and 61 bytes wide, whole, cut
    to start 3 bytes in (not 16-byte aligned) and cut short (rows wider
    than the view).  n a multiple of the 256-row block and not.
    Returns the cases checked."""
    import numpy as np
    import torch

    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.kernels.filter_project import ref as R

    rng = np.random.default_rng(1)
    checked = 0
    for n in (4096, 5001, 300, 1):
        raw = rng.integers(0, 256, (n, 90)).astype(np.uint8)
        fields = {"parse_i32": (3, 41), "parse_f32": (17, 77)}
        for off in fields["parse_i32"]:
            vals = rng.integers(0, 10**10, n)
            vals[:3] = [9_999_999_999, 2**31 - 1, 2**31][:n]
            raw[:, off:off + 10] = ascii_digits(vals, 10)
        for off in fields["parse_f32"]:
            vals = rng.integers(0, 10**8, n)
            vals[:1] = 99_999_999
            raw[:, off:off + 8] = ascii_digits(vals, 8)
        raw[n // 2:n // 2 + n // 8] = 48          # every digit '0'
        if n // 5:
            raw[n - n // 5:] = 0                  # padding rows
        host = torch.from_numpy(raw)
        card = host.to(device)
        for name, kern, plain, width in parse_kernels():
            views = [(card[:, o:o + width], host[:, o:o + width])
                     for o in fields[name]]
            views.append((card[:, fields[name][0]:fields[name][0] + width]
                          .contiguous(),
                          host[:, fields[name][0]:fields[name][0] + width]))
            for dev_view, host_view in views:
                if not _equal_fields([kern(dev_view)], [plain(dev_view)],
                                     [plain(host_view)]):
                    raise AssertionError(
                        f"{name} disagrees with its plain version (n={n}, "
                        f"stride {tuple(dev_view.stride())})")
                checked += 1
        for stride in (90, 61):
            wide = rng.integers(0, 256, (n, stride)).astype(np.uint8)
            wide[:, :60] = ascii_digits(rng.integers(0, 10**18, n), 60)
            if n // 5:
                wide[n - n // 5:] = 0
            whole = torch.from_numpy(wide)
            for dev_rows, host_rows in (
                    (whole.to(device), whole),
                    (whole.to(device)[:, 3:], whole[:, 3:]),
                    (whole.to(device)[:, :stride - 7],
                     whole[:, :stride - 7])):
                width = host_rows.shape[1]
                for _ in range(4):
                    fields_ = [(int(rng.integers(0, width - w + 1)), w)
                               for w in rng.choice(
                                   (10, 8), int(rng.integers(1, 13)))]
                    if not _equal_fields(
                            K.parse_fields(dev_rows, fields_),
                            R.parse_fields_ref(dev_rows, fields_),
                            R.parse_fields_ref(host_rows, fields_)):
                        raise AssertionError(
                            f"parse_fields disagrees with its plain version "
                            f"(n={n}, rows of {width} bytes at stride "
                            f"{stride}, fields {fields_})")
                    checked += 1
    return checked


# the ten numeric fields of store_sales, and the F1 scan's (the category
# report reads the item, date and sales price fields)
STORE_SALES_NUMERIC = ("ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                       "ss_store_sk", "ss_quantity", "ss_wholesale_cost",
                       "ss_list_price", "ss_sales_price",
                       "ss_ext_sales_price", "ss_net_profit")
F1_SCAN_FIELDS = ("ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price")


def sector_bytes(stride: int, fields, rows: int, granule: int = 32) -> int:
    """Bytes of the ``granule``-byte blocks (32: the card's sectors) of
    ``rows`` rows ``stride`` bytes apart (from an aligned base) that hold
    a byte of ``fields`` (``(offset, width)``): the least DRAM traffic a
    decoder of those fields can have when the card fetches blocks of
    that size.  The pattern repeats every ``granule / gcd(stride,
    granule)`` rows, whose blocks no neighbouring period shares."""
    import math

    period = granule // math.gcd(stride, granule)

    def count(n):
        return len({(r * stride + off + k) // granule for r in range(n)
                    for off, w in fields for k in range(w)})

    whole, rest = divmod(rows, period)
    return granule * (whole * count(period) + count(rest))


def parse_timings(device) -> dict:
    """The CSV decoder at SF1 capacity over store_sales' raw rows (2^22 x
    90 bytes on the card, zero bytes past the live rows), as the CSV
    scan hands them over: one-field calls on ss_quantity (i32) and
    ss_sales_price (f32); one multi-field launch over all ten numeric
    fields and over the F1 scan's three, each beside the one-field
    launches it replaces.  The bound counts each live row's field bytes
    once and its 4-byte outputs once; ``sector_floor_ms`` counts the
    32-byte sectors that hold field bytes over every row decoded, and
    every output, ``floor64_ms`` the same with 64-byte blocks (both
    computed, not measured: they go to the log, not the kernels line).
    In a checkout without ``parse_fields`` (``--tree``) a scan's fields
    are decoded one launch a field, as its scans decode them."""
    import numpy as np
    import torch

    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.kernels.filter_project import ref as R
    from repro_torch.relational.datagen import to_csv_bytes
    from repro_torch.relational.schema import next_pow2
    from repro_torch.relational.tpcds import generate_tpcds_catalog

    schema, nrows, cols = generate_tpcds_catalog(SF1_STORE_SALES_ROWS)[
        "store_sales"]
    host = np.zeros((next_pow2(nrows), schema.row_csv_bytes), np.uint8)
    host[:nrows] = to_csv_bytes(schema, cols, nrows)
    raw = torch.from_numpy(host).to(device)
    cap, stride = raw.shape
    offsets = schema.csv_offsets()

    def one_field(width, view):
        return (K.parse_i32 if width == 10 else K.parse_f32)(view)

    def per_field(fields):
        return [one_field(w, raw[:, o:o + w]) for o, w in fields]

    def plain(fields):
        return [(R.parse_i32_ref if w == 10 else R.parse_f32_ref)(
            raw[:, o:o + w]) for o, w in fields]

    multi = getattr(K, "parse_fields", None)

    def entry(kern, plain, fields, shape):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not _equal_fields(got, want, [w.cpu() for w in want]):
            raise AssertionError(f"the CSV decoder disagrees at SF1 ({shape})")
        width = sum(w for _, w in fields)
        bytes_ms = nrows * (width + 4 * len(fields)) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * width * nrows / F32_OPS_PER_S * 1e3
        out_bytes = 4 * len(fields) * cap
        floor = sector_bytes(stride, fields, cap) + out_bytes
        floor64 = sector_bytes(stride, fields, cap, 64) + out_bytes
        device_ms, launches = marked(device_kernels(kern), DECODER_MARKS)
        return dict(
            ms=time_ms(kern), device_ms=device_ms,
            launches_per_call=launches, plain_ms=time_ms(plain),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            sector_floor_ms=floor / HBM_BYTES_PER_S * 1e3,
            floor64_ms=floor64 / HBM_BYTES_PER_S * 1e3,
            max_abs_err=0.0, shape=shape)

    out = {}
    for (name, _, _, width), field in zip(
            parse_kernels(), ("ss_quantity", "ss_sales_price")):
        off, w = offsets[field]
        view = raw[:, off:off + w]
        what = (f"{field}: ({cap}, {w}) view at offset {off} of ({cap}, "
                f"{stride}) raw rows, {nrows} live")
        out[name] = entry(
            lambda view=view, w=w: [one_field(w, view)],
            lambda off=off, w=w: plain([(off, w)]),
            [(off, w)], what + (", direct mode" if multi else ""))
        if multi is None:
            continue
        # the staged mode, which a one-field call does not take
        out[f"{name}/staged"] = entry(
            lambda view=view, w=w, name=name: K._decode(
                view, [(0, w)], name, direct=False),
            lambda off=off, w=w: plain([(off, w)]),
            [(off, w)], f"{what}, staged mode")
    for key, names in (("all10", STORE_SALES_NUMERIC),
                       ("f1", F1_SCAN_FIELDS)):
        fields = [offsets[f] for f in names]
        what = (f"{len(fields)} fields ({', '.join(names)}) of ({cap}, "
                f"{stride}) raw rows, {nrows} live")
        if multi is not None:
            out[f"parse_fields/{key}"] = entry(
                lambda fields=fields: multi(raw, fields),
                lambda fields=fields: plain(fields),
                fields, f"one launch: {what}")
        out[f"parse_fields/{key}/per-field"] = entry(
            lambda fields=fields: per_field(fields),
            lambda fields=fields: plain(fields),
            fields, f"one launch a field: {what}")
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


def device_time(fn, device, mark: str = "filter_scan_kernel") -> dict:
    """Run ``fn`` under ``torch.profiler``; returns its wall seconds,
    the device-busy seconds (the summed time of the kernels and copies
    that ran on the device — one stream, so they do not overlap; host
    ops, which the profiler also credits with their kernels' time, are
    left out), the top device events and, under ``filter``, the summed
    device time and launches of the events whose name holds ``mark``.
    ``busy`` is None when the profiler saw no device activity."""
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
    filt = [(t, n) for k, t, n in dev if mark in k]
    filt = (sum(t for t, _ in filt), sum(n for _, n in filt))
    return dict(out=out, wall=wall, busy=busy, top=dev[:6], filter=filt,
                n_events=sum(n for _, _, n in dev), events=dev)


def main_path(K, cuda, scale_rows: int = SF1_STORE_SALES_ROWS) -> dict:
    """Phase 4: SF1 TPC-DS stream, cold then warm, columnar then CSV,
    on the card and on the CPU; results and decisions must agree.  The
    CPU's CSV passes are kept (``host_csv``) as phase A0's reference."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    cpu = torch.device("cpu")
    stats = {"launches": {}, "passes": [], "reference": {}, "batched": 0,
             "events": 0, "host_csv": []}
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
            if fmt == "csv":     # phase A0's reference
                stats["host_csv"].append(want)
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


# ---------------------------------------------------------------------------
# phases A0 and A: the asyncio serving front over the SF1 CSV tables
# ---------------------------------------------------------------------------
# Phase A's traffic is benchmarks/bench_async.py's, put on store_sales:
# open-loop clients with seeded exponential gaps, three template
# families with a fresh literal per arrival, two tenants.
ASYNC_CLIENTS, ASYNC_PER_CLIENT = 32, 8
ASYNC_GAP_S = 0.08                 # mean gap a client: ~400 queries/s
ASYNC_SEED = 1000
ASYNC_MODES = (
    ("fixed", dict(max_batch=8, max_wait_s=0.02)),
    ("adaptive", dict(max_batch=8, max_wait_s=0.02, adaptive=True,
                      slo_p99_s=2.0, max_batch_cap=64,
                      exec_default_s=0.05)),
)
ASYNC_TIMEOUT_S = 600.0            # a wedged window fails the phase


def host_csv_passes(scale_rows: int = SF1_STORE_SALES_ROWS) -> list:
    """The CPU sync front's cold and warm passes of the 50 TPC-DS
    queries on the CSV tables (phase A0's reference when the main path
    did not run)."""
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    host = build_tpcds_session(scale_rows=scale_rows, fmt="csv",
                               device="cpu")
    host.enable_tracing()
    return [run_stream(host, tpcds_queries(host), lambda: None)
            for _ in range(2)]


def async_fixed_windows(K, device, want_passes,
                        scale_rows: int = SF1_STORE_SALES_ROWS) -> list:
    """Phase A0: one client submits the 50 TPC-DS queries through
    ``AsyncQueryService`` on the SF1 CSV session, cold then warm, in
    windows that only the count (8) or ``flush()`` closes.  Each table
    and each query's and window's MQO decisions must equal the CPU sync
    front's (``want_passes``), and each CSV scan must launch the decoder
    once, however many numeric fields it reads.  Returns per pass the
    launches, the CSV scans and their numeric fields, and the
    throughput."""
    import asyncio

    from repro_torch.relational import AsyncConfig, AsyncQueryService
    from repro_torch.relational import physical
    from repro_torch.relational.observe import mqo_decision, mqo_trace
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    sess = build_tpcds_session(scale_rows=scale_rows, fmt="csv",
                               device=device)
    sess.enable_tracing()
    cfg = AsyncConfig(max_batch=WINDOW, max_wait_s=3600.0)

    async def serve(queries):
        async with AsyncQueryService(sess, config=cfg) as svc:
            t0 = time.perf_counter()
            handles = [await svc.submit(q) for q in queries]
            await svc.flush()
            tables = await asyncio.wait_for(asyncio.gather(*handles),
                                            ASYNC_TIMEOUT_S)
            return handles, tables, time.perf_counter() - t0

    # Each CSV scan (a call of physical._csv_columns) must decode all of
    # its numeric fields in one call of physical._parse_fields, which
    # launches the decoder once: the scans and the decode calls are
    # counted by separate spies and checked against each other and
    # against the launch counter.
    scans, decodes, bad = [], [], []
    decode, columns = physical._parse_fields, physical._csv_columns

    def decode_spy(raw, fields):
        decodes.append(sorted(fields))
        return decode(raw, fields)

    def scan_spy(raw, schema, needed, nrows, ctx):
        offsets = schema.csv_offsets()
        numeric = sorted(offsets[n] for n in needed
                         if schema.coltype(n).kind in ("i32", "f32"))
        first = len(decodes)
        cols = columns(raw, schema, needed, nrows, ctx)
        if decodes[first:] != ([numeric] if numeric else []):
            bad.append((numeric, decodes[first:]))
        scans.append(len(numeric))
        return cols

    out = []
    for phase, want in zip(("cold", "warm"), want_passes):
        K.reset_launches()
        scans.clear()
        decodes.clear()
        physical._parse_fields = decode_spy
        physical._csv_columns = scan_spy
        try:
            handles, tables, seconds = asyncio.run(
                serve(tpcds_queries(sess)))
        finally:
            physical._parse_fields = decode
            physical._csv_columns = columns
        launched = dict(K.LAUNCHES)
        decoding = sum(n > 0 for n in scans)
        if bad or not decoding or len(decodes) != decoding \
                or launched["parse_fields"] != decoding:
            raise AssertionError(
                f"async/{phase}: {len(scans)} CSV scans, {decoding} with "
                f"numeric fields, made {len(decodes)} decode calls and "
                f"{launched['parse_fields']} decoder launches; scans not "
                f"decoded in one call of all their numeric fields: "
                f"{bad[:3]}")
        for i, (a, b) in enumerate(zip(tables, want["tables"])):
            compare_tables(a, b, f"async/{phase}/q{i}")
        decisions = [mqo_decision(h._inner) for h in handles]
        decisions.append(mqo_trace(sess.telemetry().tracer))
        if len(tables) != len(want["tables"]) \
                or decisions != want["decisions"]:
            bad = [i for i, (x, y) in enumerate(
                zip(decisions, want["decisions"])) if x != y]
            raise AssertionError(f"async/{phase}: MQO decisions differ from "
                                 f"the CPU sync front's at {bad}")
        out.append(dict(phase=phase, qps=len(tables) / seconds,
                        launches=launched, scans=decoding,
                        fields=sum(scans)))
    events = sess.telemetry().registry.value("events.total")
    if events:
        raise AssertionError(f"phase A0 logged {events} DegradationEvents")
    return out


def async_arrivals(seed0: int = ASYNC_SEED) -> list:
    """Per client, its arrivals [(gap s, family, literals)], each client
    drawing from its own seeded generator."""
    import numpy as np

    out = []
    for i in range(ASYNC_CLIENTS):
        rng = np.random.default_rng(seed0 + i)
        out.append([(float(rng.exponential(ASYNC_GAP_S)), (i + k) % 3,
                     (int(rng.integers(1, 99)), int(rng.integers(1, 2000)),
                      int(rng.integers(0, 100))))
                    for k in range(ASYNC_PER_CLIENT)])
    return out


def family_query(sess, fam: int, lits: tuple):
    """One arrival of a template family, with its fresh literals."""
    from repro_torch.relational import expr as E

    qty, item, store = lits
    t = sess.table("store_sales")
    if fam == 0:
        return t.filter(E.cmp("ss_quantity", ">", qty)).project(
            "ss_item_sk", "ss_quantity")
    if fam == 1:
        return t.filter(E.cmp("ss_item_sk", "<", item)).project(
            "ss_item_sk", "ss_sales_price")
    return t.filter(E.and_(E.cmp("ss_quantity", ">", qty),
                           E.cmp("ss_store_sk", ">", store))).project(
        "ss_quantity", "ss_net_profit")


def async_reference(arrivals, scale_rows: int = SF1_STORE_SALES_ROWS):
    """Phase A's plans through the CPU sync front in windows of 8; the
    tables in (client, arrival) order."""
    from repro_torch.relational.tpcds import build_tpcds_session

    host = build_tpcds_session(scale_rows=scale_rows, fmt="csv",
                               device="cpu")
    svc = host.service(max_batch=WINDOW)
    handles = [svc.submit(family_query(host, fam, lits))
               for client in arrivals for _, fam, lits in client]
    svc.flush()
    return [h.result() for h in handles]


def _prime(sess) -> None:
    """What bench_async._prime does: two batches of the three families
    through the MQO path, outside the measured stream."""
    sess.run_batch([family_query(sess, f, (10 + f, 100 + f, 5 + f))
                    for f in range(3)], mqo=True)
    sess.run_batch([family_query(sess, f, (90 - f, 1900 - f, 95 - f))
                    for f in range(3)], mqo=True)


def async_open_loop(K, device, mode: str, cfg_kw: dict, arrivals, want,
                    scale_rows: int = SF1_STORE_SALES_ROWS) -> dict:
    """Phase A, one mode: the open-loop clients on a primed SF1 CSV
    session.  Raises unless every handle resolved, none failed, every
    table equals the CPU's, no DegradationEvent was logged and the
    memory audit is clean.  Returns the throughput, latency p50 / p99,
    mean window size, tenants' report and the launches of the run."""
    import asyncio

    from repro_torch.device import synchronize
    from repro_torch.relational import (AsyncConfig, AsyncQueryService,
                                        TenantQuota)
    from repro_torch.relational.tpcds import build_tpcds_session

    sess = build_tpcds_session(scale_rows=scale_rows, fmt="csv",
                               device=device)
    _prime(sess)
    synchronize(device)
    reg = sess.telemetry().registry
    closed0 = reg.value("windows.closed")
    quota = TenantQuota(max_inflight=64)
    cfg = AsyncConfig(quotas={"team0": quota, "team1": quota}, **cfg_kw)
    handles, tables, lats, waiters = {}, {}, {}, []

    async def client(svc, i):
        for k, (gap, fam, lits) in enumerate(arrivals[i]):
            await asyncio.sleep(gap)
            t0 = time.perf_counter()
            h = await svc.submit(family_query(sess, fam, lits),
                                 tenant=f"team{i % 2}")
            handles[i, k] = h

            async def wait(h=h, t0=t0, key=(i, k)):
                try:
                    tables[key] = await h
                finally:
                    lats[key] = time.perf_counter() - t0

            waiters.append(asyncio.create_task(wait()))

    async def go():
        async with AsyncQueryService(sess, config=cfg) as svc:
            t0 = time.perf_counter()
            await asyncio.gather(*(client(svc, i)
                                   for i in range(ASYNC_CLIENTS)))
            await svc.flush()
            await asyncio.wait_for(asyncio.gather(
                *waiters, return_exceptions=True), ASYNC_TIMEOUT_S)
            wall = time.perf_counter() - t0
            report = svc.metrics_report()
        return wall, report

    K.reset_launches()
    wall, report = asyncio.run(go())
    launched = dict(K.LAUNCHES)
    n = ASYNC_CLIENTS * ASYNC_PER_CLIENT
    unresolved = [key for key, h in handles.items() if not h.done]
    failed = {key: repr(h.error) for key, h in handles.items() if h.failed}
    if len(handles) != n or unresolved or failed:
        raise AssertionError(f"async/{mode}: {len(handles)} of {n} handles, "
                             f"unresolved {unresolved}, failed {failed}")
    for key, h in handles.items():
        i, k = key
        compare_tables(tables[key], want[i * ASYNC_PER_CLIENT + k],
                       f"async/{mode}/client{i}/q{k}")
    events = reg.value("events.total")
    violations = sess.memory.audit()
    if events or violations:
        raise AssertionError(f"async/{mode}: {events} DegradationEvents, "
                             f"audit {violations}")
    windows = reg.value("windows.closed") - closed0
    lat = list(lats.values())
    tenants = {t: {"submitted": sec.get("queries.submitted"),
                   "succeeded": sec.get("queries.succeeded"),
                   "bytes": sec.get("bytes_total"),
                   "p99_s": (sec.get("latency") or {}).get("p99")}
               for t, sec in report["tenants"].items()}
    del sess
    return dict(mode=mode, n=n, wall=wall, qps=n / wall,
                p50=percentile(lat, 0.5), p99=percentile(lat, 0.99),
                windows=windows, mean_window=n / max(windows, 1),
                tenants=tenants, launches=launched)


def async_phases(cuda, smi: str, want_passes) -> dict:
    """Phases A0 and A; returns the launches of each kernel over both,
    counted from 0 just before each driven run and read just after."""
    from repro_torch.kernels.filter_project import kernel as K

    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for p in async_fixed_windows(K, cuda, want_passes):
        add(p["launches"])
        log(f"async A0 csv/{p['phase']}: {p['qps']:.2f} queries/s on the "
            f"card, launches {p['launches']}: {p['scans']} CSV scans "
            f"decoded {p['fields']} numeric fields in "
            f"{p['launches']['parse_fields']} decoder launches, each scan "
            f"all of its numeric fields in one call; tables and "
            f"MQO decisions (per query and per window) equal the CPU sync "
            f"front's [{smi}]")
    arrivals = async_arrivals()
    want = async_reference(arrivals)
    for mode, cfg_kw in ASYNC_MODES:
        r = async_open_loop(K, cuda, mode, cfg_kw, arrivals, want)
        add(r["launches"])
        missing = [k for k in ("parse_fields", "filter_scan_batch")
                   if r["launches"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"async/{mode} never launched {missing}")
        log(f"async A {mode}: {r['n']} queries from {ASYNC_CLIENTS} "
            f"open-loop clients in {r['wall']:.3f} s, {r['qps']:.2f} "
            f"queries/s, latency p50 {r['p50'] * 1e3:.1f} ms p99 "
            f"{r['p99'] * 1e3:.1f} ms, {r['windows']} windows (mean "
            f"{r['mean_window']:.2f} queries), launches {r['launches']}, "
            f"tenants {json.dumps(r['tenants'], sort_keys=True)}; every "
            f"handle resolved, none failed, tables equal the CPU's, 0 "
            f"DegradationEvents, audit clean [{smi}]")
    return launches


# ---------------------------------------------------------------------------
# phase S1: attention kernels against their plain versions
# ---------------------------------------------------------------------------
# Tolerances of the attention kernels against their plain versions on the
# same inputs: both compute in f32 from the same inputs and round once
# to the output dtype, but sum in another order, so f32 outputs may
# differ by a few ulps of the f32 sums (2e-5, the JAX package's own
# kernel-test tolerance) and bf16 outputs by one bf16 ulp of values
# below 4 (3e-2, likewise).
ATTN_ATOL = {"torch.float32": 2e-5, "torch.bfloat16": 3e-2}
# Full-model logits, flash kernel against plain attention, both bf16 on
# the card: the two attentions round to bf16 apart by at most one ulp
# per element, and 36 bf16 layers carry that on; the logits must agree
# within 5% of the largest logit (a wrong mask or head mapping moves
# them by its whole size).
FORWARD_RTOL = 0.05
SERVE_SEED = 0
SERVE_BUDGET, SERVE_K = 64 << 20, 2    # prefix pool bytes, SE threshold
GRANITE_LAYERS = 36


def _randn(shape, dtype, device, gen):
    import torch

    return torch.randn(shape, generator=gen, device=device).to(dtype)


def attention_sweep(device) -> dict:
    """Both attention kernels against their plain versions: causal /
    window (and neither) x group 1-5 (and 16 at D 256) x D 32, 64, 128,
    256 x f32 / bf16, with live lengths of 1 and lengths and offsets that
    are no multiple of a tile; the bf16 forward also on the strided
    (B, T, H, D) views ``gqa_forward`` hands it; and at granite-8b's
    heads, decode over an 8192-slot cache at 8192 and 1 live keys and the
    forward at T = S = 1024 causal and at T = 64 < S = 1000 with a
    window.  Returns the worst error and case count per kernel; raises
    on an error above ATTN_ATOL."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import decode_ref, mha_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = {"decode_attention": 0.0, "flash_attention": 0.0}
    cases = {"decode_attention": 0, "flash_attention": 0}

    def check(name, got, want, dtype, what):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= ATTN_ATOL[str(dtype)]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"by {err} at {what}")
        worst[name] = max(worst[name], err)
        cases[name] += 1

    def decode_case(q, k, v, kv_len, dtype, what):
        for window in (None, 48):
            check("decode_attention",
                  DK.decode_attention(q, k, v, kv_len, window=window),
                  decode_ref(q, k, v, kv_len, window=window), dtype,
                  f"{what} window={window}")

    def flash_case(q, k, v, dtype, what, masks):
        for causal, window in masks:
            check("flash_attention",
                  FK.flash_attention(q, k, v, causal=causal, window=window),
                  mha_ref(q, k, v, causal=causal, window=window), dtype,
                  f"{what} T={q.shape[2]} S={k.shape[2]} causal={causal} "
                  f"window={window}")

    every_mask = ((True, None), (True, 48), (False, None), (False, 48))
    for d in (32, 64, 128, 256):
        for group in (1, 2, 3, 4, 5) + ((16,) if d == 256 else ()):
            for dtype in (torch.float32, torch.bfloat16):
                hkv, hq, s = 2, 2 * group, 300
                what = f"D={d} group={group} {dtype}"
                decode_case(_randn((3, hq, d), dtype, device, gen),
                            _randn((3, hkv, s, d), dtype, device, gen),
                            _randn((3, hkv, s, d), dtype, device, gen),
                            torch.tensor([1, 137, s], dtype=torch.int32,
                                         device=device), dtype, what)
                for t, s2 in ((100, 160), (130, 130), (1, 70)):
                    flash_case(_randn((1, hq, t, d), dtype, device, gen),
                               _randn((1, hkv, s2, d), dtype, device, gen),
                               _randn((1, hkv, s2, d), dtype, device, gen),
                               dtype, what, every_mask)
        for group in (1, 4):
            # (B, T, H, D) storage seen as (B, H, T, D), as gqa_forward
            # hands the kernel its q, k, v
            hkv, hq, t, s2 = 2, 2 * group, 100, 160
            flash_case(*(_randn((2, n, h, d), torch.bfloat16, device, gen)
                         .transpose(1, 2) for n, h in
                         ((t, hq), (s2, hkv), (s2, hkv))),
                       torch.bfloat16, f"D={d} group={group} strided",
                       ((True, None), (True, 48)))
    hq, hkv, d = 32, 8, 128
    for dtype in (torch.float32, torch.bfloat16):
        what = f"granite heads {dtype}"
        decode_case(_randn((2, hq, d), dtype, device, gen),
                    _randn((2, hkv, 8192, d), dtype, device, gen),
                    _randn((2, hkv, 8192, d), dtype, device, gen),
                    torch.tensor([8192, 1], dtype=torch.int32,
                                 device=device), dtype, f"{what} S=8192")
        for t, s2, masks in ((1024, 1024, ((True, None),)),
                             (64, 1000, ((True, 200),))):
            flash_case(_randn((1, hq, t, d), dtype, device, gen),
                       _randn((1, hkv, s2, d), dtype, device, gen),
                       _randn((1, hkv, s2, d), dtype, device, gen), dtype,
                       what, masks)
    return dict(worst=worst, cases=cases)


def attention_bitwise(device) -> list:
    """Run-to-run and batch invariance of both kernels at granite-8b's
    heads, in bf16: a second call equals the first bitwise, and decode
    of a batch of 8 rows (live lengths 1 .. 1024 over a 1024-slot cache,
    with and without a window) equals each row decoded alone.  Returns
    what was checked; raises on any difference."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    bf16 = torch.bfloat16
    hq, hkv, d = 32, 8, 128
    done = []
    q, k, v = (_randn((1, h, 256, d), bf16, device, gen)
               for h in (hq, hkv, hkv))
    if not torch.equal(FK.flash_attention(q, k, v),
                       FK.flash_attention(q, k, v)):
        raise AssertionError("flash_attention differs between two calls")
    done.append("flash_attention: two calls equal")
    lens = torch.tensor([1, 37, 128, 257, 300, 511, 777, 1024],
                        dtype=torch.int32, device=device)
    q = _randn((8, hq, d), bf16, device, gen)
    k = _randn((8, hkv, 1024, d), bf16, device, gen)
    v = _randn((8, hkv, 1024, d), bf16, device, gen)
    for window in (None, 100):
        full = DK.decode_attention(q, k, v, lens, window=window)
        if not torch.equal(full, DK.decode_attention(q, k, v, lens,
                                                     window=window)):
            raise AssertionError(f"decode_attention differs between two "
                                 f"calls (window={window})")
        for i in range(8):
            one = DK.decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                      lens[i:i + 1], window=window)
            if not torch.equal(one, full[i:i + 1]):
                raise AssertionError(
                    f"decode_attention of row {i} alone differs from the "
                    f"batch of 8 (window={window})")
    done.append("decode_attention: two calls equal, each of 8 rows alone "
                "equals the batch (window None and 100)")
    return done


DECODE_MARK = "decode_attention_kernel"
PROFILE_SESSIONS = 4                # S1's profiler sessions at most
PROFILE_WINDOWS, PROFILE_REPS = 3, 20   # device_kernels' defaults
FLASH_MARK = "flash_fwd_wgmma_kernel"


def _timing(kern, plain, lib, nbytes: int, flops: int, shape: str,
            marks: tuple, launched) -> dict:
    """Times of the kernel (CUDA events around the wrapper, and the
    device time of its kernels ``marks`` from the profiler), its plain
    version and one library call (CUDA events, and the device time of
    all its kernels) on the same inputs, with the bound of the
    function's work.  Raises when the profiler sees no kernel ``marks``
    or any device work of the wrapper beyond one such kernel a call.
    ``launched()`` reads the wrapper's launch counter."""
    import torch

    err = float((kern().float() - plain().float()).abs().max())
    torch.cuda.synchronize()
    if not err <= ATTN_ATOL["torch.bfloat16"]:
        raise AssertionError(f"kernel disagrees at {shape}: {err}")
    # The profiler has lost a launch in every window of a session now
    # and then.  A session that saw fewer launches than calls and no
    # other device work is profiled again (at most PROFILE_SESSIONS in
    # all), but only while the wrapper's counter shows one launch a call
    # in that session: each counted launch returned success and the
    # session's synchronize raised nothing, so the kernel ran and the
    # profiler lost its record.  Any other count fails at once.
    calls = 1 + PROFILE_WINDOWS * PROFILE_REPS    # device_kernels' calls
    for _ in range(PROFILE_SESSIONS):
        before = launched()
        kernels = device_kernels(kern, PROFILE_REPS, PROFILE_WINDOWS)
        issued = (launched() - before) / calls
        device_ms, per_call = marked(kernels, marks)
        _, every = marked(kernels, ("",))
        if not (device_ms is not None and per_call < 1 and every == per_call
                and issued == 1):
            break
        log(f"S1 at {shape}: the profiler saw {per_call:.2f} kernels "
            f"{marks} a call in its fullest window, the wrapper's counter "
            f"{issued:.2f} launches a call; profiling again")
    if device_ms is None or per_call != 1 or every != 1 or issued != 1:
        raise AssertionError(
            f"at {shape} the profiler saw {per_call} kernels {marks} and "
            f"{every} device events per wrapper call, the wrapper's "
            f"counter {issued} launches a call, not one")
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    return dict(ms=time_ms(kern), device_ms=device_ms,
                graph_ms=graph_ms(kern), plain_ms=time_ms(plain),
                library_ms=time_ms(lib),
                # every device event of the library call ("" matches all)
                library_device_ms=profiled_ms(lib, ("",)),
                library_graph_ms=graph_ms(lib),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                max_abs_err=err, shape=shape)


def attention_timings(device) -> dict:
    """Kernel, plain version and ``scaled_dot_product_attention`` at the
    serving path's shapes (granite-8b, bf16): decode over a 1024-slot
    cache at 128 and 1024 live keys (batch 1, as the engine decodes) and
    at S2's 8 requests as one batch at 272 live keys, forward over a
    256-token prompt and over T1's training batch (2 x 4096 tokens); and
    at S3's shapes (``s3/<model>``): decode at 144
    live keys of a 256-slot cache and the forward over the 128-token
    template, for recurrentgemma-9b's local layers (16 query heads of
    256 over one KV head, window 2048) and llama4-scout's (40 over 8, head
    dim 128).  Bounds count live bytes only: q and out once, the live K/V
    rows once; the forward's operations are QK^T and PV over the causal
    pairs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import decode_ref, mha_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    bf16 = torch.bfloat16
    hq, hkv, d = 32, 8, 128
    out = {}
    for b, lives in ((1, (128, 1024)), (8, (272,))):
        q = _randn((b, hq, d), bf16, device, gen)
        k = _randn((b, hkv, 1024, d), bf16, device, gen)
        v = _randn((b, hkv, 1024, d), bf16, device, gen)
        for live in lives:
            kv_len = torch.full((b,), live, dtype=torch.int32, device=device)
            key = f"decode_attention/kv{live}" + ("" if b == 1 else f"/b{b}")
            out[key] = _timing(
                lambda: DK.decode_attention(q, k, v, kv_len),
                lambda: decode_ref(q, k, v, kv_len),
                lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k[:, :, :live], v[:, :, :live],
                    enable_gqa=True),
                b * (2 * q[0].numel() * 2 + 2 * hkv * live * d * 2 + 4),
                b * 4 * hq * live * d,
                f"q ({b}, {hq}, {d}), cache ({b}, {hkv}, 1024, {d}) bf16, "
                f"kv_len {live}", (DECODE_MARK,),
                lambda: DK.LAUNCHES["decode_attention"])
    def flash(key, hq, hkv, d, t, window=None, b=1):
        q = _randn((b, hq, t, d), bf16, device, gen)
        k = _randn((b, hkv, t, d), bf16, device, gen)
        v = _randn((b, hkv, t, d), bf16, device, gen)
        out[key] = _timing(
            lambda: FK.flash_attention(q, k, v, causal=True, window=window),
            lambda: mha_ref(q, k, v, causal=True, window=window),
            # window >= t: SDPA's causal mask is the same function
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            (2 * q.numel() + 2 * k.numel()) * 2,
            4 * b * hq * d * (t * (t + 1) // 2),
            f"q ({b}, {hq}, {t}, {d}), k/v ({b}, {hkv}, {t}, {d}) bf16, causal"
            + ("" if window is None else f", window {window}"),
            (FLASH_MARK,), lambda: FK.LAUNCHES["flash_attention"])

    flash("flash_attention", hq, hkv, d, 256)
    # T1's shape: the forward of a granite-8b training step
    flash("flash_attention/train", hq, hkv, d, TRAIN_SEQ_LEN, b=TRAIN_BATCH)
    for model, _ in FAMILIES:
        cfg = get_config(model)
        if not {"attn", "local"} & set(cfg.pattern):
            continue
        hq, hkv, d, live = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 144
        window = cfg.window if "local" in cfg.pattern else None
        q = _randn((1, hq, d), bf16, device, gen)
        k = _randn((1, hkv, 256, d), bf16, device, gen)
        v = _randn((1, hkv, 256, d), bf16, device, gen)
        kv_len = torch.full((1,), live, dtype=torch.int32, device=device)
        out[f"decode_attention/s3/{model}"] = _timing(
            lambda: DK.decode_attention(q, k, v, kv_len),
            lambda: decode_ref(q, k, v, kv_len),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], k[:, :, :live], v[:, :, :live],
                enable_gqa=True),
            2 * q.numel() * 2 + 2 * hkv * live * d * 2 + 4,
            4 * hq * live * d,
            f"q (1, {hq}, {d}), cache (1, {hkv}, 256, {d}) bf16, kv_len "
            f"{live}", (DECODE_MARK,),
            lambda: DK.LAUNCHES["decode_attention"])
        flash(f"flash_attention/s3/{model}", hq, hkv, d, 128, window)
    return out


# ---------------------------------------------------------------------------
# phase S2: granite-8b through the prefix-cache MQO engine
# ---------------------------------------------------------------------------
def serving_requests(cfg):
    """8 requests over 2 few-shot templates of 256 seeded random tokens;
    request i appends a distinct tail of 8 + i tokens and asks for 16
    new tokens.  Returns (requests, templates)."""
    import numpy as np

    from repro_torch.serving import GenerationRequest

    rng = np.random.default_rng(SERVE_SEED)
    templates = [rng.integers(0, cfg.vocab_size, 256) for _ in range(2)]
    tails = [rng.integers(0, cfg.vocab_size, 8 + i) for i in range(8)]
    return [GenerationRequest(i, np.concatenate(
        [templates[i % 2], tails[i]]).astype(np.int32), 16)
        for i in range(8)], templates


def cpu_decisions(cfg, requests, budget: int, block: int, k: int) -> dict:
    """The MQO decisions for ``requests``, computed on the CPU from the
    config alone: the SE count, the selected CEs and the bytes they
    hold."""
    from repro_torch.core import (build_covering_expressions,
                                  generate_knapsack_items, price_ces,
                                  solve_mckp)
    from repro_torch.serving.costs import ServingCostModel
    from repro_torch.serving.request import (identify_shared_prefixes,
                                             plan_requests)

    reqs = plan_requests(requests, block)
    ses = identify_shared_prefixes(reqs, k=k)
    ces = build_covering_expressions(ses)
    cm = ServingCostModel(cfg)
    price_ces(ces, cm)
    sol = solve_mckp(generate_knapsack_items(ces), budget)
    return dict(n_ses=len(ses), selected={ce.psi for ce in sol.ces},
                pool_used=sum(cm.state_bytes(ce.tree.n_tokens)
                              for ce in sol.ces))


def serve_model(tag: str, cfg, make_requests, device, smi: str, *,
                cut: str, block: int, max_len: int, profile: bool) -> dict:
    """Serve ``cfg`` (bf16, random weights from SERVE_SEED) three times
    on one engine (no MQO, MQO cold, MQO warm) over ``make_requests(cfg)``
    and run one ``Model.forward`` over the first template, with the
    attention kernels' launch counts set to 0 just before and read just
    after; then the checks: tokens bitwise equal across the runs,
    prefill tokens warm < cold < baseline, one ``decode_attention``
    launch per attention layer and decode step and one
    ``flash_attention`` launch per attention layer in the forward, MQO
    decisions equal the CPU's, finite logits, and the forward against
    the plain attention within FORWARD_RTOL of the largest logit; with
    ``profile``, a profiled window of 16 decode steps.  Log lines start
    with ``tag``.  Returns the launch counts; raises on any failed
    check."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as A
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models import ffn as FFN
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import _clone_state, _generate_scan

    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} is not a bf16 config")
    n_attn = sum(kind in ("attn", "local") for kind in cfg.layer_kinds())
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SERVE_SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers ({cut}), {n_attn} "
        f"attention layers, {n_params / 1e9:.3f} B parameters in bf16 on "
        f"the card ({2 * n_params / 1e9:.1f} GB), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(cfg, params, pool_budget_bytes=SERVE_BUDGET,
                        block_size=block, max_len=max_len, k=SERVE_K,
                        policy="lru")
    requests, templates = make_requests(cfg)
    tokens = torch.as_tensor(templates[0][None], device=device)
    runs = []
    # cuBLAS picks its algorithms deterministically under this flag (the
    # workspace is pinned by CUBLAS_WORKSPACE_CONFIG, set in main)
    torch.use_deterministic_algorithms(True)
    try:
        DK.reset_launches()
        FK.reset_launches()
        for label, mqo in (("no MQO", False), ("MQO cold", True),
                           ("MQO warm", True)):
            outs, rep = eng.run_batch(make_requests(cfg)[0], mqo=mqo)
            runs.append((label, outs, rep, set(eng.pool.keys())))
        # the forward's MoE routes, which the plain forward replays
        routes = []
        real_route = FFN.route
        FFN.route = lambda c, lg: routes.append(real_route(c, lg)) \
            or routes[-1]
        try:
            with torch.inference_mode():
                logits = forward(params, tokens, cfg)
        finally:
            FFN.route = real_route
        torch.cuda.synchronize()
        launches = {"decode_attention": DK.LAUNCHES["decode_attention"],
                    "flash_attention": FK.LAUNCHES["flash_attention"]}
    finally:
        torch.use_deterministic_algorithms(False)

    generated = sum(r.max_new_tokens for r in requests)
    for label, _, rep, _ in runs:
        log(f"{tag} {cfg.name} {label}: {rep.tokens_prefilled} prefill "
            f"tokens (baseline {rep.tokens_prefilled_baseline}), "
            f"{(rep.tokens_prefilled + generated) / rep.wall_seconds:.1f} "
            f"decode steps/s, {generated / rep.wall_seconds:.2f} generated "
            f"tokens/s, {rep.wall_seconds:.2f} s, SEs {rep.n_ses}, "
            f"selected {rep.n_selected}, pool {rep.pool_used} B [{smi}]")
    base = runs[0][1]
    for label, outs, _, _ in runs[1:]:
        if not all(np.array_equal(a, b) for a, b in zip(base, outs)):
            raise AssertionError(f"{tag} {cfg.name}: {label} generated "
                                 f"other tokens than the no-MQO run")
    prefilled = [rep.tokens_prefilled for _, _, rep, _ in runs]
    if not prefilled[2] < prefilled[1] < prefilled[0]:
        raise AssertionError(f"{tag} {cfg.name}: tokens prefilled not "
                             f"warm < cold < baseline: {prefilled}")
    steps = sum(p + generated for p in prefilled)
    if launches["decode_attention"] != n_attn * steps:
        raise AssertionError(
            f"{tag} {cfg.name}: decode_attention launched "
            f"{launches['decode_attention']} times, not {n_attn} attention "
            f"layers x {steps} decode steps: some attention did not go "
            f"through the kernel")
    if launches["flash_attention"] != n_attn:
        raise AssertionError(f"{tag} {cfg.name}: flash_attention launched "
                             f"{launches['flash_attention']} times in one "
                             f"forward, not {n_attn}")
    want = cpu_decisions(cfg, make_requests(cfg)[0], SERVE_BUDGET, block,
                         SERVE_K)
    for label, _, rep, resident in runs[1:]:
        got = dict(n_ses=rep.n_ses, selected=resident,
                   pool_used=rep.pool_used)
        if got != want or rep.n_selected != len(want["selected"]):
            raise AssertionError(f"{tag} {cfg.name} {label}: MQO decisions "
                                 f"differ from the CPU's: {rep.n_ses} vs "
                                 f"{want['n_ses']} SEs, {rep.pool_used} vs "
                                 f"{want['pool_used']} B")
    t = tokens.shape[1]
    if logits.shape != (1, t, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} {cfg.name}: forward logits not "
                             f"finite or misshapen")

    # one decode step on a copy of the longest resident prefix state:
    # finite logits; then, with ``profile``, where a step's time goes
    resident, n_res = max((eng.pool.get(psi) for psi in eng.pool.keys()),
                          key=lambda state: state[1])
    first = tokens[:, n_res - 1:n_res]
    with torch.inference_mode():
        step_logits, _ = decode_step(params, _clone_state(resident), first,
                                     n_res, cfg)
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError(f"{tag} {cfg.name}: decode logits not finite")
    if profile:
        n_prof = 16
        prof = device_time(lambda: _generate_scan(
            params, _clone_state(resident), first, n_res, cfg, n_prof),
            device, mark=DECODE_MARK)
        if prof["busy"] is None:
            log(f"{tag} {cfg.name} decode, profiled: device time not "
                f"measured (the profiler saw no device activity)")
        else:
            at, an = prof["filter"]
            top = "; ".join(f"{key[:40]} {dt * 1e3:.2f} ms x{n}"
                            for key, dt, n in prof["top"])
            log(f"{tag} {cfg.name} decode, profiled, {n_prof} steps after "
                f"a {n_res}-token prefix: wall "
                f"{prof['wall'] / n_prof * 1e3:.2f} ms a step, device busy "
                f"{prof['busy'] / n_prof * 1e3:.2f} ms a step (idle share "
                f"{1 - prof['busy'] / prof['wall']:.3f}), "
                f"{prof['n_events'] / n_prof:.0f} device events a step; "
                f"{DECODE_MARK} {at * 1e3:.3f} ms x{an} "
                f"({at / prof['busy']:.3f} of busy); top device events: "
                f"{top} [{smi}]")

    if n_attn:
        # A bf16 ulp of an attention output can flip a token's top-k
        # experts (and so which tokens a full expert drops), which moves
        # its logits by their whole size: the plain forward replays the
        # kernel forward's routes, so that the comparison sees the
        # attention alone, and counts the routes it would have chosen
        # otherwise.
        real, replay, flips = A.attention, iter(routes), [0, 0]

        def replayed(c, lg):
            mine, kept = real_route(c, lg), next(replay)
            flips[0] += int((mine.top_idx != kept.top_idx).any(-1).sum())
            flips[1] += mine.top_idx.shape[0]
            return kept

        A.attention = lambda q, k, v, causal, window, scale, impl: mha_ref(
            q, k, v, causal=causal, window=window, sm_scale=scale)
        FFN.route = replayed
        try:
            with torch.inference_mode():
                plain = forward(params, tokens, cfg)
        finally:
            A.attention, FFN.route = real, real_route
        err = float((logits.float() - plain.float()).abs().max())
        top = float(plain.float().abs().max())
        agree = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
        moe = (f"; MoE routes replayed from the kernel forward ({flips[0]} "
               f"of {flips[1]} token routes would differ)" if routes
               else "")
        log(f"{tag} {cfg.name} forward: {t}-token template, flash_attention "
            f"launched {launches['flash_attention']} times; logits vs plain "
            f"attention max |diff| {err:.4g} of max |logit| {top:.4g} "
            f"(limit {FORWARD_RTOL}), argmax agrees at {agree:.4f} of "
            f"positions{moe}")
        if not err <= FORWARD_RTOL * top:
            raise AssertionError(f"{tag} {cfg.name}: forward with the "
                                 f"flash kernel differs from the plain "
                                 f"attention")
    log(f"{tag} {cfg.name}: generations bitwise equal across no-MQO / MQO "
        f"cold / MQO warm; MQO decisions equal the CPU's ({want['n_ses']} "
        f"SEs, {len(want['selected'])} selected, {want['pool_used']} B); "
        f"decode_attention launched {launches['decode_attention']} times "
        f"= {n_attn} x {steps} decode steps"
        + ("" if "mla" in cfg.pattern else
           ", no attention outside the kernels"))
    del eng, params, resident
    # the engine's objects refer to each other: collect them now, so that
    # the card's memory is free for the next phase
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serving_path(device, smi: str) -> dict:
    """Phase S2: granite-8b, all 36 layers, through :func:`serve_model`
    with the profiled window; returns the launch counts."""
    from repro_torch.configs import get_config

    cfg = replace(get_config("granite-8b"), attn_impl="pallas")
    if cfg.n_layers != GRANITE_LAYERS:
        raise AssertionError("granite-8b is not the 36-layer config")
    return serve_model("serving", cfg, serving_requests, device, smi,
                       cut="all layers", block=64, max_len=1024,
                       profile=True)


# ---------------------------------------------------------------------------
# phase S3: the Mamba, RG-LRU, MoE and MLA families
# ---------------------------------------------------------------------------
# (config, layers served; None = all of them).  Depth is the only cut,
# and only for the two MoE models, whose whole stacks do not fit one
# card (215.5 GB and 453.5 GB of bf16 parameters): llama4-scout keeps 6
# of its 48 layers, deepseek-v2 4 of its 60 (its dense first layer and 3
# MoE layers).  Widths are the published ones.
FAMILIES = (("falcon-mamba-7b", None), ("recurrentgemma-9b", None),
            ("llama4-scout-17b-a16e", 6), ("deepseek-v2-236b", 4))
PROFILED_FAMILIES = ("falcon-mamba-7b", "llama4-scout-17b-a16e")
# The -smoke configs in f32, on the card against the CPU from the same
# parameters: cuBLAS and the CPU's BLAS, and the kernels and the plain
# attention, sum in other orders; 1e-3 is the tolerance the CPU tests
# hold the port to against the JAX package.
FAMILY_ATOL = 1e-3
FAMILY_DECODE_STEPS = 40


def family_requests(cfg):
    """4 requests over one template of 128 seeded random tokens; request
    i appends a tail of 4 + i tokens and asks for 8 new tokens.  Returns
    (requests, [template])."""
    import numpy as np

    from repro_torch.serving import GenerationRequest

    rng = np.random.default_rng(SERVE_SEED)
    template = rng.integers(0, cfg.vocab_size, 128)
    tails = [rng.integers(0, cfg.vocab_size, 4 + i) for i in range(4)]
    return [GenerationRequest(i, np.concatenate(
        [template, tails[i]]).astype(np.int32), 8) for i in range(4)], \
        [template]


def family_parity(device) -> dict:
    """Phase S3a: each family's -smoke config (f32) on the card against
    the same port on the CPU, from the same parameters: the forward
    logits at the config's capacity factor, and, dropless (a token's
    route must not depend on the other token of its decode batch), the
    forward and FAMILY_DECODE_STEPS decode steps of a batch of 2, card
    against CPU and the card's decode against its forward.  Returns the
    worst error of each comparison per config; raises above
    FAMILY_ATOL."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models.decoder import init_cache

    cpu = torch.device("cpu")
    out = {}
    for name, _ in FAMILIES:
        base = replace(get_config(name + "-smoke"), attn_impl="pallas")
        dropless = replace(base, capacity_factor=float(max(
            base.n_experts, 1)))
        p_cpu = init_params(base, SERVE_SEED, cpu)
        p_card = init_params(base, SERVE_SEED, cpu).to(device)
        toks = torch.from_numpy(np.random.default_rng(SERVE_SEED).integers(
            0, base.vocab_size, (2, FAMILY_DECODE_STEPS)))
        errs = {}
        with torch.inference_mode():
            for label, cfg in (("forward", base),
                               ("forward dropless", dropless)):
                want = forward(p_cpu, toks, cfg)
                got = forward(p_card, toks.to(device), cfg)
                errs[label] = float((got.cpu() - want).abs().max())
            full = got
            c_cpu = init_cache(dropless, 2, FAMILY_DECODE_STEPS, device=cpu)
            c_card = init_cache(dropless, 2, FAMILY_DECODE_STEPS,
                                device=device)
            dec, vs_fwd = 0.0, 0.0
            for t in range(FAMILY_DECODE_STEPS):
                a, c_cpu = decode_step(p_cpu, c_cpu, toks[:, t:t + 1], t,
                                       dropless)
                b, c_card = decode_step(p_card, c_card,
                                        toks[:, t:t + 1].to(device), t,
                                        dropless)
                dec = max(dec, float((b.cpu() - a).abs().max()))
                vs_fwd = max(vs_fwd, float((b - full[:, t]).abs().max()))
        torch.cuda.synchronize()
        errs["decode"], errs["decode vs forward"] = dec, vs_fwd
        if not all(np.isfinite(e) and e <= FAMILY_ATOL
                   for e in errs.values()):
            raise AssertionError(f"S3a {name}-smoke: card vs CPU {errs} "
                                 f"(limit {FAMILY_ATOL})")
        out[name] = errs
        del p_cpu, p_card
    return out


def serve_family(name: str, layers, device, smi: str) -> dict:
    """Phase S3b for one family at full width, bf16, cut to ``layers``
    layers (None: all), through :func:`serve_model`; returns the launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_specs
    from repro_torch.models.common import map_specs

    full = replace(get_config(name), attn_impl="pallas")
    cfg = full if layers is None else replace(full, n_layers=layers)
    whole = []
    map_specs(model_specs(full), lambda spec: whole.append(
        math.prod(spec.shape)))
    cut = ("all layers" if layers is None else
           f"{layers} of {full.n_layers} layers, depth cut to fit one card; "
           f"the whole model holds {sum(whole) / 1e9:.3f} B parameters, "
           f"{2 * sum(whole) / 1e9:.1f} GB in bf16")
    return serve_model("S3b", cfg, family_requests, device, smi, cut=cut,
                       block=32, max_len=256,
                       profile=name in PROFILED_FAMILIES)


def family_phases(cuda, smi: str) -> dict:
    """Phases S3a and S3b; returns the attention kernels' launches of
    S3b, summed over the families."""
    t0 = time.perf_counter()
    for name, errs in family_parity(cuda).items():
        log(f"S3a {name}-smoke, f32, card vs CPU: " + ", ".join(
            f"{k} max |diff| {v:.3g}" for k, v in errs.items())
            + f" (limit {FAMILY_ATOL})")
    log(f"S3a: {time.perf_counter() - t0:.1f} s")
    total = {"decode_attention": 0, "flash_attention": 0}
    for name, layers in FAMILIES:
        t1 = time.perf_counter()
        launches = serve_family(name, layers, cuda, smi)
        for key, n in launches.items():
            total[key] += n
        log(f"S3b {name}: {time.perf_counter() - t1:.1f} s")
    log(f"S3: {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phases T0-T2: training
# ---------------------------------------------------------------------------
# T0's sweep: (query heads, KV heads, head dim) for GQA groups 1, 4, 5 and
# 16 at head dims 128 and 256, each over T = S = 1024 causal, gemma3's
# window of 512, and for the group-16 head-dim-256 shape (recurrentgemma's
# local layers) its window of 2048 over T = S = 2304.
TRAIN_ATTN_HEADS = ((8, 8, 128), (32, 8, 128), (40, 8, 128), (8, 2, 256),
                    (16, 1, 256))
TRAIN_LAYERS = 8                      # of granite-8b's 36
TRAIN_SEQ_LEN, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 8
# T0's bf16 forwards per row: max |kernel - plain| over a row's D outputs
# over the row's largest |plain|.  Both round f32 sums of the same
# products once to bf16, so they part by at most one ulp of an element,
# and a bf16 ulp is at most 2^-7 of the element; the limit is two ulps
# of the row's largest.  An absolute limit cannot see a lost key tile at
# T1's shape, where a row over 4096 keys is about 0.026 in size (ATTN_ATOL
# is 3e-2); per row, the control below (one 64-key tile, the kernel's,
# left out of the plain version) must fail this limit.
ROW_RTOL_BF16 = 2.0 ** -6
CONTROL_TILE = (2048, 2048 + 64)      # the key tile the control leaves out
# T1's step 1 with the flash kernel against the same step with the plain
# attention, both bf16 on the card.  The two attentions' bf16 outputs
# part by about one ulp per element, and 8 layers carry that on; on an
# H100 the loss has read 1.6e-5 apart relative, the gradient norm 9.5e-5
# and the worst leaf's gradient 0.025 (L2, relative; PERF.md), and the
# limits are about ten times those.  At random init the loss sits near
# ln(vocab) whatever the attention does, so the limits are held to a
# control: the same step with the kernel's forward run without the
# causal mask (the backward still the causal recompute) must fail them.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_RTOL = 2e-4, 1e-3, 0.25


def kernel_class(name: str) -> str:
    """The class of a device kernel of a train step, by its name:
    the flash kernel, f32 and bf16 matrix products (cuBLAS / CUTLASS),
    elementwise kernels, reductions, copies, the rest."""
    low = name.lower()
    if FLASH_MARK in name:
        return "flash_attention"
    if any(m in low for m in ("gemm", "nvjet", "xmma", "cutlass")):
        return "f32 GEMM" if ("f32f32" in low or "sgemm" in low) \
            else "bf16 GEMM"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduction"
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copy"
    return "other"


def row_error(got, want) -> float:
    """The largest over rows of max |got - want| over the row's largest
    |want| (the last dim is a row)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1).clamp_min(1e-30)).max())


def plain_without_keys(q, k, v, lo: int, hi: int):
    """Causal attention through the plain formula with keys [lo, hi) left
    out of every row: what a forward that skipped that key tile gives.
    T0's control."""
    import torch

    group = q.shape[1] // k.shape[1]
    k, v = (x.repeat_interleave(group, 1).float() for x in (k, v))
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k) \
        / q.shape[-1] ** 0.5
    i = torch.arange(q.shape[2], device=q.device)
    keep = (i[:, None] >= i[None, :]) & ((i < lo) | (i >= hi))[None, :]
    probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
    return torch.einsum("bhts,bhsd->bhtd", probs, v).to(q.dtype)


def train_attention_grads(device) -> dict:
    """Phase T0: ``ops.attention`` (the autograd Function whose forward
    launches ``flash_attention`` and whose backward recomputes through
    ``mha_ref``) against autograd through ``mha_ref`` on the same
    inputs, bf16 and f32, over :data:`TRAIN_ATTN_HEADS` and their masks
    and at T1's shape: the forward within ATTN_ATOL, in bf16 also within
    ROW_RTOL_BF16 of each row's scale, dq, dk, dv bitwise equal.  At
    T1's shape in bf16 the control, the plain version without one key
    tile, must fail the row limit.  Returns the case count, the worst
    forward errors and the control's; raises on a failed case."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import mha_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    worst, worst_row, control = {}, 0.0, None
    cases = 0
    shapes = [(1, hq, hkv, d, t, window) for hq, hkv, d in TRAIN_ATTN_HEADS
              for t, window in ((1024, None), (1024, 512))
              + (((2304, 2048),) if hkv == 1 else ())]
    shapes.append((TRAIN_BATCH, 32, 8, 128, TRAIN_SEQ_LEN, None))
    for dtype in (torch.bfloat16, torch.float32):
        for b, hq, hkv, d, t, window in shapes:
            q = _randn((b, hq, t, d), dtype, device, gen)
            k, v = (_randn((b, hkv, t, d), dtype, device, gen)
                    for _ in range(2))
            g = _randn((b, hq, t, d), dtype, device, gen)
            grads, outs = [], []
            before = FK.LAUNCHES["flash_attention"]
            for fn in (lambda *x: attention(*x, True, window, None,
                                            "pallas"),
                       lambda *x: mha_ref(*x, causal=True,
                                          window=window)):
                xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out = fn(*xs)
                out.backward(g)
                outs.append(out.detach())
                grads.append([x.grad for x in xs])
            torch.cuda.synchronize()
            what = (f"{dtype}, q ({b}, {hq}, {t}, {d}), k/v ({b}, "
                    f"{hkv}, {t}, {d}), window {window}")
            if FK.LAUNCHES["flash_attention"] - before != 1:
                raise AssertionError(f"T0 {what}: the forward did not "
                                     f"launch flash_attention once")
            err = float((outs[0].float() - outs[1].float()).abs().max())
            if not err <= ATTN_ATOL[str(dtype)]:
                raise AssertionError(f"T0 {what}: forward error {err}")
            if dtype == torch.bfloat16:
                row = row_error(outs[0], outs[1])
                if not row <= ROW_RTOL_BF16:
                    raise AssertionError(f"T0 {what}: forward error "
                                         f"{row} of a row's scale")
                worst_row = max(worst_row, row)
                if t == TRAIN_SEQ_LEN:
                    wrong = plain_without_keys(q, k, v, *CONTROL_TILE)
                    control = (row_error(wrong, outs[1]), float(
                        (wrong.float() - outs[1].float()).abs().max()))
                    del wrong
                    if control[0] <= ROW_RTOL_BF16:
                        raise AssertionError(
                            f"T0 {what}: the control without keys "
                            f"{CONTROL_TILE} passes the row limit "
                            f"({control[0]})")
            for name, x, y in zip("qkv", *grads):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"T0 {what}: d{name} differs from autograd "
                        f"through mha_ref by "
                        f"{float((x.float() - y.float()).abs().max())}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
            cases += 1
            del q, k, v, g, grads, outs
    return {"cases": cases, "worst": worst, "worst_row": worst_row,
            "control": control}


def train_granite(device, smi: str) -> dict:
    """Phase T1: granite-8b at full width, TRAIN_LAYERS of its 36
    layers, bf16 compute over f32 masters with AdamW and block remat,
    ``DataConfig(seq_len=4096, global_batch=2, seed=0)``:
    ``TRAIN_STEPS`` steps through ``train(...)``.  Checks: step 1's
    gradient of every leaf finite and non-zero, and two
    ``flash_attention`` launches a layer (forward and remat recompute)
    in that step and in every step of the run; step 1's loss and
    gradient norm against the same step with the plain attention; a
    finite loss at every step.  Logs the step seconds, tokens/s, model
    FLOP/s share, peak memory and one profiled step.  Returns the launch
    counts of the ``train(...)`` run."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import _Attention
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as A
    from repro_torch.models import init_params
    from repro_torch.models.common import named_leaves
    from repro_torch.train.optimizer import OptConfig, global_norm
    from repro_torch.train.train_step import make_train_step, value_and_grad
    from repro_torch.train.trainer import TrainerConfig, to_device, train

    full = get_config("granite-8b")
    cfg = replace(full, n_layers=TRAIN_LAYERS, attn_impl="pallas")
    if cfg.remat != "block" or cfg.dtype != "bfloat16":
        raise AssertionError("granite-8b is not a bf16 config with block "
                             "remat")
    n_params = cfg.param_count()[0]
    n_matmul = n_params - cfg.vocab_size * cfg.d_model   # all but the lookup
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ_LEN,
                          global_batch=TRAIN_BATCH, seed=0)
    opt_cfg = OptConfig()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    masters = init_params(cfg, 0, device, masters=True)
    torch.cuda.synchronize()
    log(f"T1 granite-8b: {TRAIN_LAYERS} of {full.n_layers} layers (depth "
        f"cut to fit one card: the whole model's f32 masters, gradients, m "
        f"and v take {16 * full.param_count()[0] / 1e9:.1f} GB), full "
        f"width, {n_params:,} parameters as f32 masters "
        f"({4 * n_params / 1e9:.2f} GB), bf16 compute, block remat, AdamW; "
        f"seq_len {TRAIN_SEQ_LEN} x batch {TRAIN_BATCH}; initialised in "
        f"{time.perf_counter() - t0:.1f} s ({held / 1e9:.2f} GB held "
        f"before)")

    want_launches = 2 * TRAIN_LAYERS
    batch = to_device(make_batch(data_cfg, 0), device)
    FK.reset_launches()
    loss, grads = value_and_grad(masters, batch, cfg)
    torch.cuda.synchronize()
    launched = FK.LAUNCHES["flash_attention"]
    bad = [k for k, g in named_leaves(grads)
           if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    gnorm = float(global_norm(grads))
    n_leaves = len(named_leaves(grads))
    if bad:
        raise AssertionError(f"T1: {len(bad)} of {n_leaves} parameter leaves "
                             f"got a zero or non-finite gradient: {bad[:8]}")
    if launched != want_launches:
        raise AssertionError(f"T1: one forward + backward launched "
                             f"flash_attention {launched} times, not "
                             f"{want_launches} (forward and remat recompute "
                             f"of {TRAIN_LAYERS} layers)")

    class Unmasked(_Attention):
        """The control: the kernel's forward without the causal mask,
        the causal recompute backward."""

        @staticmethod
        def forward(ctx, q, k, v, causal, window, sm_scale, impl):
            ctx.save_for_backward(q, k, v)
            ctx.mask = (causal, window, sm_scale)
            return FK.flash_attention(q, k, v, causal=False, window=window,
                                      sm_scale=sm_scale)

    def step_one(attention):
        real = A.attention
        A.attention = attention
        try:
            loss, grads = value_and_grad(masters, batch, cfg)
        finally:
            A.attention = real
        return float(loss), float(global_norm(grads)), grads

    def leaf_error(got, want):
        """The largest over leaves of |got - want| / |want| (L2)."""
        want = dict(named_leaves(want))
        return max(float(torch.linalg.vector_norm(g - want[key])
                         / torch.linalg.vector_norm(want[key]))
                   for key, g in named_leaves(got))

    plain_loss, plain_gnorm, plain_grads = step_one(
        lambda q, k, v, causal, window, scale, impl: mha_ref(
            q, k, v, causal=causal, window=window, sm_scale=scale))
    leaf = leaf_error(grads, plain_grads)
    del grads
    c_loss, c_gnorm, c_grads = step_one(Unmasked.apply)
    c_leaf = leaf_error(c_grads, plain_grads)
    del c_grads, plain_grads

    def within(loss_, gnorm_, leaf_=0.0) -> bool:
        return (abs(loss_ - plain_loss) <= TRAIN_LOSS_RTOL * plain_loss
                and abs(gnorm_ - plain_gnorm)
                <= TRAIN_GNORM_RTOL * plain_gnorm
                and leaf_ <= TRAIN_LEAF_RTOL)

    log(f"T1 step 1: every one of {n_leaves} leaves has a finite, non-zero "
        f"gradient; flash_attention launched {launched} times (forward and "
        f"remat recompute of {TRAIN_LAYERS} layers); loss {float(loss):.6f} "
        f"(plain attention {plain_loss:.6f}), grad norm {gnorm:.6g} (plain "
        f"{plain_gnorm:.6g}), worst leaf's gradient {leaf:.4g} from the "
        f"plain's (L2; limits {TRAIN_LOSS_RTOL} / {TRAIN_GNORM_RTOL} / "
        f"{TRAIN_LEAF_RTOL} relative); control, the forward without the "
        f"causal mask: loss {c_loss:.6f}, grad norm {c_gnorm:.6g}, worst "
        f"leaf {c_leaf:.4g}")
    if not within(float(loss), gnorm, leaf) \
            or within(c_loss, c_gnorm, c_leaf):
        raise AssertionError(
            f"T1: step 1 with the flash kernel (loss {float(loss)}, grad "
            f"norm {gnorm}, worst leaf {leaf}) or the control (loss "
            f"{c_loss}, grad norm {c_gnorm}, worst leaf {c_leaf}) against "
            f"the plain attention (loss {plain_loss}, grad norm "
            f"{plain_gnorm}): the kernel must be within {TRAIN_LOSS_RTOL} / "
            f"{TRAIN_GNORM_RTOL} / {TRAIN_LEAF_RTOL} relative, the control "
            f"not")
    del batch
    torch.cuda.empty_cache()

    FK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS,
                             ckpt_every=TRAIN_STEPS + 1, ckpt_dir=ckpt_dir,
                             log_every=1)
        t0 = time.perf_counter()
        result = train(cfg, data_cfg, opt_cfg, tcfg, params=masters,
                       device=device)
        seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": FK.LAUNCHES["flash_attention"]}
    log_ = result.metrics_log
    losses = [m["loss"] for m in log_]
    if [m["step"] for m in log_] != list(range(TRAIN_STEPS)) \
            or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"T1: losses not finite at every step: {log_}")
    if launches["flash_attention"] != want_launches * TRAIN_STEPS:
        raise AssertionError(
            f"T1: train(...) launched flash_attention "
            f"{launches['flash_attention']} times in {TRAIN_STEPS} steps, not "
            f"{want_launches} a step")
    first = log_[0]
    if not within(first["loss"], first["grad_norm"]):
        raise AssertionError(
            f"T1: step 1 with the flash kernel (loss {first['loss']}, grad "
            f"norm {first['grad_norm']}) differs from the plain attention "
            f"(loss {plain_loss}, grad norm {plain_gnorm}) beyond "
            f"{TRAIN_LOSS_RTOL} / {TRAIN_GNORM_RTOL}")
    tokens = TRAIN_SEQ_LEN * TRAIN_BATCH
    step_s = statistics.median(m["step_seconds"] for m in log_[1:])
    flops = 6 * n_matmul * tokens
    log(f"T1 train(...): {TRAIN_STEPS} steps in {seconds:.1f} s; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; step 1 vs plain attention: loss {first['loss']:.6f} / "
        f"{plain_loss:.6f} (limit {TRAIN_LOSS_RTOL} relative), grad norm "
        f"{first['grad_norm']:.6g} / {plain_gnorm:.6g} (limit "
        f"{TRAIN_GNORM_RTOL}); flash_attention launched "
        f"{launches['flash_attention']} times = {want_launches} x "
        f"{TRAIN_STEPS} steps [{smi}]")
    log(f"T1 step seconds (median of steps 2-{TRAIN_STEPS}) {step_s:.4f} "
        f"(each: " + ", ".join(f"{m['step_seconds']:.4f}" for m in log_)
        + f"); {tokens / step_s:.1f} tokens/s; model FLOP/s share "
        f"{flops / step_s / BF16_OPS_PER_S:.4f} (6 x {n_matmul:,} "
        f"non-embedding parameters x {tokens} tokens = {flops / 1e12:.2f} "
        f"TFLOP a step, over 989 TFLOP/s bf16); peak memory "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated) [{smi}]")

    step_fn = make_train_step(cfg, opt_cfg)
    params, opt_state = result.params, result.opt_state
    batch = to_device(make_batch(data_cfg, TRAIN_STEPS), device)
    prof = device_time(lambda: step_fn(params, opt_state, batch), device,
                       mark=FLASH_MARK)
    if prof["busy"] is None:
        log("T1 one profiled step: device time not measured (the profiler "
            "saw no device activity)")
    else:
        at, an = prof["filter"]
        top = "; ".join(f"{key[:60]} {dt * 1e3:.2f} ms x{n}"
                        for key, dt, n in prof["top"])
        classes = {}
        for key, dt, n in prof["events"]:
            c = classes.setdefault(kernel_class(key), [0.0, 0])
            c[0] += dt
            c[1] += n
        split = "; ".join(
            f"{c} {dt * 1e3:.1f} ms x{n}" for c, (dt, n) in
            sorted(classes.items(), key=lambda kv: -kv[1][0]))
        log(f"T1 one profiled step: wall {prof['wall'] * 1e3:.1f} ms, device "
            f"busy {prof['busy'] * 1e3:.1f} ms (idle share "
            f"{1 - prof['busy'] / prof['wall']:.3f}), {prof['n_events']} "
            f"device events; {FLASH_MARK} {at * 1e3:.3f} ms x{an}; by "
            f"class: {split}; top device events: {top} [{smi}]")
    del masters, params, opt_state, result, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def train_fault_tolerance(device) -> list:
    """Phase T2: ``tests/test_train_ckpt.py``'s fault-tolerance tests on
    the card at gemma3-1b-smoke (f32): a 12-step run and an 8-step run
    preempted, then resumed, give bitwise-equal parameters and optimizer
    state; 60 steps at vocab 128 lower the loss by more than 0.3.  The
    resume needs every kernel of the step to be deterministic: this
    phase runs under ``torch.use_deterministic_algorithms(True)``
    (cuBLAS's workspace pinned by CUBLAS_WORKSPACE_CONFIG, set in main),
    which makes the embedding lookup's and the loss's gather backward
    accumulate in a fixed order; the flash kernel is deterministic by
    construction (S1 checks two calls bitwise).  Returns what was
    checked; raises on a failed check."""
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.common import named_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import (PreemptionError, TrainerConfig,
                                           train)

    cfg = replace(get_config("gemma3-1b-smoke"), attn_impl="pallas")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=12)
    done = []
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
            def tcfg(name, steps=12, fail=None):
                return TrainerConfig(total_steps=steps, ckpt_every=4,
                                     ckpt_dir=os.path.join(root, name),
                                     log_every=2, fail_after_step=fail)

            full = train(cfg, data, opt, tcfg("a"), device=device)
            try:
                train(cfg, data, opt, tcfg("b", fail=8), device=device)
                raise AssertionError("T2: the injected preemption did not "
                                     "happen")
            except PreemptionError:
                pass
            resumed = train(cfg, data, opt, tcfg("b"), device=device)
            if resumed.resumed_from != 8:
                raise AssertionError(f"T2: resumed from "
                                     f"{resumed.resumed_from}, not 8")
            pairs = [(k, a, b) for tree in ("params", "m", "v")
                     for (k, a), (_, b) in zip(
                         named_leaves(full.params if tree == "params"
                                      else full.opt_state[tree]),
                         named_leaves(resumed.params if tree == "params"
                                      else resumed.opt_state[tree]))]
            differ = [f"{k} ({float((a - b).abs().max()):.3g})"
                      for k, a, b in pairs if not torch.equal(a, b)]
            if differ:
                raise AssertionError(f"T2: the resumed run differs from the "
                                     f"uninterrupted one at {differ[:6]}")
            done.append(f"12 steps = 8 steps, preempted, resumed from 8: "
                        f"{len(pairs)} tensors bitwise equal")

            small = replace(cfg, vocab_size=128)
            r = train(small, DataConfig(vocab_size=64, seq_len=32,
                                        global_batch=4),
                      OptConfig(peak_lr=5e-3, warmup_steps=5,
                                decay_steps=60),
                      TrainerConfig(total_steps=60, ckpt_every=1000,
                                    ckpt_dir=os.path.join(root, "c"),
                                    log_every=5), device=device)
            first = r.metrics_log[0]["loss"]
            last = min(m["loss"] for m in r.metrics_log[-3:])
            if not last < first - 0.3:
                raise AssertionError(f"T2: 60 steps took the loss from "
                                     f"{first} to {last}, not below "
                                     f"{first - 0.3}")
            done.append(f"60 steps at vocab 128: loss {first:.4f} -> "
                        f"{last:.4f}")
    finally:
        torch.use_deterministic_algorithms(False)
    return done


def training_phases(cuda, smi: str) -> dict:
    """Phases T0-T2; returns the launch counts of T1's ``train(...)``
    run, the training path."""
    import torch

    t0 = time.perf_counter()
    # cuBLAS picks its algorithms deterministically under this flag
    torch.use_deterministic_algorithms(True)
    try:
        sweep = train_attention_grads(cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"T0 flash_attention autograd Function vs autograd through "
        f"mha_ref: {sweep['cases']} cases, dq, dk, dv bitwise equal; "
        f"forward max |err| " + ", ".join(
            f"{k} {v:.3g}" for k, v in sweep["worst"].items())
        + f" (limits {ATTN_ATOL}); bf16 per row {sweep['worst_row']:.4g} of "
        f"the row's scale (limit {ROW_RTOL_BF16}); control at T1's shape "
        f"without keys {CONTROL_TILE}: {sweep['control'][0]:.4g} of a row's "
        f"scale (fails the limit), max |err| {sweep['control'][1]:.4g}; "
        f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    launches = train_granite(cuda, smi)
    log(f"T1: {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    for line in train_fault_tolerance(cuda):
        log(f"T2 gemma3-1b-smoke on the card: {line}")
    log(f"T2: {time.perf_counter() - t2:.1f} s; T0-T2: "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def relational_phases(cuda, smi: str, main_path_too: bool = True,
                      async_too: bool = True, checks: bool = True) -> list:
    """Phases 3-5 (``main_path_too``: the filter kernels, the TPC-DS
    stream and the literal route), the CSV decoders against their plain
    versions and their times, and phases A0 and A (``async_too``);
    returns the kernels' JSON entries.  Without ``checks`` only the
    kernels' timings run (``--only timings``)."""
    from repro_torch.kernels.filter_project import kernel as K

    timings = {}
    if main_path_too:
        if checks:
            checked = kernel_sweep(cuda)
            log(f"kernels vs plain versions: bitwise equal over "
                f"{checked['filter_scan']} literal and "
                f"{checked['filter_scan_batch']} slotted programs "
                f"({checked['variants']} compiled variants)")
        timings.update(kernel_timings(cuda))
    if checks:
        log(f"CSV decoder vs plain versions: parse_i32, parse_f32 and "
            f"parse_fields bitwise equal on the card and on the CPU over "
            f"{parse_sweep(cuda)} cases")
    timings.update(parse_timings(cuda))
    for name, t in timings.items():
        extra = ""
        if "sector_floor_ms" in t:
            extra = (f", sector floor {t['sector_floor_ms']:.4f} ms "
                     f"(64-byte blocks {t['floor64_ms']:.4f} ms), "
                     f"{t['launches_per_call']} launches a call")
        log(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms (profiler "
            f"device time {fmt_ms(t['device_ms'])}), plain "
            f"{fmt_ms(t['plain_ms'])}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}){extra} [{smi}]")

    launches = {}
    host_csv = None
    if main_path_too and checks:
        stats = main_path(K, cuda)
        launches["main"], host_csv = stats["launches"], stats["host_csv"]
        launches["literal-route"] = literal_route(K, stats["reference"],
                                                  cuda)
        log(f"literal route: filter_scan launched "
            f"{launches['literal-route']['filter_scan']} times, results "
            f"equal the main path's")
        del stats
    if async_too and checks:
        launches["async"] = async_phases(cuda, smi,
                                         host_csv or host_csv_passes())
    # Rows 3 and 3b of the kernel table are one device kernel: one entry,
    # timed at the F1 scan's three fields (the multi-field shape the CSV
    # scans launch) and counting the launches of parse_fields, which the
    # scans call; the one-field forms and the other shapes are its
    # sub-entries.  The computed sector floors stay in the log.
    kernels = []
    for name, path, src, line, counted, main, subs in (
            ("filter_scan_batch", "main", FILTER_SCAN_CU,
             "src/repro/kernels/filter_project/kernel.py:122",
             "filter_scan_batch", "filter_scan_batch", ("nq64",)),
            ("filter_scan", "literal-route", FILTER_SCAN_CU,
             "src/repro/kernels/filter_project/kernel.py:57",
             "filter_scan", "filter_scan", ()),
            ("parse_i32", "async", CSV_PARSE_CU,
             "src/repro/kernels/filter_project/kernel.py:179",
             "parse_fields", "parse_fields/f1",
             ("parse_i32", "parse_i32/staged", "parse_f32",
              "parse_f32/staged", "parse_fields/f1/per-field",
              "parse_fields/all10", "parse_fields/all10/per-field"))):
        if main not in timings:
            continue
        t = timings[main]
        entry = dict(
            name=name, route="cuda", source=src, replaces=line,
            kernel=("parse_fields_kernel" if counted == "parse_fields"
                    else "filter_scan_kernel"),
            launches=launches.get(path, {}).get(counted, 0), path=path,
            launches_by_path={p: c.get(counted, 0)
                              for p, c in launches.items()},
            max_abs_err=t["max_abs_err"], ms=t["ms"],
            device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None, shape=t["shape"])
        if counted == "parse_fields":
            # row 3b: the JAX package decodes f32 fields with XLA
            entry["also_replaces"] = "src/repro/relational/physical.py:289"
        for sub in subs:
            key = f"{name}/{sub}" if f"{name}/{sub}" in timings else sub
            entry[sub.replace("parse_fields/", "").replace("/", "_")
                  .replace("-", "_")] = {
                k: v for k, v in timings[key].items()
                if k not in ("sector_floor_ms", "floor64_ms")}
        kernels.append(entry)
    return kernels


def attention_phases(cuda, smi: str, serve: bool, families: bool,
                     training: bool) -> list:
    """Phases S1, S2 when ``serve``, S3 when ``families`` and T0-T2 when
    ``training``: the attention kernels against their plain versions,
    their times, and the serving and training paths; returns the
    kernels' JSON entries, whose ``launches`` sum the launches of the
    paths that ran."""
    sweep = attention_sweep(cuda)
    log(f"attention kernels vs plain versions: decode_attention "
        f"{sweep['cases']['decode_attention']} cases, max |err| "
        f"{sweep['worst']['decode_attention']:.3g}; flash_attention "
        f"{sweep['cases']['flash_attention']} cases, max |err| "
        f"{sweep['worst']['flash_attention']:.3g} (limits f32 "
        f"{ATTN_ATOL['torch.float32']}, bf16 "
        f"{ATTN_ATOL['torch.bfloat16']})")
    for line in attention_bitwise(cuda):
        log(f"bitwise: {line}")
    timings = attention_timings(cuda)
    for name, t in timings.items():
        log(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms (profiler "
            f"device time {fmt_ms(t['device_ms'])}, one device kernel a "
            f"call; in a CUDA graph {t['graph_ms']:.4f} ms), plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms "
            f"(device time {fmt_ms(t['library_device_ms'])}; in a CUDA "
            f"graph {t['library_graph_ms']:.4f} ms), bound "
            f"{t['bound_ms']:.3g} ms ({t['bound_by']}) [{smi}]")
    by_path = {}
    if serve:
        by_path["serving"] = serving_path(cuda, smi)
    if families:
        by_path["families"] = family_phases(cuda, smi)
    if training:
        by_path["training"] = training_phases(cuda, smi)
    kernels = []
    for name, key, src, line in (
            ("decode_attention", "decode_attention/kv128", DECODE_CU,
             "src/repro/kernels/decode_attention/kernel.py:78"),
            ("flash_attention", "flash_attention", FLASH_CU,
             "src/repro/kernels/flash_attention/kernel.py:90")):
        t = timings[key]
        entry = dict(
            name=name, route="cuda", source=src, replaces=line,
            launches=sum(c.get(name, 0) for c in by_path.values()),
            path="+".join(by_path),
            launches_by_path={p: c.get(name, 0) for p, c in by_path.items()},
            max_abs_err=max(t["max_abs_err"],
                            sweep["worst"][name]),
            ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            library_device_ms=t["library_device_ms"],
            graph_ms=t["graph_ms"], library_graph_ms=t["library_graph_ms"],
            shape=t["shape"])
        for sub in timings:
            if sub.startswith(name + "/") and sub != key:
                entry[sub[len(name) + 1:].replace("/", "_")
                      .replace("-", "_")] = timings[sub]
        kernels.append(entry)
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("relational", "async", "attention",
                                       "serving", "families", "training",
                                       "timings"),
                    help="run one group of phases (bring-up); default all")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="with --only timings: time the kernels of the "
                         "checkout at TREE (for example an earlier commit "
                         "unpacked by git archive) instead of this one")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    if tree != ROOT and args.only != "timings":
        ap.error("--tree needs --only timings")
    # pins cuBLAS's workspace so that deterministic algorithms are
    # available to the serving phase; read when CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (tree / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: src/repro_torch not found in {tree}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))
    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; kernels of {tree}")
    sources = ((FILTER_SCAN_CU, CSV_PARSE_CU) if args.only == "timings"
               else SOURCES)
    seconds, usage = build_kernels(sources, tree)
    log(f"build: {seconds:.1f} s (nvcc, sm_90a, {len(sources)} sources in "
        f"parallel)")
    for name, summary in usage.items():
        log(f"ptxas {name}: {summary}")

    cuda = torch.device("cuda")
    kernels = []
    if args.only in (None, "relational", "async", "timings"):
        kernels += relational_phases(
            cuda, smi, main_path_too=args.only != "async",
            async_too=args.only != "relational",
            checks=args.only != "timings")
        torch.cuda.empty_cache()
    if args.only in (None, "attention", "serving", "families", "training"):
        kernels += attention_phases(
            cuda, smi, serve=args.only in (None, "serving"),
            families=args.only in (None, "families"),
            training=args.only in (None, "training"))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

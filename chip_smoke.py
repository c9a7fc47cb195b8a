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
* serving (S2): serves granite-8b at full width (8 of its 36 layers)
  through the prefix-cache
  MQO engine three times (no MQO, MQO cold, MQO warm), which must
  generate the same tokens and take the MQO decisions computed on the
  CPU, and checks ``Model.forward`` with the flash kernel against the
  plain attention on the card;
* families (S3): holds the Mamba, RG-LRU, MoE and MLA families'
  ``-smoke`` configs on the card against the CPU (S3a), then serves
  falcon-mamba-7b, recurrentgemma-9b, llama4-scout (6 of 48 layers) and
  deepseek-v2 (2 of 60) at full width the same three ways (S3b), with
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
  a preempted, resumed run equals an uninterrupted one bitwise (T2);
* surfaces (E1-E4), after the relational phases (E1, E2 and E4 are
  processes of their own, started together): the three examples
  (``examples/torch_*.py``) on the card and on the CPU, whose printed
  lines must agree apart from times, rates and speedups (E1); the
  analytics server at SF1 on the card (E2); the async bench
  (``benchmarks/torch_bench_async.py``) at the JAX bench's sizes on the
  card and on the CPU, the card's windows replayed on the CPU for equal
  tables and MQO decisions, its speed gate printed (E3); and the
  serving launcher on the card (E4);
* properties (P), after the surfaces: the engine's bit-identities on
  CUDA tensors, drawn by ``tests/torch_properties.py`` as the CPU
  suites draw them, each table also against the port's CPU run: fused
  = eager and batched = per-query over random chains, unions, estimate
  overflows and mixed windows, columnar and CSV (P1, every filter and
  decoder kernel launched); a tiny budget = an unlimited one, the CE
  pool pressed to host copies and promoted back to the card (P2);
  MQO = no MQO and windowed ``submit`` = ``run_batch`` on seeded fuzz
  batches, MQO decisions equal to the CPU's (P3); successes under
  injected faults at every point = the fault-free run, over three
  fault seeds, every degradation an injected fault's (P4); pruned =
  unpruned over range and hash partitions, with the pid pool (P5);
* multi-device (M), last: the relational stream at SF1 on a row-sharded
  session (one controller; every card up to 4, else 4 shards of
  ``cuda:0``) against the single-device card session, each shard's
  filter and decoder launches counted, the sharded partitioned scan and
  a per-shard sweep against the plain versions (M1); then one world of
  2 SPMD ranks (a card each over NCCL, else both on ``cuda:0`` over
  gloo): granite-8b's tensor-parallel train step against the single-
  device step, with a control that leaves out the row-parallel
  all-reduce, and a second (warm) step timed beside the single-device
  one's, and gemma3-1b's bf16-compressed step, its update held
  against the uncompressed f32 step's (M2),
  llama4-scout's MoE FFN expert-parallel against ``moe_forward`` (M3),
  the TP masters saved and restored onto a world of 1, bitwise
  (M4), and, in the same world, the tensor-parallel ``moe_forward`` on
  DTensors (not expert-parallel) at llama4-scout's and deepseek-v2's
  published widths (bf16) and then the two ``-smoke`` MoE configs of 8
  experts at top 2 and top 1 (f32), on the (1, 2) ("data", "model")
  mesh and again on the (2, 1) one, whose ranks route their own halves
  of the rows, each against the single-device
  ``moe_forward`` on the card: routes bitwise, outputs within
  ``M_MOE_RTOL`` / ``M_SPLIT_TOL`` of the largest output (M6); then a
  world of 4 ranks over ("data", "model") = (2, 2) (a card each where
  there are four, else all on ``cuda:0`` over gloo): the six ``-smoke``
  configs' tensor-parallel train step, llama4-scout's at published
  widths (one of 48 layers, bf16 on f32 masters; every attention call
  on every rank split by rows over "data" and by heads over "model") and
  deepseek-v2's MoE FFN forward and backward on DTensors, each against
  the single-device step on the card; batch-1 decode of three cut
  configurations on a ("pod", "data", "model") = (2, 1, 2) mesh over the
  same ranks, beside a single-device bf16 decode against an f32 one;
  and deepseek-v2's dense first layer decoding 4 rows on the (2, 2)
  mesh, each "model" rank multiplying its share of MLA's latent
  down-projections, rank 0's collectives equal to the dry run's (M7);
* the dry run (D), after M: one full-size cell of
  ``repro_torch.launch.dryrun`` (granite-8b ``decode_32k`` on 256 fake
  ranks) with its roofline (D1); then a granite-8b decode step and a
  forward (4 layers) on the card under ``FlopCounterMode`` against the
  same steps traced on a 1 x 1 fake mesh: equal flops, and each kernel's
  traced calls equal its launches (D2 / D3); a falcon-mamba-7b prefill
  (4 layers, full width) the same way, whose time scans trace as the
  custom operator ``repro_torch::ssm_scan``: equal flops and scan calls,
  and both scan operators bitwise equal to their plain loops on CUDA
  tensors, forward and gradients (D4).

``--only relational|async|attention|serving|families|training|timings``
runs one group (for bring-up: ``relational`` leaves out A0 and A,
``async`` runs the CSV decoder, A0 and A, ``serving``, ``families`` and
``training`` run S1 first, ``timings`` only times the filter kernel,
the decoder and the two attention wrappers); ``--only sharded`` runs M,
``--only dryrun`` D and ``--only properties`` P alone (their kernels
lines carry launches only); ``--only surfaces`` runs E1-E4, and
``--only benches`` runs the other bench scripts on the card at the JAX
benches' sizes and the macro bench at SF1 (not part of the whole run;
its kernels line carries each kernel's launches by bench); with no
argument every other phase runs.  ``--only timings --tree
DIR`` times the kernels of another checkout through its own wrappers,
so that an earlier commit's kernels (``git archive`` into DIR) and this
one's can be timed in turns on one card; ``--only serving|families|
training --tree DIR`` runs S2, S3 or T0-T2 on that checkout's port
(without S1), whose generations' digests and T1 / T2 figures the same
phases of this checkout must equal where the single-device path is
unchanged; ``--only spmd`` runs M2-M7 alone (no M1), and with ``--tree
DIR`` on that checkout's port, so that two commits' TP steps can be
timed in turns on one card; ``--only moe_train`` runs M7 alone (also
with ``--tree``).  It prints one
line per phase and each phase's seconds.  The line before the last is
the kernels' JSON; where phase D ran, the line before it is the scan
operators' JSON (D4; they are not kernels); the last line is the device
JSON.  Any failure exits
non-zero; without CUDA it exits non-zero before any result.  The script
imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import math
import os
import re
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
# The card's peaks (HBM bytes/s, f32 outside the tensor cores, bf16
# tensor cores dense), set by set_peaks from the card's name through
# repro_torch.launch.roofline.hardware
HBM_BYTES_PER_S = F32_OPS_PER_S = BF16_OPS_PER_S = None
F32_RTOL = 1e-5                    # card vs CPU f32 aggregates (see below)
# The card and the CPU sum f32 aggregates through f64 prefix sums whose
# association order differs (a parallel scan on the card), so a group's
# sum may round to a neighbouring f32; every other value must be equal.


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, fn):
    """``fn()``, after which a line gives ``label`` and its seconds."""
    t0 = time.perf_counter()
    out = fn()
    log(f"{label}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def set_peaks(kind: str) -> str:
    """Set the peaks the bounds are computed from to those of the card
    named ``kind``; returns a line that states them.  The roofline
    module is loaded from this checkout by its path, so that ``--tree``
    still imports the package from the other checkout."""
    import importlib.util

    global HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S
    path = ROOT / "src" / "repro_torch" / "launch" / "roofline.py"
    spec = importlib.util.spec_from_file_location("_roofline", path)
    roofline = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = roofline      # its dataclass looks it up
    spec.loader.exec_module(roofline)
    hw = roofline.hardware(kind)
    HBM_BYTES_PER_S = hw.hbm_bytes_per_s
    F32_OPS_PER_S = hw.f32_flops_per_s
    BF16_OPS_PER_S = hw.bf16_flops_per_s
    return (f"peaks of the {hw.part} (NVIDIA data sheet, dense): HBM "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s, f32 {F32_OPS_PER_S / 1e12:g} "
            f"TFLOP/s, bf16 {BF16_OPS_PER_S / 1e12:g} TFLOP/s")


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


def device_kernels(fn, reps: int = 20, windows: int = 3, host: bool = False):
    """Per device kernel name, (launches per call, device ms per call) of
    ``fn``, from ``torch.profiler`` over ``windows`` windows of ``reps``
    calls after one unprofiled call.  The profiler drops a window's
    kernel records now and then, some or all of them, and in runs of
    consecutive windows; so a kernel's launches per call are the most
    any window saw, and its time per launch the mean over every launch
    of it that the windows saw.  With ``host`` also returns the host's
    calls that put work on the device (kernel launches, copies, fills:
    the runtime's records, which the profiler has not been seen to
    drop) per call of ``fn``, the most any window saw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}     # kernel name -> [most in a window, total us, launches]
    issued = 0    # the most device-work calls of the host in a window
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        calls = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count:
                rec = seen.setdefault(e.key, [0, 0.0, 0])
                rec[0] = max(rec[0], e.count)
                rec[1] += e.self_device_time_total
                rec[2] += e.count
            elif e.key.startswith("cu") and any(
                    w in e.key for w in ("Launch", "Memcpy", "Memset")):
                calls += e.count
        issued = max(issued, calls)
    kernels = {k: (most / reps, most / reps * us / n / 1e3)
               for k, (most, us, n) in seen.items()}
    return (kernels, issued / reps) if host else kernels


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
# the decode kernel's log-sum-exp against its plain version's: both f32
# from the same f32 logits (bf16 inputs widen exactly), summed in another
# order over up to 8,192 keys; a wrong max or a missing log moves it by
# about a unit
LSE_ATOL = 1e-4
# Full-model logits, flash kernel against plain attention, both bf16 on
# the card: the two attentions round to bf16 apart by at most one ulp
# per element, and the bf16 layers carry that on; the logits must agree
# within 5% of the largest logit (a wrong mask or head mapping moves
# them by its whole size).
FORWARD_RTOL = 0.05
SERVE_SEED = 0
SERVE_BUDGET, SERVE_K = 64 << 20, 2    # prefix pool bytes, SE threshold
GRANITE_LAYERS = 36
# S2 serves SERVE_LAYERS of them: the engine prefills one decode step a
# token and a step is host-bound (about 2 ms a layer), so the 3,644
# steps of the three runs took 290 s of the script at all 36 layers
SERVE_LAYERS = 8


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
    window.  Every decode case also asks for the log-sum-exp, with its
    first row's keys all dead (-inf, zero output).  Returns the worst
    error and case count per kernel and of the log-sum-exp; raises on
    an error above ATTN_ATOL (LSE_ATOL)."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import decode_ref, mha_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    worst = {"decode_attention": 0.0, "flash_attention": 0.0, "lse": 0.0}
    cases = {"decode_attention": 0, "flash_attention": 0, "lse": 0}

    def check_lse(got, want, what):
        torch.cuda.synchronize()
        dead = torch.isneginf(want)
        if not (torch.equal(torch.isneginf(got), dead)
                and torch.isfinite(got[~dead]).all()):
            raise AssertionError(f"decode_attention's lse is -inf where its "
                                 f"plain version's is not, or not finite, "
                                 f"at {what}")
        err = float((got[~dead] - want[~dead]).abs().max())
        if not err <= LSE_ATOL:
            raise AssertionError(f"decode_attention's lse disagrees with its "
                                 f"plain version's by {err} at {what}")
        worst["lse"] = max(worst["lse"], err)
        cases["lse"] += 1

    def check(name, got, want, dtype, what):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= ATTN_ATOL[str(dtype)]:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"by {err} at {what}")
        worst[name] = max(worst[name], err)
        cases[name] += 1

    def decode_case(q, k, v, kv_len, dtype, what):
        # the log-sum-exp too, with the first row's keys all dead
        dead = kv_len.clone()
        dead[0] = 0
        for window in (None, 48):
            check("decode_attention",
                  DK.decode_attention(q, k, v, kv_len, window=window),
                  decode_ref(q, k, v, kv_len, window=window), dtype,
                  f"{what} window={window}")
            out, lse = DK.decode_attention(q, k, v, dead, window=window,
                                           return_lse=True)
            want, want_lse = decode_ref(q, k, v, dead, window=window,
                                        return_lse=True)
            check("decode_attention", out, want, dtype,
                  f"{what} window={window} with lse")
            check_lse(lse, want_lse, f"{what} window={window}")

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


SPLIT_SHARDS = (2, 16)
LONG_SLOTS = 524_288                 # a gemma3-1b long_500k row
ZIGZAG_T, ZIGZAG_C = 4096, 4         # gemma3-1b's query chunks: c = 4
# The key-split merges draw q at SPLIT_PEAK times unit scale, so that
# each head's scaled logits have a standard deviation of SPLIT_PEAK and
# its softmax rests on a few keys: the outputs are a few v rows, not
# averages of 10^5 keys that lie below ATTN_ATOL whatever the merge
# does, and the shards' log-sum-exps differ by units.  v is drawn at
# SPLIT_V times unit scale, so that the outputs stay near 1 in size and
# their bf16 roundings (half an ulp of each shard's output and of the
# unsplit one) stay well inside ATTN_ATOL.  Two wrong merges serve as
# controls and must miss ATTN_ATOL: the shards' outputs weighed equally,
# and the merge without each row's heaviest shard.
SPLIT_PEAK, SPLIT_V = 8.0, 0.25


def attention_splits(device) -> list:
    """The sharded routes' arithmetic on the card, against the unsplit
    kernel: decode over 2 and 16 key shards merged by their log-sum-exps
    (``decode_attention.ops.merge_key_shards``) at S2's shapes (granite-
    8b's heads, 8 rows x 272 live keys), over its 1024-slot cache split
    evenly as the route splits it (the later shards hold no live key)
    and over the 272 live slots (every shard holds some), and at one
    524,288-slot gemma3-1b row (4 q heads over one kv head of 256), each
    with the two wrong merges of SPLIT_PEAK as controls (q and v
    scaled as SPLIT_PEAK says); the shards are
    views of the cache, which the kernel reads in place (``kv_strides``),
    and a view narrowed to one kv head and a slot range gives the bits
    of its contiguous copy; and gemma3-1b's zig-zag query chunks
    (``flash_attention.ops.zigzag_chunks``, T = S = 4096, c = 4, every
    rank's two chunks against their key prefixes, with and without its
    512 window) against the rows of one causal forward.  bf16; each
    within ATTN_ATOL.  Returns what was checked; raises on a larger
    error, on a control within it, or on a copied view."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention.ops import merge_key_shards
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import zigzag_chunks

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    bf16, tol = torch.bfloat16, ATTN_ATOL["torch.bfloat16"]
    done = []

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    def max_err(a, b):
        torch.cuda.synchronize()
        return float((a - b).abs().max())

    g = get_config("gemma3-1b")
    for label, (b, hq, hkv, d, slots, live, span) in (
            ("S2 granite-8b, 1024 slots", (8, 32, 8, 128, 1024, 272, 1024)),
            ("S2 granite-8b, 272 live slots", (8, 32, 8, 128, 1024, 272,
                                               272)),
            ("gemma3-1b long row", (1, g.n_heads, g.n_kv_heads, g.head_dim,
                                    LONG_SLOTS, LONG_SLOTS, LONG_SLOTS))):
        q = _randn((b, hq, d), torch.float32, device, gen)
        q = (q * SPLIT_PEAK).to(bf16)
        k = _randn((b, hkv, slots, d), bf16, device, gen)
        v = _randn((b, hkv, slots, d), torch.float32, device, gen)
        v = (v * SPLIT_V).to(bf16)
        kv_len = torch.full((b,), live, dtype=torch.int32, device=device)
        whole = DK.decode_attention(q, k, v, kv_len).float()
        scale = float(whole.abs().max())
        for n in SPLIT_SHARDS:
            size = span // n
            views = [(k.narrow(2, i * size, size), v.narrow(2, i * size, size))
                     for i in range(n)]
            if b > 1 and any(DK.kv_strides(kk, vv) is None
                             for kk, vv in views):
                raise AssertionError(f"{label}: the kernel would copy a "
                                     f"shard's view of the cache")
            parts = [DK.decode_attention(
                q, kk, vv, (kv_len - i * size).clamp(0, size),
                return_lse=True) for i, (kk, vv) in enumerate(views)]
            outs = torch.stack([o for o, _ in parts]).float()
            lses = torch.stack([x for _, x in parts])
            err = max_err(merge_key_shards(outs, lses, stacked), whole)
            if not err <= tol:
                raise AssertionError(f"{label}: {n} key shards merged differ "
                                     f"from the unsplit kernel by {err}")
            line = (f"{label}, {n} key shards: max |err| {err:.3g} of max "
                    f"|out| {scale:.3g}")
            live_shards = torch.isfinite(lses)
            if int(live_shards.sum(0).min()) >= 2:
                w = live_shards.float()[..., None]
                equal = (outs * w).sum(0) / w.sum(0)
                top = torch.nn.functional.one_hot(
                    lses.argmax(0), n).permute(2, 0, 1).bool()
                dropped = merge_key_shards(
                    outs, lses.masked_fill(top, float("-inf")), stacked)
                controls = (max_err(equal, whole), max_err(dropped, whole))
                if not min(controls) > tol:
                    raise AssertionError(
                        f"{label}, {n} key shards: a wrong merge passes "
                        f"the limit (equal weights {controls[0]}, heaviest "
                        f"shard dropped {controls[1]})")
                line += (f"; controls: equal weights {controls[0]:.3g}, "
                         f"heaviest shard dropped {controls[1]:.3g}")
            done.append(line)
        del views, parts, outs, lses
        if b > 1:
            # one kv head's slot range, as a rank narrows its replica
            kk, vv = k.narrow(1, 3, 1).narrow(2, 136, 136), \
                v.narrow(1, 3, 1).narrow(2, 136, 136)
            qq = q[:, 3 * (hq // hkv):4 * (hq // hkv)].contiguous()
            lens = (kv_len - 136).clamp(0, 136)
            if DK.kv_strides(kk, vv) is None or not torch.equal(
                    DK.decode_attention(qq, kk, vv, lens),
                    DK.decode_attention(qq, kk.contiguous(), vv.contiguous(),
                                        lens)):
                raise AssertionError(f"{label}: a view of kv head 3, slots "
                                     f"136-271, read in place differs from "
                                     f"its contiguous copy")
            done.append(f"{label}: kv head 3, slots 136-271 read in place, "
                        f"bitwise equal to its contiguous copy")
        del q, k, v, whole
    t, d = ZIGZAG_T, g.head_dim
    q = _randn((1, g.n_heads, t, d), bf16, device, gen)
    k = _randn((1, g.n_kv_heads, t, d), bf16, device, gen)
    v = _randn((1, g.n_kv_heads, t, d), bf16, device, gen)
    for window in (None, g.window):
        whole = FK.flash_attention(q, k, v, causal=True, window=window)
        err = 0.0
        for shard in range(ZIGZAG_C):
            for a, rows, lo, hi in zigzag_chunks(t, t, ZIGZAG_C, shard,
                                                 window):
                part = FK.flash_attention(q[:, :, a:a + rows],
                                          k[:, :, lo:hi], v[:, :, lo:hi],
                                          causal=True, window=window)
                torch.cuda.synchronize()
                err = max(err, float((part.float() - whole[
                    :, :, a:a + rows].float()).abs().max()))
        if not err <= tol:
            raise AssertionError(f"zig-zag chunks (window {window}) differ "
                                 f"from the unsplit forward by {err}")
        done.append(f"gemma3-1b zig-zag chunks, T = {t}, c = {ZIGZAG_C}, "
                    f"window {window}: max |err| {err:.3g}")
    return done


DECODE_MARK = "decode_attention_kernel"
PROFILE_SESSIONS = 8                # S1's profiler sessions at most
PROFILE_WINDOWS, PROFILE_REPS = 3, 20   # device_kernels' defaults
FLASH_MARK = "flash_fwd_wgmma_kernel"


def _timing(kern, plain, lib, nbytes: int, flops: int, shape: str,
            marks: tuple, launched) -> dict:
    """Times of the kernel (CUDA events around the wrapper, and the
    device time of its kernels ``marks`` from the profiler), its plain
    version and one library call (CUDA events, and the device time of
    all its kernels) on the same inputs, with the bound of the
    function's work.  Raises when the wrapper's counter, the profiler's
    host records or the kernels it saw show other than one launch of a
    kernel ``marks`` a call and no other device work, or when no session
    recorded the host's launches.  ``launched()`` reads the wrapper's
    launch counter."""
    import torch

    def first(x):           # the output of a call that returns more
        return x[0] if isinstance(x, tuple) else x

    err = float((first(kern()).float() - first(plain()).float())
                .abs().max())
    torch.cuda.synchronize()
    if not err <= ATTN_ATOL["torch.bfloat16"]:
        raise AssertionError(f"kernel disagrees at {shape}: {err}")
    # One launch a call and no other device work: the wrapper's counter,
    # the host's device-work calls the profiler records (which it has
    # not been seen to drop) and the kernels it saw on the device, none
    # beyond the marked one.  The profiler drops kernel records, from
    # one to all of a window's, in runs of windows; so a session that
    # saw fewer marked kernels than calls and no contrary sign is
    # profiled again, PROFILE_SESSIONS in all.  The device time is the
    # mean of the marked kernel's records seen, per launch; "not
    # measured" where every session lost them all.
    calls = 1 + PROFILE_WINDOWS * PROFILE_REPS    # device_kernels' calls
    confirmed = False           # a session's host records saw one a call
    best = (None, 0)            # device ms per launch, launches per call
    for _ in range(PROFILE_SESSIONS):
        before = launched()
        kernels, host = device_kernels(kern, PROFILE_REPS, PROFILE_WINDOWS,
                                       host=True)
        issued = (launched() - before) / calls
        device_ms, per_call = marked(kernels, marks)
        _, every = marked(kernels, ("",))
        if issued != 1 or host > 1 or per_call > 1 or every != per_call:
            raise AssertionError(
                f"at {shape} the profiler saw {per_call} kernels {marks}, "
                f"{every} device events and {host} host calls that put "
                f"work on the device per wrapper call, the wrapper's "
                f"counter {issued} launches a call, not one")
        confirmed = confirmed or host == 1
        if per_call > best[1]:
            best = (device_ms / per_call, per_call)
        if confirmed and per_call == 1:
            break
        log(f"S1 at {shape}: the profiler saw {per_call:.2f} kernels "
            f"{marks} and {host:.2f} host calls that put work on the device "
            f"a call in its fullest window, the wrapper's counter "
            f"{issued:.2f} launches a call; profiling again")
    if not confirmed:
        raise AssertionError(
            f"at {shape} no profiler session recorded the host's one "
            f"launch a call in {PROFILE_SESSIONS} sessions")
    device_ms = best[0]
    if device_ms is None:
        log(f"S1 at {shape}: the profiler lost every record of the kernel "
            f"in {PROFILE_SESSIONS} sessions; device time not measured")
    elif best[1] < 1:
        log(f"S1 at {shape}: the profiler lost some of the kernel's records "
            f"in every session (at most {best[1]:.2f} a call in a window); "
            f"device time {fmt_ms(device_ms)} a launch from those it kept")
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
            key = f"kv{live}" + ("" if b == 1 else f"/b{b}")
            # with the log-sum-exp (the key-split route's call) too: it
            # adds one f32 a row and query head to the bytes
            for lse in (False, True):
                out["decode_attention/" + ("lse/" if lse else "") + key] = \
                    _timing(
                    lambda: DK.decode_attention(q, k, v, kv_len,
                                                return_lse=lse),
                    lambda: decode_ref(q, k, v, kv_len, return_lse=lse),
                    lambda: F.scaled_dot_product_attention(
                        q[:, :, None], k[:, :, :live], v[:, :, :live],
                        enable_gqa=True),
                    b * (2 * q[0].numel() * 2 + 2 * hkv * live * d * 2 + 4
                         + 4 * hq * lse),
                    b * 4 * hq * live * d,
                    f"q ({b}, {hq}, {d}), cache ({b}, {hkv}, 1024, {d}) "
                    f"bf16, kv_len {live}" + (", with lse" if lse else ""),
                    (DECODE_MARK,), lambda: DK.LAUNCHES["decode_attention"])
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
    # a digest of the generated tokens, which two checkouts' runs compare
    digest = hashlib.sha256(b"".join(np.asarray(o, dtype=np.int64).tobytes()
                                     for o in base)).hexdigest()[:16]
    log(f"{tag} {cfg.name}: generations bitwise equal across no-MQO / MQO "
        f"cold / MQO warm (digest {digest}); MQO decisions equal the "
        f"CPU's ({want['n_ses']} "
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
    """Phase S2: granite-8b at full width, SERVE_LAYERS of its 36
    layers, through :func:`serve_model` with the profiled window;
    returns the launch counts."""
    from repro_torch.configs import get_config

    full = replace(get_config("granite-8b"), attn_impl="pallas")
    if full.n_layers != GRANITE_LAYERS:
        raise AssertionError("granite-8b is not the 36-layer config")
    cfg = replace(full, n_layers=SERVE_LAYERS)
    return serve_model("serving", cfg, serving_requests, device, smi,
                       cut=f"{SERVE_LAYERS} of {GRANITE_LAYERS} layers, "
                           f"depth cut to fit the script's time",
                       block=64, max_len=1024, profile=True)


# ---------------------------------------------------------------------------
# phase S3: the Mamba, RG-LRU, MoE and MLA families
# ---------------------------------------------------------------------------
# (config, layers served; None = all of them).  Depth is the only cut.
# The two MoE models' whole stacks do not fit one card (215.5 GB and
# 453.5 GB of bf16 parameters): llama4-scout keeps 6 of its 48 layers,
# deepseek-v2 2 of its 60 (its dense first layer and one MoE layer,
# which still cover every block kind; 4 until M7 (e) took its time).
# falcon-mamba-7b keeps 16 of 64 and recurrentgemma-9b 9 of 38 (3
# repeats of its pattern) so that the script fits its time: their
# host-bound decode steps took 112-214 s of it whole, and 67 s at 32
# and 18 layers.  Widths are the published ones.
FAMILIES = (("falcon-mamba-7b", 16), ("recurrentgemma-9b", 9),
            ("llama4-scout-17b-a16e", 6), ("deepseek-v2-236b", 2))
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
        f"TFLOP a step, over {BF16_OPS_PER_S / 1e12:g} TFLOP/s bf16); "
        f"peak memory "
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


# ---------------------------------------------------------------------------
# phases E1-E4: the user surfaces (examples, the async bench, the launcher)
# ---------------------------------------------------------------------------
# E1's examples at tests/test_examples.py's reduced sizes, each with the
# strings the JAX package's example test asserts
EXAMPLES = (
    ("examples/torch_quickstart.py", (),
     ("identical=True", "selected", "QueryService")),
    ("examples/torch_analytics_server.py",
     ("--window", "6", "--scale-rows", "20000"),
     ("aggregate ratio", "warm speedup over cold")),
    ("examples/torch_llm_serving_mqo.py", ("--requests", "6"),
     ("generations identical: True",)),
)
RELATIONAL_EXAMPLES = ("examples/torch_quickstart.py",
                       "examples/torch_analytics_server.py")
# The serving engine prefills a prompt one decode step a token, as the
# JAX package's engine does (``serving/engine.py::_prefill_scan``), so
# the serving surfaces launch decode_attention and not flash_attention,
# whose path is ``Model.forward`` (S2) and training (T1).
SERVING_KERNELS = ("decode_attention",)
SURFACE_TIMEOUT_S = 900
# Runs an example script or a module as ``__main__`` in a fresh process
# and reports the kernel wrappers' launch counts on its last stderr line.
SURFACE_RUNNER = r"""
import json, runpy, sys
target, argv = sys.argv[1], sys.argv[2:]
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.filter_project import kernel as FK
from repro_torch.kernels.flash_attention import kernel as AK
sys.argv = [target, *argv]
try:
    if target.endswith(".py"):
        runpy.run_path(target, run_name="__main__")
    else:
        runpy.run_module(target, run_name="__main__", alter_sys=True)
finally:
    sys.stdout.flush()
    print("LAUNCHES " + json.dumps({**FK.LAUNCHES, **DK.LAUNCHES,
                                    **AK.LAUNCHES}), file=sys.stderr,
          flush=True)
"""
# What a printed line may carry that depends on the clock: a time, a
# rate or a speedup (a number with a unit of s, ms, x or q/s), the
# ratio of two times, and the async front's window sizes and tenants'
# bytes (adaptive windows close on the clock, and pool bytes are
# charged to the tenant whose query first touched them).
TIMED = (re.compile(r"[\d.]+(?:/[\d.]+)*\s?(?:ms|s|x|q/s)\b"),
         re.compile(r"(?<=aggregate ratio \(warm windowed / no-MQO\): )"
                    r"\S+"),
         re.compile(r"(?<=window sizes )\[[^\]]*\]"),
         re.compile(r"(?<=bytes=)\d+B"))
FLOAT = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")
# A degradation event names its ladder's rung.  With use_pallas_filter
# off, the first rung is the kernel route on the card and the fused
# torch function on the CPU (``Session._CARD_LADDER`` / ``_LADDER``), so
# a fault retried in place at the first rung reads as either.
CARD_RUNGS = (("->kernel'", "->fused-torch'"),)


def timeless(line: str) -> str:
    """``line`` with what depends on the clock masked as ``<t>``."""
    for pattern in TIMED:
        line = pattern.sub("<t>", line)
    return line


def lines_agree(a: str, b: str) -> bool:
    """Two printed lines agree when they are equal once timeless, or
    differ only in decimal numbers within F32_RTOL (f32 aggregates)."""
    a, b = timeless(a), timeless(b)
    if a == b:
        return True
    fa, fb = FLOAT.findall(a), FLOAT.findall(b)
    return (FLOAT.sub("#", a) == FLOAT.sub("#", b) and len(fa) == len(fb)
            and all(math.isclose(float(x), float(y), rel_tol=F32_RTOL,
                                 abs_tol=0) for x, y in zip(fa, fb)))


def card_as_cpu(out: str) -> str:
    """A card run's output with its ladder's rung names read as the
    CPU's."""
    for card, cpu in CARD_RUNGS:
        out = out.replace(card, cpu)
    return out


def first_disagreement(a: str, b: str):
    """The first pair of lines of two outputs that does not agree, or
    None; outputs of different lengths disagree at the shorter's end."""
    la, lb = a.splitlines(), b.splitlines()
    for i, (x, y) in enumerate(zip(la, lb)):
        if not lines_agree(x, y):
            return i, x, y
    if len(la) != len(lb):
        n = min(len(la), len(lb))
        return n, (la[n:] or [""])[0], (lb[n:] or [""])[0]
    return None


def start_surface(target: str, args, device: str, threads=None):
    """Start ``target`` (a script path or a module name) with ``args``
    and ``--device device`` in a fresh process from the repository's
    root; returns the process.  Its output goes to temporary files, so
    that processes started together never wait on a full pipe."""
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    path = str(ROOT / target) if target.endswith(".py") else target
    files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
    proc = subprocess.Popen(
        [sys.executable, "-c", SURFACE_RUNNER, path, *args, "--device",
         device], cwd=ROOT, env=env, stdout=files[0], stderr=files[1],
        text=True)
    proc.started, proc.files = time.perf_counter(), files
    return proc


def stop_surface(proc) -> None:
    """Kill ``proc`` if it still runs, and close its output files."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for f in proc.files:
        f.close()


def finish_surface(proc, label: str) -> tuple:
    """Wait for a process of ``start_surface``; returns its stdout, its
    kernel launches and its seconds since its start.  Raises unless it
    exited 0."""
    try:
        proc.wait(timeout=SURFACE_TIMEOUT_S)
        for f in proc.files:
            f.seek(0)
        out, err = (f.read() for f in proc.files)
    finally:
        stop_surface(proc)
    if proc.returncode != 0:
        raise AssertionError(f"{label} exited {proc.returncode}: "
                             f"{err[-3000:]}")
    last = [line for line in err.splitlines()
            if line.startswith("LAUNCHES ")][-1]
    return out, json.loads(last[len("LAUNCHES "):]), \
        time.perf_counter() - proc.started


def examples_phase(smi: str, procs: dict) -> dict:
    """E1: each example on the card and on the CPU, from the processes
    ``procs[(target, device)]`` started by :func:`surfaces_phase`; each
    prints the JAX example's strings, the card's and the CPU's lines
    agree (``lines_agree``), the relational examples launch
    ``filter_scan_batch`` and the LLM example ``decode_attention`` on
    the card, and the CPU runs launch nothing.  Returns the card runs'
    launches."""
    launches: dict = {}
    card = {target: finish_surface(procs[target, "cuda"],
                                   f"{target} on cuda")
            for target, _, _ in EXAMPLES}
    cpu = {target: finish_surface(procs[target, "cpu"], f"{target} on cpu")
           for target, _, _ in EXAMPLES}
    for target, args, strings in EXAMPLES:
        (out, used, seconds), (want, cpu_used, _) = card[target], \
            cpu[target]
        missing = [s for s in strings if s not in out]
        if missing:
            raise AssertionError(f"E1 {target}: the card's output lacks "
                                 f"{missing}")
        bad = first_disagreement(card_as_cpu(out), want)
        if bad:
            raise AssertionError(f"E1 {target}: line {bad[0]} differs "
                                 f"between card and CPU: {bad[1]!r} vs "
                                 f"{bad[2]!r}")
        need = (("filter_scan_batch",) if target in RELATIONAL_EXAMPLES
                else SERVING_KERNELS)
        if any(used.get(k, 0) <= 0 for k in need) or any(cpu_used.values()):
            raise AssertionError(f"E1 {target}: card launches {used} (needs "
                                 f"{need}), CPU launches {cpu_used}")
        for k, v in used.items():
            launches[k] = launches.get(k, 0) + v
        lines = out.splitlines()
        masked = sum(timeless(x) != x for x in lines)
        log(f"E1 {target} {' '.join(args)}: card {seconds:.1f} s, "
            f"{len(lines)} lines agree with the CPU's ({masked} with "
            f"times masked), strings {list(strings)} present; card "
            f"launches {used}, CPU launches none [{smi}]")
    return launches


E2_SURFACE = ("examples/torch_analytics_server.py",
              ("--scale-rows", str(SF1_STORE_SALES_ROWS)))
E4_SURFACE = ("repro_torch.launch.serve", ("--arch", "granite-8b"))


def analytics_at_sf1(smi: str, proc) -> dict:
    """E2: the analytics server on SF1 ``store_sales`` on the card, from
    the process ``proc`` of ``E2_SURFACE``."""
    out, used, seconds = finish_surface(proc, "E2 on cuda")
    for s in ("aggregate ratio", "warm speedup over cold",
              "subsumption_hit=True", "shared_dispatch="):
        if s not in out:
            raise AssertionError(f"E2: the output lacks {s!r}")
    if used.get("filter_scan_batch", 0) <= 0:
        raise AssertionError(f"E2 launched {used}")
    keep = ("no-MQO baseline", "aggregate ratio", "warm speedup",
            "queries with resident", "latency p50", "async adaptive")
    for line in out.splitlines():
        if line.startswith(keep):
            log(f"E2 analytics_server SF1: {line}")
    log(f"E2 card run: {seconds:.1f} s, launches {used} [{smi}]")
    return used


def async_bench_phase(cuda, smi: str) -> dict:
    """E3: benchmarks/torch_bench_async.py at the JAX bench's sizes on
    the card and on the CPU; every handle resolves (the bench raises
    otherwise), and the card's windows replayed through the CPU's sync
    front give the card's tables and MQO decisions.  The speed gate's
    outcome on each device is printed, not raised."""
    from repro_torch.kernels.filter_project import kernel as K

    sys.path.insert(0, str(ROOT / "benchmarks"))
    import torch_bench_async as B

    K.reset_launches()
    t0 = time.perf_counter()
    card = B.run(cuda, keep=True)
    launched = dict(K.LAUNCHES)
    t_card = time.perf_counter() - t0
    missing = [k for k in ("parse_fields", "filter_scan_batch")
               if launched.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"E3 never launched {missing}")
    t0 = time.perf_counter()
    host = B.run("cpu")
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = B.verify(card, "cpu")
    log(f"E3 replay: {n} queries of the card's windows through the "
        f"CPU's sync front, tables and MQO decisions equal; "
        f"{time.perf_counter() - t0:.1f} s")
    for label, out, seconds in (("card", card, t_card),
                                ("cpu", host, t_cpu)):
        f, a, s = out["fixed"], out["adaptive"], out["single_client"]
        failures = B.gate(out)
        log(f"E3 {label}: fixed {f['throughput_qps']:.2f} queries/s p50 "
            f"{f['latency_p50_s'] * 1e3:.1f} ms p99 "
            f"{f['latency_p99_s'] * 1e3:.1f} ms ({f['windows_closed']} "
            f"windows); adaptive {a['throughput_qps']:.2f} queries/s p50 "
            f"{a['latency_p50_s'] * 1e3:.1f} ms p99 "
            f"{a['latency_p99_s'] * 1e3:.1f} ms ({a['windows_closed']} "
            f"windows, batch target mean {a['adaptive_batch_mean']:.1f}, "
            f"wait target mean {a['adaptive_wait_s_mean'] * 1e3:.1f} ms, "
            f"window "
            f"exec p99 read by the policy "
            f"{a['window_exec_p99_s'] * 1e3:.1f} ms); adaptive/fixed "
            f"{out['adaptive_over_fixed_throughput']:.4f}; single client "
            f"sync {s['sync_mean_s'] * 1e3:.2f} ms (window exec "
            f"{s['sync_exec_mean_s'] * 1e3:.2f}) async "
            f"{s['async_mean_s'] * 1e3:.2f} ms (window exec "
            f"{s['async_exec_mean_s'] * 1e3:.2f}), async/sync "
            f"{s['async_over_sync_latency']:.4f}; gate "
            f"{'holds' if not failures else 'fails: ' + '; '.join(failures)}"
            f"; {seconds:.1f} s"
            + (f", launches {launched} [{smi}]" if label == "card" else ""))
    return launched


def serve_launcher(smi: str, proc) -> dict:
    """E4: ``python -m repro_torch.launch.serve --arch granite-8b`` on
    the card, from the process ``proc`` of ``E4_SURFACE``."""
    out, used, seconds = finish_surface(proc, "E4 on cuda")
    served = [line for line in out.splitlines()
              if line.startswith("served 8 requests")]
    if not served or any(used.get(k, 0) <= 0 for k in SERVING_KERNELS):
        raise AssertionError(f"E4: {out[-500:]!r}, launches {used}")
    for line in out.splitlines()[:2]:
        log(f"E4 launch.serve granite-8b-smoke: {line}")
    log(f"E4 card run: {seconds:.1f} s, launches {used} [{smi}]")
    return used


def surfaces_phase(cuda, smi: str) -> dict:
    """Phases E1-E4; returns the launches of each kernel over their
    card runs.  E1, E2 and E4 are processes of their own, which all
    start together (their printed times are not compared); E3 runs in
    this process once they have ended, since it times the card against
    the CPU."""
    launches: dict = {}
    procs = {}
    t0 = time.perf_counter()
    try:
        for target, args, _ in EXAMPLES:
            procs[target, "cpu"] = start_surface(target, args, "cpu",
                                                 threads=2)
            procs[target, "cuda"] = start_surface(target, args, "cuda")
        procs["E2"] = start_surface(*E2_SURFACE, "cuda")
        procs["E4"] = start_surface(*E4_SURFACE, "cuda")
        for name, phase in (("E1", lambda: examples_phase(smi, procs)),
                            ("E2", lambda: analytics_at_sf1(
                                smi, procs["E2"])),
                            ("E4", lambda: serve_launcher(
                                smi, procs["E4"]))):
            for k, v in phase().items():
                launches[k] = launches.get(k, 0) + v
            log(f"{name}: done {time.perf_counter() - t0:.1f} s after "
                f"E1, E2 and E4 started together")
    finally:
        for proc in procs.values():
            stop_surface(proc)
    t0 = time.perf_counter()
    for k, v in async_bench_phase(cuda, smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"E3: {time.perf_counter() - t0:.1f} s")
    return launches


def scalars(out: dict) -> dict:
    """A bench result's numbers and strings, and those of its nested
    results (rows, windows); the per-query lists are left out."""
    keep = {}
    for k, v in out.items():
        if isinstance(v, list) and v and isinstance(v[0], dict):
            keep[k] = [scalars(row) for row in v]
        elif isinstance(v, dict):
            keep[k] = scalars(v)
        elif not isinstance(v, list):
            keep[k] = v
    return keep


BENCHES = ("torch_bench_filter_micro", "torch_bench_window_batch",
           "torch_bench_service", "torch_bench_subsumption",
           "torch_bench_mckp", "torch_bench_projection_micro",
           "torch_bench_window", "torch_bench_macro_tpcds",
           "torch_bench_batch_reuse", "torch_bench_canonical",
           "torch_bench_partition", "torch_bench_resilience",
           "torch_bench_telemetry", "torch_bench_serving_prefix",
           "torch_bench_macro_tpcds@SF1")


def bench_outputs(mod, name: str, cuda) -> tuple:
    """One bench at its JAX defaults on the card: (its results, its
    gate's failures).  ``...@SF1`` is the macro bench's RAM profile with
    ``store_sales`` at SF1."""
    if name.endswith("@SF1"):
        return (mod.run(cuda, scale_rows=SF1_STORE_SALES_ROWS,
                        name="macro_tpcds_sf1"),), []
    if name == "torch_bench_service":
        outs = (mod.run(cuda), mod.run_tracing_overhead(cuda))
        return outs, mod.gate(*outs)
    if name == "torch_bench_macro_tpcds":
        return (mod.run(cuda), mod.run_disk_profile(cuda)), []
    if name == "torch_bench_projection_micro":
        return (mod.run(cuda), mod.run_fused_vs_eager(cuda)), []
    out = mod.run(cuda)
    return (out,), (mod.gate(out) if hasattr(mod, "gate") else [])


def benches_phase(cuda, smi: str) -> dict:
    """The bench scripts on the card, at the JAX benches' defaults (the
    async bench is E3's), and the macro bench at SF1: each one's
    correctness checks raise; its figures, launches, seconds and gate
    are printed.  Returns each bench's launches by kernel wrapper."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK

    sys.path.insert(0, str(ROOT / "benchmarks"))
    by_bench = {}
    for name in BENCHES:
        mod = __import__(name.split("@")[0])
        for counters in (K, DK, FK):
            counters.reset_launches()
        t0 = time.perf_counter()
        outs, failures = bench_outputs(mod, name, cuda)
        seconds = time.perf_counter() - t0
        by_bench[name] = {**K.LAUNCHES, **DK.LAUNCHES, **FK.LAUNCHES}
        summary = json.dumps([scalars(o) for o in outs])
        log(f"bench {name}: {summary}; launches {by_bench[name]}; gate "
            f"{'holds' if not failures else 'fails: ' + '; '.join(failures)}"
            f"; {seconds:.1f} s [{smi}]")
    return by_bench


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
            checked = timed("filter sweep", lambda: kernel_sweep(cuda))
            log(f"kernels vs plain versions: bitwise equal over "
                f"{checked['filter_scan']} literal and "
                f"{checked['filter_scan_batch']} slotted programs "
                f"({checked['variants']} compiled variants)")
        timings.update(timed("filter timings",
                             lambda: kernel_timings(cuda)))
    if checks:
        log(f"CSV decoder vs plain versions: parse_i32, parse_f32 and "
            f"parse_fields bitwise equal on the card and on the CPU over "
            f"{timed('CSV sweep', lambda: parse_sweep(cuda))} cases")
    timings.update(timed("CSV timings", lambda: parse_timings(cuda)))
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
        stats = timed("main path", lambda: main_path(K, cuda))
        launches["main"], host_csv = stats["launches"], stats["host_csv"]
        launches["literal-route"] = timed("literal route", lambda:
                                          literal_route(K, stats["reference"],
                                                        cuda))
        log(f"literal route: filter_scan launched "
            f"{launches['literal-route']['filter_scan']} times, results "
            f"equal the main path's")
        del stats
    if async_too and checks:
        launches["async"] = timed("async A0 and A", lambda: async_phases(
            cuda, smi, host_csv or host_csv_passes()))
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
                     training: bool, s1: bool = True) -> list:
    """Phases S1 (unless ``s1`` is false: another checkout's kernels
    under ``--tree``), S2 when ``serve``, S3 when ``families`` and T0-T2
    when ``training``: the attention kernels against their plain
    versions, their times, and the serving and training paths; returns
    the kernels' JSON entries, whose ``launches`` sum the launches of
    the paths that ran (none without S1)."""
    if not s1:
        for run in ((serving_path,) if serve else ()) + \
                ((family_phases,) if families else ()) + \
                ((training_phases,) if training else ()):
            run(cuda, smi)
        return []
    sweep = timed("S1 sweep", lambda: attention_sweep(cuda))
    log(f"attention kernels vs plain versions: decode_attention "
        f"{sweep['cases']['decode_attention']} cases, max |err| "
        f"{sweep['worst']['decode_attention']:.3g}; flash_attention "
        f"{sweep['cases']['flash_attention']} cases, max |err| "
        f"{sweep['worst']['flash_attention']:.3g} (limits f32 "
        f"{ATTN_ATOL['torch.float32']}, bf16 "
        f"{ATTN_ATOL['torch.bfloat16']})")
    log(f"decode_attention lse vs plain: {sweep['cases']['lse']} cases, "
        f"max |err| {sweep['worst']['lse']:.3g} (limit {LSE_ATOL})")
    for line in timed("S1 bitwise", lambda: attention_bitwise(cuda)):
        log(f"bitwise: {line}")
    for line in timed("S1 splits", lambda: attention_splits(cuda)):
        log(f"split: {line} (limit {ATTN_ATOL['torch.bfloat16']}) [{smi}]")
    timings = timed("S1 timings", lambda: attention_timings(cuda))
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
        by_path["serving"] = timed("S2", lambda: serving_path(cuda, smi))
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


# ---------------------------------------------------------------------------
# phase M: multi-device (row-sharded relational scans, SPMD training,
# expert-parallel MoE, elastic restore)
# ---------------------------------------------------------------------------
# Relational meshes are one-controller: every card when there are
# several (at most 4), else 4 shards that all name cuda:0.  SPMD worlds
# are 2 ranks: one card each over NCCL where there are 2, else both on
# cuda:0 over gloo with CUDA tensors.
M_SHARDS_ONE_CARD = 4
M_LOSS_RTOL, M_GNORM_RTOL = 2e-4, 1e-3
M_MOE_RTOL = 1e-2                      # of max |moe_forward|: 2 bf16 ulps
M_SWEEP_ROWS = (3000, 2049, 1023)      # odd counts; last shard(s) empty
# M2b: lr from the first step, so the step moves each entry by ~lr and
# an update of nothing, or along the negated gradient, is off by lr or
# 2 lr.  The compressed update may differ from the f32 one by 2 lr where
# the bf16 rounding (2^-7 of sum_r |g_r| over 2 ranks: two roundings of
# 2^-8 and one bf16 addition) could flip the sign of AdamW's first
# moment, by M_UPDATE_RTOL lr where it is far from that; at least half
# the entries must be of the second kind
M_COMP_OPT = dict(warmup_steps=1)
M_BF16_SLACK = 2.0 ** -7
M_UPDATE_RTOL = 2.0 ** -5
# the SPMD sizes, passed to every rank (a CPU rehearsal swaps in the
# -smoke configs and the cpu device type)
M_CFG = dict(
    archs={"train": "granite-8b", "moe": "llama4-scout-17b-a16e",
           "compressed": "gemma3-1b"},
    train_layers=2,                    # of granite-8b's 36 (M2)
    train_seq=4096,
    comp_seq=512,                      # gemma3-1b compressed step (M2)
    moe_tokens=4096,                   # MoE FFN input rows (M3, M6)
    tp_moe=("llama4-scout-17b-a16e",   # M6 (a), (b): published widths
            "deepseek-v2-236b"),
    m7_train=dict(arch="llama4-scout-17b-a16e", layers=1, batch=2,
                  seq=2048),           # M7 (a): M3's 4,096 rows
    m7_ffn="deepseek-v2-236b",         # M7 (b), at moe_tokens rows
    m7_pairs=("granite-8b-smoke", "gemma3-1b-smoke",       # M7 (c)
              "falcon-mamba-7b-smoke", "recurrentgemma-9b-smoke",
              "deepseek-v2-236b-smoke", "llama4-scout-17b-a16e-smoke"),
    # M7 (d): batch-1 decode on ("pod", "data", "model") = (2, 1, 2) at
    # published widths, (arch, layers): gemma3-1b five local layers and
    # one global, recurrentgemma-9b two RG-LRU and one attention,
    # falcon-mamba-7b two Mamba; slots cut from long_500k's 524,288
    m7_decode=dict(archs=(("gemma3-1b", 6), ("recurrentgemma-9b", 3),
                          ("falcon-mamba-7b", 2)),
                   slots=32768, steps=4, batch=1,
                   control="gemma3-1b"),   # also decoded in f32 alone
    # M7 (e): deepseek-v2's dense first layer (MLA and the dense MLP) at
    # published widths, 4 rows (2 a "data" rank) on the (2, 2) mesh
    m7_mla=dict(arch="deepseek-v2-236b", layers=1, batch=4, slots=4096,
                steps=4),
    device_type="cuda")                # every SPMD tensor lives there
# M6 (c): one shape of router logits, (moe_tokens, 8), routed at top 2
# and then at top 1 in the same world (DTensor's sharding cache keys
# topk without its k: ROADMAP C7), first on the (1, 2) ("data",
# "model") mesh of (a) and (b), then on the (2, 1) mesh, whose rows
# split over "data"
M_TP_MOE_PAIR = ("deepseek-v2-236b-smoke", "llama4-scout-17b-a16e-smoke")


def m_sync(dev) -> None:
    from repro_torch.device import synchronize
    synchronize(dev)


def m_peak(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def m_relational_devices():
    import torch

    n = min(torch.cuda.device_count(), 4)
    return ([f"cuda:{i}" for i in range(n)] if n >= 2
            else ["cuda:0"] * M_SHARDS_ONE_CARD)


def m_spmd_devices():
    import torch

    return (["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2
            else ["cuda:0", "cuda:0"])


def m_sharding(devices):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import NamedSharding

    mesh = make_test_mesh((len(devices),), ("data",), devices=devices)
    return NamedSharding(mesh, ("data",))


def m_shard_spies():
    """Spies on the sharded route: every batch-mask call and every
    per-shard CSV decode must add exactly one launch per shard (one for
    a relation on one device, such as a cached CE) to the kernels'
    counters.  Returns (counts, undo)."""
    from repro_torch.kernels.filter_project import kernel as K
    from repro_torch.relational import physical as PH

    counts = {"mask_calls": 0, "decode_calls": 0, "bad": []}
    real_mask, real_csv = PH._batch_masks, PH._csv_columns

    def mask(ctx, child, *a, **kw):
        n = PH._n_shards(child)
        before = K.LAUNCHES["filter_scan_batch"]
        out = real_mask(ctx, child, *a, **kw)
        if n > 1:
            counts["mask_calls"] += 1
        if K.LAUNCHES["filter_scan_batch"] - before != n:
            counts["bad"].append(("filter_scan_batch", n))
        return out

    def csv(raw, schema, needed, nrows, ctx):
        before = K.LAUNCHES["parse_fields"]
        out = real_csv(raw, schema, needed, nrows, ctx)
        numeric = [c for c in needed
                   if schema.coltype(c).kind in ("i32", "f32")]
        if isinstance(raw, PH.RowShards) and numeric:
            counts["decode_calls"] += 1
            if K.LAUNCHES["parse_fields"] - before != len(raw.shards):
                counts["bad"].append(("parse_fields", len(raw.shards)))
        return out

    PH._batch_masks, PH._csv_columns = mask, csv

    def undo():
        PH._batch_masks, PH._csv_columns = real_mask, real_csv
    return counts, undo


def m_tpcds(K, cuda, smi: str, sharding) -> dict:
    """M1's stream: the 50 TPC-DS queries at SF1 in windows of 8, cold
    then warm, columnar then CSV, on a row-sharded session and on a
    single-device one on the card; tables, MQO decisions, pool bytes
    equal, no DegradationEvent, every shard's kernels launched."""
    import torch

    from repro_torch.device import synchronize
    from repro_torch.relational import SessionConfig
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    devices = [str(d) for d in sharding.mesh.devices.flat]
    launches, by_device = {}, {}
    qps = []
    for fmt in ("columnar", "csv"):
        single = build_tpcds_session(SF1_STORE_SALES_ROWS, fmt, device=cuda)
        sharded = build_tpcds_session(
            SF1_STORE_SALES_ROWS, fmt,
            config=SessionConfig().with_execution(sharding=sharding))
        single.enable_tracing()
        sharded.enable_tracing()
        for phase in ("cold", "warm"):
            want = run_stream(single, tpcds_queries(single),
                              lambda: synchronize(cuda))
            counts, undo = m_shard_spies()
            K.reset_launches()
            try:
                got = run_stream(sharded, tpcds_queries(sharded),
                                 lambda: [torch.cuda.synchronize(d)
                                          for d in dict.fromkeys(devices)])
            finally:
                undo()
            for k, v in K.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v
            for k, v in K.LAUNCHES_BY_DEVICE.items():
                by_device[k] = by_device.get(k, 0) + v
            for i, (a, b) in enumerate(zip(got["tables"], want["tables"])):
                compare_tables(a, b, f"M1 {fmt}/{phase}/q{i}")
            if got["decisions"] != want["decisions"]:
                bad = [i for i, (x, y) in enumerate(
                    zip(got["decisions"], want["decisions"])) if x != y]
                raise AssertionError(f"M1 {fmt}/{phase}: MQO decisions of "
                                     f"the sharded session differ at {bad}")
            if counts["bad"] or counts["mask_calls"] == 0 or (
                    fmt == "csv" and counts["decode_calls"] == 0):
                raise AssertionError(f"M1 {fmt}/{phase}: per-shard launches "
                                     f"wrong or missing: {counts}")
            q1 = len(got["tables"]) / got["seconds"]
            q0 = len(want["tables"]) / want["seconds"]
            qps.append((fmt, phase, q1, q0))
            log(f"M1 {fmt}/{phase}: sharded {q1:.2f} queries/s, single-"
                f"device {q0:.2f} queries/s (no claim); {counts['mask_calls']}"
                f" sharded mask calls and {counts['decode_calls']} sharded "
                f"CSV decodes, each one launch a shard; tables and MQO "
                f"decisions equal [{smi}]")
        if single.memory.device_used != sharded.memory.device_used:
            raise AssertionError(
                f"M1 {fmt}: pool bytes differ: single "
                f"{single.memory.device_used}, sharded "
                f"{sharded.memory.device_used}")
        events = sharded.telemetry().registry.value("events.total")
        if events:
            raise AssertionError(f"M1 {fmt}: {events} DegradationEvents")
        del single, sharded
        gc.collect()
    for name in ("filter_scan_batch", "parse_fields"):
        for d in dict.fromkeys(devices):
            if by_device.get((name, d), 0) <= 0:
                raise AssertionError(f"M1: {name} never launched on {d}")
    log(f"M1 launches by (kernel, device): {by_device}; pool bytes equal")
    return launches


def m_partitioned(K, cuda, sharding) -> dict:
    """The JAX package's TestShardedPartitionedScan at SF1: store_sales
    range-partitioned 8 ways on ss_quantity, sharded and pruned, against
    single-device and unpruned, bitwise (then an MQO family)."""
    from repro_torch.relational import (ExecutionConfig, MemoryConfig,
                                        Partitioning, Session,
                                        SessionConfig)
    from repro_torch.relational import expr as E
    from repro_torch.relational.datagen import make_storage
    from repro_torch.relational.tpcds import generate_tpcds_catalog

    schema, nrows, cols = generate_tpcds_catalog(
        SF1_STORE_SALES_ROWS, 0)["store_sales"]

    def mk(shard, prune):
        s = Session.from_config(SessionConfig(
            execution=ExecutionConfig(sharding=shard, prune=prune),
            memory=MemoryConfig(budget_bytes=1 << 31)),
            device=None if shard else cuda)
        st, _ = make_storage("store_sales", schema, nrows, "columnar",
                             cols=cols)
        s.register(st, columnar_for_stats=cols,
                   partitioning=Partitioning("ss_quantity", "range", 8))
        return s

    plain, sharded = mk(None, False), mk(sharding, True)
    preds = [E.cmp("ss_quantity", "<", 20),
             E.and_(E.cmp("ss_quantity", ">", 10),
                    E.cmp("ss_sales_price", "<", 50.0)),
             E.or_(E.cmp("ss_quantity", "<", 5),
                   E.cmp("ss_quantity", ">", 90))]

    def q(s, p):
        return s.table("store_sales").filter(p).project(
            "ss_item_sk", "ss_quantity", "ss_sales_price")

    K.reset_launches()
    r2 = sharded.run_batch([q(sharded, p) for p in preds], mqo=False)
    launched = dict(K.LAUNCHES)
    r1 = plain.run_batch([q(plain, p) for p in preds], mqo=False)
    for i, (a, b) in enumerate(zip(r1.results, r2.results)):
        # live rows bitwise (pruning changes the estimate, and with it
        # the output capacity, by up to one power of two)
        m_bitwise(a.table, b.table, f"M1 partitioned/q{i}", live=True)
    fam = [q(sharded, E.cmp("ss_quantity", "<", v)) for v in (30, 35, 40)]
    ref = [q(plain, E.cmp("ss_quantity", "<", v)) for v in (30, 35, 40)]
    rs, rr = sharded.run_batch(fam, mqo=True), plain.run_batch(ref, mqo=False)
    for i, (a, b) in enumerate(zip(rr.results, rs.results)):
        if a.table.row_multiset() != b.table.row_multiset():
            raise AssertionError(f"M1 partitioned MQO family q{i} differs")
    pruned = sum(1 for e in sharded._scan_pool.entries.values()
                 if len(e.key) > 2 and isinstance(e.key[2], tuple)
                 and len(e.key[2]) < 8)
    log(f"M1 partitioned store_sales (range 8 on ss_quantity, "
        f"{nrows:,} rows): sharded+pruned equals single-device unpruned "
        f"bitwise over 3 queries, MQO family equal; {pruned} pruned "
        f"partition-set scan entries; launches {launched}")
    return launched


def m_literal(K, cuda, sharding) -> dict:
    """Phase 5's literal route (F2, F5 with use_pallas_filter=True and
    shape_cache=False) on a row-sharded session: ``filter_scan`` on
    every shard, tables equal the single-device literal route's."""
    from repro_torch.relational import SessionConfig
    from repro_torch.relational.tpcds import (build_tpcds_session,
                                              tpcds_queries)

    cfg = SessionConfig().with_execution(use_pallas_filter=True,
                                         shape_cache=False)
    picked = list(range(10, 20)) + list(range(40, 46))   # F2, F5
    out = []
    for shard in (None, sharding):
        sess = build_tpcds_session(
            SF1_STORE_SALES_ROWS,
            config=cfg.with_execution(sharding=shard),
            device=None if shard else cuda)
        qs = tpcds_queries(sess)
        K.reset_launches()
        got = run_stream(sess, [qs[i] for i in picked],
                         lambda: m_sync(sess.device))
        out.append((got["tables"], dict(K.LAUNCHES),
                    sess.telemetry().registry.value("events.total")))
        del sess
    (want, _, _), (tables, launched, events) = out
    for i, a, b in zip(picked, tables, want):
        compare_tables(a, b, f"M1 literal/q{i}")
    n = len(list(sharding.mesh.devices.flat))
    if launched["filter_scan"] < n or events:
        raise AssertionError(f"M1 literal route: launches {launched}, "
                             f"{events} events")
    log(f"M1 literal route on the sharded session: {len(picked)} queries "
        f"equal the single-device literal route's; filter_scan launched "
        f"{launched['filter_scan']} times over {n} shards")
    return launched


def m_bitwise(a, b, label: str, live: bool = False) -> None:
    """Tables equal bit for bit: every row of the capacity, or with
    ``live`` the live rows only."""
    import torch

    if a.nrows != b.nrows or (not live and a.capacity != b.capacity):
        raise AssertionError(f"{label}: rows {a.nrows}/{b.nrows}, capacity "
                             f"{a.capacity}/{b.capacity}")
    n = a.nrows if live else a.capacity
    for c in a.columns:
        x, y = a.columns[c][:n].cpu(), b.columns[c][:n].cpu()
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{label}.{c}: not bitwise equal")


def m_sweep(K, cuda, sharding) -> int:
    """Each kernel's sharded masks against its plain version on the CPU
    for the same columns, bitwise, at odd row counts whose last shards
    hold few or no live rows: filter_scan_batch (slotted route),
    filter_scan (literal route) and parse_fields (CSV scans)."""
    import torch

    from repro_torch.relational import (ExecutionConfig, MemoryConfig,
                                        Session, SessionConfig)
    from repro_torch.relational import expr as E
    from repro_torch.relational.datagen import (generate_columns,
                                                make_storage,
                                                synthetic_schema)

    schema = synthetic_schema(n_int=3, n_dbl=2, n_str=1)
    preds = [E.cmp("n1", ">", 500),
             E.and_(E.cmp("n2", "<", 700), E.cmp("d1", ">", 0.25)),
             E.or_(E.cmp("n1", "<", 50), E.cmp("d2", ">=", 0.9)),
             E.not_(E.cmp("n3", "==", 7))]
    cases = 0
    for nrows in M_SWEEP_ROWS:
        cols = generate_columns(schema, nrows, seed=nrows)
        for fmt in ("columnar", "csv"):
            for route, kw in (("slotted", {}),
                              ("literal", dict(shape_cache=False,
                                               use_pallas_filter=True))):
                def mk(shard, device):
                    s = Session.from_config(SessionConfig(
                        execution=ExecutionConfig(sharding=shard, **kw),
                        memory=MemoryConfig(budget_bytes=1 << 26)),
                        device=device)
                    st, _ = make_storage("t", schema, nrows, fmt, cols=cols)
                    s.register(st, columnar_for_stats=cols)
                    return s

                card, host = mk(sharding, None), mk(None, torch.device("cpu"))
                K.reset_launches()
                a = card.run_batch([card.table("t").filter(p).project(
                    "n1", "d1", "s1") for p in preds], mqo=False)
                launched = dict(K.LAUNCHES)
                b = host.run_batch([host.table("t").filter(p).project(
                    "n1", "d1", "s1") for p in preds], mqo=False)
                for i, (x, y) in enumerate(zip(a.results, b.results)):
                    m_bitwise(x.table, y.table,
                              f"M1 sweep {nrows}/{fmt}/{route}/p{i}")
                    cases += 1
                need = "filter_scan_batch" if route == "slotted" \
                    else "filter_scan"
                if launched[need] <= 0 or (fmt == "csv"
                                           and launched["parse_fields"] <= 0):
                    raise AssertionError(f"M1 sweep {nrows}/{fmt}/{route}: "
                                         f"no kernel launch: {launched}")
    return cases


def m_relational(cuda, smi: str) -> dict:
    """Phase M1."""
    from repro_torch.kernels.filter_project import kernel as K

    devices = m_relational_devices()
    sharding = m_sharding(devices)
    log(f"M1 relational mesh: {len(devices)} shards over {devices} "
        f"(one controller) [{smi}]")
    launches = timed("M1 stream", lambda: m_tpcds(K, cuda, smi, sharding))
    for more in (timed("M1 partitioned",
                       lambda: m_partitioned(K, cuda, sharding)),
                 timed("M1 literal", lambda: m_literal(K, cuda, sharding))):
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v
    cases = timed("M1 sweep seconds", lambda: m_sweep(K, cuda, sharding))
    log(f"M1 sweep: sharded filter_scan_batch, filter_scan and "
        f"parse_fields equal their plain versions on the CPU bitwise over "
        f"{cases} cases (rows {M_SWEEP_ROWS}, {len(devices)} shards)")
    return launches


def m_digest(t) -> tuple:
    """Two order-sensitive integer sums of a tensor's bits."""
    import torch

    flat = t.detach().contiguous().view(-1)
    words = flat.view(torch.int32 if flat.element_size() == 4
                      else torch.int16).to(torch.int64)
    w = torch.arange(words.numel(), device=words.device) % 65521 + 1
    return int(words.sum()), int((words * w).sum())


def m_granite_cfg():
    from repro_torch.configs import get_config

    return replace(get_config(M_CFG["archs"]["train"]), n_layers=M_CFG["train_layers"],
                   attn_impl="pallas")


def m_granite_batch(cfg, device):
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.trainer import to_device

    return to_device(make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=M_CFG["train_seq"], global_batch=1,
        seed=0), 0), device)


def m_moe_inputs(device, arch=None, dtype="bfloat16"):
    """An MoE FFN's parameters (llama4-scout's unless ``arch`` is
    given; ``dtype``, seed 0) and one layer's input rows
    (M_CFG["moe_tokens"] x d_model, unit scale, seed 1)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ffn as F
    from repro_torch.models.common import materialize_params

    dtype = getattr(torch, dtype)
    cfg = get_config(arch or M_CFG["archs"]["moe"])
    p = materialize_params(F.moe_specs(cfg), 0, dtype, device)
    return cfg, p, m_moe_rows(cfg, device, dtype, seed=1)


def m_moe_rows(cfg, device, dtype, seed: int):
    """M_CFG["moe_tokens"] x d_model rows of unit scale, seeded."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((1, M_CFG["moe_tokens"], cfg.d_model), generator=gen,
                       device=device, dtype=torch.float32).to(dtype)


# the functional collectives that DTensor and the port call, and the op
# the dry run's counter books each as (roofline.COLLECTIVE_OPS' names)
M_COMM_CALLS = {"all_gather_tensor": "all-gather",
                "all_gather_single": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_single": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all"}


@contextlib.contextmanager
def m_comm_counts():
    """Within the context, each functional collective that DTensor or
    the port calls in this process, as (op, result bytes) in the list it
    yields: named and sized as the dry run's counter books it, counted
    where it is called, so before ``gloo_collectives_over_all_reduce``
    runs it as all-reduces (a collective called inside another counts
    once).  DTensor's shard-to-shard redistribution counts as an
    all-to-all, as the dry run counts it."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt
    from torch.distributed import _functional_collectives as funcol

    calls, depth = [], [0]

    def counted(fn, op):
        def call(*args, **kwargs):
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if not depth[0]:
                calls.append((op, out.numel() * out.element_size()))
            return out
        return call

    targets = [(funcol, name, op) for name, op in M_COMM_CALLS.items()
               if hasattr(funcol, name)]
    targets += [(m, "shard_dim_alltoall", "all-to-all") for m in (cu, pt)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in targets]
    for m, name, op in targets:
        setattr(m, name, counted(getattr(m, name), op))
    try:
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def m_comm_summary(calls) -> dict:
    """(op, bytes) calls as {op: [calls, bytes, largest]}."""
    out = {}
    for op, nbytes in calls:
        n, total, most = out.get(op, (0, 0, 0))
        out[op] = [n + 1, total + nbytes, max(most, nbytes)]
    return out


def m_comm_line(summary: dict) -> str:
    """A rank's collectives of one step, by op."""
    total = sum(v[1] for v in summary.values())
    ops = "; ".join(f"{op} {n} x, {b:,} B (largest {most:,})"
                    for op, (n, b, most) in sorted(summary.items()))
    return f"collectives {total:,} B: {ops or 'none'}"


def m_tp_moe_steps():
    """M6's steps in order: (label, arch, dtype, limit of max |err| as a
    fraction of max |out|, the ("data", "model") mesh's shape)."""
    a, b = M_CFG["tp_moe"]
    return ([("a", a, "bfloat16", M_MOE_RTOL, (1, 2)),
             ("b", b, "bfloat16", M_MOE_RTOL, (1, 2))]
            + [("c", arch, "float32", M_SPLIT_TOL, grid)
               for grid in ((1, 2), (2, 1)) for arch in M_TP_MOE_PAIR])


def m_moe_route(p, x, cfg, dtype):
    """``moe_forward``'s output and its route's top indices, kept
    entries and slots (host copies; gathered when DTensors)."""
    import torch

    from repro_torch.models import ffn as F

    routes = []
    real_route = F.route
    F.route = lambda c, lg: routes.append(real_route(c, lg)) or routes[-1]
    try:
        with torch.no_grad():
            y = F.moe_forward(p, x, cfg, dtype)
    finally:
        F.route = real_route
    r, = routes

    def host(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()

    return host(y), {f: host(getattr(r, f))
                     for f in ("top_idx", "keep", "slot")}, r


def m_tp_moe_refs(cuda) -> list:
    """M6's references: the single-device ``moe_forward`` of each step
    on the card, its output and route on the host."""
    import torch

    refs = []
    for _, arch, dtype, _, _ in m_tp_moe_steps():
        cfg, p, x = m_moe_inputs(cuda, arch, dtype)
        y, route, _ = m_moe_route(p, x, cfg, getattr(torch, dtype))
        refs.append((y, route))
        del p, x
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def m_tp_moe(devs, dev, refs) -> list:
    """M6 on one rank of the world of 2: each step's MoE FFN through the
    tensor-parallel ``moe_forward`` on DTensors, not expert-parallel:
    the weights placed by ``param_shardings`` on the step's ("data",
    "model") mesh, the rows as M3 places them on the (1, 2) mesh
    (experts over "model") and split over "data" on the (2, 1) mesh
    (the (1, T, d) rows as (2, T / 2, d), the same rows in the same
    order).  The route is held bitwise against the single-device route
    and the output against its output; seconds and the rank's peak
    bytes."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import (NamedSharding, device_put,
                                             param_shardings)
    from repro_torch.models import ffn as F

    out = []
    for (label, arch, dtype, limit, grid), (ref_y, ref_route) in zip(
            m_tp_moe_steps(), refs):
        mesh = Mesh(devs.reshape(grid), ("data", "model"))
        cfg, p, x = m_moe_inputs(dev, arch, dtype)
        pd = device_put(p, param_shardings(F.moe_specs(cfg), cfg, mesh))
        rows = ("data",) if grid[0] > 1 else ()
        xd = device_put(x.reshape(grid[0], -1, x.shape[-1]),
                        NamedSharding(mesh, rows))
        del p, x
        gc.collect()
        torch.cuda.empty_cache()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        m_sync(dev)
        t0 = time.perf_counter()
        with implicit_replication(), m_comm_counts() as calls:
            y, route, r = m_moe_route(pd, xd, cfg, getattr(torch, dtype))
        m_sync(dev)
        seconds = time.perf_counter() - t0
        out.append(dict(
            label=label, arch=arch, dtype=dtype, limit=limit, mesh=grid,
            top_k=cfg.top_k, experts=cfg.n_experts,
            shape=tuple(r.top_idx.shape),
            local=tuple(r.top_idx.to_local().shape),
            placements=str(tuple(r.top_idx.placements)),
            routes_equal={f: torch.equal(route[f], ref_route[f])
                          for f in route},
            kept=int(route["keep"].sum()),
            max_err=float((y.reshape(ref_y.shape).float()
                           - ref_y.float()).abs().max()),
            ref_max=float(ref_y.float().abs().max()),
            seconds=seconds, peak=m_peak(dev),
            comm=m_comm_summary(calls)))
        del pd, xd, y, r
        gc.collect()
        torch.cuda.empty_cache()
    return out


# M5: the routes where two ranks share a kv head, on the card, at the
# CPU rank tests' config and sizes (gemma3-1b-smoke at 3 q heads over one
# kv head, window 8, f32): what is checked is the routes' offsets, merges,
# chunk reassembly and gradients, not their scale.  Each is held against
# the single-device step on the card within the CPU tests' limits,
# numpy's assert_allclose at rtol = atol = 1e-5 (the loss: rel 1e-5).
M_SPLIT = dict(arch="gemma3-1b-smoke", heads=(3, 1), window=8, batch=8,
               seq=32, slots=16, pos=11, decode_batch=4)
M_SPLIT_TOL = 1e-5


def m_split_cfg():
    from repro_torch.configs import get_config

    n_heads, n_kv = M_SPLIT["heads"]
    return replace(get_config(M_SPLIT["arch"]), n_heads=n_heads,
                   n_kv_heads=n_kv, window=M_SPLIT["window"],
                   attn_impl="pallas")


def m_within(got, want, rtol=M_SPLIT_TOL, atol=M_SPLIT_TOL) -> float:
    """The worst ratio of |got - want| to atol + rtol |want| (at most 1
    passes); ``got`` may be a DTensor."""
    if hasattr(got, "full_tensor"):
        got = got.full_tensor()
    want = want.detach().float()
    return float(((got.detach().float() - want).abs()
                  / (atol + rtol * want.abs())).max())


def m_split_routes(devs, dev) -> dict:
    """M5 on one rank of a world of 2: a decode step at batch 4 whose
    two ranks split the kv head's keys ((1, 2) mesh, keys over "model"),
    one at batch 1 whose cache's slots split over "data" ((2, 1) mesh),
    and the forward and a train step's loss and gradients over zig-zag
    query chunks ((1, 2) mesh), each beside the same work on plain
    tensors on the card.  Returns each check's worst ratio to its limit,
    the caches' placements, and the kernels' launches in the sharded
    runs."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import (batch_shardings,
                                             cache_shardings, device_put,
                                             param_shardings)
    from repro_torch.models.common import named_leaves
    from repro_torch.models.decoder import init_cache, map_cache
    from repro_torch.models.model import (ShapeCell, decode_step, forward,
                                          init_params, model_specs)
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.trainer import to_device

    ms, cfg = M_SPLIT, m_split_cfg()
    keys = Mesh(devs.reshape(1, 2), ("data", "model"))
    slots = Mesh(devs.reshape(2, 1), ("data", "model"))
    out = {"launches": {"decode_attention": 0, "flash_attention": 0}}

    def counted(fn):
        before = DK.LAUNCHES["decode_attention"], \
            FK.LAUNCHES["flash_attention"]
        r = fn()
        m_sync(dev)
        out["launches"]["decode_attention"] += \
            DK.LAUNCHES["decode_attention"] - before[0]
        out["launches"]["flash_attention"] += \
            FK.LAUNCHES["flash_attention"] - before[1]
        return r

    params = init_params(cfg, 0, device=dev)
    for name, mesh, b in (("decode_keys", keys, ms["decode_batch"]),
                          ("decode_slots", slots, 1)):
        gen = torch.Generator().manual_seed(1)
        cache = map_cache(init_cache(cfg, b, ms["slots"], device="cpu"),
                          lambda t: torch.randn(t.shape, generator=gen)
                          .to(dev))
        token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                              dtype=torch.int32).to(dev)
        cell = ShapeCell("d", ms["slots"], b, "decode")
        with torch.no_grad():
            want, plain = decode_step(params, map_cache(cache, torch.clone),
                                      token, ms["pos"], cfg)
            p = device_put(params, param_shardings(model_specs(cfg), cfg,
                                                   mesh))
            c = device_put(cache, cache_shardings(cfg, cell, mesh, cache))
            t = device_put(token, batch_shardings(
                cfg, cell, mesh, {"token": token})["token"])
            with implicit_replication():
                got, c = counted(lambda: decode_step(p, c, t, ms["pos"],
                                                     cfg))
        out[name] = dict(
            worst=max([m_within(got, want)] + [
                m_within(x, y) for (_, x), (_, y) in
                zip(named_leaves(c), named_leaves(plain))]),
            placements=str(tuple(named_leaves(c)[0][1].placements)))
        del p, c, t, got, cache, plain
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=ms["seq"],
                      global_batch=ms["batch"], seed=0)
    batch = to_device(make_batch(data, 0), dev)
    cell = ShapeCell("t", ms["seq"], ms["batch"], "train")
    p_sh = param_shardings(model_specs(cfg), cfg, keys)
    b_sh = batch_shardings(cfg, cell, keys, batch)
    with torch.no_grad():
        want = forward(params, batch["tokens"], cfg)
        p = device_put(params, p_sh)
        toks = device_put(batch, b_sh)["tokens"]
        with implicit_replication():
            got = counted(lambda: forward(p, toks, cfg))
    out["forward"] = m_within(got, want)
    masters = init_params(cfg, 0, device=dev, masters=True)
    loss, grads = value_and_grad(masters, batch, cfg)
    s_loss, s_grads = counted(lambda: value_and_grad(
        device_put(masters, p_sh), device_put(batch, b_sh), cfg))
    out["loss"] = m_within(s_loss, loss, atol=0.0)
    want, got = dict(named_leaves(grads)), dict(named_leaves(s_grads))
    if sorted(want) != sorted(got):
        raise AssertionError(f"M5 gradient leaves {sorted(got)} against "
                             f"{sorted(want)}")
    out["grads"] = max(m_within(got[k], want[k]) for k in want)
    out["n_grads"] = len(want)
    return out


def m_rank(rank, mesh, cfg_m, ckpt_dir, moe_ref, tp_moe_refs):
    """One SPMD rank of phase M's world: M2 (the TP train step and its
    control, the compressed step), M3 (expert-parallel MoE), M4's save,
    M5 (the routes where two ranks share a kv head) and M6 (the
    tensor-parallel MoE route on DTensors).  Returns host values
    only."""
    M_CFG.update(cfg_m)
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import Mesh, device_mesh
    from repro_torch.launch.sharding import (NamedSharding, device_put,
                                             param_shardings, placements)
    from repro_torch.models import ffn as F
    from repro_torch.models.common import (activation_sharding,
                                           named_leaves, tree_map)
    from repro_torch.models.model import (cast_params, init_params,
                                          loss_fn, model_specs)
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.train_step import (compress_and_reduce,
                                              init_train_state,
                                              make_compressed_train_step,
                                              make_train_step,
                                              value_and_grad)
    from repro_torch.train.trainer import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.devices.flat[rank]
    devs = np.empty(mesh.size, dtype=object)
    devs[:] = list(mesh.devices.flat)
    out = {}

    def on_card(tree):
        bad = [k for k, v in named_leaves(tree)
               if (v.to_local() if hasattr(v, "to_local") else v)
               .device.type != M_CFG["device_type"]]
        if bad:
            raise AssertionError(f"rank {rank}: leaves off the card: "
                                 f"{bad[:4]}")

    seen = []
    real_ar = dist.all_reduce

    def spy(t, *a, **kw):
        if t.device.type != M_CFG["device_type"]:
            raise AssertionError(f"rank {rank}: a collective on {t.device}")
        seen.append(str(t.dtype).replace("torch.", ""))
        return real_ar(t, *a, **kw)

    # ---- M2a: granite-8b TP over ("model",) ----------------------------
    tp = Mesh(devs, ("model",))
    cfg = m_granite_cfg()
    masters = init_params(cfg, 0, dev, masters=True)
    params = device_put(masters, param_shardings(model_specs(cfg), cfg, tp))
    del masters
    torch.cuda.empty_cache()
    on_card(params)
    batch = m_granite_batch(cfg, dev)
    step = make_train_step(cfg, OptConfig())
    opt = init_train_state(cfg, params)
    FK.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    m_sync(dev)
    t0 = time.perf_counter()
    params, opt, metrics = step(params, opt, batch)
    loss = float(metrics["loss"].full_tensor()
                 if hasattr(metrics["loss"], "full_tensor")
                 else metrics["loss"])
    gnorm = metrics["grad_norm"]
    gnorm = float(gnorm.full_tensor() if hasattr(gnorm, "full_tensor")
                  else gnorm)
    m_sync(dev)
    out["m2"] = dict(loss=loss, gnorm=gnorm,
                     seconds=time.perf_counter() - t0,
                     peak=m_peak(dev),
                     flash=FK.LAUNCHES["flash_attention"],
                     held=sum(
                         (v.to_local() if hasattr(v, "to_local") else v)
                         .numel() * 4 for _, v in named_leaves(params)))
    # the control: the row-parallel products' all-reduce left out (a
    # Partial placement read as if reduced)
    real_reduce = Partial._reduce_value
    Partial._reduce_value = lambda self, tensor, mesh, mesh_dim: tensor
    try:
        with torch.no_grad(), implicit_replication():
            c = loss_fn(cast_params(params, cfg), batch, cfg)
        out["m2"]["control_loss"] = float(
            c.full_tensor() if hasattr(c, "full_tensor") else c)
    finally:
        Partial._reduce_value = real_reduce
    # a second step, warm, timed only
    t0 = time.perf_counter()
    params, opt, _ = step(params, opt, batch)
    m_sync(dev)
    out["m2"]["warm_seconds"] = time.perf_counter() - t0
    del opt, batch, step, metrics
    # M4's save: rank 0 writes the gathered masters; each rank's local
    # blocks are digested for the restore world to check
    out["digests"] = {k: (str(tuple(v.placements)),
                          m_digest(v.to_local()))
                      for k, v in named_leaves(params)}
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir, keep=1).save(1, params, blocking=True)
    out["save_seconds"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- M3: llama4-scout's MoE FFN, expert-parallel --------------------
    ep = Mesh(devs.reshape(1, mesh.size), ("data", "model"))
    mcfg, p, x = m_moe_inputs(dev)
    routes = []
    real_route = F.route

    def route_spy(c, logits):
        r = real_route(c, logits)
        routes.append(r.top_idx.cpu())
        return r

    F.route = route_spy
    try:
        pd = device_put(p, param_shardings(F.moe_specs(mcfg), mcfg, ep))
        del p
        xd = device_put(x, NamedSharding(ep, ()))
        on_card(pd)
        outs = []
        with torch.no_grad(), implicit_replication(), \
                activation_sharding(ep, moe_ep=(("data",), "model")):
            for _ in range(2):
                m_sync(dev)
                t0 = time.perf_counter()
                y = F.ffn_forward(pd, xd, mcfg, "moe", torch.bfloat16)
                y = y.full_tensor()
                m_sync(dev)
                outs.append((y, time.perf_counter() - t0))
    finally:
        F.route = real_route
    ref_out, ref_idx = moe_ref
    y0 = outs[0][0].float().cpu()
    out["m3"] = dict(
        routes_equal=all(torch.equal(r, ref_idx) for r in routes),
        n_routes=len(routes),
        max_err=float((y0 - ref_out.float()).abs().max()),
        ref_max=float(ref_out.float().abs().max()),
        repeat_bitwise=torch.equal(outs[0][0], outs[1][0]),
        seconds=[s for _, s in outs])
    del pd, xd, outs, y
    gc.collect()
    torch.cuda.empty_cache()

    # ---- M2b: gemma3-1b at full width, bf16-compressed gradients -------
    # the compressed step's update held against the uncompressed f32
    # data-parallel step's update from the same masters and batches
    # (M_COMP_OPT: lr from the first step, so each entry moves by ~lr)
    dp = Mesh(devs, ("data",))
    gcfg = replace(get_config(M_CFG["archs"]["compressed"]), attn_impl="pallas")
    opt_cfg = OptConfig(**M_COMP_OPT)
    groups = [device_mesh(dp).get_group("data")]
    masters = init_params(gcfg, 0, dev, masters=True)
    data = DataConfig(vocab_size=gcfg.vocab_size, seq_len=M_CFG["comp_seq"],
                      global_batch=mesh.size, process_index=rank,
                      process_count=mesh.size, seed=0)
    mine = to_device(make_batch(data, 0), dev)
    _, grads = value_and_grad(masters, mine, gcfg)
    worst, n_el, slack = 0.0, 0, []
    dist.all_reduce = spy
    try:
        for _, g in named_leaves(grads):
            # how far the compressed reduced gradient may lie from the
            # f32 one: 2 ranks' bf16 roundings and one bf16 addition,
            # M_BF16_SLACK of sum_r |g_r|, plus 1e-5 of the leaf's
            # largest |g| for two f32 evaluations of the gradient
            x = g.abs()
            dist.all_reduce(x)
            slack.append(M_BF16_SLACK * x + 1e-5 * float(x.max()))
            del x
            seen.clear()
            f32 = g.clone()
            dist.all_reduce(f32)
            f32 = f32 / mesh.size
            c16, _ = compress_and_reduce(g, torch.zeros_like(g), groups)
            if seen != ["float32", "bfloat16"]:
                raise AssertionError(f"rank {rank}: collectives {seen}")
            # atol=1e-2, rtol=2e-2 (the JAX package's test): the worst
            # ratio of |c16 - f32| to its allowance
            ratio = float(((c16 - f32).abs()
                           / (1e-2 + 2e-2 * f32.abs())).max())
            worst = max(worst, ratio)
            n_el += g.numel()
            g.copy_(f32)                     # the f32 step's gradient
            del f32, c16
    finally:
        dist.all_reduce = real_ar
    # the uncompressed data-parallel step, on a copy of the masters
    plain = tree_map(lambda p: p.detach().clone(), masters)
    plain, fstate, fm = adamw_update(plain, grads, init_train_state(
        gcfg, plain), opt_cfg)
    lr = float(fm["lr"])
    scale = min(1.0, opt_cfg.grad_clip / float(fm["grad_norm"]))
    # each entry's allowance: a step moves it by lr m_hat / sqrt(v_hat),
    # and a change dm of the first moment m moves that by up to about
    # lr dm / |m|; dm is the slack carried into m.  So 2 lr
    # min(1, dm / |m|), plus M_UPDATE_RTOL lr
    allow, tight = [], 0
    for (_, m) in named_leaves(fstate["m"]):
        u = slack.pop(0)
        a = 2 * lr * torch.clamp((1 - opt_cfg.b1) * scale * u
                                 / m.abs().clamp_min(1e-30), max=1.0)
        a += M_UPDATE_RTOL * lr
        tight += int((a < lr / 2).sum())
        allow.append(a.cpu())
        del u, a
    # the f32 step's masters and the allowances wait in host memory,
    # so that the compressed step has the card as it had before
    plain = tree_map(lambda p: p.cpu(), plain)
    del grads, fstate
    gc.collect()
    torch.cuda.empty_cache()
    dist.all_reduce = spy
    try:
        seen.clear()
        cstep = make_compressed_train_step(gcfg, opt_cfg, dp, ("data",))
        m_sync(dev)
        t0 = time.perf_counter()
        masters, state, metrics = cstep(masters, init_train_state(
            gcfg, masters), mine)
        m_sync(dev)
        step_s = time.perf_counter() - t0
    finally:
        dist.all_reduce = real_ar
    over, update_worst = 0, 0.0
    for (_, p), (_, q), a in zip(named_leaves(masters), named_leaves(plain),
                                 allow):
        d = (p.detach() - q.to(dev)).abs()
        a = a.to(dev)
        over += int((d > a).sum())
        update_worst = max(update_worst, float((d / a).max()))
        del d, a
    out["m2b"] = dict(worst=worst, elements=n_el, step_seconds=step_s,
                      dtypes=sorted(set(seen)), loss=float(metrics["loss"]),
                      lr=lr, over=over, update_worst=update_worst,
                      tight=tight,
                      finite=all(bool(torch.isfinite(v).all()) for _, v in
                                 named_leaves(masters)))
    del plain, allow
    del masters, state, metrics, mine
    gc.collect()
    torch.cuda.empty_cache()

    # ---- M5: the routes where two ranks share a kv head ----------------
    t0 = time.perf_counter()
    out["m5"] = m_split_routes(devs, dev)
    out["m5"]["seconds"] = time.perf_counter() - t0

    # ---- M6: the tensor-parallel MoE route on DTensors -----------------
    t0 = time.perf_counter()
    out["m6"] = m_tp_moe(devs, dev, tp_moe_refs)
    out["m6_seconds"] = time.perf_counter() - t0
    return out


def m_restore_rank(rank, mesh, cfg_m, ckpt_dir, saved_world):
    """M4: the granite masters saved by M2's world restored onto this
    world (TP over its ("model",) axis); every leaf's bits checked
    against the saving ranks' blocks, on the placements asked for."""
    M_CFG.update(cfg_m)
    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch.sharding import param_shardings, placements
    from repro_torch.models.common import map_specs, named_leaves
    from repro_torch.models.model import model_specs

    cfg = m_granite_cfg()
    specs = model_specs(cfg)
    like = map_specs(specs, lambda s: torch.empty(s.shape))
    sh = param_shardings(specs, cfg, mesh)
    t0 = time.perf_counter()
    step, tree = CheckpointManager(ckpt_dir, keep=1).restore(like,
                                                             shardings=sh)
    seconds = time.perf_counter() - t0
    want_pl = {}
    for (k, _), s in zip(named_leaves(like), _flat_shardings(sh)):
        want_pl[k] = tuple(placements(s))
    bad = []
    for k, v in named_leaves(tree):
        if tuple(v.placements) != want_pl[k] or \
                v.to_local().device.type != M_CFG["device_type"]:
            bad.append((k, "placement"))
            continue
        full = v.full_tensor()
        for r, (pl, dig) in enumerate(saved_world[k]):
            if "Shard" in pl:
                dim = int(pl.split("dim=")[1].split(")")[0])
                block = torch.chunk(full, len(saved_world[k]), dim)[r]
            else:
                block = full
            if m_digest(block) != dig:
                bad.append((k, r))
    return dict(step=step, bad=bad, seconds=seconds,
                leaves=len(named_leaves(tree)))


def _flat_shardings(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat_shardings(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _flat_shardings(v)
    else:
        yield tree


# ---- M7: the tensor-parallel MoE train step on a (2, 2) mesh ----------
# A world of its own, 4 ranks over ("data", "model") = (2, 2): a card
# each where there are four (NCCL), else four ranks sharing cuda:0 over
# gloo.  Each step is held against the single-device step on the card,
# made before the world is spawned: (c) the six -smoke configs' whole
# TP step (loss and gradients, M2's limits and the CPU tests' per-leaf
# rule; the card's torch failed this backward on every MoE config before
# the MoE moves were written without accumulating scatters, ROADMAP
# C10), (a) llama4-scout's whole TP step at its published widths, one of
# its 48 layers, bf16 compute on f32 masters (loss and grad norm), and
# (b) deepseek-v2's MoE FFN forward and backward on DTensors (routes
# bitwise, output within M_MOE_RTOL and every gradient within
# M7_GRAD_ULPS bf16 ulps of its leaf's largest |grad|).
M7_PAIR_BATCH = (4, 16)              # the CPU tests' PAIR_B, PAIR_T
# (b): each gradient within 4 bf16 ulps of its leaf's largest |grad|.
# On the (2, 2) mesh an entry is the bf16 sum of rounded partial sums
# over "model" and over "data" (each rounding at most half an ulp of
# the leaf's largest entry, three more than one device rounds), and the
# single-device side rounds once: at most 4 ulps apart
M7_GRAD_ULPS = 4
M7_ZERO_RTOL = 1e-6                  # (c): a top-1 router's zero gradient
# (d): a second DeviceMesh over the same 4 ranks, ("pod", "data",
# "model") = (2, 1, 2), as a batch of one leaves "pod" and "data" free.
# Logits (and each kernel call's q) within M_MOE_RTOL of max |logits| a
# layer of the single-device decode: M6's 2 bf16 ulps for each layer,
# since the stream's sharded sums round again in every layer (gemma3-1b
# at full width, 6 layers: 0.018 of max |logits| on a CPU world, 0.020
# on an H100)
M7_POD = (2, 1, 2)
M7_POD_AXES = ("pod", "data", "model")
# (a): every attention call's q, k and v placed as the JAX package's
# rules place them on ("data", "model"): rows over "data", heads over
# "model" (ROADMAP C15)
M7_ROWS_HEADS = "(Shard(dim=0), Shard(dim=1))"


def m7_devices():
    import torch

    return ([f"cuda:{i}" for i in range(4)]
            if torch.cuda.device_count() >= 4 else ["cuda:0"] * 4)


def m7_train_cfg():
    from repro_torch.configs import get_config

    a = M_CFG["m7_train"]
    return replace(get_config(a["arch"]), n_layers=a["layers"],
                   attn_impl="pallas")


def m7_train_batch(cfg, device):
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train.trainer import to_device

    a = M_CFG["m7_train"]
    return to_device(make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=a["seq"], global_batch=a["batch"],
        seed=0), 0), device)


def m7_pair_batch(cfg, device) -> dict:
    """The CPU tests' batch (``tests/torch_spmd_workers.train_batch``):
    tokens and labels from one numpy generator, mask all ones."""
    import numpy as np
    import torch

    b, t = M7_PAIR_BATCH
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)),
           "labels": rng.integers(0, cfg.vocab_size, (b, t))}
    out = {k: torch.from_numpy(v.astype(np.int32)) for k, v in out.items()}
    out["mask"] = torch.ones((b, t))
    return {k: v.to(device) for k, v in out.items()}


def m7_placed(specs, shardings, dtype, dev, requires_grad: bool):
    """The leaves of ``specs`` drawn as ``materialize_params`` draws them
    (one generator seeded 0, spec order, ``dtype``), each whole on the
    card only while it is placed: the rank keeps its own block of each,
    a copy, so that no leaf's whole storage stays behind."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import device_put
    from repro_torch.models.common import ParamTree, map_specs, \
        storage_dtype

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    order = iter(list(_flat_shardings(shardings)))

    def one(spec):
        whole = spec.materialize(gen, storage_dtype(spec, dtype), dev)
        t = device_put(whole, next(order))
        local = t.to_local().clone()
        out = DTensor.from_local(local, t.device_mesh, t.placements,
                                 run_check=False, shape=t.shape,
                                 stride=t.stride())
        del whole, t
        return out.requires_grad_(requires_grad)

    return ParamTree(map_specs(specs, one))


def m7_ffn_grads(p, x, w, cfg, dtype) -> tuple:
    """``ffn_forward``'s output, its route and the gradients of the
    linear function ``sum(out * w)`` for the rows ``x`` and each weight
    of ``p`` (in ``named_leaves`` order, after the rows')."""
    import torch

    from repro_torch.models import ffn as F
    from repro_torch.models.common import named_leaves

    routes = []
    real_route = F.route
    F.route = lambda c, lg: routes.append(real_route(c, lg)) or routes[-1]
    try:
        y = F.ffn_forward(p, x, cfg, "moe", dtype)
    finally:
        F.route = real_route
    loss = (y.float() * w.float()).sum()
    grads = torch.autograd.grad(loss, [x] + [v for _, v in named_leaves(p)])
    r, = routes
    return y.detach(), r, grads


def _m7_host(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().cpu()


def m7_decode_cfg(arch: str, layers: int):
    from repro_torch.configs import get_config

    return replace(get_config(arch), n_layers=layers)


def m7_decode_inputs(cfg, device, d=None):
    """(cache, tokens) of M7 (d), or of the step whose settings ``d``
    are (M7 (e)): every cache leaf drawn from one generator seeded 1 on
    ``device`` (the same on every rank and in the reference), the tokens
    (batch, steps) from a numpy generator."""
    import numpy as np
    import torch

    from repro_torch.models.decoder import init_cache, map_cache

    d = d or M_CFG["m7_decode"]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    cache = map_cache(init_cache(cfg, d["batch"], d["slots"], device=device),
                      lambda t: torch.randn(t.shape, generator=gen,
                                            device=device).to(t.dtype))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             (d["batch"], d["steps"]))
    return cache, torch.from_numpy(toks.astype(np.int32)).to(device)


@contextlib.contextmanager
def m7_queries():
    """Each decode kernel call's q on plain tensors, as a host copy, in
    the list yielded: the single-device step's, and inside the sharded
    route each rank's own heads."""
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.models import attention as A

    seen, real = [], DO.decode

    def decode(q, *args, **kwargs):
        if not hasattr(q, "placements"):
            seen.append(q.detach().float().cpu())
        return real(q, *args, **kwargs)

    DO.decode = A.decode = decode
    try:
        yield seen
    finally:
        DO.decode = A.decode = real


def m7_decode_steps(params, cache, toks, cfg, place=None, d=None) -> list:
    """M7 (d)'s decode steps (or those of the settings ``d``) from the
    last ``steps`` positions of the cache; ``place(token)`` puts a token
    on the mesh."""
    from repro_torch.models.model import decode_step

    d = d or M_CFG["m7_decode"]
    out = []
    for i in range(d["steps"]):
        tok = toks[:, i:i + 1]
        logits, cache = decode_step(params, cache,
                                    place(tok) if place else tok,
                                    d["slots"] - d["steps"] + i, cfg)
        out.append(logits)
    return out


def m7_decode_dry(arch: str, layers: int) -> dict:
    """The dry run's collectives by op (bytes) of one step of M7 (d)'s
    decode, traced on a fake world of its 4 ranks."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import ShapeCell

    d = M_CFG["m7_decode"]
    return trace_step(m7_decode_cfg(arch, layers),
                      ShapeCell("long", d["slots"], 1, "decode"),
                      int(math.prod(M7_POD)),
                      lambda devs: make_test_mesh(M7_POD, M7_POD_AXES,
                                                  devices=devs)
                      )["collectives"]


def m7_refs(cuda, ref_dir) -> dict:
    """M7's single-device references on the card, each freed before the
    next: (c) each pair config's loss and gradients (host), (a) the
    loss, grad norm, seconds and peak of the llama4-scout step and its
    loss in f32 (a forward, the control), (b)
    deepseek-v2's MoE FFN output, route, row gradient and each weight's
    largest |grad| (host), its weight gradients written to ``ref_dir``,
    one file a leaf, for the ranks to read their blocks of."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.common import named_leaves
    from repro_torch.models.model import cast_params, init_params, loss_fn
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import value_and_grad

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    refs = {"pairs": {}}
    for arch in M_CFG["m7_pairs"]:
        cfg = get_config(arch)
        loss, grads = value_and_grad(init_params(cfg, 0, cuda, masters=True),
                                     m7_pair_batch(cfg, cuda), cfg)
        refs["pairs"][arch] = (float(loss), {k: v.cpu().numpy() for k, v
                                             in named_leaves(grads)})
        del grads
    free()

    cfg = m7_train_cfg()
    masters = init_params(cfg, 0, cuda, masters=True)
    batch = m7_train_batch(cfg, cuda)
    if cuda.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cuda)
    m_sync(cuda)
    t0 = time.perf_counter()
    loss, grads = value_and_grad(masters, batch, cfg)
    gnorm = float(global_norm(grads))
    m_sync(cuda)
    refs["train"] = dict(loss=float(loss), gnorm=gnorm,
                         seconds=time.perf_counter() - t0, peak=m_peak(cuda),
                         params=sum(v.numel() for _, v in
                                    named_leaves(masters)))
    del grads
    free()
    # the control: the same loss in f32, forward only
    cfg = replace(cfg, dtype="float32")
    with torch.no_grad():
        refs["train"]["f32_loss"] = float(loss_fn(cast_params(masters, cfg),
                                                  batch, cfg))
    del masters, batch, loss
    free()

    cfg, p, x = m_moe_inputs(cuda, M_CFG["m7_ffn"], "bfloat16")
    for _, v in named_leaves(p):
        v.requires_grad_(True)
    x.requires_grad_(True)
    # the weights of the linear function whose gradient (b) takes
    w = m_moe_rows(cfg, cuda, torch.bfloat16, seed=2)
    m_sync(cuda)
    t0 = time.perf_counter()
    y, r, grads = m7_ffn_grads(p, x, w, cfg, torch.bfloat16)
    m_sync(cuda)
    seconds = time.perf_counter() - t0
    keys = [k for k, _ in named_leaves(p)]
    refs["ffn"] = dict(out=y.cpu(), dx=grads[0].cpu(), seconds=seconds,
                       route={f: getattr(r, f).cpu()
                              for f in ("top_idx", "keep", "slot")},
                       grad_max={k: float(g.float().abs().max())
                                 for k, g in zip(["x"] + keys, grads)},
                       files={})
    for i, (k, g) in enumerate(zip(keys, grads[1:])):
        path = os.path.join(ref_dir, f"grad_{i}.pt")
        torch.save(g.cpu(), path)
        refs["ffn"]["files"][k] = path
    del p, x, w, y, r, grads
    free()
    refs["decode"] = m7_decode_refs(cuda)
    free()
    refs["mla"] = m7_mla_ref(cuda)
    free()
    return refs


def m7_decode_refs(device) -> dict:
    """M7 (d)'s single-device decode of each configuration on
    ``device``: logits and each decode kernel call's q (host); for the
    control configuration also the logits of the same decode in f32
    (``"f32"``: the same draws, before their bf16 rounding)."""
    import torch

    from repro_torch.models.model import init_params

    d = M_CFG["m7_decode"]
    out = {}
    for arch, layers in d["archs"]:
        cfg = m7_decode_cfg(arch, layers)
        cache, toks = m7_decode_inputs(cfg, device)
        with torch.no_grad(), m7_queries() as qs:
            logits = m7_decode_steps(init_params(cfg, 0, device), cache,
                                     toks, cfg)
        out[arch] = dict(logits=[lg.float().cpu() for lg in logits], q=qs)
        del cache, logits
        if arch == d["control"]:
            cfg = replace(cfg, dtype="float32")
            cache, toks = m7_decode_inputs(cfg, device)
            with torch.no_grad():
                logits = m7_decode_steps(init_params(cfg, 0, device), cache,
                                         toks, cfg)
            out[arch]["f32"] = [lg.cpu() for lg in logits]
            del cache, logits
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def m7_mla_cfg():
    from repro_torch.configs import get_config

    e = M_CFG["m7_mla"]
    return replace(get_config(e["arch"]), n_layers=e["layers"])


def m7_mla_ref(device) -> list:
    """M7 (e)'s single-device decode on ``device``: each step's logits
    (host, f32)."""
    import torch

    from repro_torch.models.model import init_params

    cfg = m7_mla_cfg()
    cache, toks = m7_decode_inputs(cfg, device, M_CFG["m7_mla"])
    with torch.no_grad():
        logits = m7_decode_steps(init_params(cfg, 0, device), cache, toks,
                                 cfg, d=M_CFG["m7_mla"])
    return [lg.float().cpu() for lg in logits]


def m7_down_shares() -> tuple:
    """(flops of one step's latent down-projections, ``q_down`` and
    ``kv_down``, over its whole batch; the ranks of M7's world)."""
    e, cfg = M_CFG["m7_mla"], m7_mla_cfg()
    width = cfg.q_lora_rank + cfg.kv_lora_rank + cfg.qk_rope_dim
    return 2 * e["batch"] * cfg.d_model * width * e["layers"], 4


@contextlib.contextmanager
def m7_down_flops():
    """Inside the context, the flops each rank computes in MLA decode's
    latent down-projections (``attention.model_rows_product``), one
    entry a call in the list yielded, counted by the dry run's counter
    on the rank's local ops."""
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.models import attention as A

    real, seen = A.model_rows_product, []

    def counted(x, w):
        with StepCounter() as counter:
            out = real(x, w)
        seen.append(counter.flops)
        return out

    A.model_rows_product = counted
    try:
        yield seen
    finally:
        A.model_rows_product = real


@contextlib.contextmanager
def m7_attention_placements():
    """Inside the context each call of the flash route on DTensors
    (``flash_attention.ops._attention_local``) appends to the list
    yielded the placements its q, k and v arrive with (``"arrived"``)
    and those ``_head_placements`` gives q and k / v (``"placed"``)."""
    from repro_torch.kernels.flash_attention import ops as FO

    seen, local, heads = [], FO._attention_local, FO._head_placements

    def spied_local(q, k, v, *args):
        seen.append({"arrived": [str(tuple(t.placements))
                                 for t in (q, k, v)]})
        return local(q, k, v, *args)

    def spied_heads(q, n_kv):
        qp, kvp = heads(q, n_kv)
        seen[-1]["placed"] = [str(tuple(qp)), str(tuple(kvp))]
        return qp, kvp

    FO._attention_local, FO._head_placements = spied_local, spied_heads
    try:
        yield seen
    finally:
        FO._attention_local, FO._head_placements = local, heads


def m7_rank(rank, mesh, cfg_m, refs):
    """One rank of M7's world: (c), (a), (b) on the (2, 2) ("data",
    "model") mesh, each freed before the next.  Returns host values."""
    M_CFG.update(cfg_m)
    import numpy as np
    import torch
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.sharding import (NamedSharding, batch_shardings,
                                             device_put, param_shardings)
    from repro_torch.models import ffn as F
    from repro_torch.models.common import named_leaves
    from repro_torch.models.model import ShapeCell, init_params, model_specs
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.devices.flat[rank]
    out = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def full(t) -> float:
        return float(t.full_tensor() if hasattr(t, "full_tensor") else t)

    def start():
        free()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        m_sync(dev)
        return time.perf_counter()

    t_world = time.perf_counter()

    def progress(msg):
        # rank 0 marks each step's start: a rank that fails names it
        if rank == 0:
            log(f"M7 rank 0: {msg}, "
                f"{time.perf_counter() - t_world:.1f} s into the rank")

    # ---- (c): the six -smoke configs' whole TP step --------------------
    out["c"] = {}
    for arch in M_CFG["m7_pairs"]:
        progress(f"(c) {arch}")
        cfg = get_config(arch)
        want_loss, want = refs["pairs"][arch]
        batch = m7_pair_batch(cfg, dev)
        cell = ShapeCell("t", M7_PAIR_BATCH[1], M7_PAIR_BATCH[0], "train")
        params = device_put(init_params(cfg, 0, dev, masters=True),
                            param_shardings(model_specs(cfg), cfg, mesh))
        t0 = start()
        with m_comm_counts() as calls:
            loss, grads = value_and_grad(
                params, device_put(batch, batch_shardings(cfg, cell, mesh,
                                                          batch)), cfg)
        got = {k: _m7_host(v).numpy() for k, v in named_leaves(grads)}
        seconds = time.perf_counter() - t0

        def norm(gs):
            return math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                 for g in gs.values()))

        worst, zero = 0.0, 0.0
        for key, g in got.items():
            if cfg.top_k == 1 and key.endswith("ffn/router"):
                # a top-1 router's exact gradient is zero (its one gate
                # renormalized to 1): both sides are rounding
                zero = max(zero, float(np.abs(g).max()),
                           float(np.abs(want[key]).max()))
                continue
            scale = M_GNORM_RTOL * float(np.abs(want[key]).max())
            err = float(np.abs(g - want[key]).max())
            worst = max(worst, err / scale if scale
                        else math.inf if err else 0.0)
        out["c"][arch] = dict(
            loss=full(loss), want_loss=want_loss, gnorm=norm(got),
            want_gnorm=norm(want), worst=worst,
            zero=zero / (M7_ZERO_RTOL * norm(want)),
            keys_equal=sorted(got) == sorted(want), seconds=seconds,
            comm=m_comm_summary(calls))
        del params, loss, grads, got
    free()

    # ---- (a): llama4-scout's TP step at published widths ----------------
    progress(f"(a) {M_CFG['m7_train']['arch']}")
    cfg = m7_train_cfg()
    specs = model_specs(cfg)
    masters = m7_placed(specs, param_shardings(specs, cfg, mesh),
                        torch.float32, dev, requires_grad=True)
    a = M_CFG["m7_train"]
    cell = ShapeCell("t", a["seq"], a["batch"], "train")
    batch = m7_train_batch(cfg, dev)
    batch = device_put(batch, batch_shardings(cfg, cell, mesh, batch))
    held = sum(v.to_local().numel() * 4 for _, v in named_leaves(masters))
    FK.reset_launches()
    t0 = start()
    with m_comm_counts() as calls, m7_attention_placements() as attn:
        loss, grads = value_and_grad(masters, batch, cfg)
    with implicit_replication():
        gnorm = full(global_norm(grads))
    loss = full(loss)
    m_sync(dev)
    out["a"] = dict(loss=loss, gnorm=gnorm, seconds=time.perf_counter() - t0,
                    peak=m_peak(dev), held=held, comm=m_comm_summary(calls),
                    flash=FK.LAUNCHES["flash_attention"],
                    placements=str(tuple(
                        named_leaves(masters)[0][1].placements)),
                    attention=attn)
    del masters, batch, grads
    free()

    # ---- (b): deepseek-v2's MoE FFN, forward and backward ---------------
    progress(f"(b) {M_CFG['m7_ffn']}")
    ref = refs["ffn"]
    cfg = get_config(M_CFG["m7_ffn"])
    specs = F.moe_specs(cfg)
    p = m7_placed(specs, param_shardings(specs, cfg, mesh), torch.bfloat16,
                  dev, requires_grad=True)
    x, w = (m_moe_rows(cfg, dev, torch.bfloat16, seed) for seed in (1, 2))
    rows = NamedSharding(mesh, ("data",))
    xd = device_put(x.reshape(2, -1, cfg.d_model).requires_grad_(True),
                    rows)
    wd = device_put(w.reshape(2, -1, cfg.d_model), rows)
    del x, w
    t0 = start()
    with implicit_replication(), m_comm_counts() as calls:
        y, r, grads = m7_ffn_grads(p, xd, wd, cfg, torch.bfloat16)
    m_sync(dev)
    seconds = time.perf_counter() - t0
    peak = m_peak(dev)
    y = _m7_host(y).reshape(ref["out"].shape)
    route = {f: _m7_host(getattr(r, f)) for f in ref["route"]}
    dx = _m7_host(grads[0]).reshape(ref["dx"].shape)
    errs = {"x": float((dx.float() - ref["dx"].float()).abs().max())}
    for (key, v), g in zip(named_leaves(p), grads[1:]):
        if tuple(g.placements) != tuple(v.placements):
            g = g.redistribute(g.device_mesh, v.placements)
        _, offset = compute_local_shape_and_global_offset(
            g.shape, g.device_mesh, g.placements)
        block = torch.load(ref["files"][key], mmap=True, weights_only=True)
        local = g.to_local()
        for d, (o, n) in enumerate(zip(offset, local.shape)):
            block = block.narrow(d, o, n)
        errs[key] = float((local.float() - block.to(dev).float())
                          .abs().max())
        del block, local
    out["b"] = dict(
        routes_equal={f: torch.equal(route[f], ref["route"][f])
                      for f in route},
        kept=int(route["keep"].sum()), max_err=float(
            (y.float() - ref["out"].float()).abs().max()),
        ref_max=float(ref["out"].float().abs().max()), errs=errs,
        seconds=seconds, peak=peak, comm=m_comm_summary(calls))
    del p, xd, wd, y, r, grads
    free()

    out["d"] = m7_decode_rank(mesh, dev, progress)
    free()
    progress(f"(e) {M_CFG['m7_mla']['arch']}")
    out["e"] = m7_mla_rank(mesh, dev)
    progress("done")
    return out


def m7_decode_rank(mesh, dev, progress=lambda msg: None) -> dict:
    """M7 (d) on one rank of the world of ``mesh``: each configuration's
    batch-1 decode on a second DeviceMesh over the same ranks, ("pod",
    "data", "model") = ``M7_POD``, placed by the sharding rules: logits
    and each decode kernel call's q (host), the placements of the stream
    entering each block, rank 0's collectives, seconds, launches."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import (batch_shardings,
                                             cache_shardings, device_put,
                                             param_shardings)
    from repro_torch.models import decoder as D
    from repro_torch.models.model import ShapeCell, init_params, model_specs

    pod = make_test_mesh(M7_POD, M7_POD_AXES, devices=list(mesh.devices.flat))
    out = {}
    for arch, layers in M_CFG["m7_decode"]["archs"]:
        progress(f"(d) {arch}, {layers} layers")
        cfg = m7_decode_cfg(arch, layers)
        cache, toks = m7_decode_inputs(cfg, dev)
        cell = ShapeCell("d", M_CFG["m7_decode"]["slots"], 1, "decode")
        streams, real_block = [], D._block_decode

        def block(p, x, *args, **kwargs):
            streams.append(str(tuple(x.placements)))
            return real_block(p, x, *args, **kwargs)

        with torch.no_grad():
            params = device_put(init_params(cfg, 0, dev),
                                param_shardings(model_specs(cfg), cfg, pod))
            cache = device_put(cache, cache_shardings(cfg, cell, pod, cache))
            DK.reset_launches()
            m_sync(dev)
            t0 = time.perf_counter()
            D._block_decode = block
            try:
                with m_comm_counts() as calls, m7_queries() as qs, \
                        implicit_replication():
                    logits = m7_decode_steps(
                        params, cache, toks, cfg, lambda t: device_put(
                            t, batch_shardings(cfg, cell, pod,
                                               {"t": t})["t"]))
                m_sync(dev)
            finally:
                D._block_decode = real_block
            seconds = time.perf_counter() - t0
            out[arch] = dict(
                logits=[_m7_host(lg).float() for lg in logits], q=qs,
                streams=streams, seconds=seconds, comm=m_comm_summary(calls),
                launches=DK.LAUNCHES["decode_attention"])
        del params, cache, logits
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def m7_mla_rank(mesh, dev) -> dict:
    """M7 (e) on one rank of ``mesh``, the (2, 2) ("data", "model")
    world: deepseek-v2's dense first layer decoding M_CFG["m7_mla"]'s
    rows, placed by the sharding rules (the masters drawn leaf by leaf,
    ``m7_placed``): logits (host), the flops of each latent
    down-projection call on this rank, rank 0's collectives, seconds."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.sharding import (batch_shardings,
                                             cache_shardings, device_put,
                                             param_shardings)
    from repro_torch.models.model import ShapeCell, model_specs

    e, cfg = M_CFG["m7_mla"], m7_mla_cfg()
    cell = ShapeCell("d", e["slots"], e["batch"], "decode")
    specs = model_specs(cfg)
    cache, toks = m7_decode_inputs(cfg, dev, e)
    with torch.no_grad():
        params = m7_placed(specs, param_shardings(specs, cfg, mesh),
                           getattr(torch, cfg.dtype), dev, False)
        cache = device_put(cache, cache_shardings(cfg, cell, mesh, cache))
        m_sync(dev)
        t0 = time.perf_counter()
        with m_comm_counts() as calls, m7_down_flops() as flops, \
                implicit_replication():
            logits = m7_decode_steps(
                params, cache, toks, cfg, lambda t: device_put(
                    t, batch_shardings(cfg, cell, mesh, {"t": t})["t"]),
                d=e)
        m_sync(dev)
        seconds = time.perf_counter() - t0
        out = dict(logits=[_m7_host(lg).float() for lg in logits],
                   down=flops, comm=m_comm_summary(calls), seconds=seconds)
    del params, cache, logits
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def m7_mla_dry() -> dict:
    """The dry run's collectives by op (bytes) of one step of M7 (e),
    traced on a fake world of M7's 4 ranks over ("data", "model")."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import ShapeCell

    e = M_CFG["m7_mla"]
    return trace_step(m7_mla_cfg(),
                      ShapeCell("d", e["slots"], e["batch"], "decode"), 4,
                      lambda devs: make_test_mesh((2, 2), ("data", "model"),
                                                  devices=devs)
                      )["collectives"]


def m7_check_mla(outs, refs, smi: str) -> None:
    """M7 (e)'s lines: each rank's logits within M_MOE_RTOL of max
    |logits| a layer of the single-device decode, each rank's latent
    down-projections 1 / 4 of the step's, rank 0's collectives a step
    equal to the dry run's for the same layer and mesh.  Raises on any
    failed check."""
    e = M_CFG["m7_mla"]
    ref = refs["mla"]
    ref_max = max(float(x.abs().max()) for x in ref)
    limit = M_MOE_RTOL * e["layers"]
    whole, ranks = m7_down_shares()
    for rank, o in enumerate(outs):
        g = o["e"]
        err = max(float((a - b).abs().max())
                  for a, b in zip(g["logits"], ref))
        down = sum(g["down"]) // e["steps"]
        log(f"M7 (e) {e['arch']}, {e['layers']} layer (dense MLA + MLP), "
            f"{e['batch']} rows at {e['slots']:,} slots, {e['steps']} "
            f"decode steps on (data, model) = (2, 2), "
            f"{m7_mla_cfg().dtype}, rank {rank}: "
            f"max |err| {err:.4g} of max |logits| {ref_max:.4g} (limit "
            f"{limit:.2g} of it); latent down-projections {down:,} flops a "
            f"step on this rank ({len(g['down']) // e['steps']} calls; the "
            f"step's whole {whole:,} / {ranks} = {whole // ranks:,}); "
            f"{g['seconds']:.2f} s [{smi}]")
        if not (err <= limit * ref_max and down == whole // ranks):
            raise AssertionError(f"M7 (e) rank {rank}: err {err}, down-"
                                 f"projection flops {down}")
    dry = m7_mla_dry()
    dry = {op: [dry["op_counts"][op], b] for op, b in dry["by_op"].items()}
    card = {op: [n / e["steps"], b / e["steps"]]
            for op, (n, b, _) in outs[0]["e"]["comm"].items()}
    log(f"M7 (e) rank 0: {e['steps']} steps, "
        f"{m_comm_line(outs[0]['e']['comm'])}; a step by op [calls, bytes] "
        f"{dict(sorted(card.items()))}, the dry run's for the same layer "
        f"and mesh {dict(sorted(dry.items()))}: "
        f"{'equal' if card == dry else 'different'} [{smi}]")
    if card != dry:
        raise AssertionError(f"M7 (e): rank 0's collectives {card}, the "
                             f"dry run's {dry}")


def m7_check(outs, refs, smi: str) -> None:
    """M7's lines, one a step and rank; raises on any failed check."""
    ref_a = refs["train"]
    for rank, o in enumerate(outs):
        for arch, c in o["c"].items():
            log(f"M7 (c) {arch} TP step on the (2, 2) mesh, f32, rank "
                f"{rank}: loss {c['loss']:.6f} (single device "
                f"{c['want_loss']:.6f}), grad norm {c['gnorm']:.6g} "
                f"({c['want_gnorm']:.6g}); worst leaf {c['worst']:.3g} of "
                f"its limit ({M_GNORM_RTOL} of the leaf's max |grad|); "
                f"{c['seconds']:.2f} s [{smi}]")
            ok = (abs(c["loss"] - c["want_loss"])
                  <= M_LOSS_RTOL * abs(c["want_loss"])
                  and abs(c["gnorm"] - c["want_gnorm"])
                  <= M_GNORM_RTOL * c["want_gnorm"]
                  and c["keys_equal"] and c["worst"] <= 1
                  and c["zero"] <= 1)
            if rank == 0:
                log(f"M7 (c) {arch} rank 0: {m_comm_line(c['comm'])} "
                    f"[{smi}]")
            if not ok:
                raise AssertionError(f"M7 (c) {arch} rank {rank}: {c}")
        a = o["a"]
        loss_err = abs(a["loss"] - ref_a["loss"]) / ref_a["loss"]
        gnorm_err = abs(a["gnorm"] - ref_a["gnorm"]) / ref_a["gnorm"]
        placed = sorted({" / ".join(c.get("placed", ["none"]))
                         for c in a["attention"]})
        arrived = sorted({" / ".join(c["arrived"]) for c in a["attention"]})
        log(f"M7 (a) rank {rank}: loss off the single device's by "
            f"{loss_err:.3g} (limit {M_LOSS_RTOL}), grad norm by "
            f"{gnorm_err:.3g} (limit {M_GNORM_RTOL}); {len(a['attention'])} "
            f"attention calls, q / k / v arrived {arrived}, placed q / kv "
            f"{placed} [{smi}]")
        log(f"M7 (a) {M_CFG['m7_train']['arch']} TP step, "
            f"{M_CFG['m7_train']['layers']} layer(s), published widths, "
            f"B x T = {M_CFG['m7_train']['batch']} x "
            f"{M_CFG['m7_train']['seq']}, rank {rank}: loss {a['loss']:.6f} "
            f"(single device {ref_a['loss']:.6f}), grad norm "
            f"{a['gnorm']:.6g} ({ref_a['gnorm']:.6g}); limits "
            f"{M_LOSS_RTOL} / {M_GNORM_RTOL} relative; step "
            f"{a['seconds']:.2f} s (single device {ref_a['seconds']:.2f} s), "
            f"masters held {a['held'] / 1e9:.2f} GB "
            f"(of {ref_a['params'] * 4 / 1e9:.2f}), placements "
            f"{a['placements']}, peak {a['peak'] / 1e9:.2f} GB (single "
            f"device {ref_a['peak'] / 1e9:.2f}); flash_attention launched "
            f"{a['flash']} times [{smi}]")
        if rank == 0:
            log(f"M7 (a) rank 0: {m_comm_line(a['comm'])} [{smi}]")
            f32 = ref_a["f32_loss"]
            log(f"M7 (a) control, the single device's loss in f32 "
                f"{f32:.6f}: its bf16 loss off it by "
                f"{abs(ref_a['loss'] - f32) / f32:.3g}, rank 0's sharded "
                f"bf16 loss by {abs(a['loss'] - f32) / f32:.3g} [{smi}]")
        if not (abs(a["loss"] - ref_a["loss"]) <= M_LOSS_RTOL * ref_a["loss"]
                and abs(a["gnorm"] - ref_a["gnorm"])
                <= M_GNORM_RTOL * ref_a["gnorm"]):
            raise AssertionError(f"M7 (a) rank {rank}: {a}")
        if a["flash"] <= 0 and M_CFG["device_type"] == "cuda":
            raise AssertionError(f"M7 (a) rank {rank}: flash_attention "
                                 f"never launched")
        b = o["b"]
        # each leaf's error in bf16 ulps of its largest |grad|
        ulps = {k: e / 2.0 ** (math.floor(math.log2(
            refs["ffn"]["grad_max"][k])) - 7) for k, e in b["errs"].items()}
        worst = max(ulps, key=ulps.get)
        log(f"M7 (b) {M_CFG['m7_ffn']} MoE FFN forward and backward on "
            f"DTensors, bf16, rank {rank}: routes bitwise equal to the "
            f"single-device route: {b['routes_equal']} ({b['kept']:,} "
            f"entries kept); max |err| {b['max_err']:.4g} of max |out| "
            f"{b['ref_max']:.4g} (limit {M_MOE_RTOL} of it); gradients: "
            f"worst {ulps[worst]:.4g} bf16 ulps of the leaf's max |grad| "
            f"({worst}; limit {M7_GRAD_ULPS}), rows {ulps['x']:.4g}; "
            f"{b['seconds']:.2f} s (single device "
            f"{refs['ffn']['seconds']:.2f} s), peak {b['peak'] / 1e9:.2f} GB "
            f"[{smi}]")
        if rank == 0:
            log(f"M7 (b) rank 0: {m_comm_line(b['comm'])} [{smi}]")
        if not (all(b["routes_equal"].values())
                and b["max_err"] <= M_MOE_RTOL * b["ref_max"]
                and ulps[worst] <= M7_GRAD_ULPS):
            raise AssertionError(f"M7 (b) rank {rank}: {b} {ulps}")
    m7_check_decode(outs, refs, smi)


def m7_heads(got, want) -> tuple:
    """For each q head of a rank's decode kernel call ``got`` (B, h, D),
    the head of the single-device call ``want`` (B, H, D) nearest to it,
    and the largest of those distances over max |want|."""
    import torch

    err = torch.stack([(got[:, i, None] - want).abs().amax(dim=(0, 2))
                       for i in range(got.shape[1])])      # (h, H)
    best, heads = err.min(dim=1)
    return heads.tolist(), float(best.max() / want.abs().max())


def m7_check_decode(outs, refs, smi: str) -> None:
    """M7 (d)'s lines: each rank's logits within M_MOE_RTOL of max
    |logits| a layer of the single-device decode, every block's stream
    with no partial sum, and each decode kernel call's q heads: the two
    "model" ranks of a pod take different ones, the two "pod" ranks of a
    "model" rank the same.  Raises on any failed check."""
    import numpy as np

    d = M_CFG["m7_decode"]
    for arch, layers in d["archs"]:
        ref = refs["decode"][arch]
        limit = M_MOE_RTOL * layers
        heads = {}
        ref_max = max(float(x.abs().max()) for x in ref["logits"])
        for rank, o in enumerate(outs):
            g = o["d"][arch]
            err = max(float((a - b).abs().max())
                      for a, b in zip(g["logits"], ref["logits"]))
            got = [m7_heads(a, b) for a, b in zip(g["q"], ref["q"])]
            pos = tuple(int(i) for i in np.unravel_index(rank, M7_POD))
            heads[pos] = [h for h, _ in got]
            q_err = max([e for _, e in got] or [0.0])
            partial = sum("Partial" in x for x in g["streams"])
            log(f"M7 (d) {arch}, {layers} layers, batch 1 at {d['slots']:,} "
                f"slots, {d['steps']} decode steps on (pod, data, model) = "
                f"{M7_POD}, {m7_decode_cfg(arch, layers).dtype}, rank "
                f"{rank}: max |err| {err:.4g} of max "
                f"|logits| {ref_max:.4g} (limit {limit:.2g} of it); "
                f"decode_attention {g['launches']} launches, q heads "
                f"{sorted(set(sum(heads[pos], [])))} (nearest "
                f"single-device head within {q_err:.3g} of max "
                f"|q|); {partial} of {len(g['streams'])} block inputs "
                f"partial; {g['seconds']:.2f} s [{smi}]")
            launched = g["launches"] == len(ref["q"]) \
                or M_CFG["device_type"] != "cuda"
            if not (err <= limit * ref_max and partial == 0 and launched
                    and len(g["q"]) == len(ref["q"]) and q_err <= limit):
                raise AssertionError(f"M7 (d) {arch} rank {rank}: err {err}, "
                                     f"{partial} partial, q {q_err}")
        for (p_, d_, m_), per_call in heads.items():
            peer, twin = heads[(p_, d_, 1 - m_)], heads[(1 - p_, d_, m_)]
            for mine, theirs, same in zip(per_call, peer, twin):
                if set(mine) & set(theirs) or mine != same:
                    raise AssertionError(f"M7 (d) {arch}: rank {(p_, d_, m_)}"
                                         f" heads {mine}, its model peer "
                                         f"{theirs}, its pod twin {same}")
        log(f"M7 (d) {arch} rank 0: {d['steps']} steps, "
            f"{m_comm_line(outs[0]['d'][arch]['comm'])} [{smi}]")
        if "f32" in ref:
            # the control: how far bf16 rounding alone moves the logits
            f32_max = max(float(x.abs().max()) for x in ref["f32"])
            alone = max(float((a - b).abs().max())
                        for a, b in zip(ref["logits"], ref["f32"]))
            sharded = max(float((a - b).abs().max()) for a, b in
                          zip(outs[0]["d"][arch]["logits"], ref["logits"]))
            log(f"M7 (d) {arch} control, {layers} layers on one device: "
                f"bf16 against f32 max |err| {alone:.4g} of max |logits| "
                f"{f32_max:.4g} = {alone / f32_max:.4g}, beside rank 0's "
                f"sharded bf16 against the single-device bf16 "
                f"{sharded / ref_max:.4g} [{smi}]")


def m_moe_train(cuda, smi: str) -> dict:
    """M7 in a world of 4 ranks, checked against the single-device runs
    made here first; returns its flash_attention launches."""
    import tempfile

    from repro_torch.launch.mesh import backend, make_test_mesh, spawn

    devices = m7_devices()
    world = make_test_mesh((2, 2), ("data", "model"), devices=devices)
    log(f"M7 SPMD world: 4 ranks on {devices} over {backend(world)}, "
        f"(data, model) = (2, 2) [{smi}]")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    # four ranks' caching allocators share one card: segments that grow
    # in place keep one rank's freed blocks from stranding what another
    # needs (read by each rank's CUDA start)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        with tempfile.TemporaryDirectory(dir=build) as ref_dir:
            t0 = time.perf_counter()
            refs = m7_refs(cuda, ref_dir)
            log(f"M7 single-device references: "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            outs = spawn(m7_rank, world, M_CFG, refs)
            log(f"M7 world: {time.perf_counter() - t0:.1f} s")
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
    m7_check(outs, refs, smi)
    t0 = time.perf_counter()
    steps = M_CFG["m7_decode"]["steps"]
    for arch, layers in M_CFG["m7_decode"]["archs"]:
        dry = m7_decode_dry(arch, layers)
        dry = {op: [dry["op_counts"][op], b] for op, b in dry["by_op"].items()}
        card = {op: [n / steps, b / steps] for op, (n, b, _)
                in outs[0]["d"][arch]["comm"].items()}
        log(f"M7 (d) {arch}: rank 0's collectives a step by op [calls, "
            f"bytes] {dict(sorted(card.items()))}, the dry run's for the "
            f"same layers and mesh {dict(sorted(dry.items()))}: "
            f"{'equal' if card == dry else 'different'}")
    log(f"M7 (d) dry runs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m7_check_mla(outs, refs, smi)
    log(f"M7 (e) dry run: {time.perf_counter() - t0:.1f} s")
    # (a)'s placements last, so that a tree that fails them still
    # reports (b)-(e)
    for rank, o in enumerate(outs):
        placed = {tuple(c.get("placed", ())) for c in o["a"]["attention"]}
        if placed != {(M7_ROWS_HEADS, M7_ROWS_HEADS)}:
            raise AssertionError(f"M7 (a) rank {rank}: attention placed "
                                 f"{placed}, not rows over data and heads "
                                 f"over model")
    return {"flash_attention": sum(o["a"]["flash"] for o in outs),
            "decode_attention": sum(o["d"][a]["launches"] for o in outs
                                    for a, _ in M_CFG["m7_decode"]["archs"])}


def m_spmd(cuda, smi: str) -> dict:
    """Phases M2-M6 in one SPMD world of 2 ranks, checked against the
    single-device runs made here first, then M7 in a world of 4."""
    import tempfile

    import torch

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.mesh import backend, make_test_mesh, spawn
    from repro_torch.models.common import named_leaves
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    devices = m_spmd_devices()
    world = make_test_mesh((2,), ("model",), devices=devices)
    log(f"M2-M6 SPMD world: 2 ranks on {devices} over "
        f"{backend(world)} [{smi}]")

    # single-device references on the card
    cfg = m_granite_cfg()
    masters = init_params(cfg, 0, cuda, masters=True)
    batch = m_granite_batch(cfg, cuda)
    FK.reset_launches()
    m_sync(cuda)
    t0 = time.perf_counter()
    ref_step, state = make_train_step(cfg, OptConfig()), \
        init_train_state(cfg, masters)
    masters, state, ref = ref_step(masters, state, batch)
    ref_loss, ref_gnorm = float(ref["loss"]), float(ref["grad_norm"])
    m_sync(cuda)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_step(masters, state, batch)
    m_sync(cuda)
    ref_warm = time.perf_counter() - t0
    del masters, batch, ref, state
    gc.collect()
    torch.cuda.empty_cache()
    mcfg, p, x = m_moe_inputs(cuda)
    y, route, _ = m_moe_route(p, x, mcfg, torch.bfloat16)
    moe_ref = (y, route["top_idx"])
    del p, x, y, route
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_moe_refs = m_tp_moe_refs(cuda)
    log(f"M6 single-device references: {time.perf_counter() - t0:.1f} s")

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckpt_dir:
        t0 = time.perf_counter()
        outs = spawn(m_rank, world, M_CFG, ckpt_dir, moe_ref, tp_moe_refs)
        world_s = time.perf_counter() - t0
        m2 = [o["m2"] for o in outs]
        for r, o in enumerate(m2):
            ok = (abs(o["loss"] - ref_loss) <= M_LOSS_RTOL * ref_loss
                  and abs(o["gnorm"] - ref_gnorm) <= M_GNORM_RTOL * ref_gnorm)
            ctl = abs(o["control_loss"] - ref_loss) <= M_LOSS_RTOL * ref_loss
            log(f"M2 granite-8b TP rank {r}: loss {o['loss']:.6f} (single "
                f"device {ref_loss:.6f}), grad norm {o['gnorm']:.6g} "
                f"({ref_gnorm:.6g}); limits {M_LOSS_RTOL} / {M_GNORM_RTOL} "
                f"relative; control without the row-parallel all-reduce: "
                f"loss {o['control_loss']:.6f}; step {o['seconds']:.2f} s "
                f"(single device {ref_s:.2f} s), warm step "
                f"{o['warm_seconds']:.2f} s (single device {ref_warm:.2f} "
                f"s), masters held "
                f"{o['held'] / 1e9:.2f} GB, peak "
                f"{o['peak'] / 1e9:.2f} GB; flash_attention launched "
                f"{o['flash']} times [{smi}]")
            if not ok or ctl:
                raise AssertionError(f"M2 rank {r}: sharded step or control "
                                     f"against the single-device step: {o}")
            if o["flash"] <= 0 and M_CFG["device_type"] == "cuda":
                raise AssertionError(f"M2 rank {r}: flash_attention never "
                                     f"launched")
        for r, o in enumerate(outs):
            m3 = o["m3"]
            log(f"M3 llama4-scout MoE FFN rank {r}: routes equal "
                f"moe_forward's: {m3['routes_equal']} ({m3['n_routes']} "
                f"calls); max |err| {m3['max_err']:.4g} of max |out| "
                f"{m3['ref_max']:.4g} (limit {M_MOE_RTOL} of it); repeat "
                f"bitwise: {m3['repeat_bitwise']}; seconds "
                f"{m3['seconds']} [{smi}]")
            if not (m3["routes_equal"] and m3["repeat_bitwise"]
                    and m3["max_err"] <= M_MOE_RTOL * m3["ref_max"]):
                raise AssertionError(f"M3 rank {r}: {m3}")
            b = o["m2b"]
            log(f"M2 gemma3-1b compressed step rank {r}: reduced gradients "
                f"within atol 1e-2 / rtol 2e-2 of the f32 all-reduce (worst "
                f"{b['worst']:.4f} of the allowance over {b['elements']:,} "
                f"elements); the update against the uncompressed f32 step's "
                f"at lr {b['lr']:.3g}: {b['over']} entries over their "
                f"allowance (worst {b['update_worst']:.4f} of it), "
                f"{b['tight']:,} entries held below lr / 2; the step's "
                f"collectives {b['dtypes']}; loss {b['loss']:.4f}; step "
                f"{b['step_seconds']:.2f} s [{smi}]")
            if b["worst"] > 1 or b["dtypes"] != ["bfloat16"] \
                    or not b["finite"] or b["over"] \
                    or b["tight"] < b["elements"] / 2:
                raise AssertionError(f"M2 compressed rank {r}: {b}")
            m5 = o["m5"]
            log(f"M5 {M_SPLIT['arch']} at {M_SPLIT['heads'][0]} q / "
                f"{M_SPLIT['heads'][1]} kv heads, f32, rank {r}, worst "
                f"ratio to the CPU tests' limit (rtol = atol = "
                f"{M_SPLIT_TOL}) against the single-device step on the "
                f"card: decode over the kv head's key shards at batch "
                f"{M_SPLIT['decode_batch']} {m5['decode_keys']['worst']:.3g}"
                f", over slot shards at batch 1 "
                f"{m5['decode_slots']['worst']:.3g} (cache "
                f"{m5['decode_slots']['placements']}); forward over zig-zag "
                f"query chunks {m5['forward']:.3g}, loss {m5['loss']:.3g}, "
                f"{m5['n_grads']} gradients {m5['grads']:.3g}; launches "
                f"{m5['launches']}; {m5['seconds']:.1f} s [{smi}]")
            worst = max(m5["decode_keys"]["worst"],
                        m5["decode_slots"]["worst"], m5["forward"],
                        m5["loss"], m5["grads"])
            if not worst <= 1 \
                    or "Shard(dim=2)" not in m5["decode_slots"]["placements"] \
                    or "Shard(dim=1)" in m5["decode_keys"]["placements"]:
                raise AssertionError(f"M5 rank {r}: {m5}")
            if M_CFG["device_type"] == "cuda" \
                    and not all(m5["launches"].values()):
                raise AssertionError(f"M5 rank {r}: a kernel never "
                                     f"launched: {m5['launches']}")
            for m6 in o["m6"]:
                log(f"M6 ({m6['label']}) {m6['arch']} tensor-parallel "
                    f"moe_forward on DTensors, {m6['dtype']}, "
                    f"{m6['experts']} experts, top {m6['top_k']}, "
                    f"(data, model) mesh {m6['mesh']}, rank {r}: "
                    f"top_idx {m6['shape']} (local {m6['local']}, "
                    f"{m6['placements']}); routes bitwise equal to the "
                    f"single-device route: {m6['routes_equal']} "
                    f"({m6['kept']:,} entries kept); max |err| "
                    f"{m6['max_err']:.4g} of max |out| {m6['ref_max']:.4g} "
                    f"(limit {m6['limit']} of it); {m6['seconds']:.2f} s, "
                    f"peak {m6['peak'] / 1e9:.2f} GB [{smi}]")
                # on the (2, 1) mesh each rank routes its own half of
                # the rows
                split = m6["local"][0] * m6["mesh"][0] == m6["shape"][0] \
                    and (m6["mesh"][0] == 1
                         or "Shard(dim=0)" in m6["placements"])
                if r == 0:
                    log(f"M6 ({m6['label']}) rank 0: "
                        f"{m_comm_line(m6['comm'])} [{smi}]")
                if not (all(m6["routes_equal"].values()) and split
                        and m6["max_err"] <= m6["limit"] * m6["ref_max"]):
                    raise AssertionError(f"M6 rank {r}: {m6}")
            log(f"M6 rank {r}: {o['m6_seconds']:.1f} s, the weights' draws "
                f"and placement included [{smi}]")
        saved = {}
        for o in outs:
            for k, v in o["digests"].items():
                saved.setdefault(k, []).append(v)
        worlds = [make_test_mesh((1,), ("model",), devices=devices[:1])]
        if torch.cuda.device_count() >= 2:
            worlds.append(world)
        for w in worlds:
            res = spawn(m_restore_rank, w, M_CFG, ckpt_dir, saved)
            for r, o in enumerate(res):
                if o["step"] != 1 or o["bad"]:
                    raise AssertionError(f"M4 restore onto {w.size}: {o}")
            log(f"M4 restore: {res[0]['leaves']} leaves saved by the world "
                f"of 2 (save {outs[0]['save_seconds']:.1f} s) restored onto "
                f"a world of {w.size} in {res[0]['seconds']:.1f} s, every "
                f"leaf bitwise equal on the placements asked for [{smi}]")
    log(f"M2-M6 world: {world_s:.1f} s")
    m7 = m_moe_train(cuda, smi)
    return {"flash_attention": sum(o["m2"]["flash"]
                                   + o["m5"]["launches"]["flash_attention"]
                                   for o in outs) + m7["flash_attention"],
            "decode_attention": sum(o["m5"]["launches"]["decode_attention"]
                                    for o in outs) + m7["decode_attention"]}


M_KERNELS = (
    ("filter_scan_batch", FILTER_SCAN_CU,
     "src/repro/kernels/filter_project/kernel.py:122", "filter_scan_batch"),
    ("filter_scan", FILTER_SCAN_CU,
     "src/repro/kernels/filter_project/kernel.py:57", "filter_scan"),
    ("parse_i32", CSV_PARSE_CU,
     "src/repro/kernels/filter_project/kernel.py:179", "parse_fields"),
    ("decode_attention", DECODE_CU,
     "src/repro/kernels/decode_attention/kernel.py:78", "decode_attention"),
    ("flash_attention", FLASH_CU,
     "src/repro/kernels/flash_attention/kernel.py:90", "flash_attention"))


def sharded_phase(cuda, smi: str) -> dict:
    """Phase M: M1, then M2-M7; returns the launches of the sharded
    paths by kernel."""
    launches = m_relational(cuda, smi)
    launches.update(m_spmd(cuda, smi))
    return launches


# ---------------------------------------------------------------------------
# phase D: the multi-device dry run, and its counts against the card's
# ---------------------------------------------------------------------------
D_CELL = ("granite-8b", "decode_32k")       # D1, at full size, 256 ranks
D_LAYERS = 4                                # of granite-8b's 36, D2-D3
D_DECODE = (8, 1024)                        # D2: batch, cache slots
D_PREFILL = (2, 256)                        # D3: batch, tokens
D_TIMEOUT_S = 300


def dryrun_cell(smi: str) -> dict:
    """D1: one cell of the dry run as a user runs it (``python -m
    repro_torch.launch.dryrun``, a process of its own, since the fake
    process group belongs to its process), read back from its report."""
    arch, shape = D_CELL
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--force"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=D_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    path = (ROOT / "reports" / "dryrun_torch"
            / f"{arch}__{shape}__pod16x16.json")
    if out.returncode != 0 or not path.exists():
        raise AssertionError(f"D1: the dry run failed (exit "
                             f"{out.returncode}): {out.stderr[-2000:]}")
    rep = json.loads(path.read_text())
    if rep["status"] != "ok" or rep["chips"] != 256 \
            or rep["kernel_calls"] != {"decode_attention": 36}:
        raise AssertionError(f"D1: {arch} {shape}: status {rep['status']} "
                             f"{rep.get('error')}, kernel calls "
                             f"{rep.get('kernel_calls')}")
    r = rep["roofline"]
    log(f"D1 dry run {arch} {shape} pod16x16 ({rep['chips']} fake ranks, "
        f"{seconds:.1f} s with the process's start): flops/device "
        f"{rep['flops_per_device']:.6g}, bytes/device "
        f"{rep['bytes_accessed_per_device']:.6g}, collective bytes/device "
        f"{rep['collective_bytes_per_device']:.6g} {rep['collectives']}, "
        f"peak estimate {rep['memory']['peak_bytes_per_device_est']:.6g} B; "
        f"roofline on the {r['device']} peaks: compute {r['compute_s']} s, "
        f"memory {r['memory_s']} s, collective {r['collective_s']} s, "
        f"dominant {r['dominant']}, MFU bound {r['roofline_fraction_mfu']} "
        f"[{smi}]")
    return rep


def dryrun_parity(device, smi: str) -> dict:
    """D2-D3: granite-8b at full width, D_LAYERS layers, one decode step
    at a full cache (D2) and one forward (D3) on the card under
    ``FlopCounterMode``, then the same steps traced by the dry run on a
    1 x 1 fake mesh: the flop totals must be equal, and the trace's calls
    of each kernel's custom operator must equal the wrapper's launches on
    the card.  Returns the launches on the card by kernel."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import ShapeCell, decode_step, forward, init_params
    from repro_torch.models.decoder import init_cache

    cfg = replace(get_config("granite-8b"), n_layers=D_LAYERS)
    params = init_params(cfg, SERVE_SEED, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SERVE_SEED)
    (b_dec, slots), (b_pre, t_pre) = D_DECODE, D_PREFILL
    cache = init_cache(cfg, b_dec, slots, device=device)
    token = torch.randint(0, cfg.vocab_size, (b_dec, 1), generator=gen,
                          device=device, dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (b_pre, t_pre), generator=gen,
                           device=device, dtype=torch.int32)
    cases = (
        ("D2 decode", ShapeCell("decode", slots, b_dec, "decode"),
         lambda: decode_step(params, cache, token, slots - 1, cfg)[0]),
        ("D3 prefill", ShapeCell("prefill", t_pre, b_pre, "prefill"),
         lambda: forward(params, tokens, cfg)))
    launches = {}
    for label, cell, step in cases:
        DK.reset_launches()
        FK.reset_launches()
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            out = step()
        torch.cuda.synchronize()
        real = {k: v for k, v in {**DK.LAUNCHES, **FK.LAUNCHES}.items()
                if v}
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{label}: non-finite logits on the card")
        fake = trace_step(cfg, cell, 1, lambda devices: make_test_mesh(
            (1, 1), ("data", "model"), devices=devices))
        if fake["flops"] != fc.get_total_flops() \
                or fake["kernel_calls"] != real:
            raise AssertionError(
                f"{label}: the card counted {fc.get_total_flops()} flops and "
                f"launched {real}; the dry run counted {fake['flops']} flops "
                f"and called {fake['kernel_calls']}")
        for k, v in real.items():
            launches[k] = launches.get(k, 0) + v
        log(f"{label}: granite-8b, {D_LAYERS} of 36 layers, {cell.step} "
            f"batch {cell.global_batch} x {cell.seq_len}: {fake['flops']} "
            f"flops on the card and in the 1 x 1 dry run, equal; kernels "
            f"{real} launched on the card and traced, equal; trace "
            f"{fake['trace_seconds']:.2f} s [{smi}]")
        del out
    return launches


# D4: falcon-mamba-7b at full width, D_SSM_LAYERS of its 64 layers, a
# prefill of D_PREFILL; the scan operators' bitwise checks at the shapes
# its path gives ssm_scan and at recurrentgemma-9b's width for rglru_scan
D_SSM_LAYERS = 4
# the time scans: custom operators under a trace, not kernels (their
# implementation is the plain loop on any device)
SCAN_OPERATORS = (
    ("ssm_scan", "src/repro_torch/models/scan_ops.py",
     "src/repro/models/ssm.py:50"),
    ("rglru_scan", "src/repro_torch/models/scan_ops.py",
     "src/repro/models/rglru.py:47"))
# filled by D4: one entry a scan operator, printed on a line of its own
OPERATOR_ROWS: list = []


def scan_operators_bitwise(device, b: int, t: int) -> dict:
    """Each scan operator on CUDA tensors (bf16, seeded) against its
    plain loop: the output and every input's gradient must be bitwise
    equal.  ssm_scan at falcon-mamba-7b's d_inner and state, rglru_scan at
    recurrentgemma-9b's width.  Returns the largest |difference| of each
    (0.0 when equal) and the loop's CUDA-event ms."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.models import scan_ops

    class Passthrough(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    ssm_cfg, lru_cfg = get_config("falcon-mamba-7b"), \
        get_config("recurrentgemma-9b")
    di, st, w = ssm_cfg.d_inner, ssm_cfg.ssm_state, lru_cfg.lru_width_actual
    gen = torch.Generator(device=device)
    gen.manual_seed(SERVE_SEED)
    bf16 = torch.bfloat16
    ssm_in = [torch.nn.functional.softplus(_randn((b, t, di), bf16, device,
                                                  gen)),
              _randn((b, t, st), bf16, device, gen),
              _randn((b, t, st), bf16, device, gen),
              _randn((b, t, di), bf16, device, gen),
              -torch.exp(_randn((di, st), bf16, device, gen)),
              _randn((di,), bf16, device, gen)]
    lru_in = [torch.sigmoid(_randn((b, t, w), bf16, device, gen) + 2.0),
              _randn((b, t, w), bf16, device, gen)]
    out = {}
    for name, wrapper, loop, inputs in (
            ("ssm_scan", scan_ops.ssm_scan, scan_ops.ssm_scan_loop, ssm_in),
            ("rglru_scan", scan_ops.rglru_scan, scan_ops.rglru_scan_loop,
             lru_in)):
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        want = loop(*leaves)
        g = _randn(tuple(want.shape), bf16, device, gen)
        want_grads = torch.autograd.grad(want, leaves, g)
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        with Passthrough():
            got = wrapper(*leaves)
            if f"repro_torch_{name}" not in type(got.grad_fn).__name__:
                raise AssertionError(f"D4: {name} did not take its "
                                     f"operator under a dispatch mode")
            grads = torch.autograd.grad(got, leaves, g)
        err = max(float((a.detach().float() - b_.detach().float()).abs().max())
                  for a, b_ in zip((got,) + grads, (want,) + want_grads))
        if not (torch.equal(got, want)
                and all(torch.equal(a, b_)
                        for a, b_ in zip(grads, want_grads))):
            raise AssertionError(f"D4: {name}'s operator on CUDA tensors "
                                 f"differs from its plain loop (largest "
                                 f"|difference| {err})")
        with torch.no_grad():
            ms = time_ms(lambda: loop(*inputs), reps=5, warmup=1)
        out[name] = {"max_abs_err": err, "loop_ms": ms,
                     "shape": [tuple(x.shape) for x in inputs]}
    return out


def dryrun_ssm(device, smi: str) -> None:
    """D4: falcon-mamba-7b at full width, D_SSM_LAYERS layers, a prefill
    of D_PREFILL on the card under ``FlopCounterMode`` (the time scans
    take their operator ``repro_torch::ssm_scan`` there, whose
    implementation is the plain loop), then the same step traced by the
    dry run on a 1 x 1 fake mesh: the flop totals must be equal, the
    operator's traced calls must equal the card run's, and its flops
    the formula's.  Then the scan operators against their plain loops on
    CUDA tensors, bitwise (:func:`scan_operators_bitwise`)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import ShapeCell, forward, init_params
    from repro_torch.models import scan_ops

    cfg = replace(get_config("falcon-mamba-7b"), n_layers=D_SSM_LAYERS)
    b, t = D_PREFILL
    params = init_params(cfg, SERVE_SEED, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SERVE_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device=device, dtype=torch.int32)
    scan_ops.reset_calls()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        out = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    calls = scan_ops.CALLS["ssm_scan"]
    if not bool(torch.isfinite(out.float()).all()) \
            or tuple(out.shape) != (b, t, cfg.vocab_size):
        raise AssertionError(f"D4: logits {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out.float()).all())}")
    op_flops = fc.get_flop_counts()["Global"].get(
        torch.ops.repro_torch.ssm_scan, 0)
    formula = D_SSM_LAYERS * scan_ops.ssm_scan_flops(
        (b, t, cfg.d_inner), (b, t, cfg.ssm_state), (b, t, cfg.ssm_state),
        (b, t, cfg.d_inner), (cfg.d_inner, cfg.ssm_state), (cfg.d_inner,))
    fake = trace_step(cfg, ShapeCell("prefill", t, b, "prefill"), 1,
                      lambda devices: make_test_mesh(
                          (1, 1), ("data", "model"), devices=devices))
    if calls != D_SSM_LAYERS or fake["operator_calls"] != {"ssm_scan": calls} \
            or fake["flops"] != fc.get_total_flops() or op_flops != formula:
        raise AssertionError(
            f"D4: the card ran ssm_scan {calls} times for {op_flops} of "
            f"{fc.get_total_flops()} flops (formula {formula}); the dry "
            f"run called {fake['operator_calls']} for {fake['flops']} flops")
    log(f"D4 prefill: falcon-mamba-7b, {D_SSM_LAYERS} of 64 layers, batch "
        f"{b} x {t}: {fake['flops']} flops on the card and in the 1 x 1 dry "
        f"run, equal; ssm_scan {calls} calls on the card and traced, equal, "
        f"{op_flops} flops (2 B T di st a layer); trace "
        f"{fake['trace_seconds']:.2f} s [{smi}]")
    del out, params
    gc.collect()
    torch.cuda.empty_cache()
    checks = scan_operators_bitwise(device, b, t)
    for name, src, line in SCAN_OPERATORS:
        c = checks[name]
        log(f"D4 {name} on CUDA tensors {c['shape'][0]} bf16: operator = "
            f"plain loop, output and gradients bitwise; the loop "
            f"{c['loop_ms']:.2f} ms (CUDA events) [{smi}]")
        OPERATOR_ROWS.append(dict(
            name=name, kernel=False, route="custom operator (plain loop)",
            source=src, replaces=line,
            calls=calls if name == "ssm_scan" else 0,
            traced_calls=fake["operator_calls"].get(name, 0),
            flops=op_flops if name == "ssm_scan" else 0,
            max_abs_err=c["max_abs_err"], loop_ms=c["loop_ms"]))


def dryrun_phase(cuda, smi: str) -> dict:
    """Phase D: D1, then D2-D3, then D4; returns the card's launches by
    kernel."""
    dryrun_cell(smi)
    launches = dryrun_parity(cuda, smi)
    dryrun_ssm(cuda, smi)
    return launches


# ---------------------------------------------------------------------------
# phase P: the engine's property suites on the card
# ---------------------------------------------------------------------------
P_FAULT_SEEDS = (0, 1, 2)          # FAULT_SEED values of P4
P_SOAK_WINDOWS = 12                # P4's soak windows a seed
P_MQO_BATCHES = 8                  # P3's seeded batches a seed (seeds 0, 1)


def p_props():
    """``tests/torch_properties.py``: the CPU suites' seeded draws."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_properties

    return torch_properties


def p_bitwise(a, b, label: str) -> None:
    """Two runs on one device: every column bitwise equal."""
    props = p_props()
    try:
        props.assert_tables_bit_identical(a, b)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None


def p_launches(K, before: dict) -> dict:
    return {k: K.LAUNCHES[k] - before.get(k, 0) for k in K.LAUNCHES}


def p_fused(device) -> dict:
    """P1: fused = eager (``TestFusedEqualsEager``'s chains, the
    deferred-sync draws and the two estimate overflows, which recompact;
    ``TestUnionDeferred``'s unions) and batched = per-query
    (``TestWindowBatchIdentity``'s windows), over columnar and CSV and
    both kernel routes, each table also against the port's CPU run of
    the same draw."""
    import torch
    from repro_torch.relational import ExecContext, execute

    props, cpu = p_props(), torch.device("cpu")
    cases = 0

    def check(st, plan, label, multiset=False, **kw):
        nonlocal cases
        eager = execute(plan, props.eager_ctx(st, device))
        got = execute(plan, ExecContext(catalog={"t": st}, device=device,
                                        **kw))
        want = execute(plan, props.eager_ctx(st, cpu))
        if multiset:     # as test_estimate_overflow_eager_ops compares
            if not eager.row_multiset() == got.row_multiset() == \
                    want.row_multiset():
                raise AssertionError(f"{label}: rows differ")
        else:
            p_bitwise(eager, got, label)
            compare_tables(got, want, f"{label} vs cpu")
        cases += 1
        return got

    for fmt in ("columnar", "csv"):
        for pallas in (False, True):
            for i, (st, _, plan) in enumerate(props.chain_draws(fmt,
                                                                pallas)):
                check(st, plan, f"P1 chain {fmt} {pallas} {i}",
                      use_pallas_filter=pallas)
        for i, (st, cm, plan) in enumerate(props.deferred_draws(fmt)):
            check(st, plan, f"P1 deferred {fmt} {i}", cost_model=cm,
                  scan_cache={})
    overflows = 0
    for i, (st, cm, plan, multiset) in enumerate(props.overflow_cases()):
        got = check(st, plan, f"P1 overflow {i}", multiset, cost_model=cm)
        # the estimate was ~0 rows; the filter kept more than 700
        if not multiset and got.nrows <= 700:
            raise AssertionError("P1: the estimate did not overflow")
        overflows += 1
    for i, (st, cm, plan) in enumerate(props.union_draws()):
        check(st, plan, f"P1 union {i}", cost_model=cm)
    windows = 0
    for fmt in ("columnar", "csv"):
        for pallas in (False, True):
            batched, perq = props.window_sessions(fmt, pallas, device)
            ref, _ = props.window_sessions(fmt, pallas, cpu)
            for w in range(3):
                rb = batched.run_batch(props.mixed_window(batched, w),
                                       mqo=False)
                rp = perq.run_batch(props.mixed_window(perq, w), mqo=False)
                rc = ref.run_batch(props.mixed_window(ref, w), mqo=False)
                if rb.metrics.batched_dispatches < 1 or \
                        rb.metrics.batched_queries != 4:
                    raise AssertionError(f"P1 window {fmt} {pallas} {w}: "
                                         f"the template was not batched")
                for j, (a, b, c) in enumerate(zip(rb.results, rp.results,
                                                  rc.results)):
                    label = f"P1 window {fmt} {pallas} {w}.{j}"
                    p_bitwise(a.table, b.table, label)
                    compare_tables(a.table, c.table, f"{label} vs cpu")
                windows += 1
    return dict(cases=cases, windows=windows, overflows=overflows)


def p_budgets(device) -> dict:
    """P2: tiny budget = unlimited budget.  The memory suite's stream
    (``shared_batch``, CSV, 20,000 rows) on a session whose CE pool is
    then pressed to the host tier (``MemoryManager._make_room`` of the
    whole device budget, as the resilience soak's pulse does): every
    CE leaves the card as a host copy; the next pass reads them and
    promotes them back.  Tables bitwise equal to an unlimited session's,
    and, at the 128-byte budget that drops everything, to it as well."""
    props = p_props()
    sess = props.memory_session(1 << 26, device, fmt="csv", nrows=20_000)
    big = props.memory_session(1 << 30, device, fmt="csv", nrows=20_000)
    pool = sess.memory.pools["ce"]
    spilled = []
    spill = pool.spill_fn

    def spy(table):
        host = spill(table)
        spilled.append((table, host))
        return host

    pool.spill_fn = spy
    want = [r.table for r in big.run_batch(props.shared_batch(big),
                                           mqo=True).results]
    cold = sess.run_batch(props.shared_batch(sess), mqo=True)
    sess.memory._make_room(sess.memory.device_budget)
    host = [e for e in pool.entries.values() if e.tier == "host"]
    if not spilled or not host or any(
            a.device.type != "cpu" for e in host
            for a in e.payload.columns.values()):
        raise AssertionError("P2: no CE reached the host tier as CPU "
                             "tensors")
    for src, dst in spilled:
        for name, a in dst.columns.items():
            b = src.columns[name]
            if a.device.type != "cpu" or b.device.type != device.type:
                raise AssertionError(f"P2: spill {b.device} -> {a.device}")
            if device.type == "cuda" and a.data_ptr() == b.data_ptr():
                raise AssertionError("P2: the host copy is the card's")
    promotions = pool.stats.promotions
    warm = sess.run_batch(props.shared_batch(sess), mqo=True)
    promoted = pool.stats.promotions - promotions
    back = [e for e in pool.entries.values() if e.tier == "device"]
    if promoted <= 0 or not back or any(
            a.device.type != device.type for e in back
            for a in e.payload.columns.values()):
        raise AssertionError(f"P2: {promoted} promotions, not back on "
                             f"{device}")
    for run in (cold, warm):
        for i, (r, w) in enumerate(zip(run.results, want)):
            p_bitwise(r.table, w, f"P2 query {i}")
    tiny = props.memory_session(128, device)
    huge = props.memory_session(1 << 30, device)
    cases = 2 * len(want)
    for _ in range(2):
        rt = tiny.run_batch(props.shared_batch(tiny), mqo=True)
        rh = huge.run_batch(props.shared_batch(huge), mqo=True)
        for i, (a, b) in enumerate(zip(rt.results, rh.results)):
            p_bitwise(a.table, b.table, f"P2 tiny {i}")
            cases += 1
    if tiny.memory.device_used > 128:
        raise AssertionError("P2: the tiny budget was exceeded")
    return dict(cases=cases, spills=len(spilled), host_entries=len(host),
                promotions=promoted)


def p_mqo(device) -> dict:
    """P3: MQO never changes results.  ``fuzz_batches`` (the seeded
    draws of ``TestPropertyMQONeverChangesResults``'s space): mqo=True
    = mqo=False on the card, each table and the MQO decisions equal to
    the port's CPU run; then windowed ``submit`` = ``run_batch``."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.core.fingerprint import strict_fingerprint
    from repro_torch.relational import QueryService

    # the suite hands the sessions raw plans, a deprecated form
    warnings.filterwarnings("ignore", "passing raw logical.Node",
                            DeprecationWarning)
    props, cpu = p_props(), torch.device("cpu")
    sess, ref = props.fuzz_session(device), props.fuzz_session(cpu)
    batches = selected = 0
    for seed in (0, 1):
        for queries, budget_log2 in props.fuzz_batches(seed, P_MQO_BATCHES):
            base = sess.run_batch(queries, mqo=False)
            opt = sess.run_batch(queries, mqo=True,
                                 budget_bytes=1 << budget_log2)
            ref.run_batch(queries, mqo=False)
            want = ref.run_batch(queries, mqo=True,
                                 budget_bytes=1 << budget_log2)
            for i, (b, o, w) in enumerate(zip(base.results, opt.results,
                                              want.results)):
                label = f"P3 seed {seed} batch {batches} query {i}"
                if b.table.row_multiset() != o.table.row_multiset():
                    raise AssertionError(f"{label}: MQO changed the rows")
                compare_tables(o.table, w.table, f"{label} vs cpu")
            if props.batch_decisions(opt, strict_fingerprint) != \
                    props.batch_decisions(want, strict_fingerprint):
                raise AssertionError(f"P3 batch {batches}: MQO decisions "
                                     f"differ from the CPU's")
            selected += opt.mqo.report.n_selected
            batches += 1
    rng = np.random.default_rng(3)
    windowed = 0
    for queries, _ in props.fuzz_batches(2, 4):
        max_batch = int(rng.integers(1, 7))
        base = sess.run_batch(queries, mqo=True)
        svc = QueryService(sess, max_batch=max_batch)
        handles = [svc.submit(q) for q in queries]
        svc.flush()
        for i, (b, h) in enumerate(zip(base.results, handles)):
            if not h.done or \
                    b.table.row_multiset() != h.result().row_multiset():
                raise AssertionError(f"P3 window {max_batch} query {i}: "
                                     f"submit differs from run_batch")
        windowed += 1
    if not selected:
        raise AssertionError("P3: no batch selected a CE")
    return dict(batches=batches, selected_ces=selected, windowed=windowed)


def p_faults(device) -> dict:
    """P4: successes under injected faults = the fault-free run, for
    FAULT_SEED 0, 1, 2: ``test_resilience.py``'s schedules (scan_h2d,
    kernel_launch, batched_launch, ce_admission, window_close),
    spill_to_host at rate 1.0 under a pressure pulse, pid_pool at rate
    1.0, and its soak's rates over P_SOAK_WINDOWS windows.  Every
    successful table equals the fault-free card run's and the port's
    CPU run's; faults were injected; every degradation event is an
    injected fault's (on the card a real error gives up at once)."""
    import random

    import torch

    from repro_torch.core.faults import FAULT_POINTS
    from repro_torch.relational import QueryService

    props, cpu = p_props(), torch.device("cpu")
    ref = props.res_session(device)
    ref_cpu = props.res_session(cpu)
    injected = events = runs = 0

    def check(batch, base, want, label):
        nonlocal events, runs
        evs = batch.resilience.get("events", [])
        injected_here = any("InjectedFault" in e.get("error", "")
                            or e.get("point") in FAULT_POINTS for e in evs)
        for e in evs:
            events += 1
            # a CE poisoned by an injected fault sends its other
            # consumers to their residual plans without the cause
            if not ("InjectedFault" in e.get("error", "")
                    or e.get("point") in FAULT_POINTS
                    or (e["action"] == "fallback" and injected_here)):
                raise AssertionError(f"{label}: a real error degraded: {e}")
        for i, (r, b, w) in enumerate(zip(batch.results, base.results,
                                          want.results)):
            if r is not None:
                p_bitwise(r.table, b.table, f"{label} query {i}")
                compare_tables(r.table, w.table, f"{label} {i} vs cpu")
                runs += 1

    for seed in P_FAULT_SEEDS:
        for point, queries, mqo in (
                ("scan_h2d", props.res_queries, True),
                ("kernel_launch", lambda s: props.res_queries(s)[:1], True),
                ("batched_launch", props.batched_template, False),
                ("ce_admission",
                 lambda s: [props.res_queries(s)[0]] * 3, True),
                ("window_close", lambda s: props.res_queries(s)[:2], True)):
            sess = props.res_session(device, config=props.res_cfg(
                seed=seed, schedule={point: (0,)}))
            batch = sess.run_batch(queries(sess), mqo=mqo)
            check(batch, ref.run_batch(queries(ref), mqo=mqo),
                  ref_cpu.run_batch(queries(ref_cpu), mqo=mqo),
                  f"P4 {point} seed {seed}")
            fired = sess.fault_injector.n_fired
            if not fired:
                raise AssertionError(f"P4 {point}: nothing was injected")
            injected += fired
            if sess.memory.audit():
                raise AssertionError(f"P4 {point}: {sess.memory.audit()}")
        # spill_to_host at rate 1.0: the pulse's spills fail and drop
        sess = props.res_session(device, config=props.res_cfg(
            seed=seed, rates={"spill_to_host": 1.0}))
        qs = lambda s: [props.res_queries(s)[0]] * 3  # noqa: E731
        sess.run_batch(qs(sess))
        sess.memory._make_room(sess.memory.device_budget)
        check(sess.run_batch(qs(sess)), ref.run_batch(qs(ref)),
              ref_cpu.run_batch(qs(ref_cpu)), f"P4 spill seed {seed}")
        if not sess.memory.pools["ce"].stats.spill_failures:
            raise AssertionError("P4 spill_to_host: no spill failed")
        injected += sess.fault_injector.n_fired
        # pid_pool at rate 1.0: stats-only pruning, never a failure
        sess = props.pid_session(device, props.res_cfg(
            seed=seed, rates={"pid_pool": 1.0}))
        s1, p1 = props.seed_then_probe(sess)
        s0, p0 = props.seed_then_probe(props.pid_session(device))
        sc, pc = props.seed_then_probe(props.pid_session(cpu))
        check(s1, s0, sc, f"P4 pid seed {seed} seed")
        check(p1, p0, pc, f"P4 pid seed {seed} probe")
        if p1.n_failed or s1.n_failed or p1.metrics.pid_pruned_parts:
            raise AssertionError("P4 pid_pool: not stats-only pruning")
        injected += sess.fault_injector.n_fired
        # the soak's rates (window_close 0.02, every other point 0.05)
        rates = {p: 0.05 for p in FAULT_POINTS}
        rates["window_close"] = 0.02
        faulty = props.res_session(device, config=props.res_cfg(
            1 << 15, seed=seed, rates=rates))
        clean = props.res_session(device, 1 << 15)
        svc = QueryService(faulty, max_batch=64)
        rng = random.Random(seed)
        for w in range(P_SOAK_WINDOWS):
            idxs = rng.choices(range(6), k=rng.randint(1, 3))
            handles = [svc.submit(props.res_queries(faulty)[i])
                       for i in idxs]
            svc.flush()
            base = clean.run_batch([props.res_queries(clean)[i]
                                    for i in idxs])
            for h, b in zip(handles, base.results):
                if not h.done:
                    raise AssertionError(f"P4 soak window {w}: unresolved")
                if not h.failed:
                    p_bitwise(h.result(), b.table, f"P4 soak window {w}")
                    runs += 1
            if faulty.memory.audit():
                raise AssertionError(f"P4 soak window {w}: audit")
            if w % 7 == 6:
                faulty.memory._make_room(faulty.memory.device_budget)
        injected += faulty.fault_injector.n_fired
    if not injected:
        raise AssertionError("P4: no fault was injected")
    return dict(seeds=len(P_FAULT_SEEDS), successes=runs,
                injected=injected, events=events)


def p_pruned(device) -> dict:
    """P5: pruned = unpruned.  ``test_partition.py``'s seeded predicate
    trees (12 a cell) over range and hash partitioning, columnar and CSV,
    with the pid pool on (its default), bitwise on the card and against
    the port's CPU run; then ``TestPidPoolFault``'s seed-and-probe, whose
    probe the pid pool prunes beyond the statistics."""
    import numpy as np
    import torch

    from repro_torch.relational import Partitioning
    from repro_torch.relational.partition import prune_parts

    props, cpu = p_props(), torch.device("cpu")
    cases = pruned = 0
    for fmt in ("columnar", "csv"):
        for scheme in ("range", "hash"):
            part = Partitioning("n1", scheme, 8)
            on = props.part_session(device, fmt, part, prune=True)
            off = props.part_session(device, fmt, part, prune=False)
            ref = props.part_session(cpu, fmt, part, prune=True)
            info = on.stats.partitions["t"]
            rng = np.random.default_rng(0)
            for i in range(12):
                pred = props.random_pred_tree(rng)
                a, b, c = (s.run_batch([props.pruned_query(s, pred)],
                                       mqo=False).results[0].table
                           for s in (on, off, ref))
                label = f"P5 {fmt} {scheme} {i}"
                p_bitwise(a, b, label)
                compare_tables(a, c, f"{label} vs cpu")
                pruned += info.n_partitions - len(prune_parts(pred, info))
                cases += 1
    s, p = props.seed_then_probe(props.pid_session(device))
    sc, pc = props.seed_then_probe(props.pid_session(cpu))
    for got, want, label in ((s, sc, "seed"), (p, pc, "probe")):
        compare_tables(got.results[0].table, want.results[0].table,
                       f"P5 pid {label} vs cpu")
    pid = p.metrics.pid_pruned_parts
    if not pruned or not pid:
        raise AssertionError(f"P5: {pruned} partitions pruned by "
                             f"statistics, {pid} by the pid pool")
    return dict(cases=cases + 2, pruned_by_stats=pruned, pruned_by_pid=pid)


def properties_phase(device, smi: str) -> dict:
    """Phase P: P1-P5 on ``device``; one line an identity (cases,
    counters, seconds); returns the phase's launches by kernel."""
    from repro_torch.kernels.filter_project import kernel as K

    before = dict(K.LAUNCHES)
    for name, fn in (("P1 fused = eager, batched = per-query", p_fused),
                     ("P2 tiny budget = unlimited", p_budgets),
                     ("P3 MQO = no MQO", p_mqo),
                     ("P4 faults = fault-free", p_faults),
                     ("P5 pruned = unpruned", p_pruned)):
        at = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        out = fn(device)
        launched = {k: v for k, v in p_launches(K, at).items() if v}
        log(f"{name}: " + ", ".join(f"{k} {v}" for k, v in out.items())
            + "; launches " + (", ".join(f"{k} {v}" for k, v in
                                         launched.items()) or "none")
            + f"; {time.perf_counter() - t0:.1f} s [{smi}]")
        if device.type != "cuda":
            continue
        need = ("filter_scan", "filter_scan_batch", "parse_fields") \
            if name.startswith("P1") else ()
        if not launched or any(k not in launched for k in need):
            raise AssertionError(f"{name}: a kernel was not launched: "
                                 f"{launched}")
    return p_launches(K, before)


def attention_wrapper_timings(device, smi: str) -> None:
    """``--only timings``: the two attention wrappers of the checkout,
    CUDA-event median of 30 calls, at S2's batched decode (8 rows x 272
    live keys of a 1024-slot cache) and a causal forward at T = S = 256
    (granite-8b's heads, bf16): the per-call cost of the wrapper's path
    to its kernel."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    bf16 = torch.bfloat16
    q = _randn((8, 32, 128), bf16, device, gen)
    k = _randn((8, 8, 1024, 128), bf16, device, gen)
    v = _randn((8, 8, 1024, 128), bf16, device, gen)
    lens = torch.full((8,), 272, dtype=torch.int32, device=device)
    qf = _randn((1, 32, 256, 128), bf16, device, gen)
    kf = _randn((1, 8, 256, 128), bf16, device, gen)
    vf = _randn((1, 8, 256, 128), bf16, device, gen)
    for name, fn in (
            ("decode_attention wrapper, 8 rows x 272 keys",
             lambda: DK.decode_attention(q, k, v, lens)),
            ("flash_attention wrapper, T = S = 256 causal",
             lambda: FK.flash_attention(qf, kf, vf, causal=True))):
        log(f"{name}: {time_ms(fn):.4f} ms a call (CUDA events, median of "
            f"30) [{smi}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("relational", "async", "attention",
                                       "serving", "families", "training",
                                       "timings", "surfaces", "benches",
                                       "sharded", "spmd", "moe_train",
                                       "dryrun", "properties"),
                    help="run one group of phases (bring-up); default all")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="with --only timings|serving|families|training|"
                         "spmd|moe_train: run the port of the checkout at "
                         "TREE (for example an earlier commit unpacked by "
                         "git archive) instead of this one")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    if tree != ROOT and args.only not in ("timings", "serving", "families",
                                          "training", "spmd", "moe_train"):
        ap.error("--tree needs --only timings|serving|families|training|"
                 "spmd|moe_train")
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
    log(set_peaks(kind))
    sources = SOURCES
    seconds, usage = build_kernels(sources, tree)
    log(f"build: {seconds:.1f} s (nvcc, sm_90a, {len(sources)} sources in "
        f"parallel)")
    for name, summary in usage.items():
        log(f"ptxas {name}: {summary}")

    cuda = torch.device("cuda")
    kernels = []
    surfaces = None

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    if args.only in (None, "relational", "async", "timings"):
        kernels += phase("relational", lambda: relational_phases(
            cuda, smi, main_path_too=args.only != "async",
            async_too=args.only != "relational",
            checks=args.only != "timings"))
    if args.only == "timings":
        phase("attention wrappers", lambda: attention_wrapper_timings(
            cuda, smi))
    if args.only in (None, "surfaces"):
        surfaces = phase("surfaces", lambda: surfaces_phase(cuda, smi))
    properties = None
    if args.only in (None, "properties"):
        properties = phase("properties", lambda: properties_phase(cuda,
                                                                   smi))
    benches = None
    if args.only == "benches":
        benches = phase("benches", lambda: benches_phase(cuda, smi))
    if args.only in (None, "attention", "serving", "families", "training"):
        kernels += phase("attention", lambda: attention_phases(
            cuda, smi, serve=args.only in (None, "serving"),
            families=args.only in (None, "families"),
            training=args.only in (None, "training"), s1=tree == ROOT))
    sharded = None
    if args.only in (None, "sharded"):
        sharded = phase("sharded", lambda: sharded_phase(cuda, smi))
    if args.only == "spmd":
        sharded = phase("spmd", lambda: m_spmd(cuda, smi))
    if args.only == "moe_train":
        sharded = phase("moe_train", lambda: m_moe_train(cuda, smi))
    dryrun = None
    if args.only in (None, "dryrun"):
        dryrun = phase("dryrun", lambda: dryrun_phase(cuda, smi))
    if args.only in ("sharded", "spmd", "moe_train", "dryrun",
                     "properties"):
        # bring-up: the path's launches alone, no timings
        counts = {"sharded": sharded, "spmd": sharded, "moe_train": sharded,
                  "dryrun": dryrun, "properties": properties}[args.only]
        kernels = [dict(name=name, route="cuda", source=src, replaces=line,
                        launches=counts.get(counted, 0), path=args.only,
                        launches_by_path={})
                   for name, src, line, counted in M_KERNELS]
    if args.only == "benches":
        # each kernel's launches by bench, no timings
        kernels = [dict(name=name, route="cuda", source=src, replaces=line,
                        launches=sum(b.get(counted, 0)
                                     for b in benches.values()),
                        path="benches",
                        launches_by_path={bench: b.get(counted, 0)
                                          for bench, b in benches.items()})
                   for name, src, line, counted in M_KERNELS]
    for name, key in (("surfaces", surfaces), ("properties", properties),
                      ("sharded", sharded), ("dryrun", dryrun)):
        if key is None:
            continue
        # the surfaces' card runs and the sharded paths, beside the main
        # path's count
        for entry in kernels:
            entry["launches_by_path"][name] = key.get(
                "parse_fields" if entry["name"] == "parse_i32"
                else entry["name"], 0)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    if OPERATOR_ROWS:
        print(json.dumps({"operators": OPERATOR_ROWS}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The PyTorch port's bench runner (the counterpart of
``benchmarks/run.py``): runs the ``torch_bench_*`` modules and the
roofline report, on the GPU unless ``--device`` says otherwise.

  torch_bench_mckp              paper §6.2  (optimizer overhead < 2 s)
  torch_bench_filter_micro      paper Fig. 5–7 (+ fused vs eager)
  torch_bench_projection_micro  paper Fig. 8–9 (+ fused vs eager)
  torch_bench_window            paper Fig. 4 (batching-window sweep)
  torch_bench_macro_tpcds       paper Fig. 3 (50-query TPC-DS CDF)
  torch_bench_batch_reuse       cold vs warm repeat, per policy
  torch_bench_service           QueryService windows + tracing gate
  torch_bench_canonical         mixed-syntax stream, canonical IR
  torch_bench_partition         partition-grained MCKP, sub-CE budget
  torch_bench_resilience        5% injected transient faults
  torch_bench_window_batch      window-batched kernel execution
  torch_bench_subsumption       semantic subsumption + pid pool
  torch_bench_telemetry         tracing overhead gate
  torch_bench_async             asyncio front, adaptive vs fixed
  torch_bench_serving_prefix    LLM prefix-cache MQO
  torch_roofline_report         the port's dry-run roofline table

Each bench's ``main(argv)`` prints its CSV lines and returns its exit
status (1 when its speed gate failed); the report's ``main()`` returns
its lines.  A bench that raises, fails its
gate or writes no ``reports/bench/torch_*.json`` fails the run (exit
1).  ``--out`` merges the result files written during this run into one
JSON file.

Usage:
  python benchmarks/torch_run.py --device cpu          # everything
  python benchmarks/torch_run.py torch_bench_window torch_bench_mckp \\
      --out BENCH_torch.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

MODULES = [
    "torch_bench_mckp",
    "torch_bench_filter_micro",
    "torch_bench_projection_micro",
    "torch_bench_window",
    "torch_bench_macro_tpcds",
    "torch_bench_batch_reuse",
    "torch_bench_service",
    "torch_bench_canonical",
    "torch_bench_partition",
    "torch_bench_resilience",
    "torch_bench_window_batch",
    "torch_bench_subsumption",
    "torch_bench_telemetry",
    "torch_bench_async",
    "torch_bench_serving_prefix",
    "torch_roofline_report",
]

# the roofline report prints the dry run's cells and writes no result
NO_ARTIFACT = frozenset({"torch_roofline_report"})


def _written_since(t0: float):
    """The ``torch_*.json`` result files written after ``t0``."""
    from common import RESULTS_DIR

    if not os.path.isdir(RESULTS_DIR):
        return []
    return sorted(
        fn for fn in os.listdir(RESULTS_DIR)
        if fn.startswith("torch_") and fn.endswith(".json")
        and os.path.getmtime(os.path.join(RESULTS_DIR, fn)) >= t0)


def _merge_results(out_path: str, since: float) -> None:
    """The result files written during this run, merged into one."""
    from common import RESULTS_DIR

    merged = {}
    for fn in _written_since(since):
        with open(os.path.join(RESULTS_DIR, fn)) as f:
            merged[fn[:-5]] = json.load(f)
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"# merged {len(merged)} result sets -> {out_path}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("modules", nargs="*",
                        help=f"subset of {MODULES} (default: all)")
    parser.add_argument("--device", default="cuda",
                        help="passed to every bench (default cuda)")
    parser.add_argument("--out", default=None,
                        help="merge reports/bench/torch_*.json into this "
                             "file")
    args = parser.parse_args(argv)
    modules = args.modules or MODULES
    unknown = [m for m in modules if m not in MODULES]
    if unknown:
        parser.error(f"unknown modules: {unknown}")

    print("name,us_per_call,derived")
    t_start = time.time()
    failures = 0
    for name in modules:
        t0 = time.time()
        try:
            mod = __import__(name)
            if name in NO_ARTIFACT:
                print("\n".join(mod.main()), flush=True)
                rc = 0
            else:
                rc = mod.main(["--device", args.device])
            if rc:
                failures += 1
                print(f"# {name} FAILED: exit status {rc}", flush=True)
                continue
            if name not in NO_ARTIFACT and not _written_since(t0):
                failures += 1
                print(f"# {name} FAILED: completed without writing any "
                      f"reports/bench/torch_*.json result; it would be "
                      f"missing from the --out merge", flush=True)
                continue
            print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)
        except Exception:
            failures += 1
            print(f"# {name} FAILED:", flush=True)
            traceback.print_exc()
    if args.out:
        _merge_results(args.out, since=t_start)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

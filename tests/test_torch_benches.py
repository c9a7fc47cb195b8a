"""The port's bench scripts (``benchmarks/torch_bench_*.py``) at tiny
sizes on the CPU: each measurement runs with its correctness checks
(which raise), writes its ``reports/bench/torch_*.json`` with the device
record, and keeps the JAX bench's traffic and gate thresholds.  The
speed gates are exercised on synthetic results only: a CPU run at a
tiny size says nothing about speed."""
import json
import os
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import bench_async  # noqa: E402
import bench_filter_micro  # noqa: E402
import bench_service  # noqa: E402
import bench_subsumption  # noqa: E402
import bench_window_batch  # noqa: E402
import torch_bench_async as TA  # noqa: E402
import torch_bench_filter_micro as TF  # noqa: E402
import torch_bench_service as TS  # noqa: E402
import torch_bench_subsumption as TU  # noqa: E402
import torch_bench_window_batch as TW  # noqa: E402
from common import RESULTS_DIR  # noqa: E402


def _report(name):
    with open(os.path.join(RESULTS_DIR, f"torch_{name}.json")) as f:
        return json.load(f)


def _device_recorded(name):
    rec = _report(name)
    assert rec["device"] == "cpu" and rec["device_name"] == "cpu"
    assert rec["power_limit"] is None
    import torch

    assert rec["torch"] == torch.__version__
    return rec


# -- the JAX benches' traffic, sizes and thresholds, unchanged ----------
SAME = [
    (TA, bench_async, ("NROWS", "BUDGET", "FMT", "DISK_LATENCY",
                       "N_CLIENTS", "N_PER_CLIENT", "MEAN_GAP_S",
                       "SLO_P99_S", "FIXED", "ADAPTIVE", "SINGLE_N",
                       "MIN_ADAPTIVE_SPEEDUP", "MAX_ASYNC_OVER_SYNC")),
    (TW, bench_window_batch, ("N_ROWS", "N_QUERIES", "N_WINDOWS", "FMT",
                              "MIN_WARM_SPEEDUP")),
    (TS, bench_service, ("SCALE_ROWS", "BUDGET", "FMT", "DISK_LATENCY",
                         "MAX_BATCH", "REPEATS", "TRACING_MIN_RATIO")),
    (TU, bench_subsumption, ("SCALE_ROWS", "FMT", "DISK_LATENCY",
                             "N_PARTITIONS", "N_SEED", "N_DRILL",
                             "REPEATS")),
]


@pytest.mark.parametrize("port,ref,names", SAME,
                         ids=[p.__name__ for p, _, _ in SAME])
def test_traffic_and_thresholds_are_the_jax_benchs(port, ref, names):
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name


def test_default_sizes_are_the_jax_benchs():
    import inspect

    def defaults(fn):
        return {k: p.default for k, p in
                inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    assert defaults(TF.run)["sizes"] == defaults(
        bench_filter_micro.run)["sizes"]
    assert defaults(TF.run)["fmts"] == defaults(
        bench_filter_micro.run)["fmts"]
    assert defaults(TF.run)["repeats"] == defaults(
        bench_filter_micro.run)["repeats"]
    assert defaults(TA.run)["nrows"] == bench_async.NROWS
    assert defaults(TW.run)["n_rows"] == bench_window_batch.N_ROWS
    assert defaults(TS.run)["scale_rows"] == bench_service.SCALE_ROWS
    assert defaults(TU.run)["scale_rows"] == bench_subsumption.SCALE_ROWS


# -- the async bench ----------------------------------------------------
TINY_ASYNC = dict(nrows=3000, n_clients=4, n_per_client=3,
                  mean_gap_s=0.005, single_n=6)


@pytest.fixture(scope="module")
def async_run():
    return TA.run("cpu", keep=True, **TINY_ASYNC)


def test_async_every_handle_resolves(async_run):
    n = TINY_ASYNC["n_clients"] * TINY_ASYNC["n_per_client"]
    for mode in ("fixed", "adaptive"):
        out = async_run[mode]
        assert out["n_queries"] == n
        for kept in async_run["kept"][mode]:
            assert len(kept["tables"]) == n
            assert sorted(k for w in kept["windows"] for k, _, _ in w) \
                == sorted(kept["tables"])
        assert out["window_exec_p99_s"] > 0
    rec = _device_recorded("async_serving")
    assert "kept" not in rec
    assert rec["fixed"]["n_queries"] == n


def test_async_windows_replay_on_the_sync_front(async_run):
    """Each async window replayed through the sync QueryService gives
    the async run's tables and MQO decisions (chip_smoke.py E3 replays
    the card's windows on the CPU the same way)."""
    n = TINY_ASYNC["n_clients"] * TINY_ASYNC["n_per_client"]
    assert TA.verify(async_run, "cpu") == 4 * n + 2 * TINY_ASYNC["single_n"]


def test_async_replay_finds_a_changed_decision(async_run):
    kept = async_run["kept"]["adaptive"][1]
    key = next(iter(kept["decisions"]))
    saved = kept["decisions"][key]
    kept["decisions"][key] = ("another plan",) + saved[1:]
    try:
        with pytest.raises(AssertionError, match="MQO decisions differ"):
            TA.verify(async_run, "cpu")
    finally:
        kept["decisions"][key] = saved


@pytest.mark.parametrize("speedup,p99s,ratio,n_fail", [
    (1.25, (0.5, 0.4), 1.05, 0), (1.19, (0.5, 0.4), 1.05, 1),
    (1.5, (0.3, 0.4), 1.05, 1), (1.5, (0.5, 0.4), 1.11, 1),
    (1.0, (0.1, 0.9), 2.0, 3)])
def test_async_gate(speedup, p99s, ratio, n_fail):
    out = {"adaptive_over_fixed_throughput": speedup,
           "fixed": {"latency_p99_s": p99s[0]},
           "adaptive": {"latency_p99_s": p99s[1]},
           "single_client": {"async_over_sync_latency": ratio}}
    assert len(TA.gate(out)) == n_fail


# -- the other benches --------------------------------------------------
def test_filter_micro():
    out = TF.run("cpu", sizes=(3000,), fused_sizes=(3000,), repeats=1)
    assert [(r["fmt"], r["nrows"]) for r in out["rows"]] == \
        [("csv", 3000), ("columnar", 3000)]
    assert [(r["fmt"], r["nrows"]) for r in out["fused"]] == \
        [("csv", 3000), ("columnar", 3000)]
    assert all(r["cache_frac_fc"] > 0 for r in out["rows"])
    _device_recorded("filter_micro")
    _device_recorded("filter_micro_fused")
    assert TF.gate({"rows": [{"fmt": "csv", "nrows": 1,
                              "ws_over_base": 1.06}]})
    assert not TF.gate({"rows": [{"fmt": "csv", "nrows": 1,
                                  "ws_over_base": 1.05}]})


def test_window_batch():
    out = TW.run("cpu", n_rows=3000, n_queries=3, n_windows=3)
    assert out["warm_trace_hit_rate"] == 1.0
    assert all(r["batched_dispatches"] >= 1 for r in out["rows"])
    assert out["rows"][0]["trace_misses"] > 0
    _device_recorded("window_batch")
    assert TW.gate({"warm_speedup": 2.99})
    assert not TW.gate({"warm_speedup": 3.0})


def test_service():
    w = TS.run("cpu", scale_rows=3000, repeats=1)
    t = TS.run_tracing_overhead("cpu", scale_rows=3000, repeats=1)
    assert w["n_queries"] == 16 and w["warm_reused_handles"] > 0
    assert t["traced_spans"] > 0 and t["trace_events"] > 0
    _device_recorded("service_windows")
    _device_recorded("service_tracing_overhead")
    assert len(TS.gate({"windowed_warm_speedup": 1.29},
                       {"throughput_ratio": 0.94})) == 2
    assert not TS.gate({"windowed_warm_speedup": 1.3},
                       {"throughput_ratio": 0.95})


def test_subsumption():
    out = TU.run("cpu", scale_rows=3000, n_drill=3, repeats=2)
    assert out["all_subsumption_hits"] and out["exact_ce_hits"] == 0
    assert out["warm_drilldowns"] == 6
    assert out["accept_pid_le_1pct_of_ce"]
    _device_recorded("bench_subsumption")
    assert TU.gate({"accept_speedup_ge_1_3": False,
                    "subsumption_warm_speedup": 1.2})
    assert not TU.gate({"accept_speedup_ge_1_3": True})


@pytest.mark.parametrize("mod", [TA, TF, TW, TS, TU],
                         ids=lambda m: m.__name__)
def test_default_device_is_cuda(mod):
    import torch

    if torch.cuda.is_available():
        assert mod.parse_device([]).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])

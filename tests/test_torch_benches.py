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
import bench_batch_reuse  # noqa: E402
import bench_filter_micro  # noqa: E402
import bench_macro_tpcds  # noqa: E402
import bench_mckp  # noqa: E402
import bench_partition  # noqa: E402
import bench_projection_micro  # noqa: E402
import bench_resilience  # noqa: E402
import bench_service  # noqa: E402
import bench_serving_prefix  # noqa: E402
import bench_subsumption  # noqa: E402
import bench_window  # noqa: E402
import bench_window_batch  # noqa: E402
import run as bench_run  # noqa: E402
import torch_bench_async as TA  # noqa: E402
import torch_bench_batch_reuse as TB  # noqa: E402
import torch_bench_canonical as TC  # noqa: E402
import torch_bench_filter_micro as TF  # noqa: E402
import torch_bench_macro_tpcds as TM  # noqa: E402
import torch_bench_mckp as TK  # noqa: E402
import torch_bench_partition as TP  # noqa: E402
import torch_bench_projection_micro as TJ  # noqa: E402
import torch_bench_resilience as TR  # noqa: E402
import torch_bench_service as TS  # noqa: E402
import torch_bench_serving_prefix as TV  # noqa: E402
import torch_bench_subsumption as TU  # noqa: E402
import torch_bench_telemetry as TT  # noqa: E402
import torch_bench_window as TN  # noqa: E402
import torch_bench_window_batch as TW  # noqa: E402
import torch_run  # noqa: E402
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
    (TB, bench_batch_reuse, ("SCALE_ROWS", "BUDGET", "FMT",
                             "DISK_LATENCY")),
    (TP, bench_partition, ("SCALE_ROWS", "FMT", "DISK_LATENCY",
                           "N_PARTITIONS", "MAX_BATCH", "N_WINDOWS",
                           "REPEATS", "BUDGET_FRACTION")),
    (TR, bench_resilience, ("SCALE_ROWS", "BUDGET", "FMT", "DISK_LATENCY",
                            "MAX_BATCH", "REPEATS", "FAULT_RATE",
                            "FAULT_POINTS")),
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
    assert defaults(TS.run_mixed)["scale_rows"] == bench_service.SCALE_ROWS
    assert defaults(TB.run)["scale_rows"] == bench_batch_reuse.SCALE_ROWS
    assert defaults(TP.run)["scale_rows"] == bench_partition.SCALE_ROWS
    assert defaults(TR.run)["scale_rows"] == bench_resilience.SCALE_ROWS


def _defaults(fn):
    import inspect

    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("port,ref,names", [
    (TM.run, bench_macro_tpcds.run, ("scale_rows", "budget", "fmt")),
    (TM.run_disk_profile, bench_macro_tpcds.run_disk_profile,
     ("scale_rows", "budget", "disk_latency_per_byte")),
    (TN.run, bench_window.run, ("window_sizes", "trials", "scale_rows",
                                "budget", "seed")),
    (TJ.run, bench_projection_micro.run, ("sizes", "fmts", "budget")),
    (TV.run, bench_serving_prefix.run, ("arch",)),
], ids=["macro", "macro_disk", "window", "projection", "serving_prefix"])
def test_paper_bench_defaults_are_the_jax_benchs(port, ref, names):
    dp, dr = _defaults(port), _defaults(ref)
    for name in names:
        assert dp[name] == dr[name], name


def test_constants_inside_the_jax_benchs_functions():
    """The sizes the JAX benches keep inside their functions: the
    MCKP populations, the end-to-end session, the serving workload, the
    mixed-syntax styles, the batch-reuse policies and repeats."""
    import inspect

    src = inspect.getsource(bench_mckp.run)
    assert repr(list(TK.SOLVER_SIZES)) in src
    assert f"capacity={TK.CAPACITY >> 20} << 20" in src
    assert f"max_buckets={TK.MAX_BUCKETS}" in src
    assert f"scale_rows={TK.E2E_ROWS:_}" in src
    assert "budget_bytes=1 << 30" in src and TK.E2E_BUDGET == 1 << 30
    w = _defaults(bench_serving_prefix._workload)
    assert (w["n_templates"], w["per_template"], w["shared_len"], w["tail"],
            w["seed"]) == (TV.N_TEMPLATES, TV.PER_TEMPLATE, TV.SHARED_LEN,
                           TV.TAIL, 0)
    src = inspect.getsource(bench_serving_prefix.run)
    assert f"pool_budget_bytes=1 << {TV.POOL_BUDGET.bit_length() - 1}" \
        in src
    assert f"block_size={TV.BLOCK_SIZE}, max_len={TV.MAX_LEN}" in src
    assert all(f'"{a}"' in src for a in TV.WEIGHT_ARCHS)
    assert f"GenerationRequest(rid, p.astype(np.int32), {TV.NEW_TOKENS})" \
        in inspect.getsource(bench_serving_prefix._workload)
    assert f"n_styles = {TS.N_STYLES}" in inspect.getsource(
        bench_service.run_mixed)
    assert _defaults(bench_batch_reuse._run_policy)["repeats"] == TB.REPEATS
    assert "for p in (%s)" % ", ".join(f'"{p}"' for p in TB.POLICIES) \
        in inspect.getsource(bench_batch_reuse.run)
    assert f"seed={TP.COLUMNS_SEED}" in inspect.getsource(bench_partition)
    assert f"seed={TR.FAULT_SEED}" in inspect.getsource(
        bench_resilience._mk_session)


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


# -- the paper's experiments and the other gated benches ----------------
@pytest.fixture(scope="module")
def macro_run():
    return TM.run("cpu", scale_rows=3000)


def test_macro(macro_run):
    out = macro_run
    assert out["n_queries"] == 50 and len(out["ratios"]) == 50
    assert len(out["base_seconds"]) == len(out["opt_seconds"]) == 50
    assert 0 <= out["ge80pct_reduction_frac"] <= out["improved_frac"] <= 1
    assert out["n_ses"] > 0 and out["n_selected"] > 0
    assert 0 < out["cache_used_bytes"] <= out["cache_budget"]
    assert out["optimize_seconds"] > 0
    _device_recorded("macro_tpcds")
    d = TM.run_disk_profile("cpu", scale_rows=3000)
    assert d["disk_latency_per_byte"] == _defaults(
        bench_macro_tpcds.run_disk_profile)["disk_latency_per_byte"]
    assert 0 < d["agg_ratio"]
    _device_recorded("macro_tpcds_disk")


def test_macro_named_report():
    out = TM.run("cpu", scale_rows=2000, name="macro_tpcds_2000")
    assert out["scale_rows"] == 2000
    assert _device_recorded("macro_tpcds_2000")["n_queries"] == 50


def test_macro_counts_equal_the_jax_optimizers(macro_run):
    """The SE, CE and selected-CE counts of the macro bench's MQO pass
    equal the JAX package's MultiQueryOptimizer's over the same 50
    plans (the optimizer only; no JAX execution)."""
    from repro.core.optimizer import MultiQueryOptimizer
    from repro.relational.canonical import canonicalize_plan
    from repro.relational.rewriter import (RelationalRewriter,
                                           make_ce_transform)
    from repro.relational.rules import optimize_single
    from repro.relational.tpcds import build_tpcds_session, tpcds_queries

    sess = build_tpcds_session(scale_rows=3000, budget_bytes=TM.BUDGET,
                               fmt=TM.FMT)
    plans = [optimize_single(canonicalize_plan(q))
             for q in tpcds_queries(sess)]
    res = MultiQueryOptimizer(sess.cost_model, RelationalRewriter(),
                              budget_bytes=TM.BUDGET,
                              ce_transform=make_ce_transform()
                              ).optimize(plans)
    r = res.report
    assert (macro_run["n_ses"], macro_run["n_ces"],
            macro_run["n_selected"]) == (r.n_ses, r.n_ces, r.n_selected)


def test_window_sweep():
    out = TN.run("cpu", window_sizes=(2, 5), trials=2, scale_rows=3000)
    for w in (2, 5):
        d = out["per_window"][w]
        assert len(d["ratios"]) == len(d["ses"]) == 2
        assert all(len(ix) == w == len(set(ix)) for ix in d["subsets"])
    _device_recorded("window_sweep")


def test_window_subsets_are_the_jax_benchs(monkeypatch):
    """The JAX bench's own draws, read through a stand-in session that
    records each batch it is given (no JAX execution)."""
    from types import SimpleNamespace as NS

    batches = []

    class Stub:
        def run_batch(self, batch, mqo):
            batches.append(list(batch))
            res = NS(table=NS(row_multiset=lambda: 0))
            return NS(results=[res] * len(batch), total_seconds=1.0,
                      mqo=NS(report=NS(n_ses=0)))

    monkeypatch.setattr(bench_window, "build_tpcds_session",
                        lambda **kw: Stub())
    monkeypatch.setattr(bench_window, "tpcds_queries",
                        lambda sess: list(range(50)))
    monkeypatch.setattr(bench_window, "save_result", lambda *a: None)
    bench_window.run()
    assert TN.subsets(50) == batches[::4]
    assert len(TN.subsets(50)) == len(TN.WINDOW_SIZES) * TN.TRIALS


def test_projection_micro():
    out = TJ.run("cpu", sizes=(3000,))
    assert [(r["fmt"], r["nrows"]) for r in out["rows"]] == \
        [("columnar", 3000), ("csv", 3000)]
    fused = TJ.run_fused_vs_eager("cpu", sizes=(3000,), repeats=1)
    assert [(r["fmt"], r["nrows"]) for r in fused["rows"]] == \
        [("columnar", 3000), ("csv", 3000)]
    _device_recorded("projection_micro")
    _device_recorded("projection_micro_fused")


def test_mckp():
    out = TK.run("cpu", sizes=TK.SOLVER_SIZES[:2], scale_rows=3000)
    assert [(r["groups"], r["items"]) for r in out["solver"]] == \
        [(45, 180), (200, 1600)]
    e = out["end_to_end"]
    assert e["n_ses"] > 0 and e["under_2s"] == (e["seconds"] < 2.0)
    _device_recorded("mckp_overhead")


def test_mckp_solver_values_equal_the_jax_solvers():
    from repro.core.mckp import solve_mckp

    for g, per in TK.SOLVER_SIZES[:2]:
        ref = solve_mckp(bench_mckp._items(g, per), capacity=TK.CAPACITY,
                         max_buckets=TK.MAX_BUCKETS)
        port = TK.run_solver(((g, per),))[0]
        assert port["value"] == ref.total_value


def test_batch_reuse():
    out = TB.run("cpu", scale_rows=3000, repeats=1)
    assert [r["policy"] for r in out["policies"]] == ["lru", "benefit"]
    assert all(r["n_queries"] == 16 and r["warm_resident"] > 0
               for r in out["policies"])
    _device_recorded("batch_reuse")


@pytest.mark.parametrize("speedups,n_fail", [((1.5, 2.0), 0),
                                             ((1.49, 2.0), 1),
                                             ((1.0, 1.2), 2)])
def test_batch_reuse_gate(speedups, n_fail):
    out = {"policies": [{"policy": p, "warm_speedup": x}
                        for p, x in zip(TB.POLICIES, speedups)]}
    assert len(TB.gate(out)) == n_fail


def test_partition():
    out = TP.run("cpu", scale_rows=3000, repeats=1)
    assert out["admitted_strict_subset"]
    assert out["budget_bytes"] < out["full_ce_weight"] or \
        out["budget_bytes"] == 1 << 16
    assert out["n_queries"] == TP.MAX_BATCH * TP.N_WINDOWS
    _device_recorded("bench_partition")
    assert TP.gate({"partition_warm_speedup": 1.29})
    assert not TP.gate({"partition_warm_speedup": 1.3})


def test_partition_full_ce_weight_is_the_jax_benchs(monkeypatch):
    """The weight the budget undercuts, from the same columns (seed 4),
    at 3,000 rows in both packages."""
    from repro.relational.datagen import generate_columns

    cols = generate_columns(bench_partition.SCHEMA, 3000, seed=4)
    monkeypatch.setattr(bench_partition, "SCALE_ROWS", 3000)
    monkeypatch.setattr(bench_partition, "COLS", cols)
    ref = bench_partition.probe_full_ce_weight()
    assert ref > 0
    assert TP.probe_full_ce_weight("cpu", 3000) == ref


def test_canonical():
    out = TC.run("cpu", scale_rows=3000, repeats=2)
    assert out["n_queries"] == 14 and out["fresh_spelling_passes"] == 2
    assert out["canonical_hit_rate"] > 0
    _device_recorded("service_mixed_syntax")


@pytest.mark.parametrize("speedup,rate,n_fail", [
    (1.3, 0.01, 0), (1.29, 0.5, 1), (2.0, 0.0, 1), (1.0, 0.0, 2)])
def test_canonical_gate(speedup, rate, n_fail):
    assert len(TC.gate({"mixed_warm_speedup": speedup,
                        "canonical_hit_rate": rate})) == n_fail


def test_telemetry():
    out = TT.run("cpu", scale_rows=3000, repeats=1)
    assert out["traced_spans"] > 0
    assert TT.gate({"throughput_ratio": 0.94})
    assert not TT.gate({"throughput_ratio": 0.95})


def test_resilience():
    """The faulted stream fires faults, every query resolves with the
    clean run's rows (the run raises otherwise), the audit is clean."""
    out = TR.run("cpu", scale_rows=3000, repeats=2)
    assert out["faults_fired"] > 0
    assert set(out["faults_by_point"]) <= set(TR.FAULT_POINTS)
    _device_recorded("resilience")
    assert TR.gate({"throughput_ratio": 0.79})
    assert not TR.gate({"throughput_ratio": 0.8})


@pytest.fixture
def one_thread():
    """Decode is thousands of tiny ops: on a CPU that other test
    processes keep busy, intra-op threads wait on each other at every
    op (minutes instead of seconds), so the serving runs take one."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serving_prefix(one_thread):
    out = TV.run("cpu")
    assert out["identical_generations"]
    assert out["tokens_prefilled_mqo"] < out["tokens_prefilled_base"]
    assert out["n_selected"] > 0
    _device_recorded("serving_prefix")


def test_prefix_weights_are_the_jax_packages():
    from repro.configs import get_config
    from repro.serving.costs import ServingCostModel

    port = TV.prefix_weights()
    assert sorted(port) == sorted(TV.WEIGHT_ARCHS)
    for a in TV.WEIGHT_ARCHS:
        cm = ServingCostModel(get_config(a))
        assert port[a] == {"prefix_4k_bytes": cm.state_bytes(4096),
                           "prefix_32k_bytes": cm.state_bytes(32768)}


# -- the runner ---------------------------------------------------------
def test_runner_modules_are_the_ports_of_the_jax_runners():
    assert torch_run.MODULES == ["torch_" + m for m in bench_run.MODULES]
    assert torch_run.NO_ARTIFACT == {"torch_" + m
                                     for m in bench_run.NO_ARTIFACT}
    for name in torch_run.MODULES:
        assert os.path.exists(os.path.join(ROOT, "benchmarks",
                                           name + ".py")), name


def test_runner_merges_a_run(tmp_path):
    """The runner runs a bench and merges its result: the MCKP overhead
    bench at its full size, which has no speed gate.  The resilience
    bench's faulted / fault-free throughput gate (0.8) read 0.66-0.67
    here beside other test processes, on one intra-op thread too, with
    one fault fired; its rows and audit stay checked by
    ``test_resilience`` and its gate on the card (``chip_smoke.py --only
    benches``)."""
    out = tmp_path / "merged.json"
    assert torch_run.main(["torch_bench_mckp", "--device", "cpu",
                           "--out", str(out)]) == 0
    merged = json.loads(out.read_text())
    assert list(merged) == ["torch_mckp_overhead"]
    assert merged["torch_mckp_overhead"]["device"] == "cpu"


def test_runner_fails_a_bench_without_a_result(monkeypatch, capsys):
    import types

    mute = types.ModuleType("torch_bench_mute")
    mute.main = lambda argv: 0
    monkeypatch.setitem(sys.modules, "torch_bench_mute", mute)
    monkeypatch.setattr(torch_run, "MODULES",
                        torch_run.MODULES + ["torch_bench_mute"])
    assert torch_run.main(["torch_bench_mute", "--device", "cpu"]) == 1
    assert "torch_bench_mute FAILED: completed without writing" in \
        capsys.readouterr().out


def test_runner_fails_a_gate(monkeypatch, capsys):
    import types

    gated = types.ModuleType("torch_bench_gated")
    gated.main = lambda argv: 1
    monkeypatch.setitem(sys.modules, "torch_bench_gated", gated)
    monkeypatch.setattr(torch_run, "MODULES",
                        torch_run.MODULES + ["torch_bench_gated"])
    assert torch_run.main(["torch_bench_gated"]) == 1
    assert "torch_bench_gated FAILED: exit status 1" in \
        capsys.readouterr().out


@pytest.mark.parametrize("mod", [TA, TF, TW, TS, TU, TM, TN, TJ, TK, TB, TP,
                                 TC, TT, TR, TV],
                         ids=lambda m: m.__name__)
def test_default_device_is_cuda(mod):
    import torch

    if torch.cuda.is_available():
        assert mod.parse_device([]).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])

"""The port's multi-pod dry run (``repro_torch.launch.dryrun``).

Each traced cell runs in a subprocess of its own, as
``tests/test_dryrun.py`` runs the JAX package's: the fake process group
belongs to the process.
The unit tests below need no process group and run here: the kernels'
custom operators and their fakes, their flop formulas, the step counter
against ``FlopCounterMode``, and the shape stand-ins against the JAX
package's.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
REFERENCE_OPS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"}


def _run(code: str, timeout: int = 600) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT_JSON:")][0]
    return json.loads(line[len("RESULT_JSON:"):])


def _port_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    return _run(f"""
        import json
        from repro_torch.launch.dryrun import run_cell
        r = run_cell("{arch}", "{shape}", multi_pod={multi_pod}, save=False)
        print("RESULT_JSON:" + json.dumps(r, default=str))
    """)


@pytest.fixture(scope="module")
def decode_single():
    return _port_cell("granite-8b", "decode_32k", False)


def _ok(r: dict) -> None:
    assert r["status"] == "ok", (r.get("error"), r.get("traceback"))
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["roofline"]["device"] == "H100 SXM"
    assert set(r["collectives"]) <= REFERENCE_OPS
    assert set(r["collective_counts"]) == set(r["collectives"])
    assert r["memory"]["peak_bytes_per_device_est"] > 0
    for key in ("flops_raw_hlo", "scan_body_probe"):
        assert key not in r


class TestDryRunCells:
    """The JAX package's four cells (``tests/test_dryrun.py``) and one
    training cell."""

    def test_decode_cell_single_pod(self, decode_single):
        r = decode_single
        _ok(r)
        assert r["chips"] == 256
        assert r["flops_per_device"] > 0
        assert r["collective_bytes_per_device"] > 0
        assert r["collective_bytes_per_device"] == sum(
            r["collectives"].values())
        # one decode kernel a layer, traced through its custom operator
        assert r["kernel_calls"] == {"decode_attention": 36}
        assert r["tokens_per_step"] == 128 and r["step_kind"] == "decode"

    def test_decode_cell_multi_pod(self, decode_single):
        r = _port_cell("granite-8b", "decode_32k", True)
        _ok(r)
        assert r["chips"] == 512
        assert r["kernel_calls"] == {"decode_attention": 36}
        # the pod axis splits the batch again: half the rows a device
        assert r["flops_per_device"] == pytest.approx(
            decode_single["flops_per_device"] / 2, rel=0.05)

    def test_long_context_ssm_cell(self):
        r = _port_cell("falcon-mamba-7b", "long_500k", False)
        _ok(r)
        assert r["chips"] == 256
        assert r["kernel_calls"] == {}          # no attention layer

    def test_long_context_skip_for_full_attention(self):
        from repro_torch.launch.dryrun import run_cell

        # a skipped cell starts no process group: it runs here
        r = run_cell("granite-8b", "long_500k", False, save=False)
        assert r["status"] == "skipped"
        assert r["reason"] == ("long_500k skipped: pure full-attention "
                               "arch (quadratic)")
        assert "chips" not in r

    def test_train_cell(self):
        """gemma3-1b ``train_4k``: the backward runs through the flash
        Function's recompute (the plain attention) under fake tensors;
        with block remat the layers of the pattern repeats run their
        forward twice, the remainder layers once.  Every layer's rows
        are split over ``data`` only (the residual stream is whole over
        ``model``), so the 16 model ranks share the one kv head and
        attend 2 query chunks each (c = 4: 2 calls a forward)."""
        from repro_torch.configs import get_config

        cfg = get_config("gemma3-1b")
        r = _port_cell("gemma3-1b", "train_4k", False)
        _ok(r)
        assert r["chips"] == 256 and r["step_kind"] == "train"
        assert cfg.remat == "block" and cfg.remainder_layers > 0
        assert r["kernel_calls"] == {
            "flash_attention": 2 * (2 * cfg.full_repeats * len(cfg.pattern)
                                    + cfg.remainder_layers)}
        assert r["collectives"]["all-reduce"] > 0
        # the backward's work: more than the forward's 2 N D a device
        assert r["roofline"]["useful_flops_ratio"] > 0.1


# ---------------------------------------------------------------------------
# the JAX package's cell, side by side
# ---------------------------------------------------------------------------
_REFERENCE = r'''
import json, re
from repro.launch import dryrun as D

texts = []
real = D.collective_bytes_from_hlo


def spy(hlo):
    texts.append(hlo)
    return real(hlo)


D.collective_bytes_from_hlo = spy
r = D.run_cell("granite-8b", "decode_32k", False, save=False)
SHAPE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")


def dot_flops(hlo):
    """2 x (result elements) x (contracted size) over every dot."""
    shapes, total = {}, 0
    for line in hlo.splitlines():
        m = SHAPE.match(line)
        if m:
            shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
    for line in hlo.splitlines():
        if " dot(" not in line:
            continue
        out = shapes[SHAPE.match(line).group(1)]
        lhs = shapes[re.search(r" dot\(%?([\w.\-]+)", line).group(1)]
        dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line).group(1)
        k = 1
        for d in dims.split(","):
            if d:
                k *= lhs[int(d)]
        total += 2 * k * int(__import__("numpy").prod(out))
    return total


# texts: the module, then the scan body the probe lowers (its while
# loop's body counted once by the module)
trips = r["scan_body_probe"]["trips"]
r["dot_flops"] = dot_flops(texts[0]) + (trips - 1) * dot_flops(texts[1])
r["long_ok"] = sorted(D.LONG_OK)
r["skip_reason"] = D.cell_is_skipped("granite-8b", "long_500k")
print("RESULT_JSON:" + json.dumps(r, default=str))
'''


def test_decode_looks_up_the_embedding_where_it_lies(decode_single):
    """granite-8b ``decode_32k``: each model rank looks up its own
    sixteenth of the vocab and the rows reduce (an all-reduce of the
    rank's 8 x 1 x 4096 bf16 rows; the JAX package's HLO reduces the
    same lookup in f32): no all-gather of the table, whose rank shard
    is 25 MB, and a few MB of collectives a step where gathering the
    table took 403.8 MB."""
    r = decode_single
    table_shard = 49152 // 16 * 4096 * 2
    assert r["collective_largest"]["all-gather"] < table_shard // 1000
    assert r["collective_largest"]["all-reduce"] < table_shard // 100
    assert r["collective_bytes_per_device"] < 10 * 2 ** 20


def test_decode_flops_equal_the_references_matrix_products(decode_single):
    """granite-8b ``decode_32k`` on ``pod16x16``: the port counts the
    matrix products and the attention products of one rank, and the
    JAX package's partitioned HLO holds the same dots (the JAX package's
    ``flops_per_device`` also counts elementwise work, ``PERF.md`` §6)."""
    from repro_torch.launch import dryrun as PD

    ref = _run(_REFERENCE)
    assert ref["status"] == "ok" and ref["chips"] == 256
    assert decode_single["flops_per_device"] == ref["dot_flops"]
    ratio = decode_single["flops_per_device"] / ref["flops_per_device"]
    assert 0 < ratio < 1          # elementwise flops only add to XLA's
    assert sorted(PD.LONG_OK) == ref["long_ok"]
    assert PD.cell_is_skipped("granite-8b", "long_500k") \
        == ref["skip_reason"]
    assert decode_single["params_total"] == ref["params_total"]
    assert decode_single["tokens_per_step"] == ref["tokens_per_step"]


# ---------------------------------------------------------------------------
# the counters, without a process group
# ---------------------------------------------------------------------------
def test_collectives_and_local_flops_on_a_2x2_fake_mesh():
    """An all-gather of an (8, 6) f32 tensor split over "data", an
    all-reduce of a (3, 5) f32 partial sum over "model", and a product
    whose rows "data" splits: the counter sees each rank's collectives'
    results and the local product, not the global one."""
    got = _run("""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import device_mesh, make_test_mesh
        from repro_torch.launch.roofline import collective_bytes_from_ops

        with D.fake_world(4):
            mesh = make_test_mesh((2, 2), ("data", "model"),
                                  devices=["cpu"] * 4)
            dm = device_mesh(mesh)
            with FakeTensorMode():
                a = DTensor.from_local(torch.empty(4, 6), dm,
                                       [Shard(0), Replicate()],
                                       run_check=False, shape=(8, 6),
                                       stride=(6, 1))
                p = DTensor.from_local(torch.empty(3, 5), dm,
                                       [Replicate(), Partial()],
                                       run_check=False, shape=(3, 5),
                                       stride=(5, 1))
                w = DTensor.from_local(torch.empty(6, 4), dm,
                                       [Replicate(), Replicate()],
                                       run_check=False, shape=(6, 4),
                                       stride=(4, 1))
                c = D.StepCounter()
                with c, D._uncounted_propagation(c):
                    a @ w
                    flops = c.flops
                    a.redistribute(dm, [Replicate(), Replicate()])
                    p.redistribute(dm, [Replicate(), Replicate()])
        out = collective_bytes_from_ops(c.collectives)
        out["flops"] = flops
        print("RESULT_JSON:" + json.dumps(out))
    """)
    assert got["by_op"] == {"all-gather": 8 * 6 * 4, "all-reduce": 3 * 5 * 4}
    assert got["op_counts"] == {"all-gather": 1, "all-reduce": 1}
    assert got["total"] == 8 * 6 * 4 + 3 * 5 * 4
    assert got["flops"] == 2 * 4 * 6 * 4      # the (4, 6) x (6, 4) shard


def test_one_rank_trace_counts_what_flop_counter_mode_counts():
    """Phase D of ``chip_smoke.py`` on the CPU: granite-8b at full width,
    4 layers, one decode step at a full 1024-slot cache (batch 8) and
    one forward (2 x 256), traced by ``trace_step`` on a 1 x 1 fake mesh
    (DTensors), against ``FlopCounterMode`` over the same steps on plain
    fake tensors: equal flops, one kernel call a layer."""
    got = _run("""
        import json, torch
        from dataclasses import replace
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import trace_step
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import (ShapeCell, decode_step, forward,
                                        model_specs)
        from repro_torch.models.common import abstract_params
        from repro_torch.models.decoder import init_cache, map_cache

        cfg = replace(get_config("granite-8b"), n_layers=4)

        def fake(tree):
            return map_cache(tree, lambda t: torch.empty(t.shape,
                                                         dtype=t.dtype))

        out = {}
        with FakeTensorMode():
            params = fake(abstract_params(model_specs(cfg), torch.bfloat16))
            cache = fake(init_cache(cfg, 8, 1024, device="meta"))
            token = torch.empty(8, 1, dtype=torch.int32)
            tokens = torch.empty(2, 256, dtype=torch.int32)
            for name, step in (
                    ("decode", lambda: decode_step(params, cache, token,
                                                   1023, cfg)),
                    ("prefill", lambda: forward(params, tokens, cfg))):
                with FlopCounterMode(display=False) as fc:
                    step()
                out[name] = fc.get_total_flops()
        one = lambda devices: make_test_mesh((1, 1), ("data", "model"),
                                             devices=devices)
        for name, cell in (("decode", ShapeCell("d", 1024, 8, "decode")),
                           ("prefill", ShapeCell("p", 256, 2, "prefill"))):
            t = trace_step(cfg, cell, 1, one)
            out[name + "_trace"] = t["flops"]
            out[name + "_calls"] = t["kernel_calls"]
        print("RESULT_JSON:" + json.dumps(out))
    """)
    assert got["decode_trace"] == got["decode"] > 0
    assert got["prefill_trace"] == got["prefill"] > 0
    assert got["decode_calls"] == {"decode_attention": 4}
    assert got["prefill_calls"] == {"flash_attention": 4}


def test_collective_bytes_from_ops_names():
    from repro_torch.launch.roofline import collective_bytes_from_ops

    got = collective_bytes_from_ops([
        ("all_gather_into_tensor", 10), ("all_reduce", 4),
        ("reduce_scatter_tensor", 2), ("all_to_all_single", 8),
        ("all_reduce", 6), ("broadcast", 1)])
    assert got == {"total": 31,
                   "by_op": {"all-gather": 10, "all-reduce": 10,
                             "reduce-scatter": 2, "all-to-all": 8,
                             "broadcast": 1},
                   "op_counts": {"all-gather": 1, "all-reduce": 2,
                                 "reduce-scatter": 1, "all-to-all": 1,
                                 "broadcast": 1}}


def _ops_seen(fn):
    """(result, names of every op ``fn`` dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Spy():
        out = fn()
    return out, seen


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_custom_op_fakes_are_shape_only(device, dtype):
    """Under a FakeTensorMode, fake tensors (``cuda`` ones, and the
    ``cpu`` ones a torch without CUDA traces) reach each kernel's custom
    operator, whose fake gives the kernel's output and computes nothing:
    no plain version runs, nothing launches."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    before = (dict(FK.LAUNCHES), dict(DK.LAUNCHES))
    with FakeTensorMode():
        q = torch.empty(2, 8, 16, 64, dtype=dtype, device=device)
        k = torch.empty(2, 2, 32, 64, dtype=dtype, device=device)
        out, seen = _ops_seen(lambda: FK.flash_attention(q, k, k))
        assert isinstance(out, FakeTensor)
        assert (out.shape, out.dtype, out.device.type) == \
            (q.shape, dtype, device)
        assert seen == ["repro_torch.flash_attention.default"]
        qd = torch.empty(2, 8, 64, dtype=dtype, device=device)
        lens = torch.empty(2, dtype=torch.int32, device=device)
        out, seen = _ops_seen(lambda: DK.decode_attention(qd, k, k, lens,
                                                          window=16))
        assert (out.shape, out.dtype, out.device.type) == \
            (qd.shape, dtype, device)
        assert out.is_contiguous()
        assert seen == ["repro_torch.decode_attention.default"]
    assert (FK.LAUNCHES, DK.LAUNCHES) == before


def test_cpu_tensors_never_reach_the_custom_ops():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)))
    out, seen = _ops_seen(lambda: FK.flash_attention(q, k, v))
    assert torch.equal(out, mha_ref(q, k, v))
    _, seen_dec = _ops_seen(lambda: DK.decode_attention(
        q[:, :, 0], k, v, torch.tensor([5], dtype=torch.int32)))
    assert not any(s.startswith("repro_torch.") for s in seen + seen_dec)


def _mask_pairs(t, s, causal, window):
    """Pairs the plain version's mask keeps, counted from its mask."""
    qi = np.arange(t)[:, None] + (s - t)
    ki = np.arange(s)[None, :]
    mask = np.ones((t, s), bool)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= ki > qi - window
    return int(mask.sum())


@pytest.mark.parametrize("t,s", [(1, 1), (8, 8), (5, 13), (64, 64),
                                 (37, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 4, 16, 200])
def test_flash_flop_formula_against_the_mask(t, s, causal, window):
    pairs = _mask_pairs(t, s, causal, window)
    assert FK.attended_pairs(t, s, causal, window) == pairs
    assert FK.flash_flops((2, 4, t, 32), (2, 2, s, 32), (2, 2, s, 32),
                          causal, window, 1.0) == 4 * 2 * 4 * 32 * pairs


def test_flop_formulas_are_what_flop_counter_mode_counts():
    """4 D flops a kept (query, key) pair and query head: 4096 x 4097 / 2
    causal pairs at T = S = 4096; the decode kernel over every slot of
    the cache, at most ``window`` of them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        q = torch.empty(2, 32, 4096, 128, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 8, 4096, 128, dtype=torch.bfloat16, device="cuda")
        qd = torch.empty(8, 32, 128, dtype=torch.bfloat16, device="cuda")
        kd = torch.empty(8, 8, 1024, 128, dtype=torch.bfloat16, device="cuda")
        lens = torch.empty(8, dtype=torch.int32, device="cuda")
        counts = []
        for fn in (lambda: FK.flash_attention(q, k, k),
                   lambda: FK.flash_attention(q, k, k, window=512),
                   lambda: DK.decode_attention(qd, kd, kd, lens),
                   lambda: DK.decode_attention(qd, kd, kd, lens, window=300)):
            with FlopCounterMode(display=False) as fc:
                fn()
            counts.append(fc.get_total_flops())
    assert counts[0] == 4 * 2 * 32 * 128 * (4096 * 4097 // 2)
    # a window of 512: query i reads min(i + 1, 512) keys
    assert counts[1] == 4 * 2 * 32 * 128 * (512 * 513 // 2
                                            + (4096 - 512) * 512)
    assert counts[2] == 4 * 8 * 32 * 1024 * 128
    assert counts[3] == 4 * 8 * 32 * 300 * 128


def _fake_tree(tree):
    from repro_torch.models.decoder import map_cache

    return map_cache(tree, lambda t: torch.empty(t.shape, dtype=t.dtype))


def test_step_counter_agrees_with_flop_counter_mode():
    """On plain fake tensors the dry run's counter and FlopCounterMode
    count one decode step and one forward of a smoke model alike, with
    the kernels' formulas; the decode kernel is reached once a layer."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.models import decode_step, forward, model_specs
    from repro_torch.models.common import abstract_params
    from repro_torch.models.decoder import init_cache

    cfg = get_config("granite-8b-smoke")
    with FakeTensorMode():
        params = _fake_tree(abstract_params(model_specs(cfg), torch.float32))
        cache = _fake_tree(init_cache(cfg, 2, 64, device="meta"))
        token = torch.empty(2, 1, dtype=torch.int32)
        tokens = torch.empty(2, 32, dtype=torch.int32)
        for step in (lambda: decode_step(params, cache, token, 63, cfg),
                     lambda: forward(params, tokens, cfg)):
            with FlopCounterMode(display=False) as fc:
                step()
            with StepCounter() as sc:
                step()
            assert sc.flops == fc.get_total_flops() > 0
            assert sc.bytes > 0 and sc.peak > 0
    assert sc.kernel_calls == {"flash_attention": cfg.n_layers}


def test_unknown_options_raise():
    from repro_torch.launch.dryrun import run_cell

    with pytest.raises(ValueError, match="not supported"):
        run_cell("granite-8b", "decode_32k", False, save=False,
                 options={"shard_acts": True, "bogus": 1})


def test_report_dir_is_the_ports_own():
    from repro_torch.launch.dryrun import REPORT_DIR

    assert os.path.normpath(REPORT_DIR).split(os.sep)[-2:] == \
        ["reports", "dryrun_torch"]


# ---------------------------------------------------------------------------
# the shape stand-ins against the JAX package's
# ---------------------------------------------------------------------------
def _ref_leaves(tree, prefix=""):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def test_abstract_params_match_the_reference():
    """granite-8b's parameter stand-ins, leaf by leaf: the JAX package
    stacks the pattern repeats on a leading dim, the port lists them."""
    from repro.configs import get_config as ref_config
    from repro.models.common import abstract_params as ref_abstract
    from repro.models.model import model_specs as ref_specs

    from repro_torch.configs import get_config
    from repro_torch.models import model_specs
    from repro_torch.models.common import abstract_params, named_leaves

    cfg = get_config("granite-8b")
    ref = _ref_leaves(ref_abstract(ref_specs(ref_config("granite-8b"))))
    port = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in named_leaves(abstract_params(model_specs(cfg)))}
    assert all(t.device.type == "meta"
               for _, t in named_leaves(abstract_params(model_specs(cfg))))
    want = {}
    for key, (shape, dtype) in ref.items():
        if key.startswith("layers/scan/"):
            rest = key[len("layers/scan/"):]
            for r in range(shape[0]):
                want[f"layers/scan/{r}/{rest}"] = (shape[1:], dtype)
        else:
            want[key] = (shape, dtype)
    assert port == want
    # serving's storage dtypes on request
    bf16 = dict(named_leaves(abstract_params(model_specs(cfg),
                                             torch.bfloat16)))
    assert bf16["embed"].dtype == torch.bfloat16
    assert bf16["final_norm"].dtype == torch.float32


def test_input_specs_match_the_reference():
    from repro.configs import get_config as ref_config
    from repro.models.model import SHAPES as REF_SHAPES
    from repro.models.model import input_specs as ref_inputs

    from repro_torch.configs import get_config
    from repro_torch.models import SHAPES, input_specs

    assert [(s.name, s.seq_len, s.global_batch, s.step) for s in SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.step) for s in REF_SHAPES]
    for arch in ("granite-8b", "internvl2-2b"):
        for cell in SHAPES:
            ref = ref_inputs(ref_config(arch), cell)
            port = input_specs(get_config(arch), cell)
            assert sorted(port) == sorted(ref)
            for key, t in port.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(ref[key].shape)
                assert str(t.dtype).replace("torch.", "") \
                    == str(ref[key].dtype)


# ---------------------------------------------------------------------------
# the roofline report over the port's reports
# ---------------------------------------------------------------------------
def test_torch_roofline_report_on_two_synthetic_reports(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import torch_roofline_report as RR

    from repro_torch.launch.roofline import roofline_terms

    ok = {"arch": "granite-8b", "shape": "decode_32k", "mesh": "pod16x16",
          "status": "ok", "chips": 256, "flops_per_device": 989e12,
          "bytes_accessed_per_device": 3.35e12 * 2,
          "collective_bytes_per_device": 0.0, "params_active": 8e9,
          "tokens_per_step": 128, "step_kind": "decode"}
    ok["roofline"] = roofline_terms(ok, "NVIDIA H100 80GB HBM3")
    skipped = {"arch": "granite-8b", "shape": "long_500k",
               "mesh": "pod16x16", "status": "skipped",
               "reason": "long_500k skipped: pure full-attention arch "
                         "(quadratic)"}
    for i, rep in enumerate((ok, skipped)):
        (tmp_path / f"{i}.json").write_text(json.dumps(rep))
    lines = RR.main(str(tmp_path))
    assert lines[0] == "dryrun_torch[pod16x16],0.0,ok=1;skipped=1;errors=0"
    assert lines[1].startswith("roofline[granite-8b,decode_32k,pod16x16],"
                               "2000000.0,dominant=memory;")
    assert lines[2] == "dryrun_torch[pod2x16x16],0.0,ok=0;skipped=0;errors=0"
    table = RR.render_table("pod16x16", str(tmp_path)).splitlines()
    assert len(table) == 4
    assert re.match(r"\| granite-8b \| decode_32k \| ok \| 1\.0000 \| "
                    r"2\.0000 \| 0\.0000 \| memory \|", table[2])
    assert "| skipped (long_500k skipped" in table[3]

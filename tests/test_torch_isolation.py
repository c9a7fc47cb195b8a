"""The port stands alone: no JAX, no JAX package, and no hidden CPU.

``repro_torch`` imports torch and never ``jax`` or anything of
``repro``; its entry points default to CUDA and refuse to quietly run on
the CPU; a kernel wrapper takes its plain version only for CPU tensors.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.filter_project import kernel as K  # noqa: E402
from repro_torch.kernels.filter_project import ref as KR  # noqa: E402
from repro_torch.relational import Session, SessionConfig, c  # noqa: E402
from repro_torch.relational.tpcds import build_tpcds_session  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "src" / "repro_torch").rglob("*.cu")) + \
    sorted((ROOT / "examples").glob("torch_*.py")) + \
    sorted((ROOT / "benchmarks").glob("torch_*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_properties.py"]


CONFIG_MODULES = sorted(p.stem for p in
                        (ROOT / "src" / "repro" / "configs").glob("*.py")
                        if p.stem not in ("__init__", "registry"))


def test_import_loads_neither_jax_nor_the_jax_package():
    """Every module of the port, the dry run and the per-arch configs
    among them, and the public names the JAX package's packages export,
    import without JAX."""
    configs = "".join(f", repro_torch.configs.{m}" for m in CONFIG_MODULES)
    code = ("import sys, repro_torch.relational, repro_torch.carry, "
            "repro_torch.kernels.filter_project.ops, repro_torch.configs, "
            "repro_torch.models, repro_torch.serving.engine, "
            "repro_torch.kernels.decode_attention.ops, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.launch.roofline, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.launch.dryrun"
            f"{configs}; "
            "from repro_torch.launch import (data_axes, "
            "make_production_mesh, make_test_mesh); "
            "from repro_torch.train import make_compressed_train_step; "
            "from repro_torch.models import (SHAPES, ShapeCell, get_shape, "
            "input_specs); "
            "from repro_torch.models.common import abstract_params; "
            "from repro_torch.configs.granite_8b import CONFIG, SMOKE; "
            "assert (CONFIG.name, SMOKE.name) == "
            "('granite-8b', 'granite-8b-smoke'); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


# Names of the JAX package that the port keeps under another name or
# leaves out, each with its reason; every other public name of every
# module of the JAX package is a public name of the same module of the
# port.
NOT_MIRRORED = {
    # the serving cost model's v5e prices, renamed on purpose (MQO
    # parity depends on the values, which are not the H100's)
    ("serving/costs.py", "V5E_FLOPS"): "PRICE_FLOPS",
    ("serving/costs.py", "V5E_HBM_BW"): "PRICE_BYTES",
    # the TPU v5e's peaks: the port reads a card's by its name
    ("launch/roofline.py", "PEAK_FLOPS"): "hardware",
    ("launch/roofline.py", "HBM_BW"): "hardware",
    ("launch/roofline.py", "ICI_BW"): "hardware",
    # no HLO: the dry run records the collectives it dispatches
    ("launch/roofline.py", "collective_bytes_from_hlo"):
        "collective_bytes_from_ops",
    # the Pallas kernels' mask value; the CUDA kernels keep theirs in
    # their csrc
    ("kernels/flash_attention/kernel.py", "NEG_INF"): None,
    ("kernels/decode_attention/kernel.py", "NEG_INF"): None,
}


def _public_names(path: Path) -> set:
    """Functions, classes and module-level names a module defines, and
    what a package's ``__init__`` re-exports; none starting with "_"."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_public_names_mirror_the_jax_package():
    """Every module of the JAX package has a counterpart in the port
    with its public names, but for the names in NOT_MIRRORED, whose
    replacements exist."""
    ref_root = ROOT / "src" / "repro"
    port_root = ROOT / "src" / "repro_torch"
    missing = []
    for ref in sorted(ref_root.rglob("*.py")):
        rel = ref.relative_to(ref_root).as_posix()
        port = port_root / rel
        if not port.exists():
            missing.append(rel)
            continue
        have = _public_names(port)
        for name in sorted(_public_names(ref) - have):
            if (rel, name) not in NOT_MIRRORED:
                missing.append(f"{rel}::{name}")
    assert missing == []
    for (rel, _), new in NOT_MIRRORED.items():
        if new is not None:
            assert new in _public_names(port_root / rel), (rel, new)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_names_neither_jax_nor_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert "repro." not in text


def test_scripts_load_neither_jax_nor_the_jax_package():
    """Each example and bench script of the port, imported as a module
    (its ``__main__`` block does not run), loads neither."""
    scripts = [p for p in PORT_FILES
               if p.parent.name in ("examples", "benchmarks")]
    code = ("import importlib.util, sys\n"
            "sys.path.insert(0, 'benchmarks')\n"
            "for path in sys.argv[1:]:\n"
            "    spec = importlib.util.spec_from_file_location("
            "'m' + str(abs(hash(path))), path)\n"
            "    spec.loader.exec_module("
            "importlib.util.module_from_spec(spec))\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, *map(str, scripts)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert len(scripts) >= 9
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_default_to_cuda():
    from repro_torch.carry import params_from_reference
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.decoder import init_cache
    from repro_torch.relational import AsyncQueryService

    cfg = get_config("granite-8b-smoke")
    if torch.cuda.is_available():
        assert Session().device.type == "cuda"
        assert AsyncQueryService(Session()).session.device.type == "cuda"
        cache = init_cache(cfg, 1, 8)
        assert cache["scan"][0]["0"]["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_tpcds_session(scale_rows=1_000)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Session.from_config(SessionConfig())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Session()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AsyncQueryService(Session())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        params_from_reference({}, cfg)
    # asked for, the CPU is used
    assert AsyncQueryService(Session(device="cpu")).session.device.type \
        == "cpu"
    cache = init_cache(cfg, 1, 8, device="cpu")
    assert cache["scan"][0]["0"]["k"].device.type == "cpu"


def test_cpu_is_used_when_asked():
    sess = build_tpcds_session(scale_rows=1_000, device="cpu")
    assert sess.device == torch.device("cpu")
    svc = sess.service(max_batch=2)
    h = svc.submit(sess.table("store_sales").where(c.ss_quantity > 50)
                   .select("ss_item_sk", "ss_quantity"))
    t = h.result()
    assert all(col.device.type == "cpu" for col in t.columns.values())
    assert (t.to_numpy()["ss_quantity"] > 50).all()


def test_sharded_route_is_not_ported():
    """The row-sharded route takes only the port's own NamedSharding
    over one mesh axis; anything else (an arbitrary object, a two-axis
    spec, a JAX sharding) is refused with a TypeError naming it."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import NamedSharding

    mesh = make_test_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    import jax

    jax_sharding = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    for bad in (object(), NamedSharding(mesh, ("data", "model")),
                jax_sharding):
        cfg = SessionConfig().with_execution(sharding=bad)
        with pytest.raises(TypeError, match="NamedSharding"):
            Session.from_config(cfg, device="cpu")


def test_kernel_wrappers_take_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(0)
    cols = [torch.from_numpy(rng.integers(0, 9, 1024).astype(np.int32)),
            torch.from_numpy(rng.random(1024).astype(np.float32))]
    prog = (("gt", 0, 4), ("lt", 1, 0.5), ("and",))
    slotted = (("gt", 0, ("$i", 0)), ("lt", 1, ("$f", 0)), ("and",))
    ic = torch.tensor([[4], [2]], dtype=torch.int32)
    fc = torch.tensor([[0.5], [0.25]], dtype=torch.float32)
    before = dict(K.LAUNCHES)
    m, c = K.filter_scan(cols, prog, 1000, block=256)
    rm, rc = KR.filter_scan_ref(cols, prog, 1000, 256)
    assert torch.equal(m, rm) and torch.equal(c, rc)
    bm, bc = K.filter_scan_batch(cols, slotted, 1000, ic, fc, block=256)
    rbm, rbc = KR.filter_scan_batch_ref(cols, slotted, 1000, ic, fc, 256)
    assert torch.equal(bm, rbm) and torch.equal(bc, rbc)
    assert torch.equal(bm[0], m)
    assert K.LAUNCHES == before          # nothing was launched


# -- on the card a kernel failure surfaces ------------------------------
# These tests run without a GPU: a context whose device is set to CUDA
# after construction takes the card's routes, while its tensors stay on
# the CPU (where the wrappers run their plain versions).
def _card_ctx(sess):
    ctx = sess._fresh_ctx()
    ctx.device = torch.device("cuda")
    return ctx


def _failing_launch(*args, **kwargs):
    raise RuntimeError("filter_scan_batch launch failed: CUDA error 700")


@pytest.mark.parametrize("card", [True, False], ids=["card", "cpu"])
def test_a_real_kernel_error_gives_up_on_the_card(card):
    sess = build_tpcds_session(scale_rows=1_000, device="cpu")
    ctx = _card_ctx(sess) if card else sess._fresh_ctx()
    sess.run_one = _failing_launch
    sess._sleep = lambda s: None
    events = []
    plan = sess.table("store_sales").where(c.ss_quantity > 50) \
        .select("ss_item_sk")
    with pytest.raises(RuntimeError, match="launch failed"):
        sess.run_one_resilient(plan, ctx, events=events)
    steps = [(e.action, e.level) for e in events]
    if card:
        # no lower rung runs the plain version in the kernel's place
        assert steps == [("give-up", "kernel")]
    else:
        assert steps == [("degrade", "eager"), ("give-up", "eager")]


def test_card_ladder_is_kernel_then_eager_kernels(monkeypatch):
    from repro_torch.core.faults import InjectedFault
    from repro_torch.relational import physical

    # a replaced context re-resolves its device; keep the CUDA tag
    monkeypatch.setattr(physical, "resolve_device", lambda d: d)
    sess = build_tpcds_session(scale_rows=1_000, device="cpu")
    ctx = _card_ctx(sess)
    seen = []

    def run_one(plan, cur):
        seen.append((cur.fuse, cur.defer_sync, cur.use_pallas_filter))
        if len(seen) == 1:
            raise InjectedFault("kernel_launch", 0)
        return "ok"

    sess.run_one = run_one
    sess._sleep = lambda s: None
    events = []
    plan = sess.table("store_sales").where(c.ss_quantity > 50) \
        .select("ss_item_sk")
    assert sess.run_one_resilient(plan, ctx, events=events) == "ok"
    assert [(e.action, e.level) for e in events] == [("degrade", "eager")]
    assert seen == [(True, True, False), (False, False, False)]


@pytest.mark.parametrize("card", [True, False], ids=["card", "cpu"])
def test_eager_filters_take_the_kernel_on_the_card(monkeypatch, card):
    from repro_torch.relational import expr as E
    from repro_torch.relational import physical

    sess = build_tpcds_session(scale_rows=1_000, device="cpu")
    table = physical.execute(
        sess.table("store_sales").select("ss_item_sk", "ss_quantity"),
        sess._fresh_ctx())
    calls = []
    real = physical._try_pallas_filter

    def spy(pred, child):
        calls.append(pred)
        return real(pred, child)

    monkeypatch.setattr(physical, "_try_pallas_filter", spy)
    pred = E.cmp("ss_quantity", ">", 50)
    ctx = _card_ctx(sess) if card else sess._fresh_ctx()
    got = physical._exec_filter(pred, table, ctx)
    want = physical._exec_filter(pred, table, sess._fresh_ctx())
    assert len(calls) == (1 if card else 0)
    assert got.nrows == want.nrows
    for name in want.schema.names:
        assert torch.equal(got.columns[name], want.columns[name])


def test_a_failed_batched_group_raises_on_the_card():
    from types import SimpleNamespace

    from repro_torch.core.faults import InjectedFault
    from repro_torch.relational import physical

    sess = build_tpcds_session(scale_rows=1_000, device="cpu")
    group = [SimpleNamespace(pos=3)]
    failures = {}
    with pytest.raises(RuntimeError, match="launch failed"):
        physical._group_failed(_card_ctx(sess), group, RuntimeError(
            "filter_scan_batch launch failed"), failures)
    assert failures == {}
    for exc in (InjectedFault("batched_launch", 0),
                physical.GroupDiverged("children diverge")):
        physical._group_failed(_card_ctx(sess), group, exc, failures)
        assert failures == {3: exc}
    cpu_err = RuntimeError("any error")
    physical._group_failed(sess._fresh_ctx(), group, cpu_err, failures)
    assert failures == {3: cpu_err}


# -- the attention kernels: no plain-version fallback off the CPU --------
@pytest.mark.parametrize("which", ["decode", "flash"])
def test_attention_wrappers_raise_off_the_cpu(which):
    """Only a CPU tensor takes the plain version; any other device goes
    to the kernel's checks (here: meta tensors are refused)."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK

    meta = dict(device="meta")
    before = (dict(DK.LAUNCHES), dict(FK.LAUNCHES))
    with pytest.raises(ValueError, match="CUDA tensors"):
        if which == "decode":
            DK.decode_attention(torch.empty(1, 4, 32, **meta),
                                torch.empty(1, 2, 64, 32, **meta),
                                torch.empty(1, 2, 64, 32, **meta),
                                torch.empty(1, dtype=torch.int32, **meta))
        else:
            FK.flash_attention(torch.empty(1, 4, 8, 32, **meta),
                               torch.empty(1, 2, 8, 32, **meta),
                               torch.empty(1, 2, 8, 32, **meta))
    assert (DK.LAUNCHES, FK.LAUNCHES) == before


@pytest.mark.parametrize("which", ["decode", "flash"])
def test_a_failing_attention_kernel_surfaces_from_the_engine(monkeypatch,
                                                             which):
    """A raising kernel wrapper (as a failed launch on the card raises)
    propagates out of ServingEngine.run_batch / Model.forward: nothing
    degrades to the plain attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as DO
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.models import forward, init_params
    from repro_torch.serving import GenerationRequest, ServingEngine

    def failing(*args, **kwargs):
        raise RuntimeError(f"{which}_attention launch failed: CUDA error 700")

    from dataclasses import replace

    # on CPU tensors attn_impl="pallas" routes through the wrappers,
    # which CUDA tensors always take
    cfg = replace(get_config("granite-8b-smoke"), attn_impl="pallas")
    params = init_params(cfg, 0, device="cpu")
    prompt = np.arange(40, dtype=np.int32)
    if which == "decode":
        monkeypatch.setattr(DO, "decode_attention", failing)
        eng = ServingEngine(cfg, params, pool_budget_bytes=1 << 20,
                            block_size=16, max_len=64)
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.run_batch([GenerationRequest(0, prompt, 2),
                           GenerationRequest(1, prompt.copy(), 2)])
    else:
        monkeypatch.setattr(FO, "flash_attention", failing)
        with pytest.raises(RuntimeError, match="launch failed"):
            forward(params, torch.from_numpy(prompt[None]).long(), cfg)


# -- every reference test module has its port --------------------------
# Each test module of the JAX package and the port's test files that
# hold the same properties on the port.
PORTED_TESTS = {
    "test_api.py": ("test_torch_api.py",),
    "test_async_service.py": ("test_torch_async_service.py",),
    "test_cache_manager.py": ("test_torch_cache_manager.py",),
    "test_canonical.py": ("test_torch_canonical.py",),
    "test_dryrun.py": ("test_torch_dryrun.py", "test_torch_dryrun_moe.py",
                       "test_torch_dryrun_split.py",
                       "test_torch_dryrun_ssm.py"),
    "test_examples.py": ("test_torch_examples.py",
                         "test_torch_example_quickstart.py",
                         "test_torch_example_analytics_server.py",
                         "test_torch_example_llm_serving.py"),
    "test_fingerprint.py": ("test_torch_fingerprint.py",),
    "test_fuse.py": ("test_torch_fuse.py",),
    "test_identify_covering.py": ("test_torch_identify_covering.py",),
    "test_kernels.py": ("test_torch_filter_project.py",
                        "test_torch_csv_parse.py",
                        "test_torch_attention.py"),
    "test_mckp.py": ("test_torch_mckp.py",),
    "test_memory.py": ("test_torch_memory.py",),
    "test_models_smoke.py": ("test_torch_models.py",
                             "test_torch_model_families.py"),
    "test_mqo_end2end.py": ("test_torch_mqo_end2end.py",),
    "test_partition.py": ("test_torch_partition.py",
                          "test_torch_spmd_relational.py"),
    "test_relational_ops.py": ("test_torch_relational_ops.py",),
    "test_resilience.py": ("test_torch_resilience.py",),
    "test_rewrite_chaining.py": ("test_torch_rewrite_chaining.py",),
    "test_roofline.py": ("test_torch_roofline.py",),
    "test_rules_and_costs.py": ("test_torch_rules_and_costs.py",),
    "test_service.py": ("test_torch_service.py",),
    "test_serving_mqo.py": ("test_torch_serving.py",
                            "test_torch_serving_families.py"),
    "test_spmd.py": ("test_torch_spmd.py", "test_torch_sharding.py",
                     "test_torch_spmd_decode.py"),
    "test_subsumption.py": ("test_torch_subsumption.py",),
    "test_telemetry.py": ("test_torch_telemetry.py",),
    "test_train_ckpt.py": ("test_torch_train_ckpt.py",),
}

# Where a port file departs from its reference module, and why; a
# reference module missing from PORTED_TESTS needs an entry here too.
DOCUMENTED_EXCEPTIONS = {
    "test_partition.py::TestShardedPartitionedScan":
        "runs on the port's row-sharded session (a mesh of 8 cpu "
        "positions, no subprocess) in test_torch_spmd_relational.py, "
        "not in test_torch_partition.py",
    "test_fuse.py::TestI64Coverage":
        "torch has int64 without a flag: the port's cases run without "
        "the JAX package's enable_x64 and are also held against the "
        "port's numpy oracle (tests/torch_oracle.py)",
    "test_rules_and_costs.py::TestCostModelEquations::test_eq2_structure":
        "asserts Eq. 2 as core/costmodel.py's price_ce computes it, "
        "C_Omega = C_E* + C_W + m*C_R + C_X; the reference's copy leaves "
        "out the extraction term C_X and fails on both packages",
}


def test_every_reference_suite_is_ported():
    """No test module of the JAX package goes unported silently: each
    maps to existing port files, or has a documented exception; each
    exception names a test that exists in its reference module."""
    tests = ROOT / "tests"
    reference = sorted(p.name for p in tests.glob("test_*.py")
                       if not p.name.startswith("test_torch_"))
    excepted = {key.split("::")[0] for key in DOCUMENTED_EXCEPTIONS}
    unmapped = [m for m in reference
                if m not in PORTED_TESTS and m not in excepted]
    assert unmapped == []
    assert sorted(PORTED_TESTS) == [m for m in reference
                                    if m in PORTED_TESTS]
    for module, ports in PORTED_TESTS.items():
        for port in ports:
            assert (tests / port).is_file(), (module, port)
    for key in DOCUMENTED_EXCEPTIONS:
        module, *names = key.split("::")
        text = (tests / module).read_text()
        for name in names:
            assert re.search(rf"^\s*(class|def) {name}\b", text, re.M), key

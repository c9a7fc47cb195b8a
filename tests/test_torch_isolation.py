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
    [ROOT / "chip_smoke.py"]


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch.relational, repro_torch.carry, "
            "repro_torch.kernels.filter_project.ops, repro_torch.configs, "
            "repro_torch.models, repro_torch.serving.engine, "
            "repro_torch.kernels.decode_attention.ops, "
            "repro_torch.kernels.flash_attention.ops; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_names_neither_jax_nor_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert "repro." not in text


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
    cfg = SessionConfig().with_execution(sharding=object())
    with pytest.raises(NotImplementedError):
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
